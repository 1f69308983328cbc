"""The port's ``ContinuousLMServer`` over the int8 twin against the
reference's server over its int8 twin, on the CPU.

The weights are built by the reference from a seed and carried across with
``import_lm_state_dict`` (``tests/test_torch_serving.py``'s config), then
each package quantizes its model (compute dtype f32). Tolerances, as in
``tests/test_torch_lm_slice.py``: greedy tokens identical; prefill
log-probs within 1e-2 absolute plus 2e-3 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.interop.state_dict import export_lm_state_dict as jax_export
from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu.models.serving import ContinuousLMServer as JaxServer
from bigdl_tpu.nn.quantized import quantize_model as jax_quantize_model
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch.interop.state_dict import import_lm_state_dict
from bigdl_tpu_torch.models.generation import generate
from bigdl_tpu_torch.models.serving import ContinuousLMServer
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.nn.quantized import quantize_model
from bigdl_tpu_torch.ops import int8_matmul

torch.set_num_threads(1)

V = 1000
LLAMA = dict(embed_dim=128, num_heads=4, num_kv_heads=2, ffn_dim=256,
             num_layers=2, max_len=64, rope=True, activation="swiglu",
             norm="rms", bias=False, fused_head=True)
INT8_TOL = dict(rtol=2e-3, atol=1e-2)
SERVER = dict(slots=2, max_len=40, greedy=True, decode_block=4,
              prefill_chunk=4)


def _jax_model():
    manual_seed(11)
    return jax_transformer.build_lm(V, **LLAMA).evaluate_mode()


def _port_model():
    tm = build_lm(V, **LLAMA, device="cpu", seed=0)
    import_lm_state_dict(tm, jax_export(_jax_model()))
    return tm.evaluate_mode()


def _prompt(n, seed=0):
    return np.random.default_rng([n, seed]).integers(1, V + 1, n).tolist()


def _generate(model, ids, max_new):
    return generate(model, [ids], max_new, greedy=True,
                    device="cpu")[0, len(ids):].tolist()


@pytest.fixture(scope="module")
def int8_served():
    prompts = [_prompt(n, seed=1) for n in (3, 5, 11)]
    out = {}
    jq = jax_quantize_model(_jax_model(), compute_dtype=jnp.float32)
    tq = quantize_model(_port_model(), torch.float32, device="cpu")
    before = int8_matmul.DEQUANT_CALLS.value
    for side, srv in (("jax", JaxServer(jq, **SERVER)),
                      ("port", ContinuousLMServer(tq, device="cpu",
                                                  **SERVER))):
        try:
            out[side] = [srv.submit(p, 5, timeout=300) for p in prompts]
            out[side, "lp"] = [np.asarray(srv._pipeline.run(p)[0])
                               for p in prompts]
        finally:
            srv.close()
    out["dequant"] = int8_matmul.DEQUANT_CALLS.value - before
    gen_model = quantize_model(_port_model(), torch.float32, device="cpu")
    out["generate"] = [_generate(gen_model, p, 5) for p in prompts]
    return out


def test_int8_twin_serves_the_reference_tokens(int8_served):
    assert int8_served["port"] == int8_served["jax"]
    assert int8_served["port"] == int8_served["generate"]
    # every call had M <= 32 rows: the kernel's arithmetic, never the
    # dequantize path
    assert int8_served["dequant"] == 0


def test_int8_twin_prefill_logprobs_within_tolerance(int8_served):
    for got, ref in zip(int8_served["port", "lp"], int8_served["jax", "lp"]):
        np.testing.assert_allclose(got, ref, **INT8_TOL)
