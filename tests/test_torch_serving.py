"""The port's ``ContinuousLMServer`` against the reference's, on the CPU.

One set of weights (built by the reference from a seed and carried across
with ``import_lm_state_dict``), the same numpy prompts, through the
reference's server, the port's, and the port's ``generate``. The config
is ``test_torch_lm_slice.py``'s Llama recipe with an untied head: a tied
random model only echoes the last prompt token, this one's greedy
continuations move. Tolerances are that file's: f32 log-probs 1e-5
absolute plus 1e-5 relative; greedy tokens identical. The int8 twin and
speculative decode are in ``tests/test_torch_serving_int8.py`` and
``tests/test_torch_serving_spec.py``.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu.interop.state_dict import export_lm_state_dict as jax_export
from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu.models.serving import ContinuousLMServer as JaxServer
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch.interop.state_dict import import_lm_state_dict
from bigdl_tpu_torch.models.generation import generate
from bigdl_tpu_torch.models.serving import ContinuousLMServer
from bigdl_tpu_torch.models.transformer import build_lm

torch.set_num_threads(1)

V = 1000
LLAMA = dict(embed_dim=128, num_heads=4, num_kv_heads=2, ffn_dim=256,
             num_layers=2, max_len=64, rope=True, activation="swiglu",
             norm="rms", bias=False, fused_head=True)
TOL = dict(rtol=1e-5, atol=1e-5)
C, MAX_LEN, MAX_NEW = 4, 32, 4
SERVER = dict(slots=2, max_len=MAX_LEN, greedy=True, decode_block=4,
              prefill_chunk=C)
# tests/test_serving.py's edge lengths: 1, C-1, C, C+1, 2C+3, and a prompt
# that fills the cache to exactly max_len less the budget
EDGES = [1, C - 1, C, C + 1, 2 * C + 3, MAX_LEN - MAX_NEW]
MODES = ("chunked", "bucketed")


def _jax_model():
    manual_seed(11)
    return jax_transformer.build_lm(V, **LLAMA).evaluate_mode()


def _port_model():
    tm = build_lm(V, **LLAMA, device="cpu", seed=0)
    import_lm_state_dict(tm, jax_export(_jax_model()))
    return tm.evaluate_mode()


def _prompt(n, seed=0):
    return np.random.default_rng([n, seed]).integers(1, V + 1, n).tolist()


def _generate(model, ids, max_new=MAX_NEW):
    return generate(model, [ids], max_new, greedy=True,
                    device="cpu")[0, len(ids):].tolist()


def _serve(jax_model, port_model, mode, prompts):
    """Each server's answers and last-token prefill log-probs (each prompt
    prefilled once more after serving: in chunked mode a prefix hit)."""
    out = {}
    for side, srv in (("jax", JaxServer(jax_model, prefill_mode=mode,
                                        **SERVER)),
                      ("port", ContinuousLMServer(
                          port_model, prefill_mode=mode, device="cpu",
                          **SERVER))):
        try:
            out[side] = [srv.submit(p, MAX_NEW, timeout=300) for p in prompts]
            runs = [srv._pipeline.run(p) for p in prompts]
            out[side, "lp"] = [np.asarray(r[0]) for r in runs]
            out[side, "hit"] = [r[2] for r in runs]
        finally:
            srv.close()
    return out


@pytest.fixture(scope="module", params=MODES)
def served(request):
    prompts = [_prompt(n) for n in EDGES]
    out = _serve(_jax_model(), _port_model(), request.param, prompts)
    gen_model = _port_model()
    out["generate"] = [_generate(gen_model, p) for p in prompts]
    out["mode"] = request.param
    return out


@pytest.mark.parametrize("i", range(len(EDGES)), ids=[str(n) for n in EDGES])
def test_served_tokens_match_reference_and_generate(served, i):
    assert served["port"][i] == served["jax"][i]
    assert served["port"][i] == served["generate"][i]


def test_answers_are_not_degenerate(served):
    assert len({t for a in served["port"] for t in a}) > len(EDGES)


def test_prefill_logprobs_match_reference(served):
    """``_PrefillPipeline.run``'s last-token log-probs, the second prefill
    of each prompt; in chunked mode the prompts of C+1, 2C+3 and 28 tokens
    hit the trie, at the reference's depths."""
    for got, ref in zip(served["port", "lp"], served["jax", "lp"]):
        np.testing.assert_allclose(got, ref, **TOL)
    assert served["port", "hit"] == served["jax", "hit"]
    if served["mode"] == "chunked":
        assert served["port", "hit"] == [0, 0, 0, C, 2 * C, 6 * C]
    else:
        assert not any(served["port", "hit"])
