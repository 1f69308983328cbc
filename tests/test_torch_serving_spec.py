"""The port's ``ContinuousLMServer`` with a speculative draft, against
the non-speculative answers and the reference's speculative server, on
the CPU.

The weights are built by the reference from a seed and carried across with
``import_lm_state_dict`` (``tests/test_torch_serving.py``'s config).
Speculative decode is held to the non-speculative answers token for token,
with an identical draft (full acceptance) and an adversarial one (a model
of other weights, so the per-row rollback runs); an int8 target with an
int8 draft is held to the int8 twin's ``generate``.
"""

import threading

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
from bigdl_tpu_torch.nn.quantized import quantize_model

torch.set_num_threads(1)

V = 1000
LLAMA = dict(embed_dim=128, num_heads=4, num_kv_heads=2, ffn_dim=256,
             num_layers=2, max_len=64, rope=True, activation="swiglu",
             norm="rms", bias=False, fused_head=True)
SERVER = dict(slots=2, max_len=40, greedy=True, decode_block=4,
              prefill_chunk=4)
SPEC_LEN = 3


def _jax_model(seed=11, **kw):
    manual_seed(seed)
    return jax_transformer.build_lm(V, **dict(LLAMA, **kw)).evaluate_mode()


def _port_model(seed=11, **kw):
    tm = build_lm(V, **dict(LLAMA, **kw), device="cpu", seed=0)
    import_lm_state_dict(tm, jax_export(_jax_model(seed, **kw)))
    return tm.evaluate_mode()


def _prompt(n, seed=0):
    return np.random.default_rng([n, seed]).integers(1, V + 1, n).tolist()


def _generate(model, ids, max_new):
    return generate(model, [ids], max_new, greedy=True,
                    device="cpu")[0, len(ids):].tolist()


JOBS = [(_prompt(4, seed=2), 12), (_prompt(9, seed=2), 9),
        (_prompt(1, seed=2), 7), (_prompt(6, seed=2), 14)]
# the adversarial draft: other weights and another FFN
ADVERSARY = dict(seed=2, activation="gelu")


def _serve_threads(srv, jobs):
    results = [None] * len(jobs)

    def client(i):
        results[i] = srv.submit(*jobs[i], timeout=300)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(jobs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    return results


@pytest.fixture(scope="module")
def solo():
    """Each job's non-speculative answer (the port's generate)."""
    model = _port_model()
    return [_generate(model, ids, mx) for ids, mx in JOBS]


def _spec_server(draft, target=None):
    return ContinuousLMServer(target or _port_model(), draft=draft,
                              spec_len=SPEC_LEN, device="cpu", **SERVER)


def test_identical_draft_accepts_everything(solo):
    srv = _spec_server(_port_model())
    try:
        assert [srv.submit(*job, timeout=300) for job in JOBS] == solo
        assert srv.spec_accepted_tokens == srv.spec_proposed_tokens > 0
    finally:
        srv.close()


@pytest.fixture(scope="module")
def adversarial():
    """The port's and the reference's speculative servers with the
    adversarial draft, the jobs in flight together."""
    out = {}
    srv = _spec_server(_port_model(**ADVERSARY))
    try:
        out["port"] = _serve_threads(srv, JOBS)
        out["counts"] = (srv.spec_proposed_tokens, srv.spec_accepted_tokens)
    finally:
        srv.close()
    ref = JaxServer(_jax_model(), draft=_jax_model(**ADVERSARY),
                    spec_len=SPEC_LEN, **SERVER)
    try:
        out["jax"] = [ref.submit(*job, timeout=300) for job in JOBS]
    finally:
        ref.close()
    return out


def test_adversarial_draft_equals_non_speculative(adversarial, solo):
    assert adversarial["port"] == solo
    proposed, accepted = adversarial["counts"]
    assert 0 <= accepted < proposed             # rejections and rollbacks


def test_adversarial_draft_matches_the_reference_server(adversarial):
    assert adversarial["port"] == adversarial["jax"]


def test_int8_target_and_draft_equal_int8_generate():
    """The int8 twin as target and, as draft, a second quantize_model of
    the same weights: verification runs the int8 matmul at
    slots * (spec_len + 1) rows."""
    tq = quantize_model(_port_model(), torch.float32, device="cpu")
    dq = quantize_model(_port_model(), torch.float32, device="cpu")
    gen_model = quantize_model(_port_model(), torch.float32, device="cpu")
    srv = _spec_server(dq, target=tq)
    try:
        got = _serve_threads(srv, JOBS[:2])
        assert srv.spec_accepted_tokens == srv.spec_proposed_tokens > 0
    finally:
        srv.close()
    assert got == [_generate(gen_model, ids, mx) for ids, mx in JOBS[:2]]


def test_speculative_server_refuses_state_handoff():
    srv = _spec_server(_port_model())
    try:
        with pytest.raises(ValueError, match="speculative"):
            srv.prefill_handoff([1, 2, 3])
        with pytest.raises(ValueError, match="speculative"):
            srv.submit([1, 2, 3], 2, state=b"")
    finally:
        srv.close()
