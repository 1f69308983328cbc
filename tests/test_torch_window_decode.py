"""The sliding window's decode paths in the port against the JAX package,
on the CPU: greedy, beam and rolling-cache ``generate`` (the rolling and
linear caches give the same tokens), the ring cache's size and refusals, a
teacher-forced check of both caches, one ``ContinuousLMServer`` round per
prefill mode and one speculative round with rollbacks against the
reference's engine, the engine's refusal of learned positions, and the
dispatch that keeps a
windowed model off kernel K1 (the band is a mask, as in the reference).
One set of numpy weights from a seed goes into both packages
(``tests/test_torch_model_options.py``'s ``_pair``); greedy and beam tokens
must be identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models.generation import generate as jax_generate
from bigdl_tpu.models.serving import ContinuousLMServer as JaxServer
from bigdl_tpu_torch.models.generation import generate
from bigdl_tpu_torch.models.serving import ContinuousLMServer
from bigdl_tpu_torch.nn.attention import MultiHeadAttention
from bigdl_tpu_torch.ops import flash_attention
from test_torch_model_options import LLAMA, _ids, _pair


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------- the sliding window
WINDOWED = dict(LLAMA, window=5, max_len=40)


@pytest.fixture(scope="module")
def windowed():
    return _pair(WINDOWED, seed=6)


@pytest.mark.parametrize("mode", ["greedy", "beam", "rolling",
                                  "rolling_beam"])
def test_windowed_generate_matches_reference(windowed, mode):
    jm, tm = windowed
    prompt = _ids(2, 9, seed=11)
    kw = {"greedy": dict(greedy=True), "beam": dict(num_beams=3),
          "rolling": dict(greedy=True, rolling_cache=True),
          "rolling_beam": dict(num_beams=3, rolling_cache=True)}[mode]
    want = np.asarray(jax_generate(jm, jnp.asarray(prompt), 12, **kw))
    got = generate(tm, prompt, 12, device="cpu", **kw).numpy()
    np.testing.assert_array_equal(got, want)
    linear = {k: v for k, v in kw.items() if k != "rolling_cache"}
    np.testing.assert_array_equal(
        got, generate(tm, prompt, 12, device="cpu", **linear).numpy())


def test_rolling_cache_holds_window_slots(windowed):
    _, tm = windowed
    mha = [m for m in tm.modules() if isinstance(m, MultiHeadAttention)][0]
    mha.enable_decode(2, 40, rolling=True)
    try:
        assert tuple(mha.k_cache.shape) == (2, 5, 2, 16)
    finally:
        mha.disable_decode()
    with pytest.raises(ValueError, match="continuous"):
        mha.enable_decode(2, 40, rolling=True, continuous=True)


def test_windowed_prefill_decode_agrees_with_forward(windowed):
    """Teacher-forced: the decode path's log-probs at each new token equal
    a full windowed forward's, on both caches."""
    _, tm = windowed
    prompt = _ids(1, 9, seed=12)
    for rolling in (False, True):
        seq = generate(tm, prompt, 10, greedy=True, rolling_cache=rolling,
                       device="cpu")
        with torch.no_grad():
            lp = tm(seq)
        best = lp[0, 8:-1].argmax(-1) + 1
        assert torch.equal(best, seq[0, 9:])


class _Spy:
    """Records the ``mask`` argument of each ``use_flash`` call."""

    def __init__(self, monkeypatch):
        self.masks = []
        real = flash_attention.use_flash

        def spy(q, mask):
            self.masks.append(mask)
            return real(q, mask)
        monkeypatch.setattr(flash_attention, "use_flash", spy)


def test_windowed_attention_never_asks_for_k1(windowed, monkeypatch):
    _, tm = windowed
    spy = _Spy(monkeypatch)
    before = flash_attention.LAUNCHES.value
    with torch.no_grad():
        tm(torch.as_tensor(_ids(1, 12)))
    generate(tm, _ids(1, 7), 3, greedy=True, device="cpu")
    assert spy.masks and all(m is not None for m in spy.masks)
    assert flash_attention.LAUNCHES.value == before
    # an unwindowed model's prefill asks with no mask (K1 on the card)
    _, plain = _pair(dict(LLAMA, tie_embeddings=True))
    spy.masks.clear()
    with torch.no_grad():
        plain(torch.as_tensor(_ids(1, 12)))
    assert spy.masks and all(m is None for m in spy.masks)


@pytest.mark.parametrize("mode", ["chunked", "bucketed"])
def test_windowed_continuous_round_matches_reference(mode):
    kw = dict(WINDOWED, fused_head=True)
    jm, tm = _pair(kw, seed=6)
    server_kw = dict(slots=2, max_len=32, greedy=True, decode_block=4,
                     prefill_chunk=4, prefill_mode=mode, max_new_tokens=6)
    prompts = [_ids(1, n, seed=n)[0].tolist() for n in (3, 7, 12)]
    js = JaxServer(jm, **server_kw)
    ts = ContinuousLMServer(tm, **server_kw, device="cpu")
    try:
        want = [js.submit(p, timeout=120) for p in prompts]
        got = [ts.submit(p, timeout=120) for p in prompts]
    finally:
        js.close()
        ts.close()
    assert got == want
    _, fresh = _pair(kw, seed=6)
    for p, g in zip(prompts, got):
        assert generate(fresh, [p], 6, greedy=True,
                        device="cpu")[0, len(p):].tolist() == g


def test_continuous_engine_refuses_learned_positions():
    """An additive position table tracks one shared position: the engine
    refuses it, as the reference's does (GPT-2 serves through LMServer)."""
    from test_torch_model_options import OPTIONS
    _, tm = _pair(OPTIONS["learned"])
    with pytest.raises(ValueError, match="rope model"):
        JaxServer(_pair(OPTIONS["learned"])[0], slots=1, max_len=16)
    with pytest.raises(ValueError, match="rope model"):
        ContinuousLMServer(tm, slots=1, max_len=16, device="cpu")


def test_windowed_speculative_rollbacks_match_reference():
    """A windowed target with a draft of other weights (rejections, so the
    per-row rollback runs every round) keeps the band through the
    verification chunks: the answers are the reference engine's and
    ``generate``'s."""
    kw = dict(WINDOWED, fused_head=True)
    server_kw = dict(slots=2, max_len=32, greedy=True, decode_block=4,
                     prefill_chunk=4, max_new_tokens=8, spec_len=3)
    prompts = [_ids(1, n, seed=n + 20)[0].tolist() for n in (4, 9, 13)]
    jm, tm = _pair(kw, seed=6)
    jd, td = _pair(kw, seed=9)
    js = JaxServer(jm, draft=jd, **server_kw)
    ts = ContinuousLMServer(tm, draft=td, **server_kw, device="cpu")
    try:
        want = [js.submit(p, timeout=120) for p in prompts]
        got = [ts.submit(p, timeout=120) for p in prompts]
        assert 0 <= ts.spec_accepted_tokens < ts.spec_proposed_tokens
    finally:
        js.close()
        ts.close()
    assert got == want
    _, fresh = _pair(kw, seed=6)
    for p, g in zip(prompts, got):
        assert generate(fresh, [p], 8, greedy=True,
                        device="cpu")[0, len(p):].tolist() == g
