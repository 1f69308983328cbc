"""Greedy speculative decoding of the port (``generate_speculative``)
against the reference's, on the CPU, f32.

Models are the reference tests' ``TestSpeculativeDecoding._lms`` pair
(seed 41: a 2-layer target and a 1-layer draft) and its Llama/GQA variant,
carried across with ``import_lm_state_dict``. Greedy output must be the
target's greedy generation exactly, token for token: equal to the
reference's ``generate_speculative`` and to the port's ``generate``, for
spec_len 1-6, with a draft of other weights and a second instance of the
target's own weights (every proposal accepted). The sampled mode's
distribution test is in ``tests/test_torch_speculative_sampled.py``.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu.interop.state_dict import export_lm_state_dict as jax_export
from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu.models.generation import \
    generate_speculative as jax_speculative
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch.interop.state_dict import import_lm_state_dict
from bigdl_tpu_torch.models import generation
from bigdl_tpu_torch.models.generation import generate, generate_speculative
from bigdl_tpu_torch.models.transformer import build_lm

torch.set_num_threads(1)

TARGET = (32, 16, 4, 32)
DRAFT = (32, 16, 2, 16)
LLAMA = dict(num_kv_heads=2, rope=True, activation="swiglu", norm="rms",
             tie_embeddings=True)
_CACHE = {}


def _port(jm, args, kw):
    tm = build_lm(*args, **kw, device="cpu", seed=0)
    import_lm_state_dict(tm, jax_export(jm))
    return tm.evaluate_mode()


def _lms(llama=False):
    """(reference target, reference draft, port target, port draft, port
    twin of the target)."""
    if llama not in _CACHE:
        extra = LLAMA if llama else {}
        tkw = dict(num_layers=2, max_len=96, **extra)
        dkw = dict(num_layers=1, max_len=96, **extra)
        manual_seed(41)
        jt = jax_transformer.build_lm(*TARGET, **tkw)
        jd = jax_transformer.build_lm(*DRAFT, **dkw)
        _CACHE[llama] = (jt, jd, _port(jt, TARGET, tkw), _port(jd, DRAFT, dkw),
                         _port(jt, TARGET, tkw))
    return _CACHE[llama]


def _greedy(model, prompt, n, eos_id=None):
    return generate(model, prompt, n, greedy=True, eos_id=eos_id,
                    device="cpu").numpy()


@pytest.mark.parametrize("k", [1, 4, 6])
def test_matches_reference(k):
    jt, jd, tt, td, _ = _lms()
    prompt = np.array([[3, 5, 7]])
    want = np.asarray(jax_speculative(jt, jd, prompt.astype(np.float32), 16,
                                      spec_len=k)).astype(int)
    got = generate_speculative(tt, td, prompt, 16, spec_len=k,
                               device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _greedy(tt, prompt, 16))


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("draft", ["other", "twin"])
def test_equals_plain_greedy(k, draft):
    _, _, tt, td, twin = _lms()
    prompt = np.array([[9, 1]])
    got = generate_speculative(tt, td if draft == "other" else twin, prompt,
                               11, spec_len=k, device="cpu").numpy()
    np.testing.assert_array_equal(got, _greedy(tt, prompt, 11))


def test_twin_draft_accepts_every_proposal(monkeypatch):
    """The same weights propose exactly the target's tokens: one round
    emits spec_len + 1 tokens, so 12 new tokens take 3 rounds of 4."""
    _, _, tt, _, twin = _lms()
    rounds = []
    inner = generation._set_decode_pos

    def spy(model, value):
        if model is tt:
            rounds.append(value)
        inner(model, value)

    monkeypatch.setattr(generation, "_set_decode_pos", spy)
    out = generate_speculative(tt, twin, [[4, 4, 2]], 12, spec_len=3,
                               device="cpu")
    np.testing.assert_array_equal(out.numpy(), _greedy(tt, [[4, 4, 2]], 12))
    assert rounds == [3 + 4, 3 + 8, 3 + 12]


def test_llama_recipe_with_gqa_matches_reference():
    jt, jd, tt, td, _ = _lms(llama=True)
    prompt = np.array([[3, 5, 7, 2]])
    want = np.asarray(jax_speculative(jt, jd, prompt.astype(np.float32), 14,
                                      spec_len=3)).astype(int)
    got = generate_speculative(tt, td, prompt, 14, spec_len=3,
                               device="cpu").numpy()
    np.testing.assert_array_equal(got, want)


def test_eos_freezes_like_reference():
    jt, jd, tt, td, _ = _lms()
    prompt = np.array([[3, 5, 7]])
    eos = int(_greedy(tt, prompt, 12)[0, 5])
    want = np.asarray(jax_speculative(jt, jd, prompt.astype(np.float32), 12,
                                      spec_len=4, eos_id=eos)).astype(int)
    got = generate_speculative(tt, td, prompt, 12, spec_len=4, eos_id=eos,
                               device="cpu").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _greedy(tt, prompt, 12, eos_id=eos))


@pytest.mark.parametrize("case, match", [
    ("batch", "B=1"), ("spec_len", "spec_len"), ("temperature", "temperature"),
    ("same", "separate"), ("max_len", "max_len")])
def test_argument_errors(case, match):
    _, _, tt, td, _ = _lms()
    kw, prompt, draft = {}, np.ones((1, 3), np.int64), td
    if case == "batch":
        prompt = np.ones((2, 3), np.int64)
    elif case == "spec_len":
        kw["spec_len"] = 0
    elif case == "temperature":
        kw["temperature"] = 0.0
    elif case == "same":
        draft = tt
    with pytest.raises(ValueError, match=match):
        generate_speculative(tt, draft, prompt,
                             90 if case == "max_len" else 4, device="cpu",
                             **kw)


def test_models_leave_decode_mode():
    _, _, tt, td, _ = _lms()
    generate_speculative(tt, td, [[1, 2]], 5, device="cpu")
    for m in list(tt.modules()) + list(td.modules()):
        assert not getattr(m, "_decode", False)
        assert not getattr(m, "_decode_all", False)
        assert "k_cache" not in m._buffers
    assert not tt.training and not td.training
