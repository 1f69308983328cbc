"""Beam search of the port (``generate(num_beams > 1)``) against the
reference's, on the CPU, f32, token for token.

Every case of the reference's ``tests/test_generation.py::TestBeamSearch``
(no mesh) plus its beam guards, on weights the reference builds from a seed
and ``import_lm_state_dict`` carries across: greedy dominance, the
exhaustive oracle, eos freezing, batches, a beam width above the vocabulary
(filler beams tie at -inf: the port must break ties as ``jax.lax.top_k``
does), the rejected samplers and the pad id, on the reference's default
unfused ``TimeDistributed(Linear) + LogSoftMax`` tail and the Llama recipe.
``length_penalty`` 0.0 / 0.6 / 1.0 / 2.0 and a tied head are in
``tests/test_torch_beam_penalty.py``. Tolerance: tokens identical.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu.interop.state_dict import export_lm_state_dict as jax_export
from bigdl_tpu.models import transformer as jax_transformer
from bigdl_tpu.models.generation import generate as jax_generate
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch.interop.state_dict import import_lm_state_dict
from bigdl_tpu_torch.models.generation import generate
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.ops import flash_attention

torch.set_num_threads(1)

VOCAB = 50
KINDS = {
    # the reference tests' tiny_lm: sinusoidal positions, the unfused tail
    "unfused": (VOCAB, dict(embed_dim=32, num_heads=4, ffn_dim=64,
                            num_layers=2, max_len=64)),
    "tied": (VOCAB, dict(embed_dim=32, num_heads=4, ffn_dim=64,
                         num_layers=2, max_len=64, tie_embeddings=True)),
    "llama": (VOCAB, dict(embed_dim=32, num_heads=4, num_kv_heads=2,
                          ffn_dim=64, num_layers=2, max_len=64, rope=True,
                          activation="swiglu", norm="rms", bias=False,
                          fused_head=True)),
    "v7": (7, dict(embed_dim=16, num_heads=2, ffn_dim=32, num_layers=1,
                   max_len=16)),
    "v5": (5, dict(embed_dim=16, num_heads=2, ffn_dim=32, num_layers=1,
                   max_len=16)),
}
_MODELS = {}


def _pair(kind, seed=0):
    """(reference model, port model) on one set of weights."""
    key = (kind, seed)
    if key not in _MODELS:
        v, kw = KINDS[kind]
        manual_seed(seed)
        jm = jax_transformer.build_lm(v, **kw)
        tm = build_lm(v, **kw, device="cpu", seed=0)
        import_lm_state_dict(tm, jax_export(jm))
        _MODELS[key] = (jm, tm.evaluate_mode())
    return _MODELS[key]


def _both(kind, prompt, n, seed=0, **kw):
    jm, tm = _pair(kind, seed)
    want = np.asarray(jax_generate(jm, np.asarray(prompt, np.float32), n,
                                   **kw)).astype(int)
    got = generate(tm, np.asarray(prompt, np.int64), n, device="cpu",
                   **kw).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


def test_beam_at_least_as_good_as_greedy():
    _, tm = _pair("unfused")
    p = [[3, 9, 4]]
    greedy = generate(tm, p, 6, greedy=True, device="cpu")
    beam = _both("unfused", p, 6, num_beams=4, length_penalty=0.0)

    def joint_logp(seq):
        with torch.inference_mode():
            logp = tm(torch.as_tensor(seq))
        return sum(float(logp[0, t - 1, int(seq[0, t]) - 1])
                   for t in range(3, seq.shape[1]))

    assert joint_logp(np.asarray(beam)) >= joint_logp(
        greedy.numpy()) - 1e-4


def test_exhaustive_oracle_tiny():
    """num_beams = V over 2 steps is exhaustive: the argmax joint
    continuation."""
    _, tm = _pair("v7")
    got = _both("v7", [[2, 5]], 2, num_beams=7, length_penalty=0.0)
    best, best_s = None, -np.inf
    with torch.inference_mode():
        for a in range(1, 8):
            for bt in range(1, 8):
                logp = tm(torch.tensor([[2, 5, a, bt]]))
                s = float(logp[0, 1, a - 1]) + float(logp[0, 2, bt - 1])
                if s > best_s:
                    best_s, best = s, (a, bt)
    assert tuple(got[0, 2:]) == best


@pytest.mark.parametrize("kind", ["unfused", "llama"])
def test_beam_eos_freezes(kind):
    prompt = np.random.default_rng(3).integers(1, VOCAB + 1, (2, 3))
    probe = _both(kind, prompt, 5, num_beams=3)
    eos = int(probe[0, 4])
    out = _both(kind, prompt, 5, num_beams=3, eos_id=eos, pad_id=1)
    for row in out:
        cont = list(row[3:])
        if eos in cont:
            assert all(t == 1 for t in cont[cont.index(eos) + 1:])


def test_beam_batch_and_shapes():
    out = _both("unfused", [[3, 9], [1, 2]], 7, num_beams=4)
    assert out.shape == (2, 9)
    assert out.min() >= 1 and out.max() <= VOCAB


@pytest.mark.parametrize("beams", [6, 9])
def test_beam_width_exceeding_vocab(beams):
    out = _both("v5", [[1, 1]], 3, num_beams=beams)
    assert out.shape == (1, 5) and out.min() >= 1 and out.max() <= 5
    _both("v5", [[2, 3], [4, 4]], 4, num_beams=beams, eos_id=3, pad_id=2)


def test_num_beams_1_is_deterministic_greedy():
    _, tm = _pair("unfused")
    p = [[1, 1, 1]]
    a = generate(tm, p, 8, num_beams=1, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    b = generate(tm, p, 8, num_beams=1, device="cpu",
                 generator=torch.Generator().manual_seed(9))
    g = generate(tm, p, 8, greedy=True, device="cpu")
    assert torch.equal(a, b) and torch.equal(a, g)
    _both("unfused", p, 8, num_beams=1)


@pytest.mark.parametrize("kw, match", [
    (dict(top_k=5), "beam"), (dict(top_p=0.9), "beam"),
    (dict(repetition_penalty=1.3), "repetition_penalty"),
    (dict(min_new_tokens=2), "min_new_tokens"),
    (dict(eos_id=5, pad_id=0), "pad_id")])
def test_beam_guards_match_reference(kw, match):
    jm, tm = _pair("unfused")
    with pytest.raises(ValueError, match=match):
        jax_generate(jm, np.ones((1, 2), np.float32), 3, num_beams=2, **kw)
    with pytest.raises(ValueError, match=match):
        generate(tm, np.ones((1, 2), np.int64), 3, num_beams=2,
                 device="cpu", **kw)


def test_beam_state_is_restored_and_prefill_counted():
    """Beams leave the model out of decode mode with its caches dropped,
    and the CPU prefill takes the plain attention (no K1 launch)."""
    _, tm = _pair("llama")
    before = flash_attention.LAUNCHES.value
    generate(tm, [[4, 2, 7]], 4, num_beams=3, device="cpu")
    assert flash_attention.LAUNCHES.value == before
    for m in tm.modules():
        assert not getattr(m, "_decode", False)
        assert "k_cache" not in m._buffers
