"""The port's continuous decode mode of ``MultiHeadAttention`` against the
reference's, on the CPU.

Identical seeded caches, per-row positions and inputs go through the
reference's ``_attend_decode_continuous`` (and its module forward, for the
per-row RoPE) and the port's. Tolerance: f32, 1e-5 absolute plus 1e-5
relative (the same products summed in another order); the written caches
and positions must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.attention import MultiHeadAttention as JaxMHA
from bigdl_tpu.nn.attention import rope_rotate as jax_rope_rotate
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.nn.attention import MultiHeadAttention, rope_rotate
from bigdl_tpu_torch.ops import attention_core, flash_attention

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
E, L = 32, 16
POS = np.array([0, 5, 11, 15])      # per-row positions; 15 is the last entry
HEADS = {"mha": (4, 4), "gqa": (4, 2)}


def _pair(name, rope=True):
    """(reference MHA, port MHA) with the same weights, in continuous decode
    mode over identical seeded caches at positions POS."""
    h, kv = HEADS[name]
    jm = JaxMHA(E, h, with_bias=False, causal=True, rope=rope, num_kv_heads=kv)
    tm = MultiHeadAttention(E, h, with_bias=False, causal=True, rope=rope,
                            num_kv_heads=kv).eval()
    with torch.no_grad():
        for n in ("in_proj_weight", "out_proj_weight"):
            getattr(tm, n).copy_(torch.from_numpy(np.array(getattr(jm, n))))
    b = len(POS)
    jm.enable_decode(b, L, continuous=True)
    tm.enable_decode(b, L, continuous=True)
    rng = np.random.default_rng(3)
    shape = (b, L, kv, E // h)
    kc = rng.standard_normal(shape).astype(np.float32)
    vc = rng.standard_normal(shape).astype(np.float32)
    jm.k_cache, jm.v_cache = jnp.asarray(kc), jnp.asarray(vc)
    jm.decode_pos = jnp.asarray(POS, jnp.int32)
    tm.k_cache.copy_(torch.from_numpy(kc))
    tm.v_cache.copy_(torch.from_numpy(vc))
    tm.decode_pos = torch.as_tensor(POS)
    return jm, tm


def _qkv(name, s, seed):
    h, kv = HEADS[name]
    rng = np.random.default_rng(seed)
    d = E // h
    mk = lambda n: rng.standard_normal((len(POS), s, n, d)).astype(np.float32)
    return mk(h), mk(kv), mk(kv)


@pytest.mark.parametrize("name", sorted(HEADS))
def test_token_step_matches_reference(name):
    """s == 1: the step of every slot at its own position (the GQA case
    takes the grouped product on both sides)."""
    jm, tm = _pair(name, rope=False)
    q, k, v = _qkv(name, 1, seed=1)
    ref = np.asarray(jm._attend_decode_continuous(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tm._attend_decode_continuous(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    np.testing.assert_array_equal(tm.decode_pos.numpy(), POS + 1)
    np.testing.assert_array_equal(tm.k_cache.numpy(), np.asarray(jm.k_cache))
    np.testing.assert_array_equal(tm.v_cache.numpy(), np.asarray(jm.v_cache))


@pytest.mark.parametrize("name", sorted(HEADS))
def test_chunk_matches_reference(name):
    """s > 1: a per-row chunk (speculative verification's shape), on the
    rows that stay inside the cache (the reference drops the others'
    writes past the end, the port clamps them)."""
    jm, tm = _pair(name, rope=False)
    s = 3
    q, k, v = _qkv(name, s, seed=2)
    keep = POS + s <= L
    ref = np.asarray(jm._attend_decode_continuous(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = tm._attend_decode_continuous(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got[keep], ref[keep], **TOL)
    np.testing.assert_array_equal(tm.k_cache[keep].numpy(),
                                  np.asarray(jm.k_cache)[keep])
    np.testing.assert_array_equal(tm.decode_pos.numpy(), POS + s)


def test_writes_past_the_cache_end_stay_in_bounds():
    """A row far past the end (a free slot after many rounds) writes its
    last entry instead of faulting, and the other rows are untouched."""
    _, tm = _pair("gqa", rope=False)
    tm.decode_pos = torch.as_tensor([2, 40, 3, 16])
    before = tm.k_cache.clone()
    q, k, v = _qkv("gqa", 2, seed=4)
    out = tm._attend_decode_continuous(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v))
    assert torch.isfinite(out).all()
    assert torch.equal(tm.k_cache[1, :-1], before[1, :-1])
    assert torch.equal(tm.k_cache[1, -1], torch.from_numpy(k[1, -1]))
    assert torch.equal(tm.k_cache[0, :2], before[0, :2])
    assert torch.equal(tm.k_cache[0, 2:4], torch.from_numpy(k[0]))
    np.testing.assert_array_equal(tm.decode_pos.numpy(), [4, 42, 5, 18])


@pytest.mark.parametrize("name", sorted(HEADS))
@pytest.mark.parametrize("s", [1, 3])
def test_forward_with_per_row_rope_matches_reference(name, s):
    """The module forward in continuous mode: projections, RoPE at per-row
    (B, S) positions, the cache write and attention."""
    jm, tm = _pair(name, rope=True)
    keep = POS + s <= L
    x = np.random.default_rng(5).standard_normal(
        (len(POS), s, E)).astype(np.float32)
    ref = np.asarray(jm(jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got[keep], ref[keep], **TOL)
    np.testing.assert_allclose(tm.k_cache[keep].numpy(),
                               np.asarray(jm.k_cache)[keep], **TOL)


@pytest.mark.parametrize("positions", ["shared", "per_row"])
def test_rope_rotate_matches_reference(positions):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 2, 8)).astype(np.float32)
    pos = (np.arange(5) + 7 if positions == "shared"
           else rng.integers(0, 500, (3, 5)))
    ref = np.asarray(jax_rope_rotate(jnp.asarray(x), jnp.asarray(pos), 500.0))
    got = rope_rotate(torch.from_numpy(x), torch.as_tensor(pos), 500.0)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_rope_per_row_equals_shared_rows():
    """Row b of a (B, S) rotation equals the shared (S,) rotation at row
    b's positions."""
    x = torch.randn(2, 4, 3, 6, generator=torch.Generator().manual_seed(0))
    pos = torch.tensor([[3, 4, 5, 6], [10, 11, 12, 13]])
    got = rope_rotate(x, pos)
    for b in range(2):
        assert torch.equal(got[b:b + 1], rope_rotate(x[b:b + 1], pos[b]))


def test_rolling_cache_is_refused():
    # the rolling cache is ported; without a window it is the reference's
    # ValueError, from both packages
    jm, tm = _pair("mha")
    with pytest.raises(ValueError, match="sliding-window"):
        jm.enable_decode(1, 8, rolling=True)
    with pytest.raises(ValueError, match="sliding-window"):
        tm.enable_decode(1, 8, rolling=True)


def test_disable_decode_leaves_continuous_mode():
    _, tm = _pair("gqa")
    tm.disable_decode()
    assert not tm._continuous and tm.decode_pos == 0
    assert "k_cache" not in tm._buffers


class _Spy:
    """Records the ``mask`` argument of each call of a module-level function
    while wrapping it."""

    def __init__(self, monkeypatch, module, name):
        self.masks = []
        real = getattr(module, name)

        def wrapped(*args, **kwargs):
            # use_flash(q, mask); dot_product_attention(q, k, v, mask=...)
            self.masks.append(kwargs["mask"] if "mask" in kwargs else args[1])
            return real(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)


def test_dispatch_cold_bucket_to_use_flash_and_warm_chunk_to_masked_core(
        monkeypatch):
    """On CPU tensors: the cold bucketed prefill (``_decode_prefilled``
    False) asks ``use_flash`` with no mask, as K1's dispatch on the card
    does, and a warm chunk (the chunked prefill) and a continuous step take
    the masked plain core and never ask for K1."""
    model = build_lm(50, embed_dim=32, num_heads=4, num_kv_heads=2,
                     ffn_dim=32, num_layers=2, max_len=32, rope=True,
                     activation="swiglu", norm="rms", bias=False,
                     fused_head=True, device="cpu", seed=0).eval()
    mhas = [m for m in model.modules() if isinstance(m, MultiHeadAttention)]
    flash = _Spy(monkeypatch, flash_attention, "use_flash")
    core = _Spy(monkeypatch, attention_core, "dot_product_attention")
    before = flash_attention.LAUNCHES.value
    with torch.inference_mode():
        for m in mhas:
            m.enable_decode(1, 16)
        model(torch.ones(1, 8, dtype=torch.int64))      # cold bucket
        assert flash.masks == [None] * len(mhas)
        assert core.masks == [None] * len(mhas)         # causal, no mask
        flash.masks.clear()
        core.masks.clear()
        for m in mhas:
            m.enable_decode(1, 16)
            m._decode_prefilled = True                  # warm chunk
        model(torch.ones(1, 8, dtype=torch.int64))
        assert flash.masks == []
        assert len(core.masks) == len(mhas)
        assert all(mask is not None for mask in core.masks)
        for m in mhas:
            m.enable_decode(3, 16, continuous=True)
        model(torch.ones(3, 1, dtype=torch.int64))      # continuous step
        model(torch.ones(3, 2, dtype=torch.int64))      # continuous chunk
    assert flash.masks == []
    # the GQA step takes the grouped product; the warm chunk and the
    # continuous chunk take the core
    assert len(core.masks) == 2 * len(mhas)
    assert flash_attention.LAUNCHES.value == before
