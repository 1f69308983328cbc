"""Kernel K1's plain version against the JAX flash-attention kernel.

``bigdl_tpu_torch.ops.flash_attention.flash_attention_plain`` is what the
port runs on CPU tensors and what the CUDA kernel is held against on the
card. Here it is held against the reference's Pallas forward
(``flash_attention_with_lse``) in interpret mode, with small blocks so the
online softmax crosses several key tiles. Tolerance: 1e-5 (f32 absolute
and relative) on O and on the row log-sum-exp; the dead-row sentinel must
match exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.flash_attention import \
    flash_attention_with_lse as jax_flash_with_lse
from bigdl_tpu_torch.ops import flash_attention as fa

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
NEG = float(np.finfo(np.float32).min)


def _qkv(b, sq, sk, n, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for shape in ((b, sq, n, d), (b, sk, n, d), (b, sk, n, d)))


def _jax(q, k, v, causal):
    o, lse = jax_flash_with_lse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=causal, block_q=8, block_k=8,
                                interpret=True)
    return np.asarray(o), np.asarray(lse)


def _port(q, k, v, causal):
    o, lse = fa.flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal)
    return o.numpy(), lse.numpy()


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s", [1, 7, 33])
def test_plain_matches_reference_kernel(causal, s):
    q, k, v = _qkv(2, s, s, 2, 16, seed=s)
    o, lse = _port(q, k, v, causal)
    ro, rlse = _jax(q, k, v, causal)
    assert o.shape == q.shape and lse.shape == (2, 2, s)
    np.testing.assert_allclose(o, ro, **TOL)
    np.testing.assert_allclose(lse, rlse, **TOL)


def test_plain_matches_reference_kernel_cross_length():
    q, k, v = _qkv(1, 5, 19, 3, 16, seed=4)
    o, lse = _port(q, k, v, False)
    ro, rlse = _jax(q, k, v, False)
    np.testing.assert_allclose(o, ro, **TOL)
    np.testing.assert_allclose(lse, rlse, **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_dead_row_sentinel_matches_reference(causal):
    # every logit of (b=0, s=3, h=1) overflows to -inf: the row is dead
    q, k, v = _qkv(1, 9, 9, 2, 16, seed=5)
    q[0, 3, 1] = 0.0
    q[0, 3, 1, 0] = -3e38
    k[:, :, 1, 0] = 100.0
    o, lse = _port(q, k, v, causal)
    ro, rlse = _jax(q, k, v, causal)
    assert lse[0, 1, 3] == NEG and rlse[0, 1, 3] == NEG
    assert (o[0, 3, 1] == 0).all() and (ro[0, 3, 1] == 0).all()
    assert np.isfinite(o).all() and np.isfinite(lse).all()
    np.testing.assert_allclose(o, ro, **TOL)
    np.testing.assert_allclose(lse, rlse, **TOL)


def test_wrapper_runs_plain_version_on_cpu_tensors():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 6, 6, 2, 64, seed=6))
    before = fa.LAUNCHES.value
    o, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
    po, plse = fa.flash_attention_plain(q, k, v, causal=True)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    assert torch.equal(fa.flash_attention(q, k, v, causal=True), po)
    assert fa.LAUNCHES.value == before  # no kernel on the CPU


def test_plain_version_keeps_bf16_output_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(1, 6, 6, 2, 64, seed=7))
    o, lse = fa.flash_attention_plain(q, k, v, causal=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32


def test_use_flash_only_for_cuda_tensors():
    q = torch.zeros(1, 4, 2, 64)
    assert not fa.use_flash(q, None)  # the CPU keeps the plain core


BF16_STEP, FLASH_ATOL = 2.0 ** -7, 5e-5  # chip_smoke.py's bf16 rule for O


def _mma_numerics(q, k, v, split, block_k=64):
    """The bf16 "mma" variant of K1 in plain torch, causal: f32 logits of
    bf16 q and k, scaled after the product; the online softmax over tiles
    of ``block_k`` keys in f32; p summed in f32 for l, and multiplied by V
    as bf16 hi + lo (``split``) or as one bf16 value; f32 accumulators."""
    b, sq, n, d = q.shape
    qf, kf, vf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v))
    m = torch.full((b, n, sq, 1), NEG)
    l = torch.zeros((b, n, sq, 1))
    acc = torch.zeros((b, n, sq, d))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, k.shape[1], block_k):
        s = (qf @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)) * d ** -0.5
        keys = torch.arange(k0, k0 + s.shape[-1])[None, :]
        s = torch.where(keys <= rows, s, torch.tensor(NEG))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        dead = m_new <= NEG / 2
        p = torch.where(dead, 0.0, torch.exp(s - m_new))
        corr = torch.where(dead, 1.0, torch.exp(m - m_new))
        l = l * corr + p.sum(-1, keepdim=True)
        hi = p.to(torch.bfloat16).float()
        vt = vf[:, :, k0:k0 + block_k]
        acc = acc * corr + hi @ vt
        if split:
            acc = acc + (p - hi).to(torch.bfloat16).float() @ vt
        m = m_new
    o = acc / l.clamp_min(1e-37)
    lse = torch.where(m <= NEG / 2, torch.tensor(NEG), m + torch.log(l))
    return o.permute(0, 2, 1, 3).to(torch.bfloat16), lse[..., 0]


def _served_qkv():
    # the served prefill shape: B=4, S=384, 12 heads, D=64, bf16
    return tuple(torch.from_numpy(a).to(torch.bfloat16)
                 for a in _qkv(4, 384, 384, 12, 64, seed=11))


def _excess(o, po):
    """The largest amount by which |o - po| passes the bf16 rule."""
    diff = (o.float() - po.float()).abs()
    return (diff - (BF16_STEP * po.float().abs() + FLASH_ATOL)).max().item()


def test_mma_design_with_split_p_keeps_the_bf16_tolerance():
    q, k, v = _served_qkv()
    po, plse = fa.flash_attention_plain(q, k, v, causal=True)
    o, lse = _mma_numerics(q, k, v, split=True)
    assert _excess(o, po) <= 0.0
    assert (lse - plse).abs().max().item() <= FLASH_ATOL


def test_mma_design_with_one_bf16_p_breaks_the_tolerance():
    q, k, v = _served_qkv()
    po, _ = fa.flash_attention_plain(q, k, v, causal=True)
    o, _ = _mma_numerics(q, k, v, split=False)
    assert _excess(o, po) > 1e-4  # ~2e-3 at this shape


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "heads", "contiguous",
                                 "rank"])
def test_kernel_argument_checks(bad):
    q = torch.zeros(2, 8, 4, 64)
    k = torch.zeros(2, 8, 4, 64)
    v = torch.zeros(2, 8, 4, 64)
    fa.check_args(q, k, v)  # what the kernel takes
    if bad == "head_dim":
        q, k, v = (t[..., :32] .contiguous() for t in (q, k, v))
    elif bad == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif bad == "heads":
        k = v = torch.zeros(2, 8, 2, 64)
    elif bad == "contiguous":
        q = torch.zeros(2, 4, 8, 64).transpose(1, 2)
    else:
        q = q[0]
    with pytest.raises(ValueError):
        fa.check_args(q, k, v)
