"""The 3xTF32 split of the "tf32x3" kernel variants (K1's and K6's f32
paths), in plain PyTorch on the CPU.

On the card the two kernels split each f32 operand into tf32 pieces,
``hi = tf32(x)`` and ``lo = tf32(x - hi)`` (``cvt.rna.tf32.f32``), and
take each product as ``hi hi + hi lo + lo hi`` on the tensor cores.
``ops.precision.split_tf32`` is that split; here it is held to an
independent rounding in f64, and the three-product arithmetic, at a
VGG-16 stage-4 conv and an f32 attention, is held to the limits that
``chip_smoke.py`` holds the kernels to (y within CONV_F32_RTOL of max|y|
plus CONV_F32_ATOL, each channel's statistics within STATS_RTOL, O and
LSE within FLASH_ATOL), against f64 and against the JAX reference's
flash kernel. One tf32 pass (the hi pieces alone) must land past the same
limits: they tell the design from plain TF32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bigdl_tpu.ops.flash_attention import \
    flash_attention_with_lse as jax_flash_with_lse
from bigdl_tpu_torch.ops.precision import split_tf32, to_tf32

CONV_F32_RTOL, CONV_F32_ATOL, STATS_RTOL = 1e-4, 1e-5, 1e-5
FLASH_ATOL = 5e-5
NEG = float(np.finfo(np.float32).min)


@pytest.fixture(autouse=True)
def _one_thread():
    """One CPU thread for this file's tests, restored after each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tf32_f64(x: np.ndarray) -> np.ndarray:
    """tf32 rounding (10 mantissa bits, to nearest, ties away from zero)
    computed in f64 from the exponent: an independent reading of
    ``cvt.rna.tf32.f32`` for normal f32 values."""
    x = x.astype(np.float64)
    out = np.zeros_like(x)
    nz = x != 0
    ulp = 2.0 ** (np.floor(np.log2(np.abs(x[nz]))) - 10)
    out[nz] = np.sign(x[nz]) * np.floor(np.abs(x[nz]) / ulp + 0.5) * ulp
    return out


def test_to_tf32_rounds_as_cvt_rna():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000) * 10.0 ** rng.integers(-20, 20, 20000)
         ).astype(np.float32)
    # exact ties, both signs: 1 + 2^-11 lies halfway between tf32 values
    ties = np.array([1 + 2 ** -11, -(1 + 2 ** -11), 3 * (1 + 2 ** -11),
                     1 + 3 * 2 ** -11, 0.0, -0.0], np.float32)
    x = np.concatenate([x, ties])
    got = to_tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.astype(np.float64), _tf32_f64(x))
    assert not (got.view(np.int32) & 0x1FFF).any()   # 13 low bits dropped
    assert got[-6] == 1 + 2 ** -10 and got[-5] == -(1 + 2 ** -10)


def test_split_pieces_are_tf32_and_sum_to_x():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal(100000).astype(np.float32))
    hi, lo = split_tf32(x)
    for piece in (hi, lo):
        assert not (piece.view(torch.int32) & 0x1FFF).any()
    err = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert err <= 2.0 ** -22
    # x - hi is exact in f32, and |lo| is at most half a tf32 step of x
    assert torch.equal((x - hi).double(), x.double() - hi.double())
    assert ((lo.abs() / x.abs()) <= 2.0 ** -11).all()


def _conv(x, w):
    """SAME 3x3 conv of NHWC x with HWIO w, NHWC out, in x's dtype."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def _conv_inputs(n=1, hw=14, cin=512, cout=32, seed=2):
    """A VGG-16 stage-4 conv (14x14, 512 input channels), cut to a few
    output channels, as the kernel checks draw it."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, hw, hw, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout))
         / np.sqrt(9 * cin)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(w)


def _conv_errors(y, ref):
    """(y error over max|ref| beyond CONV_F32_ATOL as chip_smoke.py's
    y_close reads it, the largest statistics error over each channel's
    scale as its stats_close reads it)."""
    diff = (y.double() - ref).abs()
    y_ok = bool((diff <= CONV_F32_RTOL * ref.abs().max()
                 + CONV_F32_ATOL).all())
    flat, rflat = y.double().reshape(-1, y.shape[-1]), ref.reshape(
        -1, ref.shape[-1])
    stats = max(((flat.sum(0) - rflat.sum(0)).abs()
                 / rflat.abs().sum(0)).max().item(),
                ((flat.pow(2).sum(0) - rflat.pow(2).sum(0)).abs()
                 / rflat.pow(2).sum(0)).max().item())
    return y_ok, (diff.max() / ref.abs().max()).item(), stats


def test_three_products_hold_the_conv_limits_and_one_pass_does_not():
    x, w = _conv_inputs()
    ref = _conv(x.double(), w.double())
    (xh, xl), (wh, wl) = split_tf32(x), split_tf32(w)
    three = _conv(xh, wl) + _conv(xl, wh) + _conv(xh, wh)
    ok, rel, stats = _conv_errors(three, ref)
    assert ok and rel <= CONV_F32_RTOL and stats <= STATS_RTOL, (rel, stats)
    one_ok, one_rel, one_stats = _conv_errors(_conv(xh, wh), ref)
    assert not one_ok and one_rel > CONV_F32_RTOL, one_rel
    assert one_stats > STATS_RTOL, one_stats
    # the plain f32 conv, the kernel's yardstick on the card, holds them too
    ok, rel, stats = _conv_errors(_conv(x, w), ref)
    assert ok and stats <= STATS_RTOL


def _attention(q, k, v, causal, passes):
    """K1's function with each product's operands as the kernel takes
    them: ``passes`` 3 is 3xTF32 (q scaled in f32 first, then split; p
    split as it leaves the softmax), 1 is one tf32 pass (hi pieces only).
    (o, lse) in f32."""
    scale = 1.0 / q.shape[-1] ** 0.5

    def product(eq, a, b):
        (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
        if passes == 1:
            return torch.einsum(eq, ah, bh)
        return (torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
                + torch.einsum(eq, ah, bh))

    logits = product("bqnd,bknd->bnqk", q * scale, k)
    if causal:
        keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool).tril()
        logits = logits.masked_fill(~keep, NEG)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    o = product("bnqk,bknd->bqnd", p, v) / l.permute(0, 2, 1, 3)
    return o, (m + torch.log(l))[..., 0]


@pytest.mark.parametrize("causal", [True, False])
def test_three_products_hold_flash_atol_and_one_pass_does_not(causal):
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, 64, 2, 64)).astype(np.float32)
               for _ in range(3))
    ro, rlse = jax_flash_with_lse(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal, block_q=32,
                                  block_k=32, interpret=True)
    ro, rlse = np.asarray(ro), np.asarray(rlse)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    errs = {}
    for passes in (3, 1):
        o, lse = _attention(tq, tk, tv, causal, passes)
        errs[passes] = max(np.abs(o.numpy() - ro).max(),
                           np.abs(lse.numpy() - rlse).max())
    assert errs[3] <= FLASH_ATOL, errs
    assert errs[1] > FLASH_ATOL, errs
