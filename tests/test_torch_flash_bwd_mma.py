"""The precision of K2's and K3's "mma" design, emulated on the CPU.

On the card the bf16 backward runs on the tensor cores: products of bf16
operands, summed in f32. q, k, v and dO are bf16, so S = Q K^T and
dP = dO V^T are exact products; p and dS are f32 and enter dQ = dS K,
dK = dS^T Q and dV = P^T dO split into bf16 pieces. ``_mma_bwd_numerics``
repeats that in plain torch in the kernels' order of sums (K2 over keys,
K3 over queries, one 16-deep mma step at a time, each piece's product
added into the running f32 sum), and is held to ``chip_smoke.py``'s bf16
rule against the plain backward: each element within one bf16 step of the
plain value plus ``BWD_BF16_ATOL``. The design the kernels use (dS as
hi + lo for dQ, in three pieces for dK; p in three pieces) must keep
within half the atol; one bf16 piece (for dS or for p) breaks the rule by
far more. S=512, the training length: dK's and dV's column sums grow
with it.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.ops import flash_attention as fa

BF16_STEP, BWD_BF16_ATOL = 2.0 ** -7, 1e-5  # chip_smoke.py's bf16 rule
MMA_K = 16  # the depth of one mma.sync m16n8k16 step
# the kernels' split (csrc/flash_bwd.cu): bf16 pieces of p in dV, of dS in
# dQ and of dS in dK
P_PIECES, DQ_DS_PIECES, DK_DS_PIECES = 3, 2, 3


@pytest.fixture(autouse=True)
def _one_thread():
    """One CPU thread for this file's tests (the size is set for it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pieces(x, n):
    """x as n bf16 pieces (as f32), largest first: each the bf16 rounding of
    what the earlier ones left (the remainders are exact in f32)."""
    out = []
    for _ in range(n):
        hi = x.to(torch.bfloat16).float()
        out.append(hi)
        x = x - hi
    return out


def _step_sums(pieces, right):
    """sum_i pieces[i] @ right in the kernels' order: over the inner
    dimension one ``MMA_K``-deep step at a time, each piece's product of
    the step added into the running f32 sum, largest piece first."""
    acc = 0.0
    for k0 in range(0, right.shape[-2], MMA_K):
        step = slice(k0, k0 + MMA_K)
        for piece in pieces:
            acc = acc + piece[..., step] @ right[..., step, :]
    return acc


def _mma_bwd_numerics(q, k, v, g_o, lse, delta, scale, p_pieces, dq_pieces,
                      dk_pieces):
    """The "mma" K2 and K3 in plain torch, causal: f32 S and dP of bf16
    operands, p and dS in f32 with the exponent guarded before exp, and
    the three products of p / dS pieces by bf16 operands summed in f32 as
    ``_step_sums`` does. Returns (dq, dk, dv) in bf16."""
    qf, kf, vf, gf = (t.float().permute(0, 2, 1, 3) for t in (q, k, v, g_o))
    sq, sk = q.shape[1], k.shape[1]
    valid = torch.ones(sq, sk, dtype=torch.bool).tril()
    s = (qf @ kf.transpose(-1, -2)) * scale
    p = torch.where(valid, torch.exp(torch.where(valid, s - lse[..., None],
                                                 0.0)), 0.0)
    ds = p * (gf @ vf.transpose(-1, -2) - delta[..., None]) * scale
    dq = _step_sums(_pieces(ds, dq_pieces), kf)                       # K2
    dv = _step_sums(_pieces(p.transpose(-1, -2), p_pieces), gf)       # K3
    dk = _step_sums(_pieces(ds.transpose(-1, -2), dk_pieces), qf)     # K3
    return tuple(t.permute(0, 2, 1, 3).to(torch.bfloat16)
                 for t in (dq, dk, dv))


def _excess(got, ref):
    """The largest amount by which |got - ref| passes one bf16 step of ref."""
    diff = (got.float() - ref.float()).abs()
    return (diff - BF16_STEP * ref.float().abs()).clamp_min(0).max().item()


def _excesses(seed, g_lse, p_pieces, dq_pieces, dk_pieces, b=1, s=512, n=4,
              d=64):
    """(dq, dk, dv) excess of the emulation over the plain backward, causal
    bf16 inputs from a numpy seed, with or without an LSE cotangent."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    q, k, v, g_o = (f(b, s, n, d).to(torch.bfloat16) for _ in range(4))
    scale = 1.0 / d ** 0.5
    o, lse = fa.flash_attention_plain(q, k, v, True, scale)
    delta = fa.bwd_delta(o, g_o, f(b, n, s) if g_lse else None)
    args = (q, k, v, g_o, lse, delta, True, scale)
    ref = (fa.flash_bwd_dq_plain(*args), *fa.flash_bwd_dkv_plain(*args))
    got = _mma_bwd_numerics(q, k, v, g_o, lse, delta, scale, p_pieces,
                            dq_pieces, dk_pieces)
    return [_excess(a, r) for a, r in zip(got, ref)]


@pytest.mark.parametrize("seed", [5, 6, 7, 8])
@pytest.mark.parametrize("g_lse", [False, True])
def test_the_kernels_split_keeps_half_the_bf16_atol(seed, g_lse):
    excess = _excesses(seed, g_lse, P_PIECES, DQ_DS_PIECES, DK_DS_PIECES)
    assert max(excess) <= BWD_BF16_ATOL / 2, excess  # ~3e-6 at most (dQ)


def test_one_bf16_p_breaks_the_rule_for_dv():
    dq, dk, dv = _excesses(5, False, 1, DQ_DS_PIECES, DK_DS_PIECES)
    assert dv > 1e-4  # ~3e-3
    assert max(dq, dk) <= BWD_BF16_ATOL / 2  # p enters dV alone


def test_one_bf16_ds_breaks_the_rule_for_dq_and_dk():
    dq, dk, dv = _excesses(5, True, P_PIECES, 1, 1)
    assert min(dq, dk) > 1e-4  # ~2e-3
    assert dv <= BWD_BF16_ATOL / 2  # dS does not enter dV


def test_a_third_piece_of_ds_takes_dk_far_inside_the_atol():
    """dK sums over up to Sq queries, as dV does: with dS as hi + lo its
    excess is a large share of half the atol (on an H100 it passed it),
    with a third piece a small one."""
    two = _excesses(7, False, P_PIECES, DQ_DS_PIECES, 2)[1]
    three = _excesses(7, False, P_PIECES, DQ_DS_PIECES, 3)[1]
    assert two > 1e-6 and three < 2e-7, (two, three)


def test_pieces_sum_to_the_value():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    for n, rel in ((1, 2.0 ** -8), (2, 2.0 ** -16), (3, 2.0 ** -24)):
        got = sum(_pieces(x, n))
        assert ((got - x).abs() <= rel * x.abs()).all()
        assert all(torch.equal(t, t.to(torch.bfloat16).float())
                   for t in _pieces(x, n))
