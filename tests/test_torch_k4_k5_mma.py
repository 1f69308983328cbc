"""The summation orders of K5's and K4's tensor-core designs, emulated on
the CPU.

K5 "mma" (``csrc/matmul_bn.cu``, through ``csrc/col_stats.cuh``) sums each
32-deep step of K on the tensor cores from zero (two m16n8k16 products) and
adds the step to an f32 accumulator; ``_k5_step_sums`` repeats that in
plain torch and is held to ``chip_smoke.py``'s bf16 rule against the plain
version at K = 2048, the deepest 1x1 of ResNet-50: each bf16 element within
one bf16 step of the plain value plus ``CONV_BF16_ATOL``, the design within
half of that atol, and the statistics within ``STATS_RTOL``.

K4 (``csrc/int8_matmul.cu``) computes y^T = W x^T on mma.sync with K
permuted alike in both operands, sums each 64-deep chunk from zero, adds a
warp's chunks in turn (a batch of at most 8 to the warp's partials), then
the block's warps in turn (8, or 4 where the grid holds at least two
blocks an SM), then applies the scale. The tests check that the
permutation covers every k once and gives the exact product, that its
int8 -> bf16 conversion is exact for every int8, which warps every decode
shape takes, and that the fixed order keeps y within ``INT8_RTOL`` at
K = 3072.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.ops import int8_matmul, matmul_bn

BF16_STEP, CONV_BF16_ATOL, STATS_RTOL = 2.0 ** -7, 1e-5, 1e-5  # chip_smoke.py
INT8_RTOL = 1e-4                                                # chip_smoke.py
K5_STEP, MMA_K = 32, 16   # col_stats.cuh's BK; the depth of one mma.sync
K4_CHUNK, K4_MAX_BATCH, K4_ROWS = 64, 8, 16                     # int8_matmul.cu
H100_SMS = 132


@pytest.fixture(autouse=True)
def _one_thread():
    """One CPU thread for this file's tests (the sizes are set for it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _k5_step_sums(x, w):
    """y = x @ w in K5 mma's order: each K5_STEP-deep step as two MMA_K-deep
    products summed from zero, then added to the f32 accumulator."""
    acc = torch.zeros((x.shape[0], w.shape[1]))
    for k0 in range(0, x.shape[1], K5_STEP):
        part = torch.zeros_like(acc)
        for k1 in range(k0, min(k0 + K5_STEP, x.shape[1]), MMA_K):
            part = part + x[:, k1:k1 + MMA_K] @ w[k1:k1 + MMA_K]
        acc = acc + part
    return acc


def test_k5_step_sums_keep_bf16_y_within_half_the_atol():
    rng = np.random.default_rng(7)
    m, k, n = 512, 2048, 64  # stage 4's 2048 -> 512 depth
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((rng.standard_normal((k, n)) / np.sqrt(k))
                         .astype(np.float32)).to(torch.bfloat16)
    y32 = _k5_step_sums(x.float(), w.float())
    ref_y, ref_s, ref_q = matmul_bn.matmul_with_stats_plain(x, w)
    got, ref = y32.to(torch.bfloat16).float(), ref_y.float()
    excess = ((got - ref).abs() - BF16_STEP * ref.abs()).clamp_min(0).max()
    assert excess.item() <= CONV_BF16_ATOL / 2
    for stat, want, scale in ((y32.sum(0), ref_s, y32.abs().sum(0)),
                              ((y32 * y32).sum(0), ref_q, (y32 * y32).sum(0))):
        assert ((stat - want).abs() / scale).max().item() <= STATS_RTOL


def _k4_phys(t, j, logical):
    """The physical k (0..63 within a chunk) that lane column t feeds to
    logical position ``logical`` (0..15) of mma j: the lane's 16 contiguous
    values at 16t, elements 4j, 4j + 1 (logical 2t, 2t + 1) and 4j + 2,
    4j + 3 (logical 2t + 8, 2t + 9)."""
    e = logical % 2 + (2 if logical >= 8 else 0)
    return 16 * t + 4 * j + e


def test_k4_operand_permutation_covers_each_k_once_and_is_exact():
    # lane (g, t) holds logical k in {2t, 2t + 1, 2t + 8, 2t + 9} of each mma
    covered = sorted(_k4_phys((lg % 8) // 2, j, lg)
                     for j in range(4) for lg in range(16))
    assert covered == list(range(K4_CHUNK))
    rng = np.random.default_rng(3)
    w = rng.integers(-128, 128, (16, K4_CHUNK))         # one A tile, 16 rows
    x = rng.integers(-1000, 1000, (8, K4_CHUNK))         # one n8 tile of M
    y = np.zeros((16, 8), np.int64)
    for j in range(4):                                   # mma j of the chunk
        a = np.zeros((16, 16), np.int64)
        b = np.zeros((16, 8), np.int64)
        for lg in range(16):
            t = (lg % 8) // 2
            a[:, lg] = w[:, _k4_phys(t, j, lg)]
            b[lg, :] = x[:, _k4_phys(t, j, lg)]
        y += a @ b
    assert np.array_equal(y, w @ x.T)


def test_k4_int8_to_bf16_conversion_is_exact():
    # int8_matmul.cu's i8x2_bf16: b + 128 in the mantissa of 2^23, less the
    # bias 2^23 + 128, rounded to bf16
    b = np.arange(-128, 128, dtype=np.int32)
    bits = np.uint32(0x4B000000) | ((b.astype(np.uint32) ^ 0x80) & 0xFF)
    f = bits.view(np.float32) - np.float32(8388736.0)
    assert np.array_equal(f, b.astype(np.float32))
    bf = torch.from_numpy(f).to(torch.bfloat16).float().numpy()
    assert np.array_equal(bf, b.astype(np.float32))


def k4_warps(o, sms=H100_SMS):
    """int8_matmul.cu's warps a block: 4 where the grid of 16-row tiles
    holds at least two blocks an SM, else 8."""
    return 4 if -(-o // K4_ROWS) >= 2 * sms else 8


def test_k4_warps_and_batches_at_every_decode_shape():
    shapes = ((768, 768), (256, 768), (3072, 768), (768, 3072), (32000, 768))
    assert {o: k4_warps(o) for o, _ in shapes} == {
        768: 8, 256: 8, 3072: 8, 32000: 4}
    for o, k in shapes:
        # every warp copies all its chunks in one batch: one round trip
        assert -(-(-(-k // K4_CHUNK)) // k4_warps(o)) <= K4_MAX_BATCH


def _k4_fixed_order(x, w, scale, warps):
    """y in K4's order: per 64-deep chunk from zero (four 16-deep mma
    products), a warp's chunks in turn (batches of K4_MAX_BATCH added to
    its zeroed partials), the block's warps in turn, then the scale."""
    k = x.shape[1]
    chunks = -(-k // K4_CHUNK)
    xf, wf = x.float(), w.float()
    zero = torch.zeros((x.shape[0], w.shape[0]))
    partials = []
    for warp in range(warps):
        mine = list(range(warp, chunks, warps))
        red = zero.clone()
        for b0 in range(0, len(mine), K4_MAX_BATCH):
            acc = zero.clone()
            for c in mine[b0:b0 + K4_MAX_BATCH]:
                part = zero.clone()
                for k1 in range(c * K4_CHUNK, min(k, (c + 1) * K4_CHUNK), MMA_K):
                    part = part + xf[:, k1:k1 + MMA_K] @ wf[:, k1:k1 + MMA_K].T
                acc = acc + part
            red = red + acc
        partials.append(red)
    total = partials[0]
    for p in partials[1:]:
        total = total + p
    return total * scale


@pytest.mark.parametrize("warps", [4, 8])
@pytest.mark.parametrize("k", [768, 3072])
def test_k4_fixed_order_keeps_y_within_int8_rtol(warps, k):
    rng = np.random.default_rng(11)
    m, o = 4, 96  # the served M; K of the projections and of down
    x = torch.from_numpy(rng.standard_normal((m, k), np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.integers(-128, 128, (o, k), dtype=np.int8))
    scale = torch.from_numpy((rng.random(o) * 1e-2 + 1e-3).astype(np.float32))
    got = _k4_fixed_order(x, w, scale, warps)
    ref = int8_matmul.int8_matmul_plain(x, w, scale)
    assert ((got - ref).abs().max() <= INT8_RTOL * ref.abs().max()).item()
