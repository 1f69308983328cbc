"""Matmul with batch-norm column statistics (counterpart of
``bigdl_tpu/ops/matmul_bn.py``).

``matmul_with_stats(x, w) -> (y, col_sum, col_sumsq)`` computes ``y = x @ w``
with f32 accumulation, and from the f32 product, before it is rounded,
``col_sum[j] = sum_m y[m, j]`` and ``col_sumsq[j] = sum_m y[m, j]**2``
(f32, shape (N,)); y is returned in x's dtype. It is the 1x1 conv + BN
fusion: the statistics are taken while the product is in registers, so y
is never re-read for them.

On a CUDA tensor this is kernel K5 (``csrc/matmul_bn.cu``, the port of the
Pallas ``_kernel``) in one of two variants that ``kernel_variant`` picks:
``"mma"``, on the tensor cores, for bf16 with K and N multiples of 8 (every
ResNet-50 1x1 conv; x and w must be 16-byte aligned), and ``"fma"``, f32
FMA on the CUDA cores, for the rest. On a CPU tensor it is
``matmul_with_stats_plain``. K5 takes f32 or bf16 x and w of one dtype,
reads x as a contiguous row-major (M, K) matrix, and sums the statistics in
a fixed order (no atomics), so they are the same bits on every run. Where x and w differ in
dtype the product runs in the promoted dtype, as the reference's
``jnp.dot`` would, and y is still returned in x's dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch

from bigdl_tpu_torch.ops import _build

#: launches of kernel K5, either variant (counted where the kernel is
#: launched, nowhere else), and of its "mma" variant alone
LAUNCHES = _build.LaunchCounter()
LAUNCHES_MMA = _build.LaunchCounter()

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def kernel_variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """The K5 variant for x (M, K) and w (K, N) of one dtype: ``"mma"``
    (tensor cores) for bf16 with K and N multiples of 8, ``"fma"`` (CUDA
    cores) otherwise."""
    kdim, n = w.shape
    if x.dtype == torch.bfloat16 and kdim % 8 == 0 and n % 8 == 0:
        return "mma"
    return "fma"

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def matmul_with_stats_plain(x: torch.Tensor, w: torch.Tensor) -> Stats:
    """K5's function in plain PyTorch: the product in f32, the sums from
    the f32 product, y cast to x's dtype."""
    y32 = x.float() @ w.float()
    return y32.to(x.dtype), y32.sum(0), (y32 * y32).sum(0)


def matmul_with_stats_kernel(x: torch.Tensor, w: torch.Tensor) -> Stats:
    """Launch kernel K5 on CUDA tensors: x (M, K) and w (K, N) of one dtype
    (f32 or bf16), both contiguous (and 16-byte aligned for the "mma"
    variant, which reads them with 16-byte copies)."""
    if x.dtype != w.dtype or x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"K5 takes f32 or bf16 x and w of one dtype, got "
                         f"{x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("K5 takes contiguous x and w")
    mma = kernel_variant(x, w) == "mma"
    if mma and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("K5's mma variant takes 16-byte aligned x and w")
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("matmul_with_stats_kernel needs x and w on one "
                         "CUDA device")
    lib = _build.load("matmul_bn")
    m, kdim = x.shape
    n = w.shape[1]
    row_blocks = lib.bt_matmul_stats_row_blocks(m)
    dev = x.device
    y = torch.empty((m, n), dtype=x.dtype, device=dev)
    partials = torch.empty((2, row_blocks, n), dtype=torch.float32, device=dev)
    stats = torch.empty((2, n), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), partials[0].data_ptr(),
            partials[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            m, kdim, n)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mma:
        status = lib.bt_matmul_stats_mma(*args, stream)
    else:
        status = lib.bt_matmul_stats(*args, int(x.dtype == torch.bfloat16),
                                     stream)
    _build.check_status(lib, "matmul_bn", status)
    LAUNCHES.add()
    if mma:
        LAUNCHES_MMA.add()
    return y, stats[0], stats[1]


def matmul_with_stats(x: torch.Tensor, w: torch.Tensor) -> Stats:
    """``(y, col_sum, col_sumsq)`` for ``y = x @ w``; see the module
    docstring. x (M, K), w (K, N)."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_with_stats takes x (M, K) and w (K, N), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    dt = torch.promote_types(x.dtype, w.dtype)
    xk, wk = x.to(dt), w.to(dt)
    if x.device.type == "cpu":
        y, s, sq = matmul_with_stats_plain(xk, wk)
    else:
        y, s, sq = matmul_with_stats_kernel(xk.contiguous(), wk.contiguous())
    return y.to(x.dtype), s, sq
