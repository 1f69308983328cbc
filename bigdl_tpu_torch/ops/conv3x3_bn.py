"""3x3 convolution with batch-norm channel statistics, and the fused
train-mode conv+BN op (counterpart of ``bigdl_tpu/ops/conv3x3_bn.py``).

``conv3x3_with_stats(x, w) -> (y, col_sum, col_sumsq)`` computes the
stride-1 SAME-padded conv of x (N, H, W, Cin) NHWC with w (3, 3, Cin, Cout)
HWIO in f32, and from the f32 result, before it is rounded, the per-channel
sum and sum of squares over (N, H, W) (f32, shape (Cout,)); y is returned
in x's dtype. On a CUDA tensor this is kernel K6 (``csrc/conv3x3_bn.cu``,
the port of the Pallas ``_kernel``) in one of two variants that
``kernel_variant`` picks: ``"mma"``, an implicit GEMM on the tensor cores
for bf16 with Cin and Cout multiples of 8 (every ResNet-50 3x3), and
``"fma"``, f32 FMA on the CUDA cores, for the rest. Neither makes a padded
copy of x, and both take the statistics from the f32 accumulator in a
fixed order (no atomics). On a CPU tensor it is
``conv3x3_with_stats_plain``. Mixed dtypes are promoted first, as the
reference's ``jnp.dot`` would.

``conv3x3_bn_train(x, w, gamma, beta, eps) -> (out, mean, var)`` is the
reference's ``custom_vjp`` as a ``torch.autograd.Function``: the forward
runs ``conv3x3_with_stats`` and normalises with the batch statistics; the
backward is the closed-form BN gradient in f32, then the conv's input and
weight gradients as plain convolutions. ``mean`` and ``var`` (biased) feed
the running statistics and are not differentiated.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.ops.batch_norm import bn_from_stats, bn_input_grad

#: launches of kernel K6, either variant (counted where the kernel is
#: launched, nowhere else), and of its "mma" variant alone
LAUNCHES = _build.LaunchCounter()
LAUNCHES_MMA = _build.LaunchCounter()

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def kernel_variant(x: torch.Tensor, w: torch.Tensor) -> str:
    """The K6 variant for x (N, H, W, Cin) and w (3, 3, Cin, Cout) of one
    dtype: ``"mma"`` (tensor cores) for bf16 with Cin and Cout multiples of
    8, ``"fma"`` (CUDA cores) otherwise."""
    cin, cout = w.shape[2], w.shape[3]
    if x.dtype == torch.bfloat16 and cin % 8 == 0 and cout % 8 == 0:
        return "mma"
    return "fma"

Stats = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME 3x3 conv of NHWC x with HWIO w, NHWC out (the
    permuted input is a channels-last view, so no copy is made of it)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return out.permute(0, 2, 3, 1)


def conv3x3_with_stats_plain(x: torch.Tensor, w: torch.Tensor) -> Stats:
    """K6's function in plain PyTorch: the conv in f32, the sums from the
    f32 result, y cast to x's dtype."""
    y32 = _conv3x3(x.float(), w.float())
    return y32.to(x.dtype), y32.sum((0, 1, 2)), (y32 * y32).sum((0, 1, 2))


def conv3x3_with_stats_kernel(x: torch.Tensor, w: torch.Tensor) -> Stats:
    """Launch kernel K6 on CUDA tensors: x (N, H, W, Cin) and w
    (3, 3, Cin, Cout) of one dtype (f32 or bf16), both contiguous (and
    16-byte aligned for the "mma" variant, which reads them with 16-byte
    copies)."""
    if x.dtype != w.dtype or x.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"K6 takes f32 or bf16 x and w of one dtype, got "
                         f"{x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("K6 takes contiguous x and w")
    mma = kernel_variant(x, w) == "mma"
    if mma and (x.data_ptr() % 16 or w.data_ptr() % 16):
        raise ValueError("K6's mma variant takes 16-byte aligned x and w")
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError("conv3x3_with_stats_kernel needs x and w on one "
                         "CUDA device")
    lib = _build.load("conv3x3_bn")
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    rows = (lib.bt_conv3x3_stats_mma_row_blocks if mma
            else lib.bt_conv3x3_stats_row_blocks)(n, h, wd)
    dev = x.device
    y = torch.empty((n, h, wd, cout), dtype=x.dtype, device=dev)
    partials = torch.empty((2, rows, cout), dtype=torch.float32, device=dev)
    stats = torch.empty((2, cout), dtype=torch.float32, device=dev)
    args = (x.data_ptr(), w.data_ptr(), y.data_ptr(), partials[0].data_ptr(),
            partials[1].data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
            n, h, wd, cin, cout)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if mma:
        status = lib.bt_conv3x3_stats_mma(*args, stream)
    else:
        status = lib.bt_conv3x3_stats(*args, int(x.dtype == torch.bfloat16),
                                      stream)
    _build.check_status(lib, "conv3x3_bn", status)
    LAUNCHES.add()
    if mma:
        LAUNCHES_MMA.add()
    return y, stats[0], stats[1]


def conv3x3_with_stats(x: torch.Tensor, w: torch.Tensor) -> Stats:
    """``(y, col_sum, col_sumsq)`` for ``y = conv3x3_same(x, w)``; see the
    module docstring."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"conv3x3_with_stats takes x (N, H, W, Cin) and w "
                         f"(3, 3, Cin, Cout), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    dt = torch.promote_types(x.dtype, w.dtype)
    xk, wk = x.to(dt), w.to(dt)
    if x.device.type == "cpu":
        y, s, sq = conv3x3_with_stats_plain(xk, wk)
    else:
        y, s, sq = conv3x3_with_stats_kernel(xk.contiguous(), wk.contiguous())
    return y.to(x.dtype), s, sq


class Conv3x3BNTrain(torch.autograd.Function):
    """conv3x3 (SAME) + train-mode BN over (N, H, W); forward through
    ``conv3x3_with_stats`` (K6 on the card)."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, eps):
        y, s, sq = conv3x3_with_stats(x, w)
        out, mean, var, inv = bn_from_stats(y, s, sq, gamma, beta, eps,
                                            x.dtype)
        ctx.save_for_backward(x, w, gamma, y, mean, inv)
        ctx.mark_non_differentiable(mean, var)
        return out, mean, var

    @staticmethod
    def backward(ctx, dout, _dmean, _dvar):
        x, w, gamma, y, mean, inv = ctx.saved_tensors
        dyconv, dgamma, dbeta = bn_input_grad(dout, y, mean, inv, gamma)
        dyconv = dyconv.to(x.dtype)
        dt = torch.promote_types(x.dtype, w.dtype)
        xc, wc = x.to(dt), w.to(dt)
        # dx: the conv with spatially flipped, io-swapped taps; dw: the
        # batch-contracted conv. Both are the plain conv's own gradients.
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dyconv.to(dt).permute(0, 3, 1, 2), xc.permute(0, 3, 1, 2),
            wc.permute(3, 2, 0, 1), None, [1, 1], [1, 1], [1, 1], False,
            [0, 0], 1, [True, True, False])
        return (dx.permute(0, 2, 3, 1).to(x.dtype),
                dw.permute(2, 3, 1, 0).contiguous().to(w.dtype),
                dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None)


def conv3x3_bn_train(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                     beta: torch.Tensor, eps: float):
    """``(out, mean, var)``: see the module docstring."""
    return Conv3x3BNTrain.apply(x, w, gamma, beta, eps)
