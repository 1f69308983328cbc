"""Weight-only int8 matmul (counterpart of ``bigdl_tpu/ops/int8_matmul.py``).

``int8_matmul(x, w_q, scale, bias, compute_dtype)`` computes
``x @ (w_q * scale).T (+ bias)`` with ``w_q`` int8 (O, K) and a per-output-row
f32 ``scale``. For decode-shaped calls (``kernel_applicable``) the numbers
are the reference kernel's: x rounded to bf16, products summed in f32, the
scale applied after the K sum, the f32 result cast to ``compute_dtype`` and
only then the bias added in its own dtype. On a CUDA tensor that is kernel
K4 (``csrc/int8_matmul.cu``, the port of the Pallas ``_kernel``); on a CPU
tensor it is ``int8_matmul_plain``. Other calls take the reference's
dequantize-then-matmul path, where the weight is dequantized to
``compute_dtype`` and the product may go to ``torch.matmul``.

Kernel rule, re-derived for the H100 from the reference's TPU rule
(``M <= 256``, ``K % 128 == 0``, a VMEM tile cap): ``M <= 256`` keeps the
reference's decode shape limit (larger M reuses each weight byte enough
for a plain matmul); ``K % 16 == 0`` lets every weight and x load be one
aligned 16-byte vector. Any O qualifies: the kernel masks the last rows.
K4 splits K over a block's warps and sums their partials in a fixed order,
so y is the same bits on every run.
"""

from __future__ import annotations

import warnings
from typing import Optional, Set, Tuple

import torch

from bigdl_tpu_torch.ops import _build

M_MAX = 256
K_QUANTUM = 16

#: launches of kernel K4 (counted where the kernel is launched, nowhere else)
LAUNCHES = _build.LaunchCounter()
#: calls that took the dequantize-then-matmul path (on any device)
DEQUANT_CALLS = _build.LaunchCounter()

_WARNED: Set[Tuple[int, int]] = set()


def kernel_applicable(m: int, kdim: int, out_dim: int) -> bool:
    """Whether an (m, K) x (O, K) call takes kernel K4's numbers."""
    return 1 <= m <= M_MAX and kdim > 0 and kdim % K_QUANTUM == 0 and out_dim > 0


def int8_matmul_plain(x2: torch.Tensor, w_q: torch.Tensor,
                      scale_row: torch.Tensor) -> torch.Tensor:
    """K4's function in plain PyTorch: f32 (M, O) from x (M, K), int8 w_q
    (O, K) and f32 scale (O,)."""
    xb = x2.to(torch.bfloat16).float()
    return (xb @ w_q.float().T) * scale_row.float()


def check_args(x2: torch.Tensor, w_q: torch.Tensor,
               scale_row: torch.Tensor) -> None:
    """Raise ``ValueError`` for what kernel K4 does not take."""
    if x2.dim() != 2 or w_q.dim() != 2 or scale_row.dim() != 1:
        raise ValueError("int8 kernel takes x (M, K), w_q (O, K), scale (O,)")
    m, kdim = x2.shape
    out_dim = w_q.shape[0]
    if w_q.shape[1] != kdim or scale_row.shape[0] != out_dim:
        raise ValueError(f"shapes x {tuple(x2.shape)}, w_q {tuple(w_q.shape)},"
                         f" scale {tuple(scale_row.shape)} disagree")
    if not kernel_applicable(m, kdim, out_dim):
        raise ValueError(f"(M={m}, K={kdim}, O={out_dim}) is outside the "
                         f"kernel's rule (M <= {M_MAX}, K % {K_QUANTUM} == 0)")
    if (x2.dtype, w_q.dtype, scale_row.dtype) != (
            torch.bfloat16, torch.int8, torch.float32):
        raise ValueError("int8 kernel takes bf16 x, int8 w_q, f32 scale")
    if not (x2.is_contiguous() and w_q.is_contiguous()
            and scale_row.is_contiguous()):
        raise ValueError("x, w_q and scale must be contiguous")
    if x2.data_ptr() % 16 or w_q.data_ptr() % 16:
        raise ValueError("x and w_q must be 16-byte aligned")
    if not (x2.device == w_q.device == scale_row.device):
        raise ValueError("x, w_q and scale must be on one device")


def int8_matmul_kernel(x2: torch.Tensor, w_q: torch.Tensor,
                       scale_row: torch.Tensor) -> torch.Tensor:
    """Launch kernel K4 on CUDA tensors: f32 (M, O)."""
    check_args(x2, w_q, scale_row)
    if x2.device.type != "cuda":
        raise ValueError("int8_matmul_kernel needs CUDA tensors")
    lib = _build.load("int8_matmul")
    m, kdim = x2.shape
    out_dim = w_q.shape[0]
    y = torch.empty((m, out_dim), dtype=torch.float32, device=x2.device)
    status = lib.bt_int8_matmul(
        x2.data_ptr(), w_q.data_ptr(), scale_row.data_ptr(), y.data_ptr(),
        m, kdim, out_dim, torch.cuda.current_stream(x2.device).cuda_stream)
    _build.check_status(lib, "int8_matmul", status)
    LAUNCHES.add()
    return y


def _to_kernel_x(x2: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 as one contiguous, 16-byte aligned (M, K) tensor."""
    xb = x2.to(torch.bfloat16).contiguous()
    return xb if xb.data_ptr() % 16 == 0 else xb.clone()


def _note_lost_kernel(kdim: int, out_dim: int) -> None:
    """Warn once per shape when a decode-shaped call misses the kernel
    because K is off the 16-element quantum."""
    key = (kdim, out_dim)
    if key in _WARNED:
        return
    _WARNED.add(key)
    warnings.warn(
        f"int8_matmul: K={kdim} (out_dim={out_dim}) is not a multiple of "
        f"{K_QUANTUM}, so the int8 kernel is not used for this shape and the "
        f"dequantize path runs instead; pad K to a multiple of {K_QUANTUM}.",
        RuntimeWarning, stacklevel=3)


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                compute_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``y = x @ (w_q * scale).T (+ bias)``; see the module docstring."""
    lead = x.shape[:-1]
    kdim = x.shape[-1]
    out_dim = w_q.shape[0]
    x2 = x.reshape(-1, kdim)
    m = x2.shape[0]
    scale_row = scale.reshape(out_dim)
    if kernel_applicable(m, kdim, out_dim):
        if x2.device.type == "cpu":
            y = int8_matmul_plain(x2, w_q, scale_row)
        else:
            y = int8_matmul_kernel(_to_kernel_x(x2), w_q,
                                   scale_row.float().contiguous())
        y = y.to(compute_dtype)
    else:
        if m <= M_MAX and kdim % K_QUANTUM:
            _note_lost_kernel(kdim, out_dim)
        DEQUANT_CALLS.add()
        w = w_q.to(compute_dtype) * scale_row[:, None].to(compute_dtype)
        y = torch.matmul(x2.to(compute_dtype), w.T)
    if bias is not None:
        # the bias keeps its own (f32) dtype, which promotes y as in the
        # reference: logits' argmax is sensitive to a bf16 downcast here
        y = y + bias
    return y.reshape(*lead, out_dim)
