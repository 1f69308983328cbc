"""Flash-attention forward (counterpart of ``bigdl_tpu/ops/flash_attention.py``).

``flash_attention_with_lse(q, k, v, causal, scale)`` returns
``(o (B, Sq, N, D), lse (B, N, Sq) f32)``: softmax attention and the row
log-sum-exp of the scaled, masked logits. A row with every key masked gets
``o = 0`` and the finite sentinel ``lse = float32.min``, never -inf.

On a CUDA tensor it launches kernel K1 (``csrc/flash_fwd.cu``, the port of
the Pallas ``_fwd_kernel``) or raises; on a CPU tensor it runs
``flash_attention_plain``, the same function in plain PyTorch. The backward
kernels (K2, K3) are not ported yet, so this module is forward-only.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from bigdl_tpu_torch.ops import _build

NEG = float(torch.finfo(torch.float32).min)
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of kernel K1 (counted where the kernel is launched, nowhere else)
LAUNCHES = _build.LaunchCounter()


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = False, scale: Optional[float] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function in plain PyTorch, in f32: ``(o in q's dtype, lse f32)``."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    sq, sk = q.shape[1], k.shape[1]
    qf = q.float() * scale
    logits = torch.einsum("bqnd,bknd->bnqk", qf, k.float())
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, NEG)
    m = logits.amax(dim=-1, keepdim=True).clamp_min(NEG)
    dead = m <= NEG / 2
    p = torch.where(dead, torch.zeros_like(logits), torch.exp(logits - m))
    l_safe = p.sum(dim=-1, keepdim=True).clamp_min(1e-37)
    o = torch.einsum("bnqk,bknd->bqnd", p, v.float()) / l_safe.permute(0, 2, 1, 3)
    lse = torch.where(dead, torch.full_like(m, NEG), m + torch.log(l_safe))
    return o.to(q.dtype), lse[..., 0]


def check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise ``ValueError`` for what kernel K1 does not take."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes (B, S, N, D) tensors")
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    b, _, n, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, n, d):
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree "
                         "on batch, heads or head_dim")
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} is not one of {HEAD_DIMS}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: the kernel "
                         "takes float32 or bfloat16, the same for q, k, v")
    if q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError("empty sequence")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must be on one device")


def _flash_fwd_cuda(q, k, v, causal: bool, scale: float):
    check_args(q, k, v)
    lib = _build.load("flash_fwd")
    b, sq, n, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    status = lib.bt_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        b, n, sq, sk, d, float(scale), int(causal), DTYPES[q.dtype],
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check_status(lib, "flash_fwd", status)
    LAUNCHES.add()
    return o, lse


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = False, scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over (B, S, N, D) tensors returning ``(o, lse (B, N, Sq))``.
    Kernel K1 on CUDA tensors, the plain version on CPU tensors."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    return _flash_fwd_cuda(q, k, v, causal, scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = False, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Attention output only (see ``flash_attention_with_lse``)."""
    return flash_attention_with_lse(q, k, v, causal, scale)[0]


def use_flash(q: torch.Tensor, mask) -> bool:
    """Dispatch rule of ``MultiHeadAttention``: kernel K1 for unmasked
    attention of a CUDA tensor whose head_dim and dtype it takes.

    The reference's TPU gate (``seq >= 1024``) was a TPU v5e measurement
    and is not carried over; the CPU keeps the reference's plain core."""
    return (mask is None and q.device.type == "cuda"
            and q.shape[-1] in HEAD_DIMS and q.dtype in DTYPES)
