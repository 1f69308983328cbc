"""Flash attention, forward and backward (counterpart of
``bigdl_tpu/ops/flash_attention.py``).

``flash_attention_with_lse(q, k, v, causal, scale)`` returns
``(o (B, Sq, N, D), lse (B, N, Sq) f32)``: softmax attention and the row
log-sum-exp of the scaled, masked logits. A row with every key masked gets
``o = 0`` and the finite sentinel ``lse = float32.min``, never -inf.

Both outputs are differentiable through one ``torch.autograd.Function``,
``FlashAttention``, on every device, as the reference's ``custom_vjp``: the
backward takes cotangents for ``o`` AND ``lse`` and folds the latter into
``delta = rowsum(dO * O) - g_lse``. On a CUDA tensor the forward launches
kernel K1 (``csrc/flash_fwd.cu``, the port of ``_fwd_kernel``) in the
variant ``kernel_variant`` picks (``"mma"``, tensor cores, for bf16;
``"fma"``, CUDA cores, for float32), and the
backward kernels K2 (dQ) and K3 (dK, dV) (``csrc/flash_bwd.cu``, the ports
of ``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``), or raises; on a CPU tensor
they run ``flash_attention_plain`` and ``flash_attention_bwd_plain``, the
same functions in plain PyTorch.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from bigdl_tpu_torch.ops import _build

NEG = float(torch.finfo(torch.float32).min)
HEAD_DIMS = (64, 128)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: launches of kernels K1 (either variant; ``LAUNCHES_MMA``: its "mma"
#: variant alone), K2 and K3 (each counted where the kernel is launched,
#: nowhere else)
LAUNCHES = _build.LaunchCounter()
LAUNCHES_MMA = _build.LaunchCounter()
LAUNCHES_DQ = _build.LaunchCounter()
LAUNCHES_DKV = _build.LaunchCounter()


def kernel_variant(q: torch.Tensor) -> str:
    """The K1 variant for q of a dtype and head_dim that ``check_args``
    takes: ``"mma"`` (tensor cores) for bfloat16, ``"fma"`` (CUDA cores) for
    float32."""
    return "mma" if q.dtype == torch.bfloat16 else "fma"


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
    """Raise ``ValueError`` for what kernels K1, K2 and K3 do not take."""
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
    mma = kernel_variant(q) == "mma"
    if mma and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("K1's mma variant takes 16-byte aligned q, k and v")
    if q.device.type != "cuda":
        raise ValueError("K1 needs CUDA tensors")
    lib = _build.load("flash_fwd")
    b, sq, n, d = q.shape
    sk = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((b, n, sq), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, n, sq, sk, d, float(scale), int(causal))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if mma:
        status = lib.bt_flash_fwd_mma(*args, stream)
    else:
        status = lib.bt_flash_fwd(*args, DTYPES[q.dtype], stream)
    _build.check_status(lib, "flash_fwd", status)
    LAUNCHES.add()
    if mma:
        LAUNCHES_MMA.add()
    return o, lse


def bwd_delta(o: torch.Tensor, g_o: torch.Tensor,
              g_lse: Optional[torch.Tensor]) -> torch.Tensor:
    """``delta = rowsum(dO * O) - g_lse`` as (B, N, Sq) f32: the LSE
    cotangent enters the softmax jacobian where its diagonal term sits.
    One reduction outside the kernels, as in the reference."""
    delta = (g_o.float() * o.float()).sum(-1).transpose(1, 2)
    if g_lse is not None:
        delta = delta - g_lse.float()
    return delta.contiguous()


def _p_ds(q, k, v, g_o, lse, delta, causal: bool, scale: float):
    """The backward's (p, dS) in f32, (B, N, Sq, Sk), recomputed from the
    LSE; the exponent of a masked position is set to 0 BEFORE ``exp`` (a
    dead row's sentinel LSE would overflow it) and its ``p`` to 0."""
    sq, sk = q.shape[1], k.shape[1]
    logits = torch.einsum("bqnd,bknd->bnqk", q.float(), k.float()) * scale
    valid = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        valid = valid.tril()
    expo = torch.where(valid, logits - lse[..., None], 0.0)
    p = torch.where(valid, torch.exp(expo), 0.0)
    dp = torch.einsum("bqnd,bknd->bnqk", g_o.float(), v.float())
    return p, p * (dp - delta[..., None]) * scale


def flash_bwd_dq_plain(q, k, v, g_o, lse, delta, causal: bool,
                       scale: float) -> torch.Tensor:
    """K2's function in plain PyTorch: dQ = dS K, in q's dtype."""
    _, ds = _p_ds(q, k, v, g_o, lse, delta, causal, scale)
    return torch.einsum("bnqk,bknd->bqnd", ds, k.float()).to(q.dtype)


def flash_bwd_dkv_plain(q, k, v, g_o, lse, delta, causal: bool,
                        scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3's function in plain PyTorch: dK = dS^T Q, dV = P^T dO."""
    p, ds = _p_ds(q, k, v, g_o, lse, delta, causal, scale)
    dk = torch.einsum("bnqk,bqnd->bknd", ds, q.float())
    dv = torch.einsum("bnqk,bqnd->bknd", p, g_o.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def _check_bwd_args(q, k, v, g_o, lse, delta) -> None:
    check_args(q, k, v)
    b, sq, n, _ = q.shape
    if g_o.shape != q.shape or g_o.dtype != q.dtype or not g_o.is_contiguous():
        raise ValueError("g_o must be a contiguous tensor of q's shape and "
                         "dtype")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.shape != (b, n, sq) or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous (B, N, Sq) "
                             "float32 tensor")


def _bwd_inputs(q, k, v, g_o, lse, delta):
    """The input pointers both backward kernels take."""
    return tuple(t.data_ptr() for t in (q, k, v, g_o, lse, delta))


def _bwd_shape(q, k, causal: bool, scale: float):
    b, sq, n, d = q.shape
    return (b, n, sq, k.shape[1], d, float(scale), int(causal),
            DTYPES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream)


def flash_bwd_dq(q, k, v, g_o, lse, delta, causal: bool,
                 scale: float) -> torch.Tensor:
    """dQ: kernel K2 on CUDA tensors, ``flash_bwd_dq_plain`` on CPU ones."""
    if q.device.type == "cpu":
        return flash_bwd_dq_plain(q, k, v, g_o, lse, delta, causal, scale)
    _check_bwd_args(q, k, v, g_o, lse, delta)
    lib = _build.load("flash_bwd")
    dq = torch.empty_like(q)
    status = lib.bt_flash_bwd_dq(
        *_bwd_inputs(q, k, v, g_o, lse, delta), dq.data_ptr(),
        *_bwd_shape(q, k, causal, scale))
    _build.check_status(lib, "flash_bwd_dq", status)
    LAUNCHES_DQ.add()
    return dq


def flash_bwd_dkv(q, k, v, g_o, lse, delta, causal: bool,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dK, dV): kernel K3 on CUDA tensors, ``flash_bwd_dkv_plain`` on CPU
    ones."""
    if q.device.type == "cpu":
        return flash_bwd_dkv_plain(q, k, v, g_o, lse, delta, causal, scale)
    _check_bwd_args(q, k, v, g_o, lse, delta)
    lib = _build.load("flash_bwd")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    status = lib.bt_flash_bwd_dkv(
        *_bwd_inputs(q, k, v, g_o, lse, delta), dk.data_ptr(),
        dv.data_ptr(), *_bwd_shape(q, k, causal, scale))
    _build.check_status(lib, "flash_bwd_dkv", status)
    LAUNCHES_DKV.add()
    return dk, dv


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, g_o: torch.Tensor,
                              g_lse: Optional[torch.Tensor], causal: bool,
                              scale: float
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """K2 and K3's function in plain PyTorch, in f32: ``(dq, dk, dv)`` in
    the inputs' dtypes, with ``p`` recomputed from the saved LSE.
    ``g_lse`` may be None."""
    delta = bwd_delta(o, g_o, g_lse)
    dq = flash_bwd_dq_plain(q, k, v, g_o, lse, delta, causal, scale)
    return (dq, *flash_bwd_dkv_plain(q, k, v, g_o, lse, delta, causal, scale))


class FlashAttention(torch.autograd.Function):
    """``(o, lse)`` of ``(q, k, v)`` with the reference's VJP: kernels K1 /
    K2 + K3 on CUDA tensors, the plain versions on CPU tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        if q.device.type == "cpu":
            o, lse = flash_attention_plain(q, k, v, causal, scale)
        elif q.device.type == "cuda":
            o, lse = _flash_fwd_cuda(q, k, v, causal, scale)
        else:
            raise ValueError(f"flash_attention: unsupported device {q.device}")
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return o, lse

    @staticmethod
    def backward(ctx, g_o, g_lse):
        q, k, v, o, lse = ctx.saved_tensors
        g_o = (torch.zeros_like(o) if g_o is None
               else g_o.to(q.dtype).contiguous())
        delta = bwd_delta(o, g_o, g_lse)
        args = (q, k, v, g_o, lse, delta, ctx.causal, ctx.scale)
        dq = flash_bwd_dq(*args)
        dk, dv = flash_bwd_dkv(*args)
        return dq, dk, dv, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = False, scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Attention over (B, S, N, D) tensors returning ``(o, lse (B, N, Sq))``,
    both differentiable (``FlashAttention``)."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    return FlashAttention.apply(q, k, v, causal, float(scale))


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
