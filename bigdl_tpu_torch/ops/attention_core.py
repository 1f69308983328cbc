"""Plain attention cores (counterpart of ``bigdl_tpu/ops/attention_core.py``):
``dot_product_attention`` (with attention-probability dropout), the
blockwise online-softmax core ``blockwise_attention`` (``_block_scan``),
and the partials ring attention folds (``attention_partial``,
``online_softmax_combine``, ``finalize_partial``), all plain PyTorch as
the reference's are plain XLA.

Shapes follow the reference's (batch, seq, heads, head_dim) convention.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.ops import remat

_F32_MIN = float(torch.finfo(torch.float32).min)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          causal: bool = False,
                          scale: Optional[float] = None,
                          dropout_p: float = 0.0,
                          generator: Optional[torch.Generator] = None
                          ) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` over (B, S, N, D) tensors.

    ``mask`` broadcasts to (B, N, Sq, Sk), True where attention is allowed;
    ``causal`` adds the top-left-aligned lower-triangular mask. The softmax
    runs in f32; rows with every key masked give zeros, as in the reference.
    ``dropout_p`` drops the NORMALISED probabilities with inverted scale
    (unbiased), drawing from ``generator``; only this core takes it, since
    the flash kernels never form normalised probabilities.
    """
    sq, d = q.shape[1], q.shape[-1]
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    # mixed dtypes (an int8 twin's biased f32 q against its bf16 cache)
    # promote, as the reference's einsums do
    qk = torch.promote_types(q.dtype, k.dtype)
    logits = torch.einsum("bqnd,bknd->bnqk", q.to(qk), k.to(qk)) * scale
    logits = logits.float()
    if mask is not None:
        logits = logits + torch.where(
            mask, torch.zeros((), device=logits.device),
            torch.full((), _F32_MIN, device=logits.device))
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        logits = logits.masked_fill(~keep, _F32_MIN)
    dead = logits.amax(dim=-1, keepdim=True) <= _F32_MIN / 2
    weights = torch.softmax(logits, dim=-1)
    weights = weights.masked_fill(dead, 0.0)
    if dropout_p > 0.0:
        if generator is None:
            raise ValueError("dropout_p > 0 needs a generator")
        kept = remat.keep_mask(weights.shape, 1.0 - dropout_p, generator,
                               weights.device)
        weights = torch.where(kept, weights, 0.0) / (1.0 - dropout_p)
    wv = torch.promote_types(q.dtype, v.dtype)
    return torch.einsum("bnqk,bknd->bqnd", weights.to(q.dtype).to(wv),
                        v.to(wv))


# ------------------------------------------------ the blockwise core
# The reference's online-softmax formulation (its non-Pallas code): the
# recurrence kernel K1 runs on the card, and the one the ring's partial
# path (parallel/context.py) folds across ranks. Rows with every key
# masked carry the finite sentinel _F32_MIN, never -inf, so every combine
# stays NaN-free.

def _block_scan(q, k, v, mask_bias, causal: bool, scale: float,
                q_offset: int, block_size: int) -> torch.Tensor:
    """Online softmax over key blocks of ``block_size`` for q (B, Sq, N, D)
    against k/v (B, Sk, N, D); ``mask_bias`` additive, broadcastable to
    (B, N, Sq, Sk). Returns (B, Sq, N, D) in q's dtype."""
    b, sq, n, d = q.shape
    sk = k.shape[1]
    nblocks = -(-sk // block_size)
    q_pos = q_offset + torch.arange(sq, device=q.device)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    rsum = torch.zeros((b, n, sq), dtype=torch.float32, device=q.device)
    rmax = torch.full((b, n, sq), _F32_MIN, dtype=torch.float32,
                      device=q.device)
    for blk in range(nblocks):
        lo = blk * block_size
        hi = min(lo + block_size, sk)
        kblk, vblk = k[:, lo:hi], v[:, lo:hi]
        k_pos = torch.arange(lo, hi, device=q.device)
        logits = torch.einsum("bqnd,bknd->bnqk", q, kblk) * scale
        logits = logits.float()
        if mask_bias is not None:
            logits = logits + mask_bias[..., lo:hi]
        if causal:
            valid = k_pos[None, :] <= q_pos[:, None]
            logits = logits.masked_fill(~valid[None, None], _F32_MIN)
        new_max = torch.maximum(rmax, logits.amax(dim=-1))
        p = torch.exp(logits - new_max[..., None])
        # rows with every key masked so far stay empty until a live key
        dead = new_max <= _F32_MIN / 2
        p = p.masked_fill(dead[..., None], 0.0)
        correction = torch.where(dead, torch.ones_like(rmax),
                                 torch.exp(rmax - new_max))
        rsum = rsum * correction + p.sum(dim=-1)
        pv = torch.einsum("bnqk,bknd->bqnd", p, vblk.float())
        acc = acc * correction.transpose(1, 2)[..., None] + pv
        rmax = new_max
    rsum = rsum.clamp(min=1e-37)   # fully masked rows: 0, not NaN
    return (acc / rsum.transpose(1, 2)[..., None]).to(q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        causal: bool = False, scale: Optional[float] = None,
                        block_size: int = 512) -> torch.Tensor:
    """Exact attention with O(S) memory over (B, S, N, D) tensors
    (reference ``blockwise_attention``); ``mask`` broadcasts to
    (B, N, Sq, Sk), True where attention is allowed."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    mb = None
    if mask is not None:
        mb = torch.where(mask, torch.zeros((), device=q.device),
                         torch.full((), _F32_MIN, device=q.device))
        mb = mb.expand(q.shape[0], q.shape[2], q.shape[1], k.shape[1])
    return _block_scan(q, k, v, mb, causal, scale, 0,
                       min(block_size, k.shape[1]))


def online_softmax_combine(acc_a, sum_a, max_a, acc_b, sum_b, max_b):
    """Two partials over disjoint key sets, merged: each is (acc (B, Sq, N,
    D) = sum_j e^{l_j - max} v_j, row sum, row max (B, N, Sq))."""
    new_max = torch.maximum(max_a, max_b)
    ca = torch.exp(max_a - new_max)
    cb = torch.exp(max_b - new_max)
    new_sum = sum_a * ca + sum_b * cb
    new_acc = (acc_a * ca.transpose(1, 2)[..., None]
               + acc_b * cb.transpose(1, 2)[..., None])
    return new_acc, new_sum, new_max


def attention_partial(q, k, v, scale: float, k_offset: int, q_offset: int,
                      causal: bool, kv_valid_len=None, q_pos=None,
                      k_pos=None):
    """Unnormalised attention of q against one key/value chunk: (acc, row
    sum, row max) for ``online_softmax_combine``. ``k_offset``/``q_offset``
    are the chunks' first global positions; ``q_pos``/``k_pos`` (global
    position vectors, the zigzag shards') override them."""
    sq, sk = q.shape[1], k.shape[1]
    logits = (torch.einsum("bqnd,bknd->bnqk", q, k) * scale).float()
    if kv_valid_len is not None:
        valid = torch.arange(sk, device=q.device) < kv_valid_len
        logits = logits.masked_fill(~valid[None, None, None, :], _F32_MIN)
    if causal:
        if q_pos is None:
            q_pos = q_offset + torch.arange(sq, device=q.device)
        if k_pos is None:
            k_pos = k_offset + torch.arange(sk, device=q.device)
        cm = k_pos[None, :] <= q_pos[:, None]
        logits = logits.masked_fill(~cm[None, None], _F32_MIN)
    rmax = logits.amax(dim=-1)
    p = torch.exp(logits - rmax[..., None])
    # a fully masked chunk: p would be e^0 = 1 rows; zero them
    dead = rmax <= _F32_MIN / 2
    p = p.masked_fill(dead[..., None], 0.0)
    rmax = rmax.masked_fill(dead, _F32_MIN)
    rsum = p.sum(dim=-1)
    acc = torch.einsum("bnqk,bknd->bqnd", p, v.float())
    return acc, rsum, rmax


def finalize_partial(acc, rsum):
    """The normalised output of an accumulated partial."""
    return acc / rsum.clamp(min=1e-37).transpose(1, 2)[..., None]
