"""Plain attention core (counterpart of ``bigdl_tpu/ops/attention_core.py``;
``dot_product_attention`` is ported, the blockwise core and the ring
helpers wait for the training and distributed slices).

Shapes follow the reference's (batch, seq, heads, head_dim) convention.
"""

from __future__ import annotations

from typing import Optional

import torch

_F32_MIN = float(torch.finfo(torch.float32).min)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          causal: bool = False,
                          scale: Optional[float] = None) -> torch.Tensor:
    """``softmax(q k^T * scale) v`` over (B, S, N, D) tensors.

    ``mask`` broadcasts to (B, N, Sq, Sk), True where attention is allowed;
    ``causal`` adds the top-left-aligned lower-triangular mask. The softmax
    runs in f32; rows with every key masked give zeros, as in the reference.
    """
    sq, d = q.shape[1], q.shape[-1]
    sk = k.shape[1]
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    logits = torch.einsum("bqnd,bknd->bnqk", q, k) * scale
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
    return torch.einsum("bnqk,bknd->bqnd", weights.to(q.dtype), v)
