"""Plain attention core (counterpart of ``bigdl_tpu/ops/attention_core.py``;
``dot_product_attention``, with attention-probability dropout, is ported;
the blockwise core and the ring helpers wait for the distributed slice).

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
