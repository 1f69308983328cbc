"""Fused LM-head cross-entropy (counterpart of ``bigdl_tpu/ops/lm_head_ce.py``):
the (N, vocab) logits are never formed whole.

``fused_lm_head_ce`` computes ``mean(logsumexp(h @ W^T + b) - logit[target])``
with a loop over vocabulary chunks and an online log-sum-exp, inside one
``torch.autograd.Function``:

- forward: per chunk, one (N, C) product and a running (max, sum of
  exponentials, target logit) in f32; only the chunk's logits are live;
- backward: recompute each chunk's logits from the saved row LSE, form
  ``softmax - onehot`` in place, and accumulate ``dh`` and the chunk's rows
  of ``dW`` and ``db``.

Rules kept from the reference: padded vocabulary rows get bias -1e30 (their
exponentials are exactly 0); each product runs in ``h``'s dtype (bf16 under
the mixed policy), converts to f32, and only then adds the bias; targets are
1-based; the LSE output's cotangent is carried through the backward. The
reference builds this from ``jnp.matmul`` inside ``lax.scan`` (no Pallas
kernel), so each chunk's product here is ``torch.matmul``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

NEG = -1e30  # effective -inf that survives exp without NaNs


def _pad_vocab(w: torch.Tensor, b: torch.Tensor, chunk: int):
    v = w.shape[0]
    n_chunks = -(-v // chunk)
    pad = n_chunks * chunk - v
    if pad:
        w = F.pad(w, (0, 0, 0, pad))
        # padded rows get bias -1e30 so exp() contributes 0 mass
        b = F.pad(b, (0, pad), value=NEG)
    return w, b, n_chunks


def _chunk_logits(h, w, b, c: int, chunk: int) -> torch.Tensor:
    """(N, C) f32 logits of chunk ``c``; the product runs in h's dtype."""
    rows = slice(c * chunk, (c + 1) * chunk)
    logits = torch.matmul(h, w[rows].T.to(h.dtype))
    return logits.float() + b[rows].float()


class LMHeadCE(torch.autograd.Function):
    """Per-row CE over valid rows: ``(loss_sum, n_valid, lse)`` of
    ``(h (N, E), w (V, E), b (V,), valid (N,) bool, tgt0 (N,) 0-based)``."""

    @staticmethod
    def forward(ctx, h, w, b, valid, tgt0, chunk: int):
        n = h.shape[0]
        wp, bp, n_chunks = _pad_vocab(w, b, chunk)
        m = torch.full((n,), NEG, dtype=torch.float32, device=h.device)
        s = torch.zeros((n,), dtype=torch.float32, device=h.device)
        zt = torch.full((n,), NEG, dtype=torch.float32, device=h.device)
        for c in range(n_chunks):
            logits = _chunk_logits(h, wp, bp, c, chunk)
            m_new = torch.maximum(m, logits.amax(dim=-1))
            idx = tgt0 - c * chunk
            in_c = (idx >= 0) & (idx < chunk)
            z = logits.gather(1, idx.clamp(0, chunk - 1)[:, None])[:, 0]
            zt = torch.where(in_c, z, zt)
            # in place: the chunk's logits are not needed after this
            s = s * torch.exp(m - m_new) + logits.sub_(m_new[:, None]).exp_().sum(-1)
            m = m_new
        lse = m + torch.log(s.clamp_min(1e-37))
        loss_sum = torch.where(valid, lse - zt, 0.0).sum()
        n_valid = valid.float().sum()
        ctx.save_for_backward(h, w, b, valid, tgt0, lse)
        ctx.chunk = chunk
        ctx.mark_non_differentiable(n_valid)
        ctx.set_materialize_grads(False)
        return loss_sum, n_valid, lse

    @staticmethod
    def backward(ctx, g_sum, _g_n_valid, g_lse):
        h, w, b, valid, tgt0, lse = ctx.saved_tensors
        chunk = ctx.chunk
        wp, bp, n_chunks = _pad_vocab(w, b, chunk)
        n, e = h.shape
        vmask = valid.float()
        if g_sum is None:
            g_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        g_hot = g_sum.float() * vmask        # the onehot term's weight per row
        # d loss_sum / d logits = (softmax - onehot) * valid, plus the lse
        # cotangent's softmax term (zero in the criterion path)
        row_g = g_hot if g_lse is None else g_hot + g_lse.float()
        dh = torch.zeros((n, e), dtype=torch.float32, device=h.device)
        dw_chunks, db_chunks = [], []
        for c in range(n_chunks):
            g_logits = _chunk_logits(h, wp, bp, c, chunk)
            g_logits.sub_(lse[:, None]).exp_().mul_(row_g[:, None])
            idx = tgt0 - c * chunk
            in_c = (idx >= 0) & (idx < chunk)
            g_logits.scatter_add_(1, idx.clamp(0, chunk - 1)[:, None],
                                  -(g_hot * in_c)[:, None])
            w_c = wp[c * chunk:(c + 1) * chunk]
            gl = g_logits.to(h.dtype)
            dh += torch.matmul(gl, w_c.to(h.dtype)).float()
            dw_chunks.append(torch.matmul(gl.T, h).float())
            db_chunks.append(g_logits.sum(0))
        v = w.shape[0]
        dw = torch.cat(dw_chunks)[:v]
        db = torch.cat(db_chunks)[:v]
        return (dh.to(h.dtype), dw.to(w.dtype), db.to(b.dtype), None, None,
                None)


def fused_lm_head_ce(hidden: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor], targets: torch.Tensor, *,
                     chunk: int = 16384, size_average: bool = True,
                     ignore_index: Optional[int] = None) -> torch.Tensor:
    """Cross-entropy of ``hidden @ weight.T + bias`` against 1-based targets.

    ``hidden``: (..., E); ``weight``: (V, E); ``targets``: hidden's leading
    shape, values in 1..V (any numeric dtype). Rows whose target equals
    ``ignore_index`` contribute nothing and do not count toward the mean.
    Equal to ``ClassNLL(LogSoftMax(logits), targets)`` without forming the
    (N, V) logits."""
    e = hidden.shape[-1]
    h2 = hidden.reshape(-1, e)
    tgt = targets.reshape(-1).to(device=hidden.device, dtype=torch.int64)
    tgt0 = tgt - 1
    if ignore_index is not None:
        valid = tgt != int(ignore_index)
    else:
        valid = torch.ones(tgt0.shape, dtype=torch.bool, device=hidden.device)
    if bias is None:
        bias = torch.zeros((weight.shape[0],), dtype=weight.dtype,
                           device=weight.device)
    chunk = min(int(chunk), weight.shape[0])
    loss_sum, n_valid, _ = LMHeadCE.apply(h2, weight, bias, valid, tgt0, chunk)
    if size_average:
        return loss_sum / n_valid.clamp_min(1.0)
    return loss_sum
