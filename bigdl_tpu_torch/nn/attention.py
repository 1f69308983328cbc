"""Attention layers of the LM slice (counterpart of
``bigdl_tpu/nn/attention.py``).

Ported: ``LayerNorm``, ``RMSNorm``, ``PositionalEncoding``, ``rope_rotate``
(rotate-half pairing, no ``rope_scaling``), ``MultiHeadAttention`` (GQA,
RoPE, causal, attention-probability dropout; incremental decode over a
linear KV cache), and the ``TransformerEncoderLayer`` /
``TransformerEncoder`` stack with residual dropout. Sliding windows, the
rolling and continuous caches, context parallelism and MoE are later slices
(ROADMAP A3-A6).

The KV cache is module state (``enable_decode``) that the eager forward
updates in place; there is no functional-apply layer. Unmasked attention on
a CUDA tensor goes through kernels K1 (forward) and K2/K3 (backward) of
``ops/flash_attention.py``, except under attention dropout in training
mode, which takes the plain core (the kernels never form normalised
probabilities).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.regularization import Dropout
from bigdl_tpu_torch.ops import attention_core, flash_attention
from bigdl_tpu_torch.ops.precision import match_compute
from bigdl_tpu_torch.utils.device import module_device

_F32_MIN = float(torch.finfo(torch.float32).min)


class LayerNorm(Module):
    """Layer normalisation over the last axis with f32 statistics."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5):
        super().__init__()
        self.normalized_shape = (normalized_shape,)
        self.eps = eps
        self.weight = torch.nn.Parameter(torch.ones(normalized_shape))
        self.bias = torch.nn.Parameter(torch.zeros(normalized_shape))

    def forward(self, input):
        x = input.float()
        mean = x.mean(dim=-1, keepdim=True)
        var = (x - mean).square().mean(dim=-1, keepdim=True)
        y = ((x - mean) * torch.rsqrt(var + self.eps)).to(input.dtype)
        return y * self.weight + self.bias


class RMSNorm(Module):
    """Root-mean-square normalisation (Llama): one gain, no bias, f32
    statistics."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.dim, self.eps = dim, eps
        self.weight = torch.nn.Parameter(torch.ones(dim))

    def forward(self, input):
        x = input.float()
        y = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + self.eps)
        return y.to(input.dtype) * self.weight


class PositionalEncoding(Module):
    """Sinusoidal position encoding added to (B, S, E) input, then dropout.
    While decoding the positions continue from ``decode_pos``."""

    def __init__(self, embed_dim: int, max_len: int = 4096,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = Dropout(dropout)
        pos = np.arange(max_len)[:, None]
        div = np.exp(np.arange(0, embed_dim, 2)
                     * (-np.log(10000.0) / embed_dim))
        pe = np.zeros((max_len, embed_dim), np.float32)
        pe[:, 0::2] = np.sin(pos * div)
        pe[:, 1::2] = np.cos(pos * div[: embed_dim // 2])
        self.register_buffer("pe", torch.from_numpy(pe))
        self.decode_pos = 0

    def pos_table(self) -> torch.Tensor:
        return self.pe

    def enable_decode(self) -> "PositionalEncoding":
        self.decode_pos = 0
        return super().enable_decode()

    def forward(self, input):
        s = input.shape[1]
        start = self.decode_pos if self._decode else 0
        if self._decode:
            self.decode_pos += s
        return self.dropout(input + self.pe[start:start + s].to(input.dtype))


def rope_rotate(x: torch.Tensor, positions: torch.Tensor,
                theta: float = 10000.0) -> torch.Tensor:
    """Rotary position embedding of ``x`` (B, S, H, D) at absolute
    ``positions`` (S,), pairing feature i with i + D/2 (HF Llama's
    rotate-half), so the q.k score depends only on the distance."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    angles = positions.to(torch.float32)[:, None] * freqs      # (S, half)
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class MultiHeadAttention(Module):
    """Self-attention with a fused q;k;v input projection.

    The input projection is (E + 2 * E_kv, E), Torch's
    ``nn.MultiheadAttention`` stacking for full MHA and the row concatenation
    of Llama's q/k/v projections under GQA (``num_kv_heads < num_heads``,
    each k/v head shared by ``num_heads // num_kv_heads`` query heads)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 with_bias: bool = True, causal: bool = False,
                 rope: bool = False, num_kv_heads: Optional[int] = None,
                 rope_theta: float = 10000.0, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must divide num_heads")
        self.num_kv_heads = num_kv_heads or num_heads
        if num_heads % self.num_kv_heads != 0:
            raise ValueError(f"num_kv_heads {self.num_kv_heads} must divide "
                             f"num_heads {num_heads}")
        if rope and (embed_dim // num_heads) % 2 != 0:
            raise ValueError("rope needs an even head_dim")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.with_bias = with_bias
        self.causal = causal
        self.rope = rope
        self.rope_theta = rope_theta
        self._e_kv = self.num_kv_heads * self.head_dim
        rows = embed_dim + 2 * self._e_kv
        bound = math.sqrt(6.0 / (2 * embed_dim))  # the reference's xavier
        self.in_proj_weight = torch.nn.Parameter(
            torch.empty(rows, embed_dim).uniform_(-bound, bound))
        self.out_proj_weight = torch.nn.Parameter(
            torch.empty(embed_dim, embed_dim).uniform_(-bound, bound))
        if with_bias:
            self.in_proj_bias = torch.nn.Parameter(torch.zeros(rows))
            self.out_proj_bias = torch.nn.Parameter(torch.zeros(embed_dim))
        # attention-probability dropout: its rate and generator
        self.attn_drop = Dropout(dropout)
        self.decode_pos = 0
        self._decode_prefilled = False

    # ------------------------------------------------------------- decoding
    def _cache_dtype(self) -> torch.dtype:
        return self.in_proj_weight.dtype

    def enable_decode(self, batch_size: int,
                      max_len: int) -> "MultiHeadAttention":
        """Incremental-decode mode with a (B, max_len, num_kv_heads, D) KV
        cache, written in place at ``decode_pos`` by each forward."""
        dev = module_device(self)
        shape = (batch_size, max_len, self.num_kv_heads, self.head_dim)
        self.register_buffer("k_cache", torch.zeros(
            shape, dtype=self._cache_dtype(), device=dev), persistent=False)
        self.register_buffer("v_cache", torch.zeros(
            shape, dtype=self._cache_dtype(), device=dev), persistent=False)
        self.decode_pos = 0
        self._decode_prefilled = False
        self._decode = True
        return self

    def disable_decode(self) -> "MultiHeadAttention":
        self._decode = False
        for name in ("k_cache", "v_cache"):
            self._buffers.pop(name, None)
        return self

    def _attend_decode(self, q, k, v):
        """Write k/v at ``decode_pos`` and attend the new queries.

        A multi-token call on a cold cache is the prompt prefill: the fresh
        k/v are the whole context, so it takes the standard causal path
        (kernel K1 on the card). A warm multi-token chunk attends the cache
        with the position mask ``k_pos <= q_pos``; a GQA single-token step
        reads the cache at its num_kv_heads size with a grouped product.
        Only the written prefix of the cache is read: the masked tail would
        add exact zeros."""
        pos = self.decode_pos
        s = q.shape[1]
        self.k_cache[:, pos:pos + s] = k.to(self.k_cache.dtype)
        self.v_cache[:, pos:pos + s] = v.to(self.v_cache.dtype)
        self.decode_pos = pos + s
        first = not self._decode_prefilled
        self._decode_prefilled = True
        if s > 1 and first:
            return self._attend(q, self._expand_kv(k), self._expand_kv(v), None)
        length = pos + s
        keys, vals = self.k_cache[:, :length], self.v_cache[:, :length]
        k_pos = torch.arange(length, device=q.device)[None, :]
        q_pos = pos + torch.arange(s, device=q.device)[:, None]
        step_mask = k_pos <= q_pos
        n_kv = self.num_kv_heads
        if n_kv == self.num_heads or s > 1:
            return attention_core.dot_product_attention(
                q, self._expand_kv(keys), self._expand_kv(vals),
                mask=step_mask, causal=False)
        b, _, h, d = q.shape
        g = h // n_kv
        q_vec = q.reshape(b, n_kv, g, d)                   # s == 1
        logits = torch.einsum("bkgd,blkd->bkgl", q_vec, keys)
        logits = (logits * (1.0 / float(d) ** 0.5)).float()
        logits = logits.masked_fill(~step_mask[0], _F32_MIN)
        w = torch.softmax(logits, dim=-1)
        ctx = torch.einsum("bkgl,blkd->bkgd", w.to(vals.dtype), vals)
        return ctx.reshape(b, 1, h, d)

    # -------------------------------------------------------------- forward
    def _split_heads(self, x):
        b, s, e = x.shape
        return x.reshape(b, s, e // self.head_dim, self.head_dim)

    def _expand_kv(self, kv):
        """Repeat kv heads up to num_heads (GQA); identity for full MHA."""
        n_kv = kv.shape[2]
        if n_kv == self.num_heads:
            return kv
        return torch.repeat_interleave(kv, self.num_heads // n_kv, dim=2)

    def _project(self, x, w, b):
        y = torch.matmul(match_compute(x, w), w.T)
        return y + b if b is not None else y

    def _in_projections(self, x):
        """(q, k, v) before the head split; the quantized twin overrides
        this and ``_out_projection`` to run kernel K4 on the int8 rows."""
        e, ekv = self.embed_dim, self._e_kv
        w = self.in_proj_weight
        wq, wk, wv = w[:e], w[e:e + ekv], w[e + ekv:]
        if self.with_bias:
            bias = self.in_proj_bias
            bq, bk, bv = bias[:e], bias[e:e + ekv], bias[e + ekv:]
        else:
            bq = bk = bv = None
        return (self._project(x, wq, bq), self._project(x, wk, bk),
                self._project(x, wv, bv))

    def _out_projection(self, ctx):
        out = torch.matmul(match_compute(ctx, self.out_proj_weight),
                           self.out_proj_weight.T)
        if self.with_bias:
            out = out + self.out_proj_bias
        return out

    def forward(self, input):
        pq, pk, pv = self._in_projections(input)
        q, k, v = (self._split_heads(pq), self._split_heads(pk),
                   self._split_heads(pv))
        if self.rope:
            pos = torch.arange(q.shape[1], device=q.device)
            if self._decode:
                pos = pos + self.decode_pos
            q = rope_rotate(q, pos, self.rope_theta)
            k = rope_rotate(k, pos, self.rope_theta)
        if self._decode:
            ctx = self._attend_decode(q, k, v)
        else:
            ctx = self._attend(q, self._expand_kv(k), self._expand_kv(v), None)
        b, s = ctx.shape[:2]
        return self._out_projection(ctx.reshape(b, s, self.embed_dim))

    def _attend(self, q, k, v, mask):
        drop = self.attn_drop.p if self.training else 0.0
        if drop > 0.0:  # probability dropout needs the plain core
            return attention_core.dot_product_attention(
                q, k, v, mask=mask, causal=self.causal, dropout_p=drop,
                generator=self.attn_drop.generator(q.device))
        if flash_attention.use_flash(q, mask):
            return flash_attention.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(),
                causal=self.causal)
        return attention_core.dot_product_attention(q, k, v, mask=mask,
                                                    causal=self.causal)


class TransformerEncoderLayer(Module):
    """Pre-norm transformer block: attention + FFN with residuals.

    ``activation``: ``"gelu"`` (tanh form, GPT-2's gelu_new) or ``"swiglu"``
    (Llama's gated FFN ``W2(silu(W1 x) * Wg x)``); the reference's
    post-norm block and its other activations are not ported. ``bias=False``
    drops every affine bias (the Llama convention). ``dropout`` drops the
    attention probabilities and both residual branches in training mode."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 activation: str = "gelu", causal: bool = False,
                 rope: bool = False, norm: str = "layer",
                 num_kv_heads: Optional[int] = None,
                 rope_theta: float = 10000.0, bias: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        if activation not in ("gelu", "swiglu"):
            raise ValueError(f"unknown activation {activation!r}: 'gelu' or "
                             "'swiglu'")
        self.activation = activation
        self.self_attn = MultiHeadAttention(
            embed_dim, num_heads, with_bias=bias, causal=causal, rope=rope,
            num_kv_heads=num_kv_heads, rope_theta=rope_theta, dropout=dropout)
        self.drop = Dropout(dropout)
        self.linear1 = Linear(embed_dim, ffn_dim, with_bias=bias)
        self.linear2 = Linear(ffn_dim, embed_dim, with_bias=bias)
        if activation == "swiglu":
            self.linear_gate = Linear(embed_dim, ffn_dim, with_bias=bias)
        if norm == "layer":
            self.norm1, self.norm2 = LayerNorm(embed_dim), LayerNorm(embed_dim)
        elif norm == "rms":
            self.norm1, self.norm2 = RMSNorm(embed_dim), RMSNorm(embed_dim)
        else:
            raise ValueError(f"unknown norm {norm!r}: 'layer' or 'rms'")

    def _ffn(self, x):
        if self.activation == "swiglu":
            return self.linear2(F.silu(self.linear1(x)) * self.linear_gate(x))
        return self.linear2(F.gelu(self.linear1(x), approximate="tanh"))

    def forward(self, input):
        x = input + self.drop(self.self_attn(self.norm1(input)))
        return x + self.drop(self._ffn(self.norm2(x)))


class TransformerEncoder(Module):
    """Stack of pre-norm ``TransformerEncoderLayer``s (children ``layer0``,
    ``layer1``, ...) and the final norm."""

    def __init__(self, num_layers: int, embed_dim: int, num_heads: int,
                 ffn_dim: int, activation: str = "gelu",
                 causal: bool = False, rope: bool = False,
                 norm: str = "layer", num_kv_heads: Optional[int] = None,
                 rope_theta: float = 10000.0, bias: bool = True,
                 dropout: float = 0.0):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                embed_dim, num_heads, ffn_dim, activation=activation,
                causal=causal, rope=rope, norm=norm,
                num_kv_heads=num_kv_heads, rope_theta=rope_theta, bias=bias,
                dropout=dropout))
        self.final_norm = (RMSNorm(embed_dim) if norm == "rms"
                           else LayerNorm(embed_dim))

    def forward(self, input):
        x = input
        for i in range(self.num_layers):
            x = self._modules[f"layer{i}"](x)
        return self.final_norm(x)
