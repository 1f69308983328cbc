"""Attention layers of the LM slice (counterpart of
``bigdl_tpu/nn/attention.py``).

Ported: ``LayerNorm``, ``RMSNorm``, the additive position encodings
(``PositionalEncoding``, sinusoidal, and ``LearnedPositionalEncoding``,
GPT-2's ``wpe``), ``rope_rotate`` (rotate-half pairing, shared (S,) or
per-row (B, S) positions) with the ``llama3``, ``linear`` and ``yarn``
frequency rescalings (``scale_rope_freqs``), ``MultiHeadAttention`` (GQA,
RoPE, causal, a sliding window, q/k/v-only biases, attention-probability
dropout; incremental decode over a linear KV cache, a rolling ring cache of
``window`` slots, and the serving engine's continuous mode with per-row
positions), and the pre- or post-norm ``TransformerEncoderLayer`` /
``TransformerEncoder`` stack with residual dropout and per-block
recomputation (``remat_blocks``). Context parallelism and
MoE are later slices (ROADMAP A.4).

The KV cache is module state (``enable_decode``) that the eager forward
updates in place; there is no functional-apply layer. Unmasked attention on
a CUDA tensor goes through kernels K1 (forward) and K2/K3 (backward) of
``ops/flash_attention.py``, except under attention dropout in training
mode, which takes the plain core (the kernels never form normalised
probabilities). A sliding window is a mask, so windowed attention always
takes the plain core, as in the reference.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.linear import Linear
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.regularization import Dropout
from bigdl_tpu_torch.ops import attention_core, flash_attention, remat
from bigdl_tpu_torch.ops.precision import match_compute
from bigdl_tpu_torch.utils.device import module_device

_F32_MIN = float(torch.finfo(torch.float32).min)

#: argument -> (its default, the ROADMAP item that will port other values):
#: the reference's blockwise-attention, context-parallel and MoE options
NOT_PORTED = {
    "block_size": (0, "A.4 (distributed plane)"),
    "seq_axis": (None, "A.4 (distributed plane)"),
    "seq_mode": ("ring", "A.4 (distributed plane)"),
    "seq_layout": ("contiguous", "A.4 (distributed plane)"),
    "moe_experts": (0, "A.4 (distributed plane: expert parallelism)"),
    "moe_k": (2, "A.4 (distributed plane: expert parallelism)"),
}


def refuse_not_ported(owner: str, **values) -> None:
    """Raise ``NotImplementedError`` naming the ROADMAP item for any of
    ``NOT_PORTED``'s arguments given another value than its default."""
    for name, value in values.items():
        default, item = NOT_PORTED[name]
        if value != default:
            raise NotImplementedError(
                f"{owner}({name}={value!r}) is not ported yet: ROADMAP {item}")


class LayerNorm(Module):
    """Layer normalisation over the last ``len(normalized_shape)`` axes
    with f32 statistics (reference ``LayerNorm``); ``normalized_shape`` is
    an int or a tuple; ``elementwise_affine`` adds the weight and bias."""

    def __init__(self, normalized_shape, eps: float = 1e-5,
                 elementwise_affine: bool = True):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = (normalized_shape,)
        self.normalized_shape = tuple(int(d) for d in normalized_shape)
        self.eps = eps
        self.elementwise_affine = elementwise_affine
        if elementwise_affine:
            self.weight = torch.nn.Parameter(torch.ones(self.normalized_shape))
            self.bias = torch.nn.Parameter(torch.zeros(self.normalized_shape))

    def forward(self, input):
        axes = tuple(range(input.dim() - len(self.normalized_shape),
                           input.dim()))
        x = input.float()
        mean = x.mean(dim=axes, keepdim=True)
        var = (x - mean).square().mean(dim=axes, keepdim=True)
        y = ((x - mean) * torch.rsqrt(var + self.eps)).to(input.dtype)
        if self.elementwise_affine:
            y = y * self.weight + self.bias
        return y


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


class _AddedPositionBase(Module):
    """What the additive position encodings share: a (max_len, E) table
    added to (B, S, E) input, then dropout; while decoding the positions
    continue from ``decode_pos``. Subclasses hold the table and return it
    from ``pos_table()``."""

    decode_pos = 0

    def pos_table(self) -> torch.Tensor:
        raise NotImplementedError

    def enable_decode(self) -> "_AddedPositionBase":
        self.decode_pos = 0
        return super().enable_decode()

    def forward(self, input):
        s = input.shape[1]
        start = self.decode_pos if self._decode else 0
        if self._decode:
            self.decode_pos += s
        pe = self.pos_table()[start:start + s]
        return self.dropout(input + pe.to(input.dtype))


class PositionalEncoding(_AddedPositionBase):
    """Sinusoidal position encoding added to (B, S, E) input, then dropout."""

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

    def pos_table(self) -> torch.Tensor:
        return self.pe


class LearnedPositionalEncoding(_AddedPositionBase):
    """Learned absolute position embeddings, GPT-2's ``wpe`` table: a
    (max_len, E) parameter drawn from N(0, 0.02) with PyTorch's default
    generator, which ``build_lm(seed=)`` seeds."""

    def __init__(self, embed_dim: int, max_len: int = 1024,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = Dropout(dropout)
        self.max_len, self.embed_dim = max_len, embed_dim
        self.weight = torch.nn.Parameter(
            torch.empty(max_len, embed_dim).normal_(0.0, 0.02))

    def pos_table(self) -> torch.Tensor:
        return self.weight


def llama3_scale_freqs(freqs: torch.Tensor, scaling: dict) -> torch.Tensor:
    """Llama-3.1's frequency rescaling (the ``llama3`` rope_type): long
    wavelengths slow by ``factor``, short ones keep, and a band between
    interpolates (HF ``_compute_llama3_parameters``)."""
    factor = float(scaling["factor"])
    low_f = float(scaling.get("low_freq_factor", 1.0))
    high_f = float(scaling.get("high_freq_factor", 4.0))
    orig = float(scaling.get("original_max_position_embeddings", 8192))
    wavelen = 2.0 * np.pi / freqs
    smooth = (orig / wavelen - low_f) / (high_f - low_f)
    smooth = torch.clamp(smooth, 0.0, 1.0)
    return (1.0 - smooth) * freqs / factor + smooth * freqs


def scale_rope_freqs(freqs: torch.Tensor, theta: float,
                     scaling: dict) -> Tuple[torch.Tensor, float]:
    """``(scaled freqs, attention factor)`` for an HF ``rope_scaling`` dict:
    ``linear`` divides every frequency by ``factor``; ``yarn`` blends
    interpolated (freqs / factor) and kept frequencies along a ramp between
    the ``beta_fast`` and ``beta_slow`` correction dims and scales cos/sin
    by ``attention_factor`` (default ``0.1 ln(factor) + 1``), as HF
    ``_compute_yarn_parameters``; ``llama3`` is ``llama3_scale_freqs``.
    Any other type (``dynamic``, ``longrope``) raises ``ValueError``."""
    rt = scaling.get("rope_type", scaling.get("type"))
    if rt == "llama3":
        return llama3_scale_freqs(freqs, scaling), 1.0
    if rt == "linear":
        return freqs / float(scaling["factor"]), 1.0
    if rt == "yarn":
        factor = float(scaling["factor"])
        attn = scaling.get("attention_factor")
        if attn is None:
            mscale = scaling.get("mscale")
            attn = (0.1 * math.log(factor) + 1.0 if mscale is None
                    else 0.1 * float(mscale) * math.log(factor) + 1.0)
        beta_fast = float(scaling.get("beta_fast", 32.0))
        beta_slow = float(scaling.get("beta_slow", 1.0))
        orig = float(scaling.get("original_max_position_embeddings", 4096))
        half = freqs.shape[0]
        dim = 2 * half

        def correction_dim(rot):
            return (dim * math.log(orig / (rot * 2 * math.pi))
                    / (2 * math.log(theta)))

        low = max(math.floor(correction_dim(beta_fast)), 0)
        high = min(math.ceil(correction_dim(beta_slow)), dim - 1)
        ramp = torch.clamp((torch.arange(half, dtype=torch.float32,
                                         device=freqs.device) - low)
                           / max(high - low, 1e-3), 0.0, 1.0)
        extrap = 1.0 - ramp  # 1 where frequencies extrapolate
        scaled = (freqs / factor) * (1.0 - extrap) + freqs * extrap
        return scaled, float(attn)
    raise ValueError(f"unsupported rope_scaling type {rt!r} "
                     "(llama3/linear/yarn)")


def rope_rotate(x: torch.Tensor, positions: torch.Tensor,
                theta: float = 10000.0,
                scaling: Optional[dict] = None) -> torch.Tensor:
    """Rotary position embedding of ``x`` (B, S, H, D) at absolute
    ``positions``, (S,) shared by the batch or (B, S) per row (the
    continuous cache's slots), pairing feature i with i + D/2 (HF Llama's
    rotate-half), so the q.k score depends only on the distance.
    ``scaling`` is an HF ``rope_scaling`` dict (``scale_rope_freqs``)."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    att_scale = 1.0
    if scaling is not None:
        freqs, att_scale = scale_rope_freqs(freqs, theta, scaling)
    angles = positions.to(torch.float32)[..., None] * freqs  # (B?, S, half)
    if angles.dim() == 2:                                    # shared positions
        angles = angles[None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if att_scale != 1.0:
        # yarn's attention factor scales q and k, so the scores by its square
        cos, sin = cos * att_scale, sin * att_scale
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _common(*ts):
    """The tensors in their promoted dtype (the reference's mixed-dtype
    einsums promote; PyTorch's refuse). The int8 twin's biased q/k/v are
    f32 against a bf16 cache."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t.to(dt) for t in ts)


def _grouped_step(q, keys, vals, valid):
    """One GQA decode token against a cache read at its num_kv_heads size:
    q (B, 1, H, D), keys/vals (B, L, n_kv, D), ``valid`` broadcasting to
    (B, n_kv, g, L)."""
    b, _, h, d = q.shape
    n_kv = keys.shape[2]
    q_vec = q.reshape(b, n_kv, h // n_kv, d)
    q_vec, keys_c = _common(q_vec, keys)
    logits = torch.einsum("bkgd,blkd->bkgl", q_vec, keys_c)
    logits = (logits * (1.0 / float(d) ** 0.5)).float()
    logits = logits.masked_fill(~valid, _F32_MIN)
    w = torch.softmax(logits, dim=-1)
    w, vals_c = _common(w.to(vals.dtype), vals)
    ctx = torch.einsum("bkgl,blkd->bkgd", w, vals_c)
    return ctx.reshape(b, 1, h, d)


class MultiHeadAttention(Module):
    """Self-attention with a fused q;k;v input projection.

    The input projection is (E + 2 * E_kv, E), Torch's
    ``nn.MultiheadAttention`` stacking for full MHA and the row concatenation
    of Llama's q/k/v projections under GQA (``num_kv_heads < num_heads``,
    each k/v head shared by ``num_heads // num_kv_heads`` query heads).

    ``window`` (causal only) is sliding-window attention: query i sees keys
    (i - window, i], the Mistral convention; the band is a mask, so it
    never takes kernel K1. ``rope_scaling`` is an HF ``rope_scaling`` dict
    for ``rope_rotate``. ``qkv_bias`` puts a bias on the q/k/v projections
    only (Qwen2): ``in_proj_bias`` exists when ``with_bias or qkv_bias``,
    the out-projection bias only with ``with_bias``."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 with_bias: bool = True, causal: bool = False,
                 block_size: int = 0, seq_axis: Optional[str] = None,
                 seq_mode: str = "ring", seq_layout: str = "contiguous",
                 rope: bool = False, num_kv_heads: Optional[int] = None,
                 rope_theta: float = 10000.0,
                 window: Optional[int] = None,
                 rope_scaling: Optional[dict] = None,
                 qkv_bias: bool = False):
        super().__init__()
        refuse_not_ported("MultiHeadAttention", block_size=block_size,
                          seq_axis=seq_axis, seq_mode=seq_mode,
                          seq_layout=seq_layout)
        if embed_dim % num_heads != 0:
            raise ValueError("embed_dim must divide num_heads")
        if window is not None:
            if not causal:
                raise ValueError("window (sliding-window attention) "
                                 "requires causal=True")
            if window < 1:
                raise ValueError("window must be >= 1")
        self.window = window
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
        self.qkv_bias = qkv_bias
        self.causal = causal
        self.rope = rope
        self.rope_theta = rope_theta
        self.rope_scaling = rope_scaling
        self._e_kv = self.num_kv_heads * self.head_dim
        rows = embed_dim + 2 * self._e_kv
        bound = math.sqrt(6.0 / (2 * embed_dim))  # the reference's xavier
        self.in_proj_weight = torch.nn.Parameter(
            torch.empty(rows, embed_dim).uniform_(-bound, bound))
        self.out_proj_weight = torch.nn.Parameter(
            torch.empty(embed_dim, embed_dim).uniform_(-bound, bound))
        if with_bias or qkv_bias:
            self.in_proj_bias = torch.nn.Parameter(torch.zeros(rows))
        if with_bias:
            self.out_proj_bias = torch.nn.Parameter(torch.zeros(embed_dim))
        # attention-probability dropout: its rate and generator
        self.attn_drop = Dropout(dropout)
        self.decode_pos = 0
        self._decode_prefilled = False

    # ------------------------------------------------------------- decoding
    #: per-row cache positions (``enable_decode(continuous=True)``)
    _continuous = False
    #: the ring cache of ``enable_decode(rolling=True)``
    _rolling = False
    #: the (B,) position tensor that continuous ``enable_decode`` made: the
    #: forward and the engine's rollback update it in place (the tensor a
    #: CUDA graph of the engine's round reads); one installed by a caller
    #: is replaced instead
    _own_pos = None

    def _cache_dtype(self) -> torch.dtype:
        return self.in_proj_weight.dtype

    def enable_decode(self, batch_size: int, max_len: int,
                      rolling: bool = False,
                      continuous: bool = False) -> "MultiHeadAttention":
        """Incremental-decode mode with a (B, max_len, num_kv_heads, D) KV
        cache, written in place at ``decode_pos`` by each forward.

        ``rolling=True`` (sliding-window models only) makes the cache a
        ring of ``min(window, max_len)`` slots, so decode memory is
        O(window) whatever the length generated (``_attend_decode_rolling``).

        ``continuous=True`` is the serving engine's slot mode
        (``models/serving.py``): ``decode_pos`` is a (B,) int64 tensor on the
        module's device, so each row decodes at its own position; prefill
        happens out of band (the engine copies a b=1 prefilled cache into a
        row)."""
        if rolling and continuous:
            raise ValueError("continuous batching does not compose with "
                             "the rolling ring cache yet")
        if rolling and not self.window:
            raise ValueError("rolling cache requires sliding-window "
                             "attention (window=N): an unbounded-context "
                             "model needs every past key")
        dev = module_device(self)
        cache_len = min(self.window, max_len) if rolling else max_len
        shape = (batch_size, cache_len, self.num_kv_heads, self.head_dim)
        self.register_buffer("k_cache", torch.zeros(
            shape, dtype=self._cache_dtype(), device=dev), persistent=False)
        self.register_buffer("v_cache", torch.zeros(
            shape, dtype=self._cache_dtype(), device=dev), persistent=False)
        self.decode_pos = (torch.zeros(batch_size, dtype=torch.int64,
                                       device=dev) if continuous else 0)
        self._own_pos = self.decode_pos if continuous else None
        self._continuous = continuous
        self._rolling = rolling
        self._decode_prefilled = False
        self._decode = True
        return self

    def disable_decode(self) -> "MultiHeadAttention":
        self._decode = False
        self._continuous = False
        self._rolling = False
        self.decode_pos = 0
        self._own_pos = None
        for name in ("k_cache", "v_cache"):
            self._buffers.pop(name, None)
        return self

    def _attend_decode(self, q, k, v):
        """Write k/v at ``decode_pos`` and attend the new queries.

        A multi-token call on a cold cache is the prompt prefill: the fresh
        k/v are the whole context, so it takes the standard causal path
        (kernel K1 on the card, unless a window bands it). A warm
        multi-token chunk attends the cache with the position mask
        ``k_pos <= q_pos`` (and ``k_pos > q_pos - window``); a GQA
        single-token step reads the cache at its num_kv_heads size with a
        grouped product. Only the written prefix of the cache is read: the
        masked tail would add exact zeros."""
        if self._rolling:
            return self._attend_decode_rolling(q, k, v)
        if self._continuous:
            return self._attend_decode_continuous(q, k, v)
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
        if self.window:
            step_mask = step_mask & (k_pos > q_pos - self.window)
        if self.num_kv_heads == self.num_heads or s > 1:
            return attention_core.dot_product_attention(
                q, self._expand_kv(keys), self._expand_kv(vals),
                mask=step_mask, causal=False)
        return _grouped_step(q, keys, vals, step_mask[0])  # s == 1

    def _attend_decode_continuous(self, q, k, v):
        """Decode with per-row cache positions (reference
        ``_attend_decode_continuous``): row b writes its k/v from
        ``decode_pos[b]`` and its query i attends keys
        ``<= decode_pos[b] + i`` (and ``> decode_pos[b] + i - window``)
        over the whole cache row. ``s == 1`` is the token step; ``s > 1`` a
        per-row chunk (speculative verification).

        Where the reference's scatter drops writes past the cache end, the
        write index of such a row is clamped to the last entry, since
        ``index_put_`` faults out of range. Only a free slot or a row that
        has used its budget reaches past the end; the engine never reads
        its outputs, and a live row never reads that entry (a request
        fits ``prompt + max_new <= max_len``)."""
        pos = self.decode_pos                                    # (B,)
        bsz, s = q.shape[0], q.shape[1]
        length = self.k_cache.shape[1]
        rows = torch.arange(bsz, device=q.device)[:, None]
        q_pos = pos[:, None] + torch.arange(s, device=q.device)  # (B, S)
        write = q_pos.clamp(max=length - 1)
        self.k_cache[rows, write] = k.to(self.k_cache.dtype)
        self.v_cache[rows, write] = v.to(self.v_cache.dtype)
        if pos is self._own_pos:
            # in place: a CUDA graph of the engine's round replays this write
            pos.add_(s)
        else:   # a tensor the caller installed is replaced, never written
            self.decode_pos = pos + s
        k_pos = torch.arange(length, device=q.device)
        if s > 1:
            valid = k_pos[None, None, :] <= q_pos[:, :, None]    # (B, S, L)
            if self.window:
                valid = valid & (k_pos[None, None, :]
                                 > q_pos[:, :, None] - self.window)
            return attention_core.dot_product_attention(
                q, self._expand_kv(self.k_cache),
                self._expand_kv(self.v_cache), mask=valid[:, None],
                causal=False)
        valid = k_pos[None, :] <= q_pos                          # (B, L)
        if self.window:
            valid = valid & (k_pos[None, :] > q_pos - self.window)
        if self.num_kv_heads == self.num_heads:
            return attention_core.dot_product_attention(
                q, self.k_cache, self.v_cache,
                mask=valid[:, None, None, :], causal=False)
        return _grouped_step(q, self.k_cache, self.v_cache,
                             valid[:, None, None, :])

    def _attend_decode_rolling(self, q, k, v):
        """Ring-cache decode (reference ``_attend_decode_rolling``): attend
        [ring, fresh k/v] before writing (an in-chunk ring write could
        destroy a slot an earlier row of the chunk still needs), then write
        the chunk's last ``ring`` entries.

        Ring slot j holds the k/v of the largest position <= decode_pos - 1
        congruent to j modulo the ring size; the mask admits it for the
        query at position p when that position is >= 0 and in the window
        (p - window, p]. ``decode_pos`` rewinds (speculative decoding) are
        not supported on a ring: a rejected chunk's writes have already
        replaced older slots."""
        w = self.k_cache.shape[1]
        win = self.window
        pos = self.decode_pos
        s = q.shape[1]
        dev = q.device
        j = torch.arange(w, device=dev)[None, :]
        rows = torch.arange(s, device=dev)[:, None]
        p_i = pos + rows                                  # each query's position
        last = pos - 1
        a_j = last - torch.remainder(last - j, w)         # each slot's position
        ring_valid = (a_j >= 0) & (a_j > p_i - win)
        t = torch.arange(s, device=dev)[None, :]
        fresh_valid = (t <= rows) & ((pos + t) > p_i - win)
        mask = torch.cat([ring_valid, fresh_valid], dim=1)
        keys = torch.cat([self.k_cache, k.to(self.k_cache.dtype)], dim=1)
        vals = torch.cat([self.v_cache, v.to(self.v_cache.dtype)], dim=1)
        if s == 1 and self.num_kv_heads != self.num_heads:
            ctx = _grouped_step(q, keys, vals, mask[0])
        else:
            ctx = attention_core.dot_product_attention(
                q, self._expand_kv(keys), self._expand_kv(vals), mask=mask,
                causal=False)
        if s > w:  # only the chunk's last w entries survive, in unique slots
            k_wr, v_wr = k[:, -w:], v[:, -w:]
            wr_idx = torch.remainder(pos + s - w + torch.arange(w, device=dev),
                                     w)
        else:
            k_wr, v_wr = k, v
            wr_idx = torch.remainder(pos + torch.arange(s, device=dev), w)
        self.k_cache[:, wr_idx] = k_wr.to(self.k_cache.dtype)
        self.v_cache[:, wr_idx] = v_wr.to(self.v_cache.dtype)
        self.decode_pos = pos + s
        self._decode_prefilled = True
        return ctx

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

    def _in_bias(self):
        """(bq, bk, bv), or Nones when there is no input-projection bias."""
        if not (self.with_bias or self.qkv_bias):
            return None, None, None
        e, ekv = self.embed_dim, self._e_kv
        bias = self.in_proj_bias
        return bias[:e], bias[e:e + ekv], bias[e + ekv:]

    def _in_projections(self, x):
        """(q, k, v) before the head split; the quantized twin overrides
        this and ``_out_projection`` to run kernel K4 on the int8 rows."""
        e, ekv = self.embed_dim, self._e_kv
        w = self.in_proj_weight
        wq, wk, wv = w[:e], w[e:e + ekv], w[e + ekv:]
        bq, bk, bv = self._in_bias()
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
            if self._decode and self._continuous:
                pos = self.decode_pos[:, None] + pos[None, :]    # (B, S)
            elif self._decode:
                pos = pos + self.decode_pos
            q = rope_rotate(q, pos, self.rope_theta, self.rope_scaling)
            k = rope_rotate(k, pos, self.rope_theta, self.rope_scaling)
        if self._decode:
            ctx = self._attend_decode(q, k, v)
        else:
            ctx = self._attend(q, self._expand_kv(k), self._expand_kv(v), None)
        b, s = ctx.shape[:2]
        return self._out_projection(ctx.reshape(b, s, self.embed_dim))

    def _attend(self, q, k, v, mask):
        if self.window:
            # banded causal: query i sees keys (i - window, i]. The band
            # rides the mask, which keeps kernel K1 out (as the reference's
            # mask path excludes its flash kernel)
            q_pos = torch.arange(q.shape[1], device=q.device)[:, None]
            k_pos = torch.arange(k.shape[1], device=q.device)[None, :]
            band = k_pos > q_pos - self.window
            mask = band if mask is None else mask & band
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
    """Pre- or post-norm transformer block: attention + FFN with residuals.

    ``activation``: ``"gelu"`` (tanh form, GPT-2's gelu_new),
    ``"gelu_exact"`` (the erf form, HF's ``gelu``) or ``"swiglu"`` (Llama's
    gated FFN ``W2(silu(W1 x) * Wg x)``).
    ``pre_norm=False`` is the post-norm block, ``norm(x + f(x))``.
    ``bias=False`` drops every affine bias (the Llama convention);
    ``qkv_bias`` gives the q/k/v projections theirs back (Qwen2).
    ``norm_eps`` defaults to 1e-5 (LayerNorm) or 1e-6 (RMSNorm).
    ``dropout`` drops the attention probabilities and both residual
    branches in training mode."""

    def __init__(self, embed_dim: int, num_heads: int, ffn_dim: int,
                 dropout: float = 0.0, activation: str = "gelu",
                 pre_norm: bool = True, causal: bool = False,
                 block_size: int = 0, seq_axis: Optional[str] = None,
                 seq_mode: str = "ring", seq_layout: str = "contiguous",
                 moe_experts: int = 0, moe_k: int = 2, rope: bool = False,
                 norm: str = "layer", num_kv_heads: Optional[int] = None,
                 rope_theta: float = 10000.0, bias: bool = True,
                 norm_eps: Optional[float] = None,
                 window: Optional[int] = None,
                 rope_scaling: Optional[dict] = None,
                 qkv_bias: bool = False):
        super().__init__()
        refuse_not_ported("TransformerEncoderLayer", block_size=block_size,
                          seq_axis=seq_axis, seq_mode=seq_mode,
                          seq_layout=seq_layout, moe_experts=moe_experts,
                          moe_k=moe_k)
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}: one of "
                             f"{sorted(_ACTIVATIONS)}")
        self.activation = activation
        self.pre_norm = pre_norm
        self.self_attn = MultiHeadAttention(
            embed_dim, num_heads, with_bias=bias, causal=causal, rope=rope,
            num_kv_heads=num_kv_heads, rope_theta=rope_theta, dropout=dropout,
            window=window, rope_scaling=rope_scaling, qkv_bias=qkv_bias)
        self.drop = Dropout(dropout)
        self.linear1 = Linear(embed_dim, ffn_dim, with_bias=bias)
        self.linear2 = Linear(ffn_dim, embed_dim, with_bias=bias)
        if activation == "swiglu":
            self.linear_gate = Linear(embed_dim, ffn_dim, with_bias=bias)
        self.norm1 = _norm(norm, embed_dim, norm_eps)
        self.norm2 = _norm(norm, embed_dim, norm_eps)

    def _ffn(self, x):
        if self.activation == "swiglu":
            return self.linear2(F.silu(self.linear1(x)) * self.linear_gate(x))
        return self.linear2(_ACTIVATIONS[self.activation](self.linear1(x)))

    def forward(self, input):
        if self.pre_norm:
            x = input + self.drop(self.self_attn(self.norm1(input)))
            return x + self.drop(self._ffn(self.norm2(x)))
        x = self.norm1(input + self.drop(self.self_attn(input)))
        return self.norm2(x + self.drop(self._ffn(x)))


_ACTIVATIONS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # GPT-2's gelu_new
    "gelu_exact": F.gelu,                             # the erf form
    "swiglu": None,                                   # gated: see _ffn
}


def _norm(norm: str, dim: int, eps: Optional[float]) -> Module:
    if norm == "layer":
        return LayerNorm(dim, eps=1e-5 if eps is None else eps)
    if norm == "rms":
        return RMSNorm(dim, eps=1e-6 if eps is None else eps)
    raise ValueError(f"unknown norm {norm!r}: 'layer' or 'rms'")


class TransformerEncoder(Module):
    """Stack of ``TransformerEncoderLayer``s (children ``layer0``,
    ``layer1``, ...) and, for pre-norm stacks, the final norm (a post-norm
    block ends normalised, so ``final_norm`` is None there)."""

    #: ``Optimizer.set_remat("block")`` sets this: in training mode each
    #: block runs under ``ops.remat.checkpoint``, so the backward keeps only
    #: the blocks' boundary activations (B*S*E a layer) and recomputes the
    #: rest, kernel K1 included, block by block
    remat_blocks = False

    def __init__(self, num_layers: int, embed_dim: int, num_heads: int,
                 ffn_dim: int, dropout: float = 0.0,
                 activation: str = "gelu", pre_norm: bool = True,
                 causal: bool = False, block_size: int = 0,
                 seq_axis: Optional[str] = None, seq_mode: str = "ring",
                 seq_layout: str = "contiguous", moe_experts: int = 0,
                 moe_k: int = 2, rope: bool = False, norm: str = "layer",
                 num_kv_heads: Optional[int] = None,
                 rope_theta: float = 10000.0, bias: bool = True,
                 norm_eps: Optional[float] = None,
                 window: Optional[int] = None,
                 rope_scaling: Optional[dict] = None,
                 qkv_bias: bool = False):
        super().__init__()
        refuse_not_ported("TransformerEncoder", block_size=block_size,
                          seq_axis=seq_axis, seq_mode=seq_mode,
                          seq_layout=seq_layout, moe_experts=moe_experts,
                          moe_k=moe_k)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer{i}", TransformerEncoderLayer(
                embed_dim, num_heads, ffn_dim, activation=activation,
                causal=causal, rope=rope, norm=norm,
                num_kv_heads=num_kv_heads, rope_theta=rope_theta, bias=bias,
                dropout=dropout, pre_norm=pre_norm, norm_eps=norm_eps,
                window=window, rope_scaling=rope_scaling, qkv_bias=qkv_bias))
        self.final_norm = _norm(norm, embed_dim, norm_eps) if pre_norm else None

    def forward(self, input):
        x = input
        ckpt = self.remat_blocks and self.training
        for i in range(self.num_layers):
            layer = self._modules[f"layer{i}"]
            x = remat.checkpoint_module(layer, x) if ckpt else layer(x)
        return x if self.final_norm is None else self.final_norm(x)
