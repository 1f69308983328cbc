"""Causal transformer language model (counterpart of
``bigdl_tpu/models/transformer.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.activation import LogSoftMax
from bigdl_tpu_torch.nn.attention import (LearnedPositionalEncoding,
                                          PositionalEncoding,
                                          TransformerEncoder)
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.linear import LMHead, Linear, LookupTable, TiedLMHead
from bigdl_tpu_torch.nn.recurrent import TimeDistributed
from bigdl_tpu_torch.nn.regularization import Dropout
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device


def build_lm(*args, device: DeviceLike = "cuda", seed: Optional[int] = None,
             **options) -> Sequential:
    """Causal LM: 1-based token ids (B, T) -> log-probs (B, T, vocab).

    The model options are ``lm_modules``' arguments, which mirror the
    reference's ``build_lm``. ``rope=True, activation="swiglu",
    norm="rms", bias=False, tie_embeddings=True`` with ``num_kv_heads`` is
    the Llama block recipe. ``dropout`` goes into the
    positional encoding (under RoPE a ``Dropout`` on the embedding stream)
    and into every block. The tail is ``TiedLMHead`` when
    ``tie_embeddings``, ``LMHead`` when ``fused_head``, and otherwise the
    reference's default ``TimeDistributed(Linear) + LogSoftMax``, which
    trains with ``TimeDistributedCriterion(ClassNLLCriterion())`` on the
    (B, S, vocab) log-probs.

    The checkpoint options (``interop/hf.py`` builds with them):
    ``pos="learned"`` is GPT-2's trained ``wpe`` table in place of the
    sinusoidal encoding (ignored under ``rope``); ``head_bias`` overrides
    ``bias`` for an untied head; ``norm_eps`` sets every norm's epsilon;
    ``window`` is sliding-window attention (query i sees keys
    (i - window, i]); ``rope_scaling`` an HF ``rope_scaling`` dict
    (``llama3``, ``linear``, ``yarn``); ``qkv_bias`` biases the q/k/v
    projections only (Qwen2). ``seq_axis="seq"`` shards every attention
    layer's sequence over that mesh axis (``seq_mode`` ring or ulysses,
    ``seq_layout`` contiguous or zigzag; RoPE rotates at the shard's global
    positions; ``parallel.context.ContextParallelLM`` runs such a model).
    ``moe_experts`` replaces every block's FFN with a top-``moe_k`` routed
    mixture of experts (``parallel.expert.MoE``; not with ``swiglu``).

    Parameters are drawn on the CPU from ``seed`` (PyTorch's global
    generator is left as it was) and then moved to ``device``."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        if seed is not None:
            torch.manual_seed(seed)
        m = lm_modules(*args, **options)
    return m.to(dev)


def lm_modules(vocab_size: int, embed_dim: int = 128, num_heads: int = 4,
               ffn_dim: int = 256, num_layers: int = 2, max_len: int = 1024,
               dropout: float = 0.0, fused_head: bool = False,
               tie_embeddings: bool = False, rope: bool = False,
               activation: str = "gelu", norm: str = "layer",
               num_kv_heads: Optional[int] = None,
               rope_theta: float = 10000.0, pos: str = "sinusoidal",
               bias: bool = True, head_bias: Optional[bool] = None,
               norm_eps: Optional[float] = None, window: Optional[int] = None,
               rope_scaling: Optional[dict] = None,
               qkv_bias: bool = False, seq_axis: Optional[str] = None,
               seq_mode: str = "ring",
               seq_layout: str = "contiguous", moe_experts: int = 0,
               moe_k: int = 2) -> Sequential:
    """``build_lm``'s module tree, and the one list of its model options,
    on the current default device, its parameters drawn from PyTorch's
    default generator (the loaders of ``interop/hf.py`` build it on the
    ``meta`` device, draw nothing, and give it the checkpoint's values)."""
    embed = LookupTable(vocab_size, embed_dim)
    m = Sequential().add(embed)
    if not rope:
        if pos == "learned":
            m.add(LearnedPositionalEncoding(embed_dim, max_len, dropout))
        elif pos == "sinusoidal":
            m.add(PositionalEncoding(embed_dim, max_len, dropout))
        else:
            raise ValueError(f"unknown pos {pos!r}: 'sinusoidal' or 'learned'")
    elif dropout:
        # the embedding-stream dropout the positional encoding applies
        m.add(Dropout(dropout))
    m.add(TransformerEncoder(num_layers, embed_dim, num_heads, ffn_dim,
                             activation=activation, causal=True, rope=rope,
                             norm=norm, num_kv_heads=num_kv_heads,
                             rope_theta=rope_theta, bias=bias, dropout=dropout,
                             norm_eps=norm_eps, window=window,
                             rope_scaling=rope_scaling, qkv_bias=qkv_bias,
                             seq_axis=seq_axis, seq_mode=seq_mode,
                             seq_layout=seq_layout, moe_experts=moe_experts,
                             moe_k=moe_k))
    hb = bias if head_bias is None else head_bias
    if tie_embeddings:
        m.add(TiedLMHead(embed))
    elif fused_head:
        m.add(LMHead(embed_dim, vocab_size, with_bias=hb))
    else:
        m.add(TimeDistributed(Linear(embed_dim, vocab_size, with_bias=hb)))
        m.add(LogSoftMax())
    # plain attribute: rope models have no positional table to read it from
    m.lm_max_len = max_len
    return m
