"""Causal transformer language model (counterpart of
``bigdl_tpu/models/transformer.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.attention import PositionalEncoding, TransformerEncoder
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.linear import LMHead, LookupTable, TiedLMHead
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

# argument -> (its default, the ROADMAP item that will port other values)
_NOT_PORTED = {
    "dropout": (0.0, "A2 (training slice)"),
    "seq_axis": (None, "A6 (distributed plane)"),
    "seq_mode": ("ring", "A6 (distributed plane)"),
    "seq_layout": ("contiguous", "A6 (distributed plane)"),
    "moe_experts": (0, "A6 (distributed plane: expert parallelism)"),
    "moe_k": (2, "A6 (distributed plane: expert parallelism)"),
    "head_bias": (None, "A4 (model options)"),
    "norm_eps": (None, "A4 (model options)"),
    "window": (None, "A4 (model options)"),
    "rope_scaling": (None, "A4 (model options)"),
    "qkv_bias": (False, "A4 (model options)"),
}


def build_lm(vocab_size: int, embed_dim: int = 128, num_heads: int = 4,
             ffn_dim: int = 256, num_layers: int = 2, max_len: int = 1024,
             fused_head: bool = False, tie_embeddings: bool = False,
             rope: bool = False, activation: str = "gelu",
             norm: str = "layer", num_kv_heads: Optional[int] = None,
             rope_theta: float = 10000.0, pos: str = "sinusoidal",
             bias: bool = True, *, device: DeviceLike = "cuda",
             seed: Optional[int] = None, **not_ported) -> Sequential:
    """Causal LM: 1-based token ids (B, T) -> log-probs (B, T, vocab).

    The arguments mirror the reference's ``build_lm``. ``rope=True,
    activation="swiglu", norm="rms", bias=False, tie_embeddings=True`` with
    ``num_kv_heads`` is the Llama block recipe. The head is ``TiedLMHead``
    when ``tie_embeddings``, else ``LMHead`` (``fused_head=True``); the
    reference's unfused ``TimeDistributed(Linear) + LogSoftMax`` tail and
    every other reference argument at a non-default value raise
    ``NotImplementedError`` naming the ROADMAP item that will port them.

    Parameters are drawn on the CPU from ``seed`` (PyTorch's global
    generator is left as it was) and then moved to ``device``."""
    for name, value in not_ported.items():
        if name not in _NOT_PORTED:
            raise TypeError(f"build_lm() got an unexpected argument {name!r}")
        default, item = _NOT_PORTED[name]
        if value != default:
            raise NotImplementedError(
                f"build_lm({name}={value!r}) is not ported yet: ROADMAP {item}")
    if pos != "sinusoidal":
        raise NotImplementedError(f"build_lm(pos={pos!r}) is not ported yet: "
                                  "ROADMAP A4 (model options)")
    if not (fused_head or tie_embeddings):
        raise NotImplementedError(
            "the TimeDistributed(Linear) + LogSoftMax tail is not ported yet "
            "(ROADMAP A4); pass fused_head=True or tie_embeddings=True")
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        if seed is not None:
            torch.manual_seed(seed)
        embed = LookupTable(vocab_size, embed_dim)
        m = Sequential().add(embed)
        if not rope:
            m.add(PositionalEncoding(embed_dim, max_len))
        m.add(TransformerEncoder(num_layers, embed_dim, num_heads, ffn_dim,
                                 activation=activation, causal=True,
                                 rope=rope, norm=norm,
                                 num_kv_heads=num_kv_heads,
                                 rope_theta=rope_theta, bias=bias))
        if tie_embeddings:
            m.add(TiedLMHead(embed))
        else:
            m.add(LMHead(embed_dim, vocab_size, with_bias=bias))
    # plain attribute: rope models have no positional table to read it from
    m.lm_max_len = max_len
    return m.to(dev)
