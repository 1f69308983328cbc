"""Causal transformer language model (counterpart of
``bigdl_tpu/models/transformer.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.activation import LogSoftMax
from bigdl_tpu_torch.nn.attention import PositionalEncoding, TransformerEncoder
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.linear import LMHead, Linear, LookupTable, TiedLMHead
from bigdl_tpu_torch.nn.recurrent import TimeDistributed
from bigdl_tpu_torch.nn.regularization import Dropout
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

# argument -> (its default, the ROADMAP item that will port other values)
_NOT_PORTED = {
    "seq_axis": (None, "A.4 (distributed plane)"),
    "seq_mode": ("ring", "A.4 (distributed plane)"),
    "seq_layout": ("contiguous", "A.4 (distributed plane)"),
    "moe_experts": (0, "A.4 (distributed plane: expert parallelism)"),
    "moe_k": (2, "A.4 (distributed plane: expert parallelism)"),
    "head_bias": (None, "A.2 (model options)"),
    "norm_eps": (None, "A.2 (model options)"),
    "window": (None, "A.2 (model options)"),
    "rope_scaling": (None, "A.2 (model options)"),
    "qkv_bias": (False, "A.2 (model options)"),
}


def build_lm(vocab_size: int, embed_dim: int = 128, num_heads: int = 4,
             ffn_dim: int = 256, num_layers: int = 2, max_len: int = 1024,
             dropout: float = 0.0, fused_head: bool = False,
             tie_embeddings: bool = False, rope: bool = False,
             activation: str = "gelu",
             norm: str = "layer", num_kv_heads: Optional[int] = None,
             rope_theta: float = 10000.0, pos: str = "sinusoidal",
             bias: bool = True, *, device: DeviceLike = "cuda",
             seed: Optional[int] = None, **not_ported) -> Sequential:
    """Causal LM: 1-based token ids (B, T) -> log-probs (B, T, vocab).

    The arguments mirror the reference's ``build_lm``. ``rope=True,
    activation="swiglu", norm="rms", bias=False, tie_embeddings=True`` with
    ``num_kv_heads`` is the Llama block recipe. ``dropout`` goes into the
    positional encoding (under RoPE a ``Dropout`` on the embedding stream)
    and into every block. The tail is ``TiedLMHead`` when
    ``tie_embeddings``, ``LMHead`` when ``fused_head``, and otherwise the
    reference's default ``TimeDistributed(Linear) + LogSoftMax``, which
    trains with ``TimeDistributedCriterion(ClassNLLCriterion())`` on the
    (B, S, vocab) log-probs. Every other reference argument at a
    non-default value raises ``NotImplementedError`` naming the ROADMAP
    item that will port it.

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
                                  "ROADMAP A.2 (model options)")
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        if seed is not None:
            torch.manual_seed(seed)
        embed = LookupTable(vocab_size, embed_dim)
        m = Sequential().add(embed)
        if not rope:
            m.add(PositionalEncoding(embed_dim, max_len, dropout))
        elif dropout:
            # the embedding-stream dropout the positional encoding applies
            m.add(Dropout(dropout))
        m.add(TransformerEncoder(num_layers, embed_dim, num_heads, ffn_dim,
                                 activation=activation, causal=True,
                                 rope=rope, norm=norm,
                                 num_kv_heads=num_kv_heads,
                                 rope_theta=rope_theta, bias=bias,
                                 dropout=dropout))
        if tie_embeddings:
            m.add(TiedLMHead(embed))
        elif fused_head:
            m.add(LMHead(embed_dim, vocab_size, with_bias=bias))
        else:
            m.add(TimeDistributed(Linear(embed_dim, vocab_size,
                                         with_bias=bias)))
            m.add(LogSoftMax())
    # plain attribute: rope models have no positional table to read it from
    m.lm_max_len = max_len
    return m.to(dev)
