"""The collective byte model's symbols, read off the live objects of a run
(the port's side of ``analysis/commcost.py``, whose closed forms import
nothing): parameter bytes, ZeRO geometry, a block boundary's activation,
an MoE layer's routed buffer, a ring's K block, a pipeline's boundaries.
``held(mode, snapshot, steps, symbols)`` holds a mode's model against a
``parallel.mesh.COLLECTIVES`` snapshot of the same run.

Each function reads structure (shapes, dtypes, the optimizer's shard
layout), never the counts it is held against.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

import torch

from bigdl_tpu_torch.analysis import commcost


def nbytes(tensors: Iterable[torch.Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def dp_symbols(opt, n_epochs: int = 1) -> Dict[str, float]:
    """The data plane's symbols of a ``DistriOptimizer`` after its run:
    P (every trained leaf's master bytes), L, clip, n_epochs, S_data, and
    the mode's own (P_flat, comp, B_buf; P_shd, P_rep)."""
    params = {n: p for n, p in opt._params.items()}
    mode = opt.sync_mode
    sym = {"S_data": opt.mesh.size, "L": 4.0, "n_epochs": n_epochs,
           "clip": 1.0 if "l2" in opt._grad_clip else 0.0}
    if mode == "sharded":
        flat = opt._flat
        sym["P_flat"] = flat.numel() * flat.element_size()
        sym["comp"] = 0.5 if opt.compress_gradients else 1.0
        sym["B_buf"] = nbytes(b for b in opt.model.buffers()
                              if b.is_floating_point())
    elif mode == "fsdp":
        item = {n: p.element_size() for n, p in params.items()}
        shd = sum(math.prod(opt._shapes[n]) * item[n] for n in opt._full)
        whole = sum(math.prod(opt._shapes[n]) * item[n] for n in params)
        sym.update(P_shd=shd, P_rep=whole - shd, P=whole)
    else:
        sym["P"] = nbytes(p for p in params.values())
    return sym


def tp_symbols(model, mesh, rows: int, seq: int, compute_bytes: int,
               clip: bool, axis: str = "tensor") -> Dict[str, float]:
    """A tensor-parallel LM's symbols: A (rows x seq x E in the compute
    dtype), n_blk, n_emb, VE (the tied table), P_sp, clip, S_tensor."""
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.nn.linear import TiedLMHead
    from bigdl_tpu_torch.parallel import tensor_parallel as tp
    specs = getattr(model, "_tp_specs", {}) or {}
    named = dict(model.named_parameters())
    n_blk = sum(1 for m in model.modules()
                if isinstance(m, nn.TransformerEncoderLayer))
    emb = next(m for m in model.modules() if isinstance(m, nn.LookupTable))
    emb_name = next(n for n, p in named.items() if p is emb.weight)
    vocab, embed = emb.n_index, emb.n_output
    sharded = axis in specs.get(emb_name, ())
    tied = any(isinstance(m, TiedLMHead) for m in model.modules())
    return {"A": rows * seq * embed * compute_bytes, "n_blk": n_blk,
            "n_emb": 1.0 if sharded else 0.0,
            "VE": vocab * embed * compute_bytes if (tied and sharded)
            else 0.0,
            "P_sp": nbytes(named[n] for n in tp.sp_partial_params(model)),
            "clip": 1.0 if clip else 0.0, "S_tensor": mesh.axis_size(axis)}


def moe_symbols(model, tokens_per_rank: int, compute_bytes: int,
                n_data: int, clip: bool) -> Dict[str, float]:
    """An MoE LM's symbols: n_moe, k, E_x, aux and T (one layer's routed
    (E, C, D) buffer in the compute dtype, C as ``MoE.forward`` sizes it
    for ``tokens_per_rank`` tokens a rank over ``n_data`` data ranks)."""
    from bigdl_tpu_torch.parallel.expert import MoE
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    m = moes[0]
    t_glob = tokens_per_rank * n_data
    capacity = min(max(1, int(math.ceil(
        t_glob / m.n_experts * m.capacity_factor * m.k))), t_glob)
    rows = min(capacity, tokens_per_rank)
    return {"n_moe": len(moes), "k": m.k, "E_x": m.n_experts,
            "aux": 1.0 if m.aux_loss_weight else 0.0,
            "T": m.n_experts * rows * m.input_size * compute_bytes,
            "clip": 1.0 if clip else 0.0, "S_data": n_data}


def ring_symbols(model, mesh, batch: int, seq: int, compute_bytes: int,
                 axis: str = "seq") -> Dict[str, float]:
    """A ring-attention LM's symbols: K (one expanded K shard), n_ring
    (K and V, forward and backward, per layer), P (the f32 gradients'
    flat all-reduce), S_seq."""
    from bigdl_tpu_torch import nn
    att = [m for m in model.modules()
           if isinstance(m, nn.MultiHeadAttention)]
    p = mesh.axis_size(axis)
    a = att[0]
    return {"K": batch * (seq // p) * a.num_heads * a.head_dim
            * compute_bytes, "n_ring": 4 * len(att), "S_seq": p,
            "P": sum(t.numel() * 4 for t in model.parameters())}


def gpipe_symbols(x: torch.Tensor, n_micro: int, mesh,
                  axis: str = "pipe") -> Dict[str, float]:
    """GPipe's symbols for the whole batch ``x``: M (one microbatch's
    boundary in ``x``'s dtype), n_micro, S_pipe."""
    return {"M": x.numel() // n_micro * x.element_size(), "n_micro": n_micro,
            "S_pipe": mesh.axis_size(axis)}


def stage_symbols(pipe, n_micro: int, mesh,
                  axis: str = "pipe") -> Dict[str, float]:
    """A ``StagePipeline`` rank's symbols: M_send and M_recv (its own
    boundaries, f32; a (1,) placeholder at the ends), n_micro, S_pipe."""
    p, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    send = (1,) if idx == p - 1 else pipe._in_shapes[idx + 1]
    recv = (1,) if idx == 0 else pipe._in_shapes[idx]
    return {"M_send": math.prod(send) * 4, "M_recv": math.prod(recv) * 4,
            "n_micro": n_micro, "S_pipe": p}


def held(mode: str, snapshot: Dict, steps: int, symbols: Dict[str, float],
         rtol: float = 0.0, drop: Optional[int] = None) -> Dict:
    """``commcost.compare`` of ``mode`` at ``symbols`` against a
    ``COLLECTIVES.snapshot()`` of ``steps`` steps; ``drop``: that term of
    the model left out (a control, which must fail the tolerance the
    sound reading meets)."""
    return commcost.compare(mode, commcost.counted_by_axis(snapshot), steps,
                            rtol=rtol, drop=drop, **symbols)
