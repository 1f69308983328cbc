"""Sequence (context) parallelism: ring attention and Ulysses
(counterpart of ``bigdl_tpu/parallel/context.py``).

The reference calls these inside ``shard_map`` bodies, where the mesh axis
is a name. The port calls them in each rank's process, on its (B, S/P, N,
D) shard, over the ``axis_name`` group of ``mesh`` (a
``parallel.mesh.Mesh``; ``MultiHeadAttention(seq_axis=...)`` takes its
``seq_mesh``, which ``ContextParallelLM`` sets):

- ``ring_attention``: the query shard stays and the key/value shards go
  round the ring (``Mesh.shift``, P - 1 hops: the reference's last
  ``ppermute`` of each kind carries nothing it reads). On the card each
  hop's partial is kernel K1 (``flash_attention_with_lse``: its LSE is
  the statistic the combine needs, and its backward, kernels K2 and K3,
  takes the LSE's cotangent); elsewhere, or with ``use_kernel=False``,
  the plain ``attention_partial`` path. The reference's ``lax.switch``
  over past, diagonal and future chunks is a host branch here, since each
  rank knows its chunk ids: a past chunk runs unmasked, the diagonal
  causal, a future chunk launches nothing.
- ``layout="zigzag"``: rank i holds chunks (i, 2P-1-i) of 2P, balancing
  the causal work; a kernel hop runs the 4 half-chunk pairs (a future
  half launches nothing) and folds them with the LSE combine.
- ``ulysses_attention``: two ``all_to_all``s turn the sequence shard into
  a head shard, full-sequence attention runs on the local heads (K1 on the
  card, the blockwise core elsewhere), and two more turn it back.

Every collective on the differentiated path is an autograd Function with
its transpose: the shift's gradient goes the other way round the ring,
the all-to-all's is the inverse all-to-all. Autograd runs the backward in
the reverse order of the forward, so the ranks meet in the same
collectives as long as each rank's every collective stays in its graph:
a shifted chunk that only reaches future hops is tied to the output by a
zero term. All-masked rows carry the
finite sentinel float32.min, never -inf, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from bigdl_tpu_torch.ops.attention_core import (attention_partial,
                                                blockwise_attention,
                                                finalize_partial,
                                                online_softmax_combine)

_NEG = float(torch.finfo(torch.float32).min)


class _Shift(torch.autograd.Function):
    """``Mesh.shift`` by ``offset`` (the receive shaped ``recv_shape`` of
    ``recv_dtype`` where the ranks send unlike tensors); its gradient
    shifted back."""

    @staticmethod
    def forward(ctx, x, mesh, axis, offset, recv_shape=None, recv_dtype=None):
        ctx.mesh, ctx.axis, ctx.offset = mesh, axis, offset
        ctx.x_meta = (tuple(x.shape), x.dtype)
        return mesh.shift(x, axis, offset, recv_shape, recv_dtype)

    @staticmethod
    def backward(ctx, g):
        shape, dtype = ctx.x_meta
        return (ctx.mesh.shift(g, ctx.axis, -ctx.offset, shape, dtype),
                *([None] * (len(ctx.needs_input_grad) - 1)))


class _AllToAll(torch.autograd.Function):
    """``Mesh.all_to_all``; its gradient the inverse all-to-all."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis = mesh, axis
        ctx.split_dim, ctx.concat_dim = split_dim, concat_dim
        return mesh.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_to_all(g, ctx.axis, ctx.concat_dim,
                                    ctx.split_dim), None, None, None, None)


def _mesh(mesh):
    if mesh is None:
        raise ValueError("the port's context parallelism runs over a "
                         "parallel.mesh.Mesh: pass mesh= (a model built with "
                         "seq_axis runs inside parallel.context."
                         "ContextParallelLM)")
    return mesh


def _lse_combine(o_a, l_a, o_b, l_b):
    """Two (output, logsumexp) partials over disjoint key sets, merged.
    o: (B, S, N, D) f32; l: (B, N, S) f32 with the finite sentinel on
    all-masked rows."""
    m = torch.maximum(l_a, l_b)
    ca = torch.exp(l_a - m)
    cb = torch.exp(l_b - m)
    s = ca + cb
    l_new = m + torch.log(s)
    ca, cb = ca / s, cb / s
    o_new = (o_a * ca.transpose(1, 2)[..., None]
             + o_b * cb.transpose(1, 2)[..., None])
    return o_new, l_new


def _ring_hop_kernel(q, kc, vc, scale: float, kv_chunk: int, q_chunk: int,
                     causal: bool):
    """One (q chunk, kv chunk) pair's (o f32, lse) through
    ``flash_attention_with_lse``, or None for a future chunk (it adds
    nothing). Chunks are contiguous spans of one length."""
    from bigdl_tpu_torch.ops.flash_attention import flash_attention_with_lse
    if causal and kv_chunk > q_chunk:
        return None
    o, lse = flash_attention_with_lse(q.contiguous(), kc.contiguous(),
                                      vc.contiguous(),
                                      causal=causal and kv_chunk == q_chunk,
                                      scale=scale)
    return o.float(), lse


def _fold(acc, part):
    if part is None:
        return acc
    if acc is None:
        return part
    return _lse_combine(acc[0], acc[1], part[0], part[1])


def _zigzag_hop_kernel(q, kc, vc, scale: float, src: int, my: int, p: int,
                       causal: bool):
    """One zigzag hop's (o, lse): the local pair (my, 2P-1-my) against the
    kv pair (src, 2P-1-src), as 4 contiguous half-chunk launches folded per
    q half (non-causal: one launch of the whole shards)."""
    if not causal:
        return _ring_hop_kernel(q, kc, vc, scale, 0, 0, False)
    c2 = q.shape[1] // 2
    halves_q = ((q[:, :c2], my), (q[:, c2:], 2 * p - 1 - my))
    halves_kv = ((kc[:, :c2], vc[:, :c2], src),
                 (kc[:, c2:], vc[:, c2:], 2 * p - 1 - src))
    outs = []
    for qh, qid in halves_q:
        acc = None
        for kh, vh, kid in halves_kv:
            acc = _fold(acc, _ring_hop_kernel(qh, kh, vh, scale, kid, qid,
                                              True))
        if acc is None:   # both kv halves in this half's future: empty
            b, _, n, _ = qh.shape
            acc = (torch.zeros(qh.shape, dtype=torch.float32,
                               device=q.device),
                   torch.full((b, n, c2), _NEG, dtype=torch.float32,
                              device=q.device))
        outs.append(acc)
    return (torch.cat([outs[0][0], outs[1][0]], dim=1),
            torch.cat([outs[0][1], outs[1][1]], dim=2))


def zigzag_permutation(seq_len: int, p: int) -> np.ndarray:
    """The index permutation that puts the zigzag layout into contiguous
    shards: after ``x[:, perm]`` a P-way split hands rank i the global
    chunks (i, 2P-1-i). Needs ``seq_len % (2 p) == 0``."""
    if seq_len % (2 * p):
        raise ValueError(f"zigzag needs seq ({seq_len}) divisible by "
                         f"2*devices ({2 * p})")
    c2 = seq_len // (2 * p)
    idx = []
    for i in range(p):
        idx.extend(range(i * c2, (i + 1) * c2))
        j = 2 * p - 1 - i
        idx.extend(range(j * c2, (j + 1) * c2))
    return np.asarray(idx, dtype=np.int32)


def zigzag_inverse(seq_len: int, p: int) -> np.ndarray:
    perm = zigzag_permutation(seq_len, p)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(seq_len, dtype=np.int32)
    return inv


def zigzag_positions(dev: int, chunk: int, p: int,
                     device=None) -> torch.Tensor:
    """Global positions of rank ``dev``'s zigzag shard of ``chunk``
    (reference ``_zigzag_positions``)."""
    c2 = chunk // 2
    ar = torch.arange(c2, device=device)
    return torch.cat([dev * c2 + ar, (2 * p - 1 - dev) * c2 + ar])


_zigzag_positions = zigzag_positions


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str, causal: bool = False,
                   scale: Optional[float] = None,
                   use_kernel: Optional[bool] = None,
                   layout: str = "contiguous", mesh=None) -> torch.Tensor:
    """Ring attention over ``axis_name``: q, k, v are this rank's (B, S/P,
    N, D) shard of a sequence laid out contiguously in rank order or in
    the zigzag striping; returns this rank's output shard, the same math
    as full attention on the whole sequence. ``use_kernel`` (default: on a
    CUDA tensor) runs each hop through ``flash_attention_with_lse``."""
    if scale is None:
        scale = 1.0 / float(q.shape[-1]) ** 0.5
    if layout not in ("contiguous", "zigzag"):
        raise ValueError(f"unknown ring layout {layout!r}")
    if use_kernel is None:
        use_kernel = q.device.type == "cuda"
    mesh = _mesh(mesh)
    p = mesh.axis_size(axis_name)
    my = mesh.axis_index(axis_name)
    chunk = q.shape[1]
    kc, vc = k, v
    if use_kernel:
        acc, tie = None, None
        for t in range(p):
            src = (my - t) % p
            if layout == "zigzag":
                part = _zigzag_hop_kernel(q, kc, vc, scale, src, my, p,
                                          causal)
            else:
                part = _ring_hop_kernel(q, kc, vc, scale, src, my, causal)
            if part is None and t > 0:
                # a future chunk adds nothing, but its shift's backward must
                # run here as on the rank that used it (a collective a rank
                # skipped would hang the other): a zero term keeps it
                zero = (kc.float().sum() + vc.float().sum()) * 0.0
                tie = zero if tie is None else tie + zero
            acc = _fold(acc, part)
            if t < p - 1:
                kc = _Shift.apply(kc, mesh, axis_name, 1)
                vc = _Shift.apply(vc, mesh, axis_name, 1)
        o = acc[0] if tie is None else acc[0] + tie
        return o.to(q.dtype)
    if layout == "zigzag":
        q_pos = zigzag_positions(my, chunk, p, q.device)
    else:
        q_pos = my * chunk + torch.arange(chunk, device=q.device)
    state = None
    for t in range(p):
        src = (my - t) % p
        if layout == "zigzag":
            k_pos = zigzag_positions(src, chunk, p, q.device)
        else:
            k_pos = src * chunk + torch.arange(chunk, device=q.device)
        part = attention_partial(q, kc, vc, scale, 0, 0, causal,
                                 q_pos=q_pos, k_pos=k_pos)
        state = part if state is None else online_softmax_combine(
            *state, *part)
        if t < p - 1:
            kc = _Shift.apply(kc, mesh, axis_name, 1)
            vc = _Shift.apply(vc, mesh, axis_name, 1)
    return finalize_partial(state[0], state[1]).to(q.dtype)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis_name: str, causal: bool = False,
                      scale: Optional[float] = None, mesh=None
                      ) -> torch.Tensor:
    """Ulysses sequence parallelism: (B, S/P, N, D) shards to (B, S, N/P,
    D) head shards by all-to-all, full attention on the local heads (K1 on
    the card, ``blockwise_attention`` elsewhere), and back. ``num_heads``
    must divide by the axis's size."""
    from bigdl_tpu_torch.ops import flash_attention
    mesh = _mesh(mesh)
    p = mesh.axis_size(axis_name)
    n = q.shape[2]
    if n % p:
        raise ValueError(f"heads {n} must divide seq axis size {p}")

    def to_heads(x):
        return _AllToAll.apply(x, mesh, axis_name, 2, 1)

    def to_seq(x):
        return _AllToAll.apply(x, mesh, axis_name, 1, 2)

    qh, kh, vh = to_heads(q), to_heads(k), to_heads(v)
    if flash_attention.use_flash(qh, None):
        out = flash_attention.flash_attention(
            qh.contiguous(), kh.contiguous(), vh.contiguous(), causal=causal,
            scale=scale)
    else:
        out = blockwise_attention(qh, kh, vh, causal=causal, scale=scale,
                                  block_size=max(128, qh.shape[1] // 8))
    return to_seq(out)


def ring_self_attention(q, k, v, mesh, axis_name: str = "seq",
                        causal: bool = False, scale: Optional[float] = None,
                        mode: str = "ring",
                        use_kernel: Optional[bool] = None,
                        layout: str = "contiguous") -> torch.Tensor:
    """The whole-array form: the full (B, S, N, D) q, k, v on every rank of
    ``mesh``'s ``axis_name`` group are split into this rank's shard (the
    zigzag striping for ``layout="zigzag"``), run through ring or Ulysses
    attention, and the answer is gathered back in sequence order (forward
    this rank's block, backward an all-gather; the gather's backward keeps
    this rank's block)."""
    from bigdl_tpu_torch.parallel.tensor_parallel import gather, split
    if mode == "ring":
        def impl(a, b, c):
            return ring_attention(a, b, c, axis_name, causal, scale,
                                  use_kernel=use_kernel, layout=layout,
                                  mesh=mesh)
    elif mode == "ulysses":
        def impl(a, b, c):
            return ulysses_attention(a, b, c, axis_name, causal, scale,
                                     mesh=mesh)
    else:
        raise ValueError(f"unknown mode {mode!r}: 'ring' or 'ulysses'")
    zig = mode == "ring" and layout == "zigzag"
    if zig:
        s, p = q.shape[1], mesh.axis_size(axis_name)
        fwd = torch.as_tensor(zigzag_permutation(s, p), dtype=torch.int64,
                              device=q.device)
        q, k, v = (t.index_select(1, fwd) for t in (q, k, v))
    shards = [split(t, mesh, axis_name, 1) for t in (q, k, v)]
    out = gather(impl(*shards), mesh, axis_name, 1)
    if zig:
        inv = torch.as_tensor(zigzag_inverse(s, p), dtype=torch.int64,
                              device=q.device)
        out = out.index_select(1, inv)
    return out


class ContextParallelLM(torch.nn.Module):
    """A ``build_lm`` model run with its sequence sharded over ``axis``
    (the reference's ``_train_context_parallel`` split): the modules before
    the ``TransformerEncoder`` (embedding, positional encoding) run on the
    whole batch, then the sequence is cut to this rank's shard (for
    ``layout="zigzag"`` after the zigzag permutation) and the stack (its
    attention over the ring or Ulysses) and the head run on the shard.
    The cut is a plain slice: each rank's gradients cover its shard's
    positions (and, through the ring's backward, what its keys and values
    gave the other shards), so the gradients of the loss are the sum over
    the ranks of each rank's ``loss / P``. Every attention layer with a
    ``seq_axis`` gets ``mesh`` as its ``seq_mesh``."""

    def __init__(self, model, mesh, axis: str = "seq",
                 layout: str = "contiguous"):
        super().__init__()
        from bigdl_tpu_torch.nn.attention import (MultiHeadAttention,
                                                  TransformerEncoder)
        self.model = model
        self.mesh, self.axis, self.layout = mesh, axis, layout
        mods = list(model._modules.values())
        self._split = next(i for i, m in enumerate(mods)
                           if isinstance(m, TransformerEncoder))
        for m in model.modules():
            if isinstance(m, MultiHeadAttention) and m.seq_axis is not None:
                m.seq_mesh = mesh

    def shard(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """This rank's shard of a whole-sequence tensor."""
        p, r = self.mesh.axis_size(self.axis), self.mesh.axis_index(self.axis)
        s = x.shape[dim]
        if s % p:
            raise ValueError(f"sequence {s} does not divide by the "
                             f"{self.axis!r} axis's {p} ranks")
        if self.layout == "zigzag":
            perm = torch.as_tensor(zigzag_permutation(s, p),
                                   dtype=torch.int64, device=x.device)
            x = x.index_select(dim, perm)
        return x.narrow(dim, r * (s // p), s // p)

    def unshard(self, shard: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """Every rank's shard gathered into the whole sequence (not
        differentiable: for evaluation)."""
        full = self.mesh.all_gather(shard.detach(), self.axis, dim=dim)
        if self.layout == "zigzag":
            inv = torch.as_tensor(
                zigzag_inverse(full.shape[dim], self.mesh.axis_size(
                    self.axis)), dtype=torch.int64, device=full.device)
            full = full.index_select(dim, inv)
        return full

    def forward(self, tokens: torch.Tensor):
        """This rank's shard of the model's output."""
        mods = list(self.model._modules.values())
        x = tokens
        for m in mods[:self._split]:
            x = m(x)
        x = self.shard(x)
        for m in mods[self._split:]:
            x = m(x)
        return x

    def train_step(self, tokens, targets, criterion, method, state,
                   params, precision=None, clip_norm: float = 0.0) -> float:
        """One step on the whole batch (every rank passes the same
        ``tokens`` and ``targets``): forward and backward of this rank's
        shard loss over P, the gradients summed over the axis in one flat
        all-reduce, an optional L2 clip, ``method``'s update of ``params``
        (by name) in place. ``precision``: a ``DtypePolicy`` for the
        forward's parameters. Returns the loss, the ranks' mean."""
        p = self.mesh.axis_size(self.axis)
        for t in params.values():
            t.grad = None
        if precision is not None:
            p_c = precision.cast_params_for_compute(params)
            out = torch.func.functional_call(
                self, {f"model.{n}": t for n, t in p_c.items()}, (tokens,))
        else:
            out = self(tokens)
        loss = criterion.forward(out, self.shard(targets)).float()
        (loss / p).backward()
        names = list(params)
        with torch.no_grad():
            grads = [params[n].grad if params[n].grad is not None
                     else torch.zeros_like(params[n]) for n in names]
            flat = torch.cat([g.reshape(-1).float() for g in grads])
            self.mesh.all_reduce(flat, axis=self.axis)
            if clip_norm:
                norm = flat.square().sum().sqrt()
                flat.mul_(torch.clamp(clip_norm / norm.clamp(min=1e-12),
                                      max=1.0))
            out_grads, off = {}, 0
            for n, g in zip(names, grads):
                out_grads[n] = flat[off:off + g.numel()].view(g.shape).to(
                    params[n].dtype)
                off += g.numel()
            method.update(out_grads, state, params)
            for t in params.values():
                t.grad = None
            mean = self.mesh.all_reduce(loss.detach().reshape(1).clone(),
                                        op="avg", axis=self.axis)
        return float(mean[0])
