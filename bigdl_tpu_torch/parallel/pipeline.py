"""Pipeline parallelism: GPipe and circular schedules over the mesh
``pipe`` axis (counterpart of ``bigdl_tpu/parallel/pipeline.py``).

``PipelineStack(block_factory, depth)`` holds ``depth`` copies of a
shape-preserving block with every parameter (and buffer) stacked on a
leading layer axis: its children are the block's, each leaf (depth, ...),
so its names are the block's and its leaves the reference's stacked ones.
``scan_apply`` runs the block over the layers (``torch.func.functional_call``
with each layer's slice); a buffered block (batch norm) advances its
stacked buffers layer by layer, microbatch by microbatch.

The reference runs the schedules inside ``shard_map`` with ``lax.ppermute``
between stages; the port runs one process a stage, the stage's layers
(the rank's slice of the stacked axis, ``pipeline_spec_tree``) on its own
card, and ``Mesh.shift`` (counted in ``mesh.COLLECTIVES``; staged through
pinned host memory on gloo, ``shift_staged``) as the ring step, an
``autograd.Function`` whose backward shifts the gradient back:

- every rank meets every shift: a stage skips its compute in a bubble but
  still shifts, and each step's output is tied to the step's receive (a
  zero term where nothing else reads it), so the backward meets the
  shifts in one order on every rank;
- the closing ``psum`` replicates the last stage's outputs: its forward
  all-reduces, its backward is the identity (a summing backward would
  give P times the gradients);
- a buffered stage advances its buffers only while it holds a real
  microbatch;
- ``remat=True`` recomputes each stage step in the backward
  (``ops.remat.checkpoint``), the gradients unchanged;
- ``data_axis`` (dp x pp): each data group runs its own pipeline on its
  slice of the batch; the loss is the mean over the axis and the
  parameters' gradients are averaged over it inside the backward.

``gpipe_loss_fn`` returns a callable on this rank's slices (or the whole
stacked leaves, of which it takes the rank's) whose loss ``.backward()``
gives the reference's gradients. ``StagePipeline`` pipelines a list of
heterogeneous stages (an LM's embedding + blocks | blocks + head): one
stage a rank, the stage parameters raveled into a (P, max_param_len) host
array in ``jax.flatten_util.ravel_pytree``'s order (sorted names, C
order), so one stacked array moves between the packages bit for bit. The
reference ships every boundary in one f32 conduit padded to the largest
(an SPMD artifact); each port rank knows what it receives, so a boundary
goes at its own shape, cast to f32 as the reference's, and the ring's
wrap-around (the last stage to the first, which reads none of it) is one
element. The loss runs on the last stage and its scalar is all-reduced.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops import remat as _remat
from bigdl_tpu_torch.parallel.context import _Shift
from bigdl_tpu_torch.parallel.mesh import PIPELINE_AXIS
from bigdl_tpu_torch.parallel.tensor_parallel import (copy_to_region,
                                                      reduce_from_region)
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device


def _shift(x, mesh, axis, recv_shape=None, recv_dtype=None):
    return _Shift.apply(x, mesh, axis, 1, recv_shape, recv_dtype)


def _tie(out: torch.Tensor, recv: torch.Tensor) -> torch.Tensor:
    """``out`` plus a zero term of ``recv``: the receive stays in the
    autograd graph (its shift's backward runs on this rank) at no value."""
    return out + recv.reshape(-1)[0].to(out.dtype) * 0


def _grad_state(like: torch.Tensor) -> torch.Tensor:
    """The schedule's first receive: zeros that take a gradient, so that
    every step's shift is in the graph from the first step."""
    return torch.zeros_like(like, requires_grad=torch.is_grad_enabled())


def _data_region(tensors: Dict[str, torch.Tensor], mesh, data_axis):
    """dp x pp: the parameters' gradients summed over ``data_axis`` in the
    backward (the loss is the axis's mean, so the sum is the mean
    gradient)."""
    if not data_axis:
        return tensors
    return {n: copy_to_region(t, mesh, data_axis) for n, t in tensors.items()}


def _data_mean(loss: torch.Tensor, mesh, data_axis) -> torch.Tensor:
    if not data_axis:
        return loss
    return reduce_from_region(loss, mesh, data_axis) / mesh.axis_size(
        data_axis)


class PipelineStack(Module):
    """``depth`` copies of ``block_factory()``'s block with parameters and
    buffers stacked on axis 0 (reference ``PipelineStack``); the block must
    map its input to an output of the same shape. See the module
    docstring."""

    def __init__(self, block_factory: Callable[[], torch.nn.Module],
                 depth: int, device: DeviceLike = "cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.depth = depth
        block = block_factory()
        layers = [block_factory() for _ in range(depth)]
        self._owners = []    # (name, owning module, leaf, is a buffer)
        # the template's own buffers: what scan_apply without ``buffers``
        # gives every layer, as the reference's template block does
        self.__dict__["_block_buffers"] = {
            n: b.detach().clone() for n, b in block.named_buffers()}
        with torch.no_grad():
            for prefix, m in block.named_modules():
                base = f"{prefix}." if prefix else ""
                for leaf, p in list(m._parameters.items()):
                    if p is None:
                        continue
                    name = base + leaf
                    stacked = torch.stack([l.get_parameter(name).detach()
                                           for l in layers])
                    m._parameters[leaf] = torch.nn.Parameter(stacked)
                    self._owners.append((name, m, leaf, False))
                for leaf, b in list(m._buffers.items()):
                    if b is None:
                        continue
                    name = base + leaf
                    m._buffers[leaf] = torch.stack(
                        [l.get_buffer(name) for l in layers])
                    self._owners.append((name, m, leaf, True))
        # the block's children are the stack's; its own leaves too
        for name, child in block._modules.items():
            self.add_module(name, child)
        for leaf, p in block._parameters.items():
            if p is not None:
                self.register_parameter(leaf, p)
        for leaf, b in block._buffers.items():
            if b is not None:
                self.register_buffer(leaf, b)
        self.__dict__["block"] = block   # the template, not a child
        self.to(dev)

    def _apply(self, fn, *args, **kwargs):
        super()._apply(fn, *args, **kwargs)
        # the template's own leaves are the stack's (its children are too)
        for leaf in self.block._parameters:
            self.block._parameters[leaf] = self._parameters[leaf]
        for leaf in self.block._buffers:
            self.block._buffers[leaf] = self._buffers[leaf]
        own = self.__dict__.get("_block_buffers")
        if own:
            self.__dict__["_block_buffers"] = {n: fn(b)
                                               for n, b in own.items()}
        return self

    def _leaves(self, buffers: bool) -> Dict[str, torch.Tensor]:
        # read through the owners: inside functional_call they hold the
        # substituted tensors
        return {name: getattr(m, leaf) for name, m, leaf, is_buf
                in self._owners if is_buf == buffers}

    def parameter_tree(self) -> Dict[str, torch.Tensor]:
        """{dotted name: stacked (depth, ...) leaf}."""
        return self._leaves(False)

    def buffer_tree(self) -> Dict[str, torch.Tensor]:
        return self._leaves(True)

    def _stacked_targets(self, tree, kind: str, prefix: str):
        """What ``load_parameter_tree`` / ``load_buffer_tree`` write: the
        stacked leaves, named as ``parameter_tree()`` names them or
        nested as the reference's stacked trees (reference
        ``PipelineStack.load_parameter_tree``), loaded in place."""
        flat = _dotted(tree)
        buffers = kind == "_buffers"
        return [(prefix + name, getattr(m, kind)[leaf], flat[name])
                for name, m, leaf, is_buf in self._owners
                if is_buf == buffers and name in flat]

    def _summary_view(self):
        # as the reference's: no own leaves, the template block once, its
        # leaves counted unstacked
        return 0, [("block", self.block, self.depth)]

    @property
    def has_buffers(self) -> bool:
        return any(is_buf for *_, is_buf in self._owners)

    def scan_apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
                   training: bool = False, buffers=None):
        """The layers in order, each with its slice of ``params`` (stacked
        leaves by name); ``(out, new_buffers)`` when ``buffers`` (stacked)
        are given and the stack carries buffers, else ``out`` (a buffered
        block then runs on the template block's own buffers, as the
        reference's)."""
        block = self.block
        block.train(training)
        with_buf = buffers is not None and self.has_buffers
        n = next(iter(params.values())).shape[0]
        new: Dict[str, List[torch.Tensor]] = {k: [] for k in (
            buffers if with_buf else {})}
        h = x
        for i in range(n):
            layer = {k: p[i] for k, p in params.items()}
            lb = ({k: b[i].clone() for k, b in buffers.items()} if with_buf
                  else {k: b.clone() for k, b in
                        self._block_buffers.items()})
            h = torch.func.functional_call(block, {**layer, **lb}, (h,))
            if with_buf:
                for k, b in lb.items():
                    new[k].append(b)
        if with_buf:
            return h, {k: torch.stack(v) for k, v in new.items()}
        return h

    def forward(self, input):
        params = self.parameter_tree()
        if not self.has_buffers:
            return self.scan_apply(params, input, training=self.training)
        out, new = self.scan_apply(params, input, training=self.training,
                                   buffers=self.buffer_tree())
        if self.training:
            with torch.no_grad():
                for k, b in self.buffer_tree().items():
                    b.copy_(new[k])
        return out

    def extra_repr(self) -> str:
        return f"depth={self.depth}, block={type(self.block).__name__}"


def _dotted(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def pipeline_spec_tree(stack: PipelineStack, axis: str = PIPELINE_AXIS
                       ) -> Dict[str, tuple]:
    """Specs sharding the stacked layer axis over ``axis``, by name."""
    return {name: (axis,) + (None,) * (leaf.dim() - 1)
            for name, leaf in stack.parameter_tree().items()}


def circular_permutation(depth: int, p: int, interleave: int) -> np.ndarray:
    """The circular schedule's layer order: device ``d``'s contiguous shard
    then holds its V round-robin chunks in chunk order (chunk ``v`` of
    device ``d``: layers ``[(v*p + d)*c, (v*p + d + 1)*c)``, ``c = depth /
    (p*V)``), as the reference's."""
    assert depth % (p * interleave) == 0, (depth, p, interleave)
    c = depth // (p * interleave)
    return np.asarray([(v * p + d) * c + j
                       for d in range(p)
                       for v in range(interleave)
                       for j in range(c)], dtype=np.int32)


def schedule_length(n_micro: int, p: int, interleave: int = 1) -> int:
    """Time steps of the schedule: bubble fraction = (P-1)/length."""
    return n_micro * interleave + p - 1


def local_slices(tree: Dict[str, torch.Tensor], mesh, axis: str,
                 depth: int) -> Dict[str, torch.Tensor]:
    """This rank's block of axis 0 of each stacked leaf ``depth`` long
    (a leaf already ``depth / P`` long is kept)."""
    p, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    size = depth // p
    return {name: (leaf[idx * size:(idx + 1) * size]
                   if p > 1 and leaf.shape[0] == depth else leaf)
            for name, leaf in tree.items()}


def _need_mesh(mesh):
    if mesh is None:
        raise ValueError("the pipeline schedules run over a Mesh: pass "
                         "mesh=MeshTopology(pipeline=P).build()")
    return mesh


def _gpipe_schedule(step: Callable, mbs, n_micro: int, mesh, axis: str,
                    state: torch.Tensor, send_shape):
    """The GPipe schedule of this rank's stage, ``M + P - 1`` steps, each
    ending in one shift on every rank. On a real microbatch the stage runs
    ``step`` (the first stage on ``mbs[t]``, the others on their receive);
    in a bubble it sends zeros of ``send_shape`` tied to its receive, and
    the last stage keeps its outputs and sends zeros tied to them.
    ``state`` is the first receive (it takes a gradient); every receive
    has its shape and dtype. Returns (the last stage's outputs by
    microbatch, or None; the last receive)."""
    p, idx = mesh.axis_size(axis), mesh.axis_index(axis)
    last = idx == p - 1
    recv_shape, dtype = tuple(state.shape), state.dtype
    outs = []
    for t in range(schedule_length(n_micro, p)):
        zeros = torch.zeros(send_shape, dtype=dtype, device=state.device)
        if idx <= t < idx + n_micro:
            out = step(mbs[t] if idx == 0 else state)
            if idx == 0:
                out = _tie(out, state)
            if last:
                outs.append(out)
                out = _tie(zeros, out)
        else:
            out = _tie(zeros, state)
        state = _shift(out, mesh, axis, recv_shape, dtype)
    return (outs if last else None), state


def gpipe_apply(stack: PipelineStack, local_params, x, n_micro: int,
                axis_name: str = PIPELINE_AXIS, training: bool = False,
                remat: bool = False, local_buffers=None, mesh=None):
    """GPipe forward of this rank's stage (``local_params``: its
    (depth/P, ...) slices) over ``mesh``'s ``axis_name``: ``x`` the whole
    batch on every rank, cut into ``n_micro`` microbatches. Returns the
    output, replicated, or ``(output, new_local_buffers)`` when buffers are
    passed."""
    mesh = _need_mesh(mesh)
    b = x.shape[0]
    assert b % n_micro == 0, \
        f"batch {b} must divide into {n_micro} microbatches"
    mbs = x.reshape(n_micro, b // n_micro, *x.shape[1:])
    with_buf = local_buffers is not None and stack.has_buffers
    bufs = dict(local_buffers) if with_buf else None

    def stage(h, *buf_values):
        if with_buf:
            out, nb = stack.scan_apply(local_params, h, training=training,
                                       buffers=dict(zip(bufs, buf_values)))
            return (out, *nb.values())
        return (stack.scan_apply(local_params, h, training=training),)

    run = (lambda *a: _remat.checkpoint(stage, *a)) if remat else stage

    def step(h):
        nonlocal bufs
        if not with_buf:
            return run(h)[0].to(mbs.dtype)
        res = run(h, *bufs.values())
        # a real microbatch: the buffers advance
        bufs = dict(zip(bufs, (r.detach() for r in res[1:])))
        return res[0].to(mbs.dtype)

    outs, state = _gpipe_schedule(step, mbs, n_micro, mesh, axis_name,
                                  _grad_state(mbs[0]), mbs.shape[1:])
    out_buf = torch.stack(outs) if outs is not None else torch.zeros_like(mbs)
    out_buf = reduce_from_region(_tie(out_buf, state), mesh, axis_name)
    out = out_buf.reshape(b, *out_buf.shape[2:])
    if with_buf:
        return out, bufs
    return out


def circular_apply(stack: PipelineStack, local_params, x, n_micro: int,
                   interleave: int, axis_name: str = PIPELINE_AXIS,
                   training: bool = False, remat: bool = False, mesh=None):
    """The interleaved (circular) schedule of the reference: this rank
    holds ``interleave`` (V) round-robin chunks (``circular_permutation``'s
    layout), items ride the ring V times chunk-major, stage 0 keeps the
    wrapped-around activations in a fifo of ``n_micro - P + 1``. Needs
    ``n_micro >= P`` and a buffer-free stack."""
    assert not stack.has_buffers, \
        "circular schedule supports buffer-free stacks only"
    mesh = _need_mesh(mesh)
    p, idx = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
    v, m, b = interleave, n_micro, x.shape[0]
    assert b % m == 0, f"batch {b} must divide into {m} microbatches"
    assert m >= p, f"circular schedule needs n_micro ({m}) >= stages ({p})"
    mbs = x.reshape(m, b // m, *x.shape[1:])
    local_depth = next(iter(local_params.values())).shape[0]
    assert local_depth % v == 0, (local_depth, v)
    lc = local_depth // v

    def chunk(vv, h):
        return stack.scan_apply(
            {n: leaf[vv * lc:(vv + 1) * lc] for n, leaf in
             local_params.items()}, h, training=training)

    def run(vv, h):
        if remat:
            return _remat.checkpoint(lambda a: chunk(vv, a), h)
        return chunk(vv, h)

    delay = m - p
    state = _grad_state(mbs[0])
    fifo = [torch.zeros_like(mbs[0]) for _ in range(delay + 1)]
    outs: List[Optional[torch.Tensor]] = [None] * m
    for t in range(schedule_length(m, p, v)):
        s = t - idx
        slot = t % (delay + 1)
        if 0 <= s < v * m:
            vv, mi = divmod(s, m)
            if idx == 0:
                # the wrapped delivery of item s - M, read before this
                # step's write to its slot
                inp = mbs[mi] if vv == 0 else fifo[slot]
                out = _tie(run(vv, inp).to(mbs.dtype), state)
            else:
                out = run(vv, state).to(mbs.dtype)
            if idx == p - 1 and vv == v - 1:
                outs[s - (v - 1) * m] = out
        else:
            out = state * 0
        state = _shift(out, mesh, axis_name)
        fifo[slot] = state
    out_buf = torch.stack(outs) if idx == p - 1 else torch.zeros_like(mbs)
    out_buf = reduce_from_region(_tie(out_buf, state), mesh, axis_name)
    return out_buf.reshape(b, *out_buf.shape[2:])


def gpipe_loss_fn(stack: PipelineStack, criterion, mesh, n_micro: int,
                  axis_name: str = PIPELINE_AXIS,
                  head: Optional[Callable] = None, remat: bool = False,
                  interleave: int = 1, data_axis: Optional[str] = None):
    """``(stacked_params, head_params, x, labels) -> loss``; a buffered
    stack's takes ``(stacked_params, buffers, head_params, x, labels)``
    and returns ``(loss, new_buffers)`` (reference ``gpipe_loss_fn``).

    ``stacked_params`` (and ``buffers``): this rank's (depth/P, ...)
    slices by name, or the whole stacked leaves, of which the rank's slice
    is taken. ``head(head_params, features)`` runs after the stack on every
    rank. ``interleave=V > 1``: the circular schedule (parameters permuted
    by ``circular_permutation``). ``data_axis``: ``x`` and ``labels`` are
    this data rank's slice of the batch; the loss is the mean over the
    axis and the gradients average over it."""
    if stack.has_buffers:
        assert interleave == 1, \
            "circular schedule supports buffer-free stacks only"
        assert data_axis is None, (
            "buffered stacks under dp would need cross-group stat "
            "merging; use buffer-free blocks with data_axis")

        def loss_buf(stacked, bufs, head_params, x, labels):
            params = local_slices(stacked, mesh, axis_name, stack.depth)
            bufs = local_slices(bufs, mesh, axis_name, stack.depth)
            feats, new = gpipe_apply(stack, params, x, n_micro, axis_name,
                                     training=True, remat=remat,
                                     local_buffers=bufs, mesh=mesh)
            logits = head(head_params, feats) if head is not None else feats
            return criterion.forward(logits, labels).float(), new
        return loss_buf

    def loss_fn(stacked, head_params, x, labels):
        params = _data_region(local_slices(stacked, mesh, axis_name,
                                           stack.depth), mesh, data_axis)
        if isinstance(head_params, dict):
            head_params = _data_region(head_params, mesh, data_axis)
        if interleave > 1:
            feats = circular_apply(stack, params, x, n_micro, interleave,
                                   axis_name, training=True, remat=remat,
                                   mesh=mesh)
        else:
            feats = gpipe_apply(stack, params, x, n_micro, axis_name,
                                training=True, remat=remat, mesh=mesh)
        logits = head(head_params, feats) if head is not None else feats
        loss = criterion.forward(logits, labels).float()
        return _data_mean(loss, mesh, data_axis)
    return loss_fn


# ------------------------------------------------- heterogeneous stages
def _ravel_names(module: torch.nn.Module) -> List[str]:
    """Parameter names in ``ravel_pytree``'s order of the reference's
    nested ``parameter_tree()``: sorted keys at every level."""
    tree: Dict[str, Any] = {}
    for name, _ in module.named_parameters():
        node = tree
        parts = name.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = name

    def walk(node):
        for key in sorted(node):
            if isinstance(node[key], dict):
                yield from walk(node[key])
            else:
                yield node[key]
    return list(walk(tree))


class StagePipeline:
    """GPipe over a list of shape-heterogeneous stages (reference
    ``StagePipeline``): one stage a rank of the ``pipe`` axis. See the
    module docstring. A probe forward at construction (training mode, on
    ``sample_microbatch``) finds each boundary's shape and refuses a stage
    that mutates its buffers."""

    def __init__(self, stages, sample_microbatch, device: DeviceLike = "cuda"):
        if len(stages) < 2:
            raise ValueError("need at least 2 stages to pipeline")
        dev = resolve_device(device)
        self.device = dev
        self.stages = [st.to(dev) for st in stages]
        self._layouts = []
        flats = []
        for st in self.stages:
            named = dict(st.named_parameters())
            layout, off = [], 0
            for name in _ravel_names(st):
                shape = tuple(named[name].shape)
                size = int(np.prod(shape))
                layout.append((name, shape, off, size))
                off += size
            self._layouts.append(layout)
            flats.append(np.concatenate(
                [named[n].detach().float().cpu().numpy().reshape(-1)
                 for n, *_ in layout]) if layout else np.zeros(0, np.float32))
        self._param_lens = [f.shape[0] for f in flats]
        self.max_param_len = max(self._param_lens)
        # host-side: the (P, max_len) array never sits on one card whole
        self._stacked = np.stack([
            np.pad(f, (0, self.max_param_len - f.shape[0])) for f in flats])

        x = torch.as_tensor(np.asarray(sample_microbatch)).to(dev)
        self._in_shapes, self._in_dtypes = [], []
        with torch.no_grad():
            for i, st in enumerate(self.stages):
                self._in_shapes.append(tuple(x.shape))
                self._in_dtypes.append(x.dtype)
                before = {n: b.clone() for n, b in st.named_buffers()}
                st.train()
                x = st(x)
                after = dict(st.named_buffers())
                changed = [n for n, b in before.items()
                           if not torch.allclose(b.float(), after[n].float())]
                for n, b in before.items():
                    after[n].copy_(b)
                if changed:
                    raise ValueError(
                        f"stage {i} mutates buffers during forward (BatchNorm "
                        "running stats?); StagePipeline needs step-constant "
                        "stages — use LayerNorm/GroupNorm, or the homogeneous "
                        "PipelineStack which threads buffers")
        self.out_shape, self.out_dtype = tuple(x.shape), x.dtype

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    def parameter_tree(self) -> np.ndarray:
        """(P, max_param_len) f32 on the host; row i is stage i's."""
        return self._stacked

    def _unravel(self, i: int, row) -> Dict[str, Any]:
        return {name: row[off:off + size].reshape(shape)
                for name, shape, off, size in self._layouts[i]}

    def unstack_parameter_trees(self, stacked) -> List[Dict[str, Any]]:
        """Per-stage ``{name: leaf}`` of a (P, L) array or tensor."""
        return [self._unravel(i, stacked[i]) for i in range(self.n_stages)]

    def _stage_params(self, i: int, row) -> Dict[str, torch.Tensor]:
        if not torch.is_tensor(row):
            row = torch.as_tensor(np.asarray(row))
        return self._unravel(i, row.to(self.device))

    def sequential_apply(self, stacked, x, training: bool = True):
        """The unpipelined forward: stage after stage, each with its row
        of ``stacked``."""
        h = torch.as_tensor(x).to(self.device) if not torch.is_tensor(x) \
            else x
        for i, st in enumerate(self.stages):
            st.train(training)
            h = torch.func.functional_call(
                st, self._stage_params(i, stacked[i]), (h,))
        return h

    def _row(self, local_stacked, idx: int):
        if local_stacked.dim() == 2:
            return local_stacked[idx] if local_stacked.shape[0] == \
                self.n_stages else local_stacked[0]
        return local_stacked

    def _schedule(self, row, x, n_micro: int, axis_name: str, remat: bool,
                  training: bool, mesh):
        """This rank's stage over the GPipe schedule: (the last stage's
        f32 outputs by microbatch, or None; the last receive)."""
        mesh = _need_mesh(mesh)
        p, idx = mesh.axis_size(axis_name), mesh.axis_index(axis_name)
        assert p == self.n_stages, (
            f"mesh '{axis_name}' axis ({p}) must equal the stage count "
            f"({self.n_stages})")
        b = x.shape[0]
        assert b % n_micro == 0, (b, n_micro)
        mb = self._in_shapes[0][0]
        assert b // n_micro == mb, (
            f"microbatch {b}//{n_micro}={b // n_micro} != sample_microbatch "
            f"batch {mb} used at construction")
        mbs = x.reshape(n_micro, mb, *x.shape[1:])
        st = self.stages[idx]
        st.train(training)
        params = self._stage_params(idx, row)
        in_dtype = self._in_dtypes[idx]
        send = (1,) if idx == p - 1 else self._in_shapes[idx + 1]
        recv = (1,) if idx == 0 else self._in_shapes[idx]

        def body(h):
            return torch.func.functional_call(st, params,
                                              (h.to(in_dtype),)).float()

        run = (lambda h: _remat.checkpoint(body, h)) if remat else body
        state = torch.zeros(recv, dtype=torch.float32, device=self.device,
                            requires_grad=torch.is_grad_enabled())
        return _gpipe_schedule(run, mbs, n_micro, mesh, axis_name, state,
                               send)

    def pipeline_apply(self, local_stacked, x, n_micro: int,
                       axis_name: str = PIPELINE_AXIS, remat: bool = False,
                       training: bool = True, mesh=None):
        """The GPipe schedule of this rank's stage (``local_stacked``: its
        row, as (L,) or (1, L), or the whole (P, L)); the last stage's
        outputs replicated over the axis (``psum``; backward the
        identity)."""
        mesh = _need_mesh(mesh)
        row = self._row(local_stacked, mesh.axis_index(axis_name))
        outs, state = self._schedule(row, x, n_micro, axis_name, remat,
                                     training, mesh)
        shape = (n_micro,) + self.out_shape
        out_buf = torch.stack(outs) if outs is not None else torch.zeros(
            shape, dtype=torch.float32, device=self.device)
        out_buf = reduce_from_region(_tie(out_buf, state), mesh, axis_name)
        return out_buf.reshape(n_micro * self.out_shape[0],
                               *self.out_shape[1:]).to(self.out_dtype)


def stage_pipeline_loss_fn(pipe: StagePipeline, criterion, mesh,
                           n_micro: int, axis_name: str = PIPELINE_AXIS,
                           remat: bool = False,
                           data_axis: Optional[str] = None):
    """``(stacked_params, x, labels) -> loss`` (reference
    ``stage_pipeline_loss_fn``): ``stacked_params`` this rank's row (or the
    whole (P, L)); the criterion runs on the last stage's outputs there
    and the scalar loss is all-reduced over the axis (backward the
    identity). ``data_axis`` composes dp x pp as ``gpipe_loss_fn`` does."""

    def loss_fn(stacked, x, labels):
        idx = mesh.axis_index(axis_name)
        row = pipe._row(stacked, idx)
        if data_axis:
            row = copy_to_region(row, mesh, data_axis)
        outs, state = pipe._schedule(row, x, n_micro, axis_name, remat,
                                     True, mesh)
        if outs is not None:
            feats = torch.cat(outs).to(pipe.out_dtype)
            loss = criterion.forward(feats, labels).float()
        else:
            loss = torch.zeros((), dtype=torch.float32, device=pipe.device)
        loss = reduce_from_region(_tie(loss, state), mesh, axis_name)
        return _data_mean(loss, mesh, data_axis)
    return loss_fn
