"""Mesh topology (counterpart of ``bigdl_tpu/parallel/mesh.py``) and the
port's collectives.

The reference's ``MeshTopology(data=, tensor=, pipeline=, sequence=,
expert=)`` is devices in one process (XLA SPMD). The port's is processes, one card each (or the
CPU), in the default ``torch.distributed`` process group: ``build()``
returns a ``Mesh``, this process's view of the group. Process ranks lay
out over the axes in ``_CANONICAL_ORDER`` with the tensor axis innermost,
as the reference orders its devices, and each axis above 1 gets its own
sub-group (``torch.distributed.new_group``): rank r's coordinate on an
axis is its index among the ranks that share its other coordinates (the
``pipe`` axis runs ``parallel/pipeline.py``'s schedules, the ``expert``
axis ``parallel/expert.py``'s split experts). Without a process group a
mesh of one is local: every collective is then the identity.

``Mesh.size`` and ``Mesh.rank`` are the DATA axis's size and this
process's coordinate on it (what the data plane divides batches and
optimizer slices by); ``world`` and ``process_rank`` are the group's.
The collectives take an ``axis`` (default ``"data"``): ``all_reduce``,
``reduce_scatter`` and ``all_gather`` (flat, or along a ``dim``),
``all_to_all``, and ``shift`` (send to the next rank of the axis's ring,
receive from the previous one, of its own shape unless ``recv_shape``
and ``recv_dtype`` say otherwise); ``broadcast``, ``all_gather_object`` and
``barrier`` span the whole group. Each is counted in ``COLLECTIVES``
(calls, payload bytes and host seconds by op, and calls by ``op/axis``),
which ``chip_smoke.py`` holds to each path's structure; with
``COLLECTIVES.sync_timing`` a CUDA tensor's stream is synchronized before
and after each call, so that the seconds are the collective's alone (for
measurement only). Gloo takes CUDA tensors in all-reduce, reduce-scatter,
all-gather, broadcast and all-to-all (f32 and bf16, torch 2.11 on an
H100: PERF.md §6) and copies them through the host itself; it refuses
them in send/recv, so ``shift`` stages a CUDA tensor through pinned host
memory, counted as ``shift_staged``.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

DATA_AXIS = "data"
TENSOR_AXIS = "tensor"
PIPELINE_AXIS = "pipe"
SEQUENCE_AXIS = "seq"
EXPERT_AXIS = "expert"

_CANONICAL_ORDER = (DATA_AXIS, PIPELINE_AXIS, EXPERT_AXIS, SEQUENCE_AXIS,
                    TENSOR_AXIS)

class _Counts:
    """Calls, payload bytes and host seconds per collective op, and calls
    and payload bytes per ``op/axis``."""

    def __init__(self) -> None:
        self.calls: Dict[str, int] = collections.Counter()
        self.bytes: Dict[str, int] = collections.Counter()
        self.seconds: Dict[str, float] = collections.Counter()
        self.by_axis: Dict[str, int] = collections.Counter()
        self.bytes_by_axis: Dict[str, int] = collections.Counter()
        self.sync_timing = False

    @contextlib.contextmanager
    def count(self, op: str, nbytes: int, t: torch.Tensor = None,
              axis: str = DATA_AXIS):
        """Count the collective run inside the block."""
        sync = self.sync_timing and t is not None and t.is_cuda
        if sync:
            torch.cuda.current_stream(t.device).synchronize()
        t0 = time.perf_counter()
        yield
        if sync:
            torch.cuda.current_stream(t.device).synchronize()
        self.calls[op] += 1
        self.bytes[op] += int(nbytes)
        self.seconds[op] += time.perf_counter() - t0
        self.by_axis[f"{op}/{axis}"] += 1
        self.bytes_by_axis[f"{op}/{axis}"] += int(nbytes)

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()
        self.seconds.clear()
        self.by_axis.clear()
        self.bytes_by_axis.clear()

    def snapshot(self) -> Dict[str, Dict]:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "seconds": dict(self.seconds), "by_axis": dict(self.by_axis),
                "bytes_by_axis": dict(self.bytes_by_axis)}


#: every collective a ``Mesh`` ran in this process
COLLECTIVES = _Counts()

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _coords(rank: int, sizes: Dict[str, int]) -> Dict[str, int]:
    """A process rank's coordinate on every axis (tensor innermost)."""
    out = {}
    for a in reversed(_CANONICAL_ORDER):
        out[a] = rank % sizes[a]
        rank //= sizes[a]
    return out


def axis_ranks(sizes: Dict[str, int], axis: str) -> List[List[int]]:
    """Every group of process ranks along ``axis``: ranks sharing their
    other coordinates, each group ordered by its coordinate on ``axis``."""
    world = 1
    for v in sizes.values():
        world *= v
    groups: Dict[tuple, List[int]] = {}
    for r in range(world):
        c = _coords(r, sizes)
        key = tuple(c[a] for a in _CANONICAL_ORDER if a != axis)
        groups.setdefault(key, []).append(r)
    return [groups[k] for k in sorted(groups)]


class Mesh:
    """This process's view of a mesh: the axes' sizes (``sizes``; a bare
    ``Mesh(size, rank, device, backend)`` is a data mesh of ``size``),
    its rank in the group, its device, the group's ``backend`` (None: no
    group, a local mesh) and each wide axis's sub-group. ``shape`` is the
    reference's ``mesh.shape``: the axes above 1 in canonical order
    (``{"data": 1}`` when none is)."""

    def __init__(self, size: int, rank: int, device: torch.device,
                 backend: Optional[str], sizes: Optional[Dict[str, int]] = None,
                 groups: Optional[Dict[str, object]] = None):
        if sizes is None:
            sizes = {DATA_AXIS: int(size)}
        self.sizes = {a: int(sizes.get(a, 1)) for a in _CANONICAL_ORDER}
        self.world = 1
        for v in self.sizes.values():
            self.world *= v
        self.process_rank = int(rank)
        self.coords = _coords(self.process_rank, self.sizes)
        self.device = torch.device(device)
        self.backend = backend
        self._groups = dict(groups or {})
        self.shape = ({a: self.sizes[a] for a in _CANONICAL_ORDER
                       if self.sizes[a] > 1} or {DATA_AXIS: 1})
        # the data plane's size and coordinate
        self.size = self.sizes[DATA_AXIS]
        self.rank = self.coords[DATA_AXIS]

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    def axis_size(self, axis: str) -> int:
        """The ranks along ``axis`` (``"world"``: every process)."""
        return self.world if axis == "world" else self.sizes[axis]

    def axis_index(self, axis: str) -> int:
        return self.process_rank if axis == "world" else self.coords[axis]

    def __repr__(self) -> str:
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return (f"Mesh({axes}, rank={self.process_rank}, "
                f"device={self.device}, backend={self.backend})")

    def __deepcopy__(self, memo) -> "Mesh":
        # a process's handle on its groups: a copied module shares it
        return self

    def _group(self, axis: str):
        """(whether ``axis`` has more than one rank here, its group: None
        for the whole default group)."""
        if not self.distributed or self.axis_size(axis) <= 1:
            return False, None
        return True, self._groups.get(axis)

    def _peer(self, axis: str, coord: int) -> int:
        """The process rank at ``coord`` on ``axis``, this rank's other
        coordinates kept."""
        c = dict(self.coords, **{axis: coord % self.sizes[axis]})
        r = 0
        for a in _CANONICAL_ORDER:
            r = r * self.sizes[a] + c[a]
        return r

    # -------------------------------------------------------- collectives
    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   axis: str = DATA_AXIS) -> torch.Tensor:
        """``t`` reduced over ``axis`` in place (``"sum"``, ``"max"``,
        ``"min"``, ``"avg"``: the sum over the axis's size; ``axis="world"``
        spans every process); returns ``t``."""
        wide, group = self._group(axis)
        if not wide:
            return t
        import torch.distributed as dist
        red = {"max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}.get(op, dist.ReduceOp.SUM)
        with COLLECTIVES.count("all_reduce", _nbytes(t), t, axis):
            dist.all_reduce(t, op=red, group=group)
        if op == "avg":
            t.div_(self.axis_size(axis))
        return t

    def reduce_scatter(self, t: torch.Tensor, axis: str = DATA_AXIS,
                       dim: Optional[int] = None) -> torch.Tensor:
        """This rank's part of the sum of ``t`` over ``axis``: with
        ``dim=None`` its slice of ``t`` flat (1-D, a multiple of the
        size), else its block of ``dim``."""
        n = self.sizes[axis]
        wide, group = self._group(axis)
        if dim is None:
            flat = t
            if not wide:
                return flat.clone()
            import torch.distributed as dist
            out = torch.empty(flat.numel() // n, dtype=flat.dtype,
                              device=flat.device)
            with COLLECTIVES.count("reduce_scatter", _nbytes(flat), flat,
                                   axis):
                dist.reduce_scatter_tensor(out, flat.contiguous(),
                                           group=group)
            return out
        dim = dim % t.dim()
        if not wide:
            return t.clone()
        moved = t.movedim(dim, 0).contiguous()
        out = self.reduce_scatter(moved.view(-1), axis)
        shape = list(moved.shape)
        shape[0] //= n
        return out.view(shape).movedim(0, dim)

    def all_gather(self, piece: torch.Tensor, axis: str = DATA_AXIS,
                   dim: Optional[int] = None) -> torch.Tensor:
        """Every rank's ``piece`` over ``axis``, in axis order: with
        ``dim=None`` concatenated flat (1-D pieces of one length), else
        along ``dim``."""
        n = self.sizes[axis]
        wide, group = self._group(axis)
        if dim is None:
            if not wide:
                return piece.clone()
            import torch.distributed as dist
            out = torch.empty(piece.numel() * n, dtype=piece.dtype,
                              device=piece.device)
            with COLLECTIVES.count("all_gather", _nbytes(out), piece, axis):
                dist.all_gather_into_tensor(out, piece.contiguous(),
                                            group=group)
            return out
        dim = dim % piece.dim()
        if not wide:
            return piece.clone()
        moved = piece.movedim(dim, 0).contiguous()
        flat = self.all_gather(moved.view(-1), axis)
        shape = list(moved.shape)
        shape[0] *= n
        return flat.view(shape).movedim(0, dim)

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """``lax.all_to_all(tiled=True)``: ``t`` cut into the axis's size
        blocks along ``split_dim``, block j sent to rank j, the blocks
        received concatenated along ``concat_dim`` in rank order."""
        n = self.sizes[axis]
        wide, group = self._group(axis)
        if not wide:
            return t.clone()
        import torch.distributed as dist
        split_dim, concat_dim = split_dim % t.dim(), concat_dim % t.dim()
        blocks = torch.stack(t.chunk(n, dim=split_dim)).contiguous()
        got = torch.empty_like(blocks)
        with COLLECTIVES.count("all_to_all", _nbytes(blocks), t, axis):
            dist.all_to_all_single(got, blocks, group=group)
        return torch.cat(got.unbind(0), dim=concat_dim)

    def shift(self, t: torch.Tensor, axis: str, offset: int = 1,
              recv_shape=None, recv_dtype=None) -> torch.Tensor:
        """The ring step of ``axis``: ``t`` sent to the rank ``offset``
        ahead, the one ``offset`` behind received (``lax.ppermute``'s
        ``[(i, i + offset)]``), shaped ``recv_shape`` of ``recv_dtype``
        (default: as ``t``) where the ranks send unlike tensors."""
        n = self.sizes[axis]
        wide, _ = self._group(axis)
        if not wide or offset % n == 0:
            return t.clone()
        import torch.distributed as dist
        me = self.coords[axis]
        src, op = t.contiguous(), "shift"
        if src.is_cuda and self.backend == "gloo":
            # gloo refuses CUDA tensors in send/recv: a pinned host copy
            src, op = torch.empty(src.shape, dtype=src.dtype,
                                  pin_memory=True).copy_(src), "shift_staged"
        got = torch.empty(
            src.shape if recv_shape is None else tuple(recv_shape),
            dtype=src.dtype if recv_dtype is None else recv_dtype,
            device=src.device)
        with COLLECTIVES.count(op, _nbytes(src), t, axis):
            ops = [dist.P2POp(dist.isend, src, self._peer(axis, me + offset)),
                   dist.P2POp(dist.irecv, got, self._peer(axis, me - offset))]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return got.to(t.device, non_blocking=True)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` overwritten in place with process ``src``'s."""
        if not self.distributed:
            return t
        import torch.distributed as dist
        with COLLECTIVES.count("broadcast", _nbytes(t), t, "world"):
            dist.broadcast(t, src)
        return t

    def all_gather_object(self, obj) -> List:
        """Every process's picklable ``obj``, in rank order."""
        if not self.distributed:
            return [obj]
        import torch.distributed as dist
        out: List = [None] * self.world
        with COLLECTIVES.count("all_gather_object", 0, axis="world"):
            dist.all_gather_object(out, obj)
        return out

    def barrier(self) -> None:
        if self.distributed:
            import torch.distributed as dist
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()


class MeshTopology:
    """Named parallelism axes over the processes of a group (reference
    ``MeshTopology``); see the module docstring."""

    def __init__(self, data: int = 1, tensor: int = 1, pipeline: int = 1,
                 sequence: int = 1, expert: int = 1):
        sizes = {DATA_AXIS: data, TENSOR_AXIS: tensor, PIPELINE_AXIS: pipeline,
                 SEQUENCE_AXIS: sequence, EXPERT_AXIS: expert}
        for k, v in sizes.items():
            if v < 1:
                raise ValueError(f"axis {k} must be >= 1, got {v}")
        self.sizes = sizes

    @staticmethod
    def data_parallel(n_processes: Optional[int] = None) -> "MeshTopology":
        """``data`` over every process of the group (``Engine``'s count)."""
        from bigdl_tpu_torch.utils.engine import Engine
        n = (n_processes if n_processes is not None
             else Engine.process_count())
        return MeshTopology(data=n)

    def total(self) -> int:
        t = 1
        for v in self.sizes.values():
            t *= v
        return t

    def axis_names(self) -> Tuple[str, ...]:
        return (tuple(a for a in _CANONICAL_ORDER if self.sizes[a] > 1)
                or (DATA_AXIS,))

    def build(self, device=None) -> Mesh:
        """This process's ``Mesh``: the default group, which must hold
        ``total()`` processes, on the device ``Engine`` placed this rank
        on, with a sub-group per axis above 1 (every process makes every
        group, in one order); a mesh of one needs no group and is then on
        ``device`` (by default the card)."""
        from bigdl_tpu_torch.utils.engine import Engine
        Engine.maybe_init_distributed()
        n = self.total()
        if Engine.process_group_up():
            world = Engine.process_count()
            if world != n:
                raise ValueError(f"mesh needs {n} processes, the process "
                                 f"group has {world}")
            import torch.distributed as dist
            rank = Engine.process_index()
            groups = {}
            for axis in _CANONICAL_ORDER:
                if self.sizes[axis] <= 1 or self.sizes[axis] == world:
                    continue   # absent, or the whole default group
                for ranks in axis_ranks(self.sizes, axis):
                    g = dist.new_group(ranks)
                    if rank in ranks:
                        groups[axis] = g
            return Mesh(self.sizes[DATA_AXIS], rank,
                        Engine.distributed_device(), Engine.backend(),
                        sizes=self.sizes, groups=groups)
        if n != 1:
            raise ValueError(
                f"mesh needs {n} processes and no process group is up: "
                "start one with Engine.init_distributed (or the BIGDL_* "
                "environment)")
        from bigdl_tpu_torch.utils.device import resolve_device
        return Mesh(1, 0, resolve_device(device or "cuda"), None)

    def __repr__(self) -> str:
        parts = ", ".join(f"{a}={self.sizes[a]}" for a in _CANONICAL_ORDER
                          if self.sizes[a] > 1)
        return f"MeshTopology({parts or 'data=1'})"


def split_sizes(n: int, size: int) -> Sequence[int]:
    """(padded length, chunk) of a flat vector of ``n`` over ``size``
    ranks, as the reference's ZeRO-1 layout pads it."""
    pad = (-n) % size
    return n + pad, (n + pad) // size
