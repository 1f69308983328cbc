"""Mesh topology (counterpart of ``bigdl_tpu/parallel/mesh.py``) and the
port's collectives.

The reference's ``MeshTopology(data=N)`` is N devices in one process (XLA
SPMD). The port's is N processes, one card each (or the CPU), in the
default ``torch.distributed`` process group: ``build()`` returns a
``Mesh``, the group with its size, this process's rank and its device.
Only the ``data`` axis is ported; a ``tensor``, ``pipeline``, ``sequence``
or ``expert`` axis above 1 raises ``NotImplementedError`` naming
``MODEL_PARALLEL``. Without a process group a mesh of one is local: every
collective is then the identity.

``Mesh``'s collectives (``all_reduce``, ``reduce_scatter``,
``all_gather``, ``broadcast``, ``all_gather_object``) are
``torch.distributed``'s, counted per call in ``COLLECTIVES`` (calls,
payload bytes and host seconds, by op), which ``chip_smoke.py`` holds to
each sync mode's structure; with ``COLLECTIVES.sync_timing`` a CUDA
tensor's stream is synchronized before and after each call, so that the
seconds are the collective's alone (for measurement only). Gloo takes
CUDA tensors in every op used here (f32 and bf16, torch 2.11 on an H100:
PERF.md §6), so no collective is staged through the host; gloo copies
through the host itself.
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

#: the label a model-parallel axis raises with (the next slice's work)
MODEL_PARALLEL = "A.4 (distributed plane: model-parallel axes)"

class _Counts:
    """Calls, payload bytes and host seconds per collective op."""

    def __init__(self) -> None:
        self.calls: Dict[str, int] = collections.Counter()
        self.bytes: Dict[str, int] = collections.Counter()
        self.seconds: Dict[str, float] = collections.Counter()
        self.sync_timing = False

    @contextlib.contextmanager
    def count(self, op: str, nbytes: int, t: torch.Tensor = None):
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

    def reset(self) -> None:
        self.calls.clear()
        self.bytes.clear()
        self.seconds.clear()

    def snapshot(self) -> Dict[str, Dict]:
        return {"calls": dict(self.calls), "bytes": dict(self.bytes),
                "seconds": dict(self.seconds)}


#: every collective a ``Mesh`` ran in this process
COLLECTIVES = _Counts()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Mesh:
    """A data-parallel mesh: the ``size`` processes of the default group
    (with ``backend``; None: no group, a local mesh of one), this
    process's ``rank`` and ``device``. ``shape`` is ``{"data": size}`` as
    the reference's ``mesh.shape``."""

    def __init__(self, size: int, rank: int, device: torch.device,
                 backend: Optional[str]):
        self.size = int(size)
        self.rank = int(rank)
        self.device = torch.device(device)
        self.backend = backend
        self.shape = {DATA_AXIS: self.size}

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    def __repr__(self) -> str:
        return (f"Mesh(data={self.size}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend})")

    # -------------------------------------------------------- collectives
    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the mesh in place (``"sum"``, ``"max"``,
        ``"avg"``: the sum over the size); returns ``t``."""
        if not self.distributed:
            return t
        import torch.distributed as dist
        red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
        with COLLECTIVES.count("all_reduce", _nbytes(t), t):
            dist.all_reduce(t, op=red)
        if op == "avg":
            t.div_(self.size)
        return t

    def reduce_scatter(self, flat: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the sum of ``flat`` (1-D, its length a
        multiple of the size) over the mesh."""
        n = flat.numel() // self.size
        if not self.distributed:
            return flat.clone()
        import torch.distributed as dist
        out = torch.empty(n, dtype=flat.dtype, device=flat.device)
        with COLLECTIVES.count("reduce_scatter", _nbytes(flat), flat):
            dist.reduce_scatter_tensor(out, flat.contiguous())
        return out

    def all_gather(self, piece: torch.Tensor) -> torch.Tensor:
        """Every rank's ``piece`` (1-D, one length) concatenated in rank
        order."""
        if not self.distributed:
            return piece.clone()
        import torch.distributed as dist
        out = torch.empty(piece.numel() * self.size, dtype=piece.dtype,
                          device=piece.device)
        with COLLECTIVES.count("all_gather", _nbytes(out), piece):
            dist.all_gather_into_tensor(out, piece.contiguous())
        return out

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` overwritten in place with rank ``src``'s."""
        if not self.distributed:
            return t
        import torch.distributed as dist
        with COLLECTIVES.count("broadcast", _nbytes(t), t):
            dist.broadcast(t, src)
        return t

    def all_gather_object(self, obj) -> List:
        """Every rank's picklable ``obj``, in rank order."""
        if not self.distributed:
            return [obj]
        import torch.distributed as dist
        out: List = [None] * self.size
        with COLLECTIVES.count("all_gather_object", 0):
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
    ``MeshTopology``); only ``data`` is ported, see the module
    docstring."""

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
        on; a mesh of one needs no group and is then on ``device`` (by
        default the card)."""
        wide = [a for a in _CANONICAL_ORDER
                if a != DATA_AXIS and self.sizes[a] > 1]
        if wide:
            raise NotImplementedError(
                f"mesh axes {wide} are not ported yet: ROADMAP "
                f"{MODEL_PARALLEL}; the port's mesh has the data axis only")
        from bigdl_tpu_torch.utils.engine import Engine
        Engine.maybe_init_distributed()
        n = self.total()
        if Engine.process_group_up():
            world = Engine.process_count()
            if world != n:
                raise ValueError(f"mesh needs {n} processes, the process "
                                 f"group has {world}")
            return Mesh(world, Engine.process_index(),
                        Engine.distributed_device(), Engine.backend())
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
