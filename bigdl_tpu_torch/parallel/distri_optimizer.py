"""Data-parallel synchronous training over a process group (counterpart of
``bigdl_tpu/parallel/distri_optimizer.py``, reference
``optim/DistriOptimizer.scala:669`` and
``parameters/AllReduceParameter.scala:62``).

One process a rank, one card (or the CPU) each. Every rank runs the
single-card loop of ``optim/optimizer.py`` on its own batches (a
``DistributedDataSet``: batch sizes are per rank) and the ranks meet in
``torch.distributed`` collectives (``parallel.mesh.Mesh``) inside each
step. Each rank differentiates the mean loss of its own rows; the modes:

- ``"allreduce"``: replicated parameters. The gradients are all-reduced in
  flat buckets of up to ``BUCKET_BYTES`` and divided by the rank count,
  then clipped (the global gradient is on every rank) and applied.
  Batch norm runs synchronized (``ops.batch_norm.synchronized``): the
  reference's XLA computes its statistics over the global batch.
- ``"sharded"`` (ZeRO-1, the reference's slice ownership): the parameters
  are views of one flat padded f32 vector cut into N slices. The flat
  gradient is reduce-scattered and divided by N, clipped by the global
  norm (the slices' squared norms all-reduced, pad lanes masked), and the
  optim method updates this rank's slice with slice-shaped state (1/N of
  its memory); one all-gather republishes the vector. Batch norm runs per
  rank and the float buffers are averaged (one all-reduce), as the
  reference's ``shard_map`` does.
- ``"fsdp"`` (ZeRO-3, ``parallel/fsdp.py``): each leaf that
  ``fsdp_param_specs`` shards rests as this rank's slab, with slab-shaped
  optim state; the other leaves stay replicated. A step all-gathers each
  sharded leaf (the whole model at the step's start), runs forward and
  backward with synchronized batch norm, reduce-scatters each sharded
  leaf's gradient (the replicated leaves' are all-reduced in buckets),
  divides by N, clips by the global norm, updates the slabs and frees the
  full weights again.

``compress_gradients=True`` rounds to bf16 where the reference does:
allreduce and fsdp round the reduced gradient, sharded casts the flat
gradient to bf16 before the reduce-scatter. The logged loss is the mean
over the ranks. ``set_steps_per_dispatch`` takes no effect (windows of
one: ``supports_multi_dispatch = False``, as the reference's).

Hooks: a plain checkpoint is gathered to full shapes (a ZeRO-1 state as
its flat padded vector) and written by rank 0; ``set_checkpoint(...,
sharded=True)`` has every rank write its own slabs (refused for
``"sharded"``, whose flat state cannot reshard); resuming takes this
rank's part of the full state, so a snapshot of one world size restores
into another. Validation runs on each rank's slice of a distributed
validation set and merges the methods' (numerator, count) pairs with one
all-gather. The RESUME marker's ``mesh`` records the process and device
counts, the mesh shape and the sync mode; a preemption notice is agreed
every ``BIGDL_PREEMPT_SYNC_EVERY`` steps (default 10) by an all-reduce of
the ranks' flags, so every rank snapshots at the same step. Dropout masks
draw from generators seeded by (seed, rank): each rank its own masks,
where the reference draws one global mask.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Dict, List, Optional

import torch

from bigdl_tpu_torch.dataset.device_cache import DeviceCachedDataSet
from bigdl_tpu_torch.nn.regularization import Dropout
from bigdl_tpu_torch.ops.batch_norm import synchronized
from bigdl_tpu_torch.optim.optimizer import (LocalOptimizer, Tensors,
                                             _load_into, _tensors)
from bigdl_tpu_torch.parallel.fsdp import shard_dim
from bigdl_tpu_torch.parallel.mesh import MeshTopology, split_sizes
from bigdl_tpu_torch.utils import sharded_checkpoint as sckpt

SYNC_MODES = ("allreduce", "sharded", "fsdp")

#: the largest flat all-reduce of the allreduce mode's gradient buckets
BUCKET_BYTES = 64 << 20


def _buckets(tensors: List[torch.Tensor], cap: int) -> List[List[int]]:
    """Indices of ``tensors`` in consecutive groups of at most ``cap``
    bytes (a larger tensor alone); one dtype a group."""
    groups: List[List[int]] = []
    size, dtype = 0, None
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        if not groups or size + nbytes > cap or t.dtype != dtype:
            groups.append([])
            size, dtype = 0, t.dtype
        groups[-1].append(i)
        size += nbytes
    return groups


def _rank_major(t: torch.Tensor, d: int, n: int) -> torch.Tensor:
    """``t`` flat with rank r's slab of dim ``d`` as the r-th chunk."""
    shape = list(t.shape)
    split = shape[:d] + [n, shape[d] // n] + shape[d + 1:]
    return t.reshape(split).movedim(d, 0).contiguous().view(-1)


def _from_rank_major(flat: torch.Tensor, shape, d: int, n: int
                     ) -> torch.Tensor:
    slab = list(shape)
    slab[d] //= n
    return flat.view(n, *slab).movedim(0, d).reshape(shape)


def _map_tensors(tree, fn):
    """``tree`` (nested dicts) with each tensor leaf ``fn(path, t)``."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if torch.is_tensor(node):
            return fn(path, node)
        return node
    return walk(tree, ())


class DistriOptimizer(LocalOptimizer):
    """Data-parallel optimizer (reference ``DistriOptimizer``); see the
    module docstring."""

    supports_multi_dispatch = False

    def __init__(self, model, dataset, criterion,
                 topology: Optional[MeshTopology] = None,
                 sync_mode: str = "allreduce",
                 compress_gradients: bool = False, **kwargs):
        super().__init__(model, dataset, criterion, **kwargs)
        self.topology = topology or MeshTopology.data_parallel()
        self.sync_mode = sync_mode
        self.compress_gradients = bool(compress_gradients)
        self.mesh = self.topology.build(self.device)
        if self.mesh.device.type != self.device.type or (
                self.device.type == "cuda"
                and self.mesh.device.index != self.device.index):
            raise ValueError(f"this rank's mesh device is {self.mesh.device} "
                             f"but the model is on {self.device}")
        if isinstance(dataset, DeviceCachedDataSet):
            dataset.set_mesh(self.mesh)
        self._full: Dict[str, int] = {}      # fsdp: sharded leaf -> dim

    # ------------------------------------------------------------- records
    def _mode(self) -> str:
        if self.sync_mode not in SYNC_MODES:
            raise ValueError(f"sync_mode {self.sync_mode!r}: one of "
                             f"{SYNC_MODES}")
        return self.sync_mode

    def _telemetry_mode(self) -> str:
        return f"mesh-{self.sync_mode}"

    def _mesh_descriptor(self):
        return {"process_count": self.mesh.size,
                "device_count": self.mesh.size,
                "mesh_shape": dict(self.mesh.shape),
                "sync_mode": self.sync_mode}

    def _seed_dropout(self) -> None:
        for i, m in enumerate(self.model.modules()):
            if isinstance(m, Dropout):
                m.manual_seed(self.seed + i + 1_000_003 * self.mesh.rank)

    # ------------------------------------------------------- optim state
    def _init_opt_state(self, params: Tensors) -> Dict:
        self._params = params
        self._full = {}
        mode = self._mode()
        if mode == "sharded":
            state = self._init_flat(params)
        elif mode == "fsdp":
            state = self._init_fsdp(params)
        else:
            state = super()._init_opt_state(params)
        self._opt_state = state
        return state

    def resident_mib(self) -> Dict[str, float]:
        """This rank's parameter and optim-state MiB at rest, between
        steps, of the last ``optimize()``."""
        if self.sync_mode == "sharded":
            params = [self._flat]
        elif self.sync_mode == "fsdp":
            params = [*self._slabs.values(), *(
                p for n, p in self._params.items() if n not in self._full)]
        else:
            params = list(self._params.values())
        mib = lambda ts: sum(t.numel() * t.element_size()
                             for t in ts) / 2 ** 20
        return {"params": mib(params), "optim": mib(_tensors(self._opt_state))}

    def _init_flat(self, params: Tensors) -> Dict:
        """ZeRO-1: the parameters become views of one flat padded vector;
        the state is that of this rank's slice."""
        dtypes = {p.dtype for p in params.values()}
        if len(dtypes) != 1:
            raise ValueError(f"sync_mode='sharded' needs one parameter "
                             f"dtype, got {sorted(map(str, dtypes))}")
        n = sum(p.numel() for p in params.values())
        padded, chunk = split_sizes(n, self.mesh.size)
        flat = torch.zeros(padded, dtype=dtypes.pop(), device=self.device)
        off = 0
        with torch.no_grad():
            for p in params.values():
                view = flat[off:off + p.numel()].view(p.shape)
                view.copy_(p)
                p.data = view
                off += p.numel()
        lo = self.mesh.rank * chunk
        self._flat, self._n, self._chunk = flat, n, chunk
        self._slice = {"flat": flat[lo:lo + chunk]}
        lane = lo + torch.arange(chunk, device=self.device)
        self._mask = (lane < n).to(flat.dtype)
        return self.optim_method.init_state(self._slice)

    def _init_fsdp(self, params: Tensors) -> Dict:
        """ZeRO-3: this rank's slab of each sharded leaf, and their state."""
        n, r = self.mesh.size, self.mesh.rank
        self._full = {name: d for name, p in params.items()
                      if (d := shard_dim(tuple(p.shape), n)) is not None}
        self._shapes = {name: tuple(p.shape) for name, p in params.items()}
        self._slabs = {}
        for name, d in self._full.items():
            p = params[name]
            s = p.shape[d] // n
            self._slabs[name] = p.detach().narrow(d, r * s, s).contiguous()
        self._opt_params = {name: self._slabs.get(name, p)
                            for name, p in params.items()}
        return self.optim_method.init_state(self._opt_params)

    def _refresh_slabs(self) -> None:
        """Each slab from its (full) parameter, after a resume."""
        n, r = self.mesh.size, self.mesh.rank
        with torch.no_grad():
            for name, d in self._full.items():
                s = self._shapes[name][d] // n
                self._slabs[name].copy_(
                    self._params[name].detach().narrow(d, r * s, s))

    def _gather_full(self) -> None:
        """fsdp: each sharded parameter's full weight, all-gathered."""
        n = self.mesh.size
        with torch.no_grad():
            for name, d in self._full.items():
                p = self._params[name]
                if tuple(p.shape) == self._shapes[name]:
                    continue   # already whole
                flat = self.mesh.all_gather(self._slabs[name].view(-1))
                p.data = _from_rank_major(flat, self._shapes[name], d,
                                          n).contiguous()

    def _free_full(self) -> None:
        """fsdp: drop the full weights; the slabs are the masters."""
        for name in self._full:
            p = self._params[name]
            p.data = torch.empty(0, dtype=p.dtype, device=p.device)

    @contextlib.contextmanager
    def _full_weights(self):
        """The full parameters for the block (fsdp gathers and frees)."""
        if self._full:
            self._gather_full()
            try:
                yield
            finally:
                self._free_full()
        else:
            yield

    def _end_training(self) -> None:
        if self._full:
            self._gather_full()   # the returned model is whole

    # ----------------------------------------------------------- the step
    def _step_context(self):
        mode = self._mode()
        stack = contextlib.ExitStack()
        if mode == "fsdp":
            self._gather_full()
        if mode in ("allreduce", "fsdp"):
            stack.enter_context(synchronized(self.mesh))
        return stack

    def _compress(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(torch.bfloat16).to(t.dtype) if self.compress_gradients \
            else t

    def _all_reduce_mean(self, tensors: List[torch.Tensor]
                         ) -> List[torch.Tensor]:
        """The rank mean of each tensor, through flat bucket all-reduces."""
        out: List[Optional[torch.Tensor]] = [None] * len(tensors)
        n = self.mesh.size
        for group in _buckets(tensors, BUCKET_BYTES):
            flat = torch.cat([tensors[i].reshape(-1) for i in group])
            self.mesh.all_reduce(flat).div_(n)
            off = 0
            for i in group:
                k = tensors[i].numel()
                out[i] = flat[off:off + k].view(tensors[i].shape)
                off += k
        return out

    def _update(self, grads, opt_state, params, scalars) -> None:
        if scalars is None:
            self.optim_method.update(grads, opt_state, params)
        else:
            self.optim_method.update(grads, opt_state, params, scalars)

    @torch.no_grad()
    def _clip_global(self, grads: Tensors, sharded: List[str],
                     mask: Optional[torch.Tensor] = None) -> None:
        """The clip setting over a gradient whose ``sharded`` entries are
        this rank's slices of the global one (their squared norms are
        all-reduced) and whose other entries are whole on every rank."""
        const = self._grad_clip.get("constant")
        max_norm = self._grad_clip.get("l2")
        if const is not None:
            for g in grads.values():
                g.clamp_(*const)
        if mask is not None:
            # pad lanes stay zero through a clamp range without 0
            grads["flat"].mul_(mask)
        if max_norm is None:
            return
        part = torch.zeros(1, dtype=torch.float32, device=self.device)
        for name in sharded:
            part += grads[name].float().square().sum()
        gn_sq = self.mesh.all_reduce(part)[0]
        for name, g in grads.items():
            if name not in sharded:
                gn_sq = gn_sq + g.float().square().sum()
        scale = torch.clamp(
            max_norm * torch.rsqrt(torch.clamp(gn_sq, min=1e-24)), max=1.0)
        for g in grads.values():
            g.copy_(g * scale)

    @torch.no_grad()
    def _apply_grads(self, grads: Tensors, opt_state: Dict, params: Tensors,
                     clip: Callable, scalars=None) -> None:
        mode = self._mode()
        if mode == "allreduce":
            names = list(grads)
            reduced = self._all_reduce_mean([grads[k] for k in names])
            grads = clip({k: self._compress(g)
                          for k, g in zip(names, reduced)})
            self._update(grads, opt_state, params, scalars)
        else:
            if mode == "sharded":
                self._apply_flat(grads, opt_state, scalars)
            else:
                self._apply_fsdp(grads, opt_state, scalars)
            for p in self._params.values():   # consumed: none rests
                p.grad = None

    def _apply_flat(self, grads: Tensors, opt_state: Dict, scalars) -> None:
        mesh, n = self.mesh, self.mesh.size
        pad = self._flat.numel() - self._n
        flat = torch.cat([g.reshape(-1) for g in grads.values()]
                         + [grads[next(iter(grads))].new_zeros(pad)])
        if self.compress_gradients:
            flat = flat.to(torch.bfloat16)
        g = (mesh.reduce_scatter(flat) / n).to(self._flat.dtype)
        g_slice = {"flat": g}
        self._clip_global(g_slice, ["flat"], self._mask)
        self._update(g_slice, opt_state, self._slice, scalars)
        self._flat.copy_(mesh.all_gather(self._slice["flat"]))
        # per-rank batch statistics: the float buffers' rank mean
        bufs = [b for b in self.model.buffers() if b.is_floating_point()]
        if bufs:
            for b, mean in zip(bufs, self._all_reduce_mean(bufs)):
                b.copy_(mean)

    def _apply_fsdp(self, grads: Tensors, opt_state: Dict, scalars) -> None:
        mesh, n = self.mesh, self.mesh.size
        out: Tensors = {}
        for name, d in self._full.items():
            g = mesh.reduce_scatter(_rank_major(grads[name], d, n)) / n
            out[name] = self._compress(g).view(self._slabs[name].shape)
        rep = [k for k in grads if k not in self._full]
        for k, g in zip(rep, self._all_reduce_mean([grads[k] for k in rep])):
            out[k] = self._compress(g)
        out = {k: out[k] for k in grads}    # the parameters' order
        self._clip_global(out, list(self._full))
        self._update(out, opt_state, self._opt_params, scalars)
        self._free_full()

    def _batch_records(self, batch) -> int:
        """The global batch's: every rank trains as many rows."""
        return batch.size() * self.mesh.size

    def _step_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return self.mesh.all_reduce(loss.reshape(1), op="avg").reshape(())

    # ------------------------------------------------------------- hooks
    def _validate(self, driver_state) -> None:
        with self._full_weights():
            super()._validate(driver_state)

    def _summarize_parameters(self, neval: int) -> None:
        with self._full_weights():
            super()._summarize_parameters(neval)

    def _evaluate_validation(self):
        """This rank's part, merged over the ranks when the validation set
        is distributed (each rank then scored its own slice)."""
        results, count = super()._evaluate_validation()
        if self.mesh.size == 1 or not self.validation_dataset.is_distributed():
            return results, count
        rows = [list(r.state()) if r is not None else [0.0, 0.0]
                for r in results] + [[float(count), 0.0]]
        mine = torch.tensor(rows, dtype=torch.float64,
                            device=self.mesh.device).view(-1)
        summed = self.mesh.all_gather(mine).view(
            self.mesh.size, len(rows), 2).sum(0).tolist()
        # from the METHOD, identical on every rank: a rank whose slice was
        # empty still sees the merged value, so score triggers agree
        merged = [m.to_result(num, int(cnt)) if cnt > 0 else None
                  for m, (num, cnt) in zip(self.validation_methods,
                                           summed[:-1])]
        return merged, int(summed[-1][0])

    def _should_preempt(self, handler, neval: int) -> bool:
        """The ranks agree on a notice every ``BIGDL_PREEMPT_SYNC_EVERY``
        steps: an all-reduce (max) of their flags."""
        local = handler.should_snapshot()
        if self.mesh.size == 1:
            return local
        every = max(1, int(os.environ.get("BIGDL_PREEMPT_SYNC_EVERY", "10")))
        if neval % every:
            return False
        flag = torch.tensor([1.0 if local else 0.0], device=self.mesh.device)
        return bool(self.mesh.all_reduce(flag, op="max")[0] > 0)

    # --------------------------------------------------------- snapshots
    def _writes_checkpoint(self) -> bool:
        return self.mesh.rank == 0

    def _barrier(self) -> None:
        self.mesh.barrier()

    def _full_state(self, opt_state: Dict) -> Dict:
        """The optim state in full shapes (collective): a ZeRO-1 slice as
        the flat padded vector, an fsdp slab as its leaf's shape."""
        mesh, n = self.mesh, self.mesh.size
        if self.sync_mode == "sharded":
            return _map_tensors(opt_state, lambda path, t: mesh.all_gather(
                t.reshape(-1)) if t.numel() == self._chunk else t)
        if self.sync_mode == "fsdp":
            def full(path, t):
                name = path[-1] if path else None
                if name in self._full and tuple(t.shape) != \
                        self._shapes[name]:
                    return _from_rank_major(mesh.all_gather(t.reshape(-1)),
                                            self._shapes[name],
                                            self._full[name], n)
                return t
            return _map_tensors(opt_state, full)
        return opt_state

    def _checkpoint_trees(self, opt_state: Dict):
        mode = self._mode()
        if not self._ckpt_sharded:
            if not self._full:
                return super()._checkpoint_trees(self._full_state(opt_state))
            with self._full_weights():   # fsdp: a copy of the gathered
                model_tree, _ = super()._checkpoint_trees(opt_state)
                model_tree = _map_tensors(model_tree,
                                          lambda p, t: t.detach().clone())
            return model_tree, self._full_state(opt_state)
        if mode == "sharded":
            raise ValueError(
                "set_checkpoint(sharded=True) is not supported with "
                "sync_mode='sharded' (ZeRO-1 state is rank-count-shaped; "
                "its restore cannot reshard): use 'fsdp' or 'allreduce'")
        n, r = self.mesh.size, self.mesh.rank

        def slab(name, t):
            d = self._full[name]
            shape = self._shapes[name]
            offsets = [0] * len(shape)
            offsets[d] = r * (shape[d] // n)
            return sckpt.Slab(t, shape, offsets)

        params = {name: (slab(name, self._slabs[name]) if name in self._full
                         else p) for name, p in self.model.named_parameters()}
        state = _map_tensors(opt_state, lambda path, t: slab(path[-1], t)
                             if path and path[-1] in self._full
                             and tuple(t.shape) != self._shapes[path[-1]]
                             else t)
        return ({"params": params,
                 "buffers": dict(self.model.named_buffers())}, state)

    def _resume_state(self, resume, opt_state, driver_state):
        if self.sync_mode == "sharded":
            model_path = (resume.model_path if hasattr(resume, "model_path")
                          else resume[0])
            if sckpt.is_sharded_checkpoint(model_path):
                raise ValueError(
                    "sharded checkpoints cannot restore into sync_mode="
                    "'sharded' (ZeRO-1 flat state is rank-count-shaped); use "
                    "'fsdp' or 'allreduce', or a plain checkpoint")
        with self._full_weights() if self._full else contextlib.nullcontext():
            marker = super()._resume_state(resume, opt_state, driver_state)
            self._refresh_slabs()
        return marker

    def _load_opt_state(self, opt_state: Dict, loaded: Dict) -> None:
        """A full-shaped state (any world size's) as this rank's part."""
        n, r = self.mesh.size, self.mesh.rank
        if self.sync_mode == "sharded":
            padded = self._flat.numel()
            lo = r * self._chunk

            def mine(path, t):
                if t.dim() == 1 and t.numel() >= self._n and \
                        t.numel() != self._chunk:
                    full = torch.zeros(padded, dtype=t.dtype)
                    full[:self._n] = t[:self._n]
                    return full[lo:lo + self._chunk]
                return t
        elif self.sync_mode == "fsdp":
            def mine(path, t):
                name = path[-1] if path else None
                if name in self._full and tuple(t.shape) == \
                        self._shapes[name]:
                    d = self._full[name]
                    s = t.shape[d] // n
                    return t.narrow(d, r * s, s)
                return t
        else:
            _load_into(opt_state, loaded)
            return
        as_tensors = _map_numpy(loaded)
        _load_into(opt_state, _map_tensors(as_tensors, mine))


def _map_numpy(tree):
    """Host numpy leaves of a loaded tree as tensors."""
    import numpy as np
    if isinstance(tree, dict):
        return {k: _map_numpy(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.ndim > 0:
        return torch.from_numpy(np.ascontiguousarray(tree))
    return tree
