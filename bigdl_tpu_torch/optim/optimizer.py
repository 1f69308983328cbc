"""Optimizer facade and the single-card training loop (counterpart of
``bigdl_tpu/optim/optimizer.py``: ``Optimizer``, ``LocalOptimizer`` and
``make_grad_clipper`` are ported).

``Optimizer(model, dataset, criterion, device="cuda").optimize()`` runs the
reference's loop: each epoch shuffles the dataset and walks its batches;
each iteration runs the training forward (on compute-dtype copies of the
master parameters under a mixed ``DtypePolicy``), the criterion, autograd,
the gradient clippers and the optim method's in-place update; the driver
state (``epoch``, ``neval``, ``trainingLoss``) feeds the end trigger, which
is checked after every iteration and at every epoch start. Each iteration
logs one line in the reference's format.

The loss reaches the host ONE DISPATCH LATE, as in the reference's
pipelined ``flush``: a window's losses are fetched after the next window
has been queued on the device, so the host's launch work overlaps the
device's compute. On a card each window's losses are copied to pinned host
memory right behind it and fetched by that copy's event, so the fetch waits
for that window alone; a window's time is the interval between its
completion and the previous one's, both device events (from its own start
when nothing was in flight at its dispatch). An end trigger that reads the
loss (``Trigger.min_loss``) makes the loop fetch each loss before it checks
the trigger.

``set_steps_per_dispatch(k)`` groups up to k iterations into one window
(the reference's ``train.multi_step``, a ``lax.scan`` over k stacked
batches). On a card a window of more than one iteration is one replay of a
CUDA graph of k steps (``_WindowGraph``; one graph per window length, the
first window of each length its eager warm-up); its k losses come back in
one host read. On the CPU the window's iterations run eagerly one by one,
so k changes no number there. Windows of 1, and ``k = 1``, run the eager
step. The ``train.dispatch`` and ``train.sync`` spans mark the reference's
sites.

A window whose batches are all ``CachedSliceBatch``es of one
``DeviceCachedDataSet`` gathers them inside its graph: its only input is
the (k, B) index tensor, a copy on the device (the reference's
``multi_step_cached``); a k = 1 step gathers its batch on the device too. A
mixed window takes the pinned copy of its stacked batches, as the
reference's ``all(...)`` test sends it to ``multi_step``.

A parameter's regularizer (``w_regularizer`` / ``b_regularizer``,
``Module.register_parameter``) adds its loss of the f32 master to the
loss the step differentiates, in a k = 1 step and in a captured window
alike; the logged loss is the criterion's alone, as in the reference. A
full-batch method (``LBFGS``) is refused by ``set_optim_method``.

``set_remat`` recomputes activations in the backward (``ops/remat.py``):
``True``/``"full"`` the whole forward, ``"conv"`` all but the tagged conv
outputs and batch-norm sums (both a ``Sequential`` child by child,
``remat.Recompute``), ``"block"`` each ``TransformerEncoder`` block on its
own (``remat_blocks``). A recomputed forward draws the dropout
masks its forward drew, so the gradients are those without remat.

``set_train_summary(summary)`` writes ``Loss``, ``Throughput`` and
``LearningRate`` (of optim methods with ``current_rate``) through
``summary.add_scalar(tag, value, neval)`` for every iteration, when its
loss reaches the host; a window's time is spread over its iterations. A
summary with ``get_summary_trigger("Parameters")`` gets
``add_histogram("Parameters/<name>", values, neval)`` of every parameter
at each iteration the trigger fires at, and that trigger bounds windows as
the others do. ``set_validation_summary(summary)`` gets each validation
method's value (``add_scalar(name, value, neval - 1)``). Any object with
these methods is a sink (no ``visualization/`` writer is ported).

Hooks run at every window's end, as in the reference: validation
(``set_validation``), then the checkpoint (``set_checkpoint``: ``model[.N]``
= ``{"params", "buffers"}`` and ``state[.N]`` = ``{"optim", "driver"}`` as
host numpy, then the RESUME marker), then the chaos injectors
(``set_chaos``) and the preemption flag (``set_preemption_handler``: one
final snapshot, then ``TrainingPreempted``). A window never spans an
iteration after which a hook would fire. ``resume``/``auto_resume`` copy a
snapshot into the model's parameters and the optim state's tensors in
place, before any graph is captured; the marker's cursor, the dataset's
replayed shuffles and the dropout generators' states make a mid-epoch
restart bit-exact. ``optimize()`` retries a failed run from the newest
complete snapshot (``BIGDL_FAILURE_RETRY_TIMES`` within
``BIGDL_FAILURE_RETRY_INTERVAL`` seconds). ``set_checkpoint(...,
sharded=True)`` writes ``model[.N]/`` (``{"params", "buffers"}``) and
``state[.N]/`` (``{"optim"}`` and ``driver.json``) through
``utils/sharded_checkpoint.py``; ``resume`` and ``auto_resume`` read either
form. A dataset with a ``drain()`` (``dataset.ingest.PrefetchingDataSet``)
is drained by the preemption path before its snapshot, and each epoch's
iterator is closed at the epoch's end and on every exit.

Telemetry: the programs are tracked sites of ``telemetry.profiling``
(``train.step``, the k = 1 step; ``train.multi_step`` and
``train.multi_step_cached``, a window's graph, whose first call, the eager
warm-up and the capture, is its compile; ``train.forward``, validation),
and the loop writes the reference's ``bigdl_train_*{mode="local"}``
families: data wait, dispatch and sync seconds a window, step seconds,
steps, records and records/s an iteration, compiles (the first window),
and ``bigdl_train_mfu``, the window's program FLOPs over its device
seconds and ``peak_flops()`` (from the second window on).
``set_profiling(log_dir, start_iteration, n_iterations)`` runs
``torch.profiler`` over exactly those iterations and writes a Chrome trace
into ``log_dir``; meanwhile each iteration runs under a ``record_function``
range ``iteration N`` and each module's forward under one named by the
module, so the trace's kernels are attributed to layers (the reference's
``jax.named_scope``). Under ``set_steps_per_dispatch(k > 1)`` a window is
one graph replay: its range is ``iterations N-M`` and no module range is
visible inside it. The hooks exist only while the profiler runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.dataset.base import AbstractDataSet
from bigdl_tpu_torch.dataset.device_cache import CachedSliceBatch
from bigdl_tpu_torch.interop.state_dict import import_tree_state
from bigdl_tpu_torch.nn.attention import TransformerEncoder
from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.nn.module import named_regularizers
from bigdl_tpu_torch.nn.regularization import Dropout
from bigdl_tpu_torch.optim.evaluator import evaluate_batches, evaluating
from bigdl_tpu_torch.optim.methods import SGD, OptimMethod
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.ops import remat
from bigdl_tpu_torch.ops.precision import DtypePolicy
from bigdl_tpu_torch.resilience import chaos as chaos_mod
from bigdl_tpu_torch.resilience import coordinator
from bigdl_tpu_torch.resilience.preemption import (PreemptionHandler,
                                                   TrainingPreempted)
from bigdl_tpu_torch.telemetry import get_registry, instruments, profiling
from bigdl_tpu_torch.telemetry.profiling import (sample_device_memory,
                                                 tracked_jit)
from bigdl_tpu_torch.telemetry.tracing import span
from bigdl_tpu_torch.utils import file_io
from bigdl_tpu_torch.utils import sharded_checkpoint as sckpt
from bigdl_tpu_torch.utils.cuda_graph import GraphedProgram
from bigdl_tpu_torch.utils.device import DeviceLike, check_module_device

logger = logging.getLogger("bigdl_tpu_torch.optim")

Tensors = Dict[str, torch.Tensor]


def make_grad_clipper(clip: Dict) -> Callable[[Tensors], Tensors]:
    """Gradient clipping from an ``Optimizer``'s setting (reference
    ``make_grad_clipper``): ``"constant": (lo, hi)`` clamps every element,
    then ``"l2": max_norm`` rescales so the GLOBAL L2 norm over all the
    gradients is at most ``max_norm``. Clips the ``{name: grad}`` dict in
    place and returns it; an empty setting is the identity."""
    const = clip.get("constant")
    max_norm = clip.get("l2")

    @torch.no_grad()
    def apply(grads: Tensors) -> Tensors:
        if const is not None:
            for g in grads.values():
                g.clamp_(*const)
        if max_norm is not None:
            gn_sq = sum(g.float().square().sum() for g in grads.values())
            scale = torch.clamp(
                max_norm * torch.rsqrt(torch.clamp(gn_sq, min=1e-24)), max=1.0)
            for g in grads.values():
                g.copy_(g * scale)
        return grads

    return apply


def _data_parallel(dataset, kwargs) -> bool:
    """Whether the facade trains ``dataset`` through ``DistriOptimizer``
    (the reference's factory, optim/optimizer.py, takes every distributed
    dataset there: its mesh is the devices of one process)."""
    if dataset is None or not dataset.is_distributed():
        return False
    if any(k in kwargs for k in ("topology", "sync_mode",
                                 "compress_gradients")):
        return True
    from bigdl_tpu_torch.dataset.base import DistributedDataSet
    root = dataset
    while not isinstance(root, DistributedDataSet) and hasattr(root, "base"):
        root = root.base
    if isinstance(root, DistributedDataSet):
        return True
    from bigdl_tpu_torch.utils.engine import Engine
    return Engine.process_count() > 1


class Optimizer:
    """Facade (reference ``Optimizer``): ``Optimizer(model, dataset,
    criterion, device=...)`` yields a ``LocalOptimizer``, or a
    ``parallel.DistriOptimizer`` (which also takes ``topology``,
    ``sync_mode`` and ``compress_gradients``) for a distributed dataset
    that trains data-parallel: a process group of more than one is up, the
    caller passes one of those three, or the dataset was asked for as
    distributed (``DataSet.array(..., distributed=True)``). A dataset that
    deals its shards by rank (``StreamingShardDataSet``,
    ``PrefetchingDataSet``) in a single process keeps ``LocalOptimizer``
    and its k-step windows.

    ``device`` defaults to ``"cuda"`` and must be where the model lives; the
    batches are moved there. ``seed`` seeds every ``Dropout`` of the model
    (module i of ``model.modules()`` gets ``seed + i``)."""

    def __new__(cls, model=None, dataset=None, criterion=None, **kwargs):
        if cls is Optimizer:
            if _data_parallel(dataset, kwargs):
                from bigdl_tpu_torch.parallel.distri_optimizer import \
                    DistriOptimizer
                return super().__new__(DistriOptimizer)
            return super().__new__(LocalOptimizer)
        return super().__new__(cls)

    def __init__(self, model: torch.nn.Module, dataset: AbstractDataSet,
                 criterion: Criterion, *, device: DeviceLike = "cuda",
                 seed: int = 0):
        self.device = check_module_device(model, device)
        self.model = model
        self.dataset = dataset
        self.criterion = criterion
        self.seed = seed
        self.optim_method: OptimMethod = SGD()
        self.end_when: Trigger = Trigger.max_epoch(10)
        self.precision = DtypePolicy.fp32()
        self._grad_clip: Dict = {}
        self._steps_per_dispatch = 1
        self._remat = False
        self.train_summary = None
        self.validation_summary = None
        self.validation_trigger: Optional[Trigger] = None
        self.validation_dataset: Optional[AbstractDataSet] = None
        self.validation_methods: Optional[List[ValidationMethod]] = None
        self.checkpoint_path: Optional[str] = None
        self.checkpoint_trigger: Optional[Trigger] = None
        self.is_overwrite = False
        self.state: Dict = {}
        self.metrics = Metrics()
        self._resume_from = None
        self._auto_resume = False
        self._preemption: Optional[PreemptionHandler] = None
        self._chaos: List = []
        self._ckpt_sharded = False
        self._profile = None
        self._live_data_iter = None
        self._eval_cache: Dict = {}
        self._fwd = None
        #: one entry per trained iteration: neval, epoch, loss, seconds
        #: (time between two iterations' completions), records
        self.history: List[Dict] = []
        #: one entry per validation: neval (the driver's, as the trigger
        #: saw it), records, seconds, and {method name: ValidationResult}
        self.validation_history: List[Dict] = []

    # ---------------------------------------------------------------- builder
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
        if not getattr(method, "supports_minibatch", True):
            # refused here, not at the first step (reference message)
            raise ValueError(
                f"{type(method).__name__} is a full-batch method and cannot "
                "drive the minibatch training loop; call "
                "method.optimize(feval, x) directly instead")
        self.optim_method = method
        return self

    def set_end_when(self, end_when: Trigger) -> "Optimizer":
        self.end_when = end_when
        return self

    def set_gradient_clipping_by_l2_norm(self, clip_norm: float
                                         ) -> "Optimizer":
        """Scale the gradients so their global L2 norm never exceeds
        ``clip_norm`` (reference ``setGradientClippingByl2Norm``)."""
        if clip_norm <= 0:
            raise ValueError(f"clip_norm must be > 0, got {clip_norm}")
        self._grad_clip = {**self._grad_clip, "l2": float(clip_norm)}
        return self

    def set_constant_gradient_clipping(self, min_value: float,
                                       max_value: float) -> "Optimizer":
        """Clamp every gradient element into [min_value, max_value]."""
        if not min_value < max_value:
            raise ValueError(f"need min_value < max_value, got "
                             f"[{min_value}, {max_value}]")
        self._grad_clip = {**self._grad_clip,
                           "constant": (float(min_value), float(max_value))}
        return self

    def disable_gradient_clipping(self) -> "Optimizer":
        self._grad_clip = {}
        return self

    def set_precision(self, policy) -> "Optimizer":
        """``"bf16"`` (bf16 compute over f32 masters), ``"fp32"`` or a
        ``DtypePolicy``."""
        if isinstance(policy, str):
            makers = {"bf16": DtypePolicy.bf16, "fp32": DtypePolicy.fp32}
            if policy not in makers:
                raise ValueError(f"unknown precision {policy!r}; use 'bf16', "
                                 "'fp32', or a DtypePolicy")
            policy = makers[policy]()
        self.precision = policy
        return self

    def set_steps_per_dispatch(self, k: int) -> "Optimizer":
        """Run up to ``k`` iterations as one dispatch (reference
        ``set_steps_per_dispatch``): on a card one replay of a CUDA graph
        of k steps, the counterpart of the reference's ``lax.scan``. Every
        iteration keeps its own log line and ``history`` entry. A window
        never crosses an epoch or an iteration at which the end trigger
        would fire (probed at the simulated ``neval``); a trigger that
        reads the loss, or one not ``probe_safe``, forces windows of 1."""
        if int(k) < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {k}")
        self._steps_per_dispatch = int(k)
        return self

    # ------------------------------------------------ hooks and resilience
    def set_validation(self, trigger: Trigger, dataset: AbstractDataSet,
                       v_methods: Sequence[ValidationMethod]
                       ) -> "Optimizer":
        """Evaluate ``v_methods`` over ``dataset`` whenever ``trigger``
        fires; the first method's value is the driver's ``score``
        (``Trigger.max_score``)."""
        self.validation_trigger = trigger
        self.validation_dataset = dataset
        self.validation_methods = list(v_methods)
        return self

    def set_checkpoint(self, path: str, trigger: Trigger,
                       sharded: bool = False) -> "Optimizer":
        """Write ``model.N`` and ``state.N`` (N the driver's ``neval``)
        under ``path`` whenever ``trigger`` fires; ``sharded``: as
        directories of ``utils/sharded_checkpoint.py`` (one shard file per
        process) instead of single files."""
        self._ckpt_sharded = bool(sharded)
        self.checkpoint_path = path
        self.checkpoint_trigger = trigger
        return self

    def overwrite_checkpoint(self) -> "Optimizer":
        """Write untagged ``model`` and ``state``, replacing the last."""
        self.is_overwrite = True
        return self

    def set_state(self, state: Dict) -> "Optimizer":
        """Initial driver state (``epoch``, ``neval``, ...)."""
        self.state = dict(state)
        return self

    def resume(self, model_path: str, state_path: str) -> "Optimizer":
        """Continue from snapshot files (the examples' --model/--state)."""
        self._resume_from = (model_path, state_path)
        return self

    def auto_resume(self, enabled: bool = True) -> "Optimizer":
        """On ``optimize()``, continue from the newest COMPLETE snapshot
        under ``checkpoint_path`` (partial writes rejected), mid-epoch
        bit-exact when it has a RESUME marker."""
        self._auto_resume = bool(enabled)
        return self

    def set_preemption_handler(self,
                               handler: Optional[PreemptionHandler] = None
                               ) -> "Optimizer":
        """Install SIGTERM (by default) hooks for the duration of
        ``optimize()``: on a notice the loop finishes the window in flight,
        writes one final snapshot and RESUME marker under
        ``checkpoint_path`` and raises ``TrainingPreempted``."""
        self._preemption = (handler if handler is not None
                            else PreemptionHandler())
        return self

    def set_chaos(self, injectors: Sequence) -> "Optimizer":
        """Deterministic fault injectors probed at every step boundary
        (``resilience.chaos``); ``BIGDL_CHAOS`` (e.g. ``kill@5``) adds to
        these at ``optimize()`` time."""
        self._chaos = list(injectors)
        return self

    def set_remat(self, enabled=True) -> "Optimizer":
        """Recompute activations in the backward (reference ``set_remat``):
        ``True`` or ``"full"``, the whole forward; ``"conv"``, all but the
        conv outputs and batch-norm statistics (K5 and K6 then launch once
        a step); ``"block"``, every ``TransformerEncoder`` block on its own
        (``remat_blocks``), the memory recipe of a large LM; ``False``,
        none."""
        encs = [m for m in self.model.modules()
                if isinstance(m, TransformerEncoder)]
        for enc in encs:  # reset; "block" re-enables below
            enc.remat_blocks = False
        if isinstance(enabled, str):
            if enabled not in remat.POLICIES:
                raise ValueError(f"unknown remat policy {enabled!r}; "
                                 "expected True/False, 'full', 'conv' or "
                                 "'block'")
            if enabled == "block":
                if not encs:
                    raise ValueError("remat='block' needs a model with "
                                     "TransformerEncoder blocks")
                for enc in encs:
                    enc.remat_blocks = True
                self._remat = False  # per-block checkpoints, no outer one
            else:
                self._remat = True if enabled == "full" else enabled
        else:
            self._remat = bool(enabled)
        return self

    def set_train_summary(self, summary) -> "Optimizer":
        """Per-iteration scalars (and parameter histograms) to ``summary``;
        see the module docstring."""
        self.train_summary = summary
        return self

    def set_validation_summary(self, summary) -> "Optimizer":
        """Each validation's results to ``summary.add_scalar``."""
        self.validation_summary = summary
        return self

    def set_profiling(self, log_dir: str, start_iteration: int = 5,
                      n_iterations: int = 5) -> "Optimizer":
        """Trace iterations [start_iteration, start_iteration +
        n_iterations) with ``torch.profiler`` into a Chrome trace under
        ``log_dir`` (reference ``set_profiling``); see the module
        docstring."""
        self._profile = (log_dir, int(start_iteration), int(n_iterations))
        return self

    def _train_instruments(self):
        """The ``mode="local"`` training metric children, resolved once."""
        cached = getattr(self, "_tm_cache", None)
        if cached is not None:
            return cached
        from types import SimpleNamespace
        tm = instruments(get_registry())
        mode = self._telemetry_mode()
        cached = SimpleNamespace(
            step=tm.train_step_seconds.labels(mode=mode),
            data_wait=tm.train_data_wait_seconds.labels(mode=mode),
            dispatch=tm.train_dispatch_seconds.labels(mode=mode),
            sync=tm.train_sync_seconds.labels(mode=mode),
            steps=tm.train_steps_total.labels(mode=mode),
            records=tm.train_records_total.labels(mode=mode),
            rps=tm.train_records_per_second.labels(mode=mode),
            compiles=tm.train_compiles_total.labels(mode=mode),
            mfu=tm.train_mfu.labels(mode=mode),
            validation=tm.train_validation_seconds.labels(mode=mode))
        self._tm_cache = cached
        return cached

    def _telemetry_mode(self) -> str:
        """The ``mode`` label of the training families."""
        return "local"

    def _close_data_iter(self) -> None:
        """Close the epoch's iterator, if one is live: an ingest engine's
        joins its stage threads."""
        it, self._live_data_iter = self._live_data_iter, None
        close = getattr(it, "close", None)
        if close is not None:
            close()

    def optimize(self) -> torch.nn.Module:
        raise NotImplementedError


def _tensors(obj) -> List[torch.Tensor]:
    """Every tensor in a nest of dicts, lists and tuples."""
    if torch.is_tensor(obj):
        return [obj]
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return [t for x in obj for t in _tensors(x)]
    return []


class _WindowGraph:
    """A window of k iterations as one CUDA graph (the counterpart of the
    reference's ``train.multi_step``): ``step`` k times, iteration j on
    ``batch(buffers, j)``, over static ``buffers`` shaped as ``like`` and a
    (k, n) buffer of the optim method's ``step_scalars``, then every
    gradient released; its output is the (k,) losses. A host window's
    buffers are its stacked (k, B, ...) data and labels; a cached window's
    one (k, B) index tensor, whose batches ``batch`` gathers from the cache
    (``reads``, tensors the graph reads at fixed addresses). Each call
    fills the buffers, host tensors by a pinned non-blocking copy and
    device ones by a device copy, and runs the program (the first call is
    its eager warm-up, then the capture; see ``utils/cuda_graph.py``); it
    returns a copy of the losses."""

    def __init__(self, step: Callable, release: Callable, k: int,
                 like: Sequence[torch.Tensor], batch: Callable,
                 n_scalars: int, device: torch.device, generators: Callable,
                 state, reads: Sequence[torch.Tensor] = ()):
        self.buffers = [torch.empty(t.shape, dtype=t.dtype, device=device)
                        for t in like]
        self.scalars = torch.empty((k, n_scalars), dtype=torch.float32,
                                   device=device)

        def body():
            losses = [step(*batch(self.buffers, j), self.scalars[j])
                      for j in range(k)]
            release()
            return torch.stack(losses)

        self.program = GraphedProgram(
            body, device, generators=generators,
            inputs=lambda: [*self.buffers, self.scalars, *reads,
                            *_tensors(state)])

    def __call__(self, inputs: Sequence[torch.Tensor],
                 scalars: torch.Tensor) -> torch.Tensor:
        for buf, t in zip((*self.buffers, self.scalars), (*inputs, scalars)):
            buf.copy_(t.pin_memory() if t.device.type == "cpu" else t,
                      non_blocking=True)
        # a copy: the losses are read one window late, after the next
        # replay has overwritten the graph's static output
        return self.program().clone()

    def close(self) -> None:
        self.program.close()


class _Fetched:
    """A window's (k,) losses on a card, copied to pinned host memory right
    behind it, and timing events at its start and its end: ``flush`` waits
    on ``done`` for this window alone (reading the device tensor would
    queue behind, and wait for, the window dispatched after it) and times
    it on the device's clock."""

    @staticmethod
    def event() -> torch.cuda.Event:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __init__(self, start: torch.cuda.Event, losses: torch.Tensor):
        self.start = start
        self.host = torch.empty(losses.shape, dtype=losses.dtype,
                                pin_memory=True)
        self.host.copy_(losses, non_blocking=True)
        self.done = self.event()


def _load_into(dst: Dict, src: Dict, where: str = "optim") -> None:
    """Copy a loaded host tree into a live state dict in place: tensors by
    ``copy_`` (their addresses, which a captured graph holds, stay),
    anything else (the host counters) by assignment."""
    if set(dst) != set(src):
        raise ValueError(f"snapshot {where} has keys {sorted(src)}, this "
                         f"run's has {sorted(dst)}: another optim method?")
    for k, d in dst.items():
        v = src[k]
        if torch.is_tensor(d):
            if not torch.is_tensor(v):
                v = torch.as_tensor(np.asarray(v))
            if tuple(v.shape) != tuple(d.shape):
                raise ValueError(f"snapshot {where}.{k}: shape "
                                 f"{tuple(v.shape)} != {tuple(d.shape)}")
            d.copy_(v)
        elif isinstance(d, dict):
            _load_into(d, v, f"{where}.{k}")
        else:   # a host counter; a sharded snapshot holds it as a 0-d array
            dst[k] = v.item() if isinstance(v, np.ndarray) else v


class _WindowProfiler:
    """``set_profiling``'s ``torch.profiler`` over the windows that hold
    iterations [start, start + n): started at the first such window's
    dispatch, stopped (after a device synchronize, so the last kernels are
    in it) once the last is dispatched, and exported as a Chrome trace
    into ``log_dir``. While it runs, each window is a ``record_function``
    range and each module's forward another, named by the module; the
    module hooks exist only then."""

    def __init__(self, profile, model: torch.nn.Module, device: torch.device):
        self.profile = profile
        self.model = model
        self.device = device
        self.prof = None
        self.done = profile is None
        self._hooks: List = []
        self.trace_path: Optional[str] = None

    def begin(self, neval0: int, last_neval: int) -> None:
        if self.done or self.prof is not None:
            return
        log_dir, start, _ = self.profile
        if not neval0 <= start <= last_neval:
            return
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._first = neval0
        self.prof = profile(activities=activities)
        self.prof.start()
        for m in self.model.modules():
            self._add_range(m, getattr(m, "name", None) or type(m).__name__)

    def _add_range(self, module: torch.nn.Module, name: str) -> None:
        stack: List = []

        def pre(_mod, _inp):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            stack.append(rf)

        def post(_mod, _inp, _out):
            if stack:
                stack.pop().__exit__(None, None, None)

        self._hooks.append(module.register_forward_pre_hook(pre))
        self._hooks.append(module.register_forward_hook(post))

    def window(self, neval0: int, last_neval: int):
        if self.prof is None:
            return contextlib.nullcontext()
        name = (f"iteration {neval0}" if neval0 == last_neval
                else f"iterations {neval0}-{last_neval}")
        return torch.profiler.record_function(name)

    def end(self, last_neval: int) -> None:
        if self.prof is not None and \
                last_neval >= self.profile[1] + self.profile[2] - 1:
            self.close()

    def close(self) -> None:
        """Stop and export (also when training ends inside the window)."""
        if self.prof is None:
            return
        for h in self._hooks:
            h.remove()
        self._hooks = []
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof, self.prof = self.prof, None
        prof.stop()
        self.done = True
        log_dir = self.profile[0]
        os.makedirs(log_dir, exist_ok=True)
        self.trace_path = os.path.join(log_dir, "trace.json")
        prof.export_chrome_trace(self.trace_path)
        logger.info("[Profiler] trace of iterations from %d written to %s",
                    self._first, self.trace_path)


class LocalOptimizer(Optimizer):
    """Single-card training loop (reference ``LocalOptimizer``). The
    methods between ``_init_opt_state`` and ``_should_preempt`` are where
    ``parallel.DistriOptimizer`` puts its collectives."""

    #: False: every window is one iteration (``set_steps_per_dispatch``)
    supports_multi_dispatch = True

    def _to_device(self, array) -> torch.Tensor:
        """A batch array on the training device. To a card it is copied
        from pinned memory without blocking: a pageable copy would wait for
        the whole stream and undo the one-step-late loss fetch."""
        t = torch.as_tensor(array)
        if self.device.type == "cuda" and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _dropouts(self) -> List[Dropout]:
        return [m for m in self.model.modules() if isinstance(m, Dropout)]

    def _seed_dropout(self) -> None:
        for i, m in enumerate(self.model.modules()):
            if isinstance(m, Dropout):
                m.manual_seed(self.seed + i)

    def optimize(self) -> torch.nn.Module:
        """Train until ``end_when`` fires; returns the model, whose
        parameters were updated in place and whose train/eval mode is
        restored.

        A failure other than a configuration error restarts the run from
        the newest COMPLETE snapshot under ``checkpoint_path``, up to
        ``BIGDL_FAILURE_RETRY_TIMES`` (default 5) failures within a
        sliding ``BIGDL_FAILURE_RETRY_INTERVAL``-second window (default
        120). ``TrainingPreempted`` is not retried: the host is going
        away, and ``auto_resume()`` picks its snapshot up on relaunch."""
        retry_times = int(os.environ.get("BIGDL_FAILURE_RETRY_TIMES", "5"))
        retry_window = float(
            os.environ.get("BIGDL_FAILURE_RETRY_INTERVAL", "120"))
        failures: List[float] = []
        resume = self._resume_from
        if resume is None and self._auto_resume:
            point = coordinator.latest_resume_point(self.checkpoint_path)
            if point is not None:
                resume = point
                logger.info("[AutoResume] discovered snapshot %s",
                            point.model_path)
        self._chaos_live = list(self._chaos) + chaos_mod.from_env()
        handler = self._preemption
        if handler is not None:
            handler.install()
            drain = getattr(self.dataset, "drain", None)
            if callable(drain):
                # an ingest engine's threads stop and join before the
                # final snapshot's IO
                handler.add_drain_hook(drain)
        try:
            while True:
                try:
                    return self._run_training(resume)
                except (ValueError, TypeError, NotImplementedError,
                        KeyboardInterrupt, TrainingPreempted):
                    raise  # configuration errors, and a host going away
                except Exception as e:  # noqa: BLE001 - the retry boundary
                    now = time.time()
                    failures = [t for t in failures if now - t < retry_window]
                    failures.append(now)
                    latest = coordinator.latest_resume_point(
                        self.checkpoint_path)
                    if len(failures) > retry_times or latest is None:
                        raise
                    # in process, the dataset's shuffle order has already
                    # advanced past a fresh process's, so the marker's
                    # replay and batch skip would align to the wrong
                    # permutation: the epoch restarts from batch 0
                    resume = dataclasses.replace(latest, marker=None)
                    logger.warning(
                        "[Retry %d/%d] training failed (%s); restarting "
                        "from checkpoint %s", len(failures), retry_times, e,
                        latest.model_path)
        finally:
            self._close_data_iter()
            if handler is not None:
                handler.uninstall()

    # ------------------------------------------------------------ snapshots
    def _resume_state(self, resume, opt_state: Dict, driver_state: Dict
                      ) -> Optional[Dict]:
        """Load a snapshot into the model and ``opt_state`` in place;
        returns its RESUME marker (None: resume epoch-granular)."""
        if isinstance(resume, coordinator.ResumePoint):
            model_path, state_path = resume.model_path, resume.state_path
            marker = resume.marker
        else:
            model_path, state_path = resume
            marker = coordinator.read_marker(state_path)
        if sckpt.is_sharded_checkpoint(model_path):
            snap, st = self._load_sharded(model_path, state_path, opt_state)
        else:
            snap = file_io.load(model_path, device="cpu")
            st = file_io.load(state_path, device="cpu")
        if not (isinstance(snap, dict) and "params" in snap):
            raise ValueError(f"{model_path} is not a training snapshot "
                             "({'params', 'buffers'}); a saved module is "
                             "loaded with file_io.load")
        import_tree_state(self.model, snap["params"], snap.get("buffers", {}))
        with torch.no_grad():
            self._load_opt_state(opt_state, st["optim"])
        driver_state.update(st["driver"])
        elastic = coordinator.is_elastic(marker)
        instruments(get_registry()).resilience_resumes_total.labels(
            elastic="unknown" if elastic is None
            else ("true" if elastic else "false")).inc()
        logger.info("[Resume] from %s at epoch %s neval %s", model_path,
                    driver_state["epoch"], driver_state["neval"])
        return marker

    def _load_sharded(self, model_path: str, state_path: str,
                      opt_state: Dict):
        """A sharded pair as host trees shaped like a plain snapshot's:
        the targets are this run's own parameter, buffer and optim-state
        structures."""
        none_of = lambda tree: ({k: none_of(v) for k, v in tree.items()}
                                if isinstance(tree, dict) else None)
        snap = sckpt.load_sharded(model_path, {
            "params": {n: None for n, _ in self.model.named_parameters()},
            "buffers": {n: None for n, _ in self.model.named_buffers()}})
        for part in snap.values():      # import_tree_state reads numpy
            for n, v in part.items():
                if torch.is_tensor(v):
                    part[n] = v.float().numpy()
        st = sckpt.load_sharded(state_path, {"optim": none_of(opt_state)})
        with open(os.path.join(state_path, "driver.json")) as f:
            st["driver"] = json.load(f)
        return snap, st

    def _restore_rng(self, marker: Dict) -> None:
        """The dropout generators' states, from the marker's ``rng``."""
        states = (marker.get("rng") or {}).get("dropout") or []
        drops = self._dropouts()
        if states and len(states) != len(drops):
            raise ValueError(f"the snapshot recorded {len(states)} dropout "
                             f"generators, the model has {len(drops)}")
        for m, state in zip(drops, states):
            if state is not None:
                m.generator(self.device).set_state(
                    torch.tensor(state, dtype=torch.uint8))

    def _rng_record(self) -> Dict[str, Any]:
        """The marker's ``rng`` entry: each dropout generator's state
        (None while it has drawn nothing) and the seed they started from.
        The dataset's shuffles are replayed from its own seed."""
        return {"seed": self.seed,
                "dropout": [None if m._generator is None
                            else m._generator.get_state().tolist()
                            for m in self._dropouts()]}

    def _save_checkpoint(self, opt_state: Dict, driver_state: Dict) -> None:
        """``model[.N]`` and ``state[.N]`` as host numpy (one wait for the
        card's copies), then the RESUME marker, written last."""
        if self.checkpoint_path is None:
            return
        tag = "" if self.is_overwrite else f".{int(driver_state['neval'])}"
        model_path = file_io.join(self.checkpoint_path, f"model{tag}")
        state_path = file_io.join(self.checkpoint_path, f"state{tag}")
        model_tree, optim_tree = self._checkpoint_trees(opt_state)
        if self._ckpt_sharded:
            sckpt.save_sharded(model_path, model_tree)
            sckpt.save_sharded(state_path, {"optim": optim_tree})
            self._barrier()   # every rank's shard files are in place
            if not self._writes_checkpoint():
                return
            with open(os.path.join(state_path, "driver.json"), "w") as f:
                json.dump({k: (v.item() if hasattr(v, "item") else v)
                           for k, v in driver_state.items()}, f)
            files = {"model": coordinator.sharded_digests(model_path),
                     "state": coordinator.sharded_digests(state_path)}
        else:
            if not self._writes_checkpoint():
                return
            host = file_io.to_host({
                "model": model_tree,
                "state": {"optim": optim_tree, "driver": dict(driver_state)}})
            files = {"model": file_io.save(host["model"], model_path),
                     "state": file_io.save(host["state"], state_path)}
        if "://" not in self.checkpoint_path and self._loop_cursor:
            cursor = self._loop_cursor
            coordinator.write_marker(
                state_path, step=int(driver_state["neval"]),
                epoch=int(driver_state["epoch"]), rng=self._rng_record(),
                epoch_batches=cursor["epoch_batches"],
                epoch_records=cursor["epoch_records"],
                mesh=self._mesh_descriptor(),
                cursor_epoch=cursor["epoch"], files=files)
        logger.info("[Checkpoint] saved model%s to %s", tag,
                    self.checkpoint_path)

    # --------------------------------------------- the distributed seams
    def _init_opt_state(self, params: Tensors) -> Dict:
        return self.optim_method.init_state(params)

    def _load_opt_state(self, opt_state: Dict, loaded: Dict) -> None:
        """A snapshot's optim state into this run's, in place."""
        _load_into(opt_state, loaded)

    def _step_context(self):
        """Entered around each step's forward and backward."""
        return contextlib.nullcontext()

    def _apply_grads(self, grads: Tensors, opt_state: Dict, params: Tensors,
                     clip: Callable, scalars=None) -> None:
        """Clip and update in place."""
        grads = clip(grads)
        if scalars is None:
            self.optim_method.update(grads, opt_state, params)
        else:
            self.optim_method.update(grads, opt_state, params, scalars)

    def _step_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss a step reports."""
        return loss

    def _epoch_limit(self) -> Optional[int]:
        """The iterations the next epoch may take (None: all its
        batches); asked before the epoch's first batch is read."""
        return None

    def _checkpoint_trees(self, opt_state: Dict):
        """(model tree, optim tree) a snapshot writes."""
        model = self.model
        return ({"params": dict(model.named_parameters()),
                 "buffers": dict(model.named_buffers())}, opt_state)

    def _writes_checkpoint(self) -> bool:
        """Does this process write the snapshot files and marker?"""
        return True

    def _barrier(self) -> None:
        pass

    def _mesh_descriptor(self) -> Dict[str, Any]:
        return coordinator.current_mesh_descriptor()

    def _evaluate_validation(self):
        """(results, record count) of the validation set."""
        if self._fwd is None:
            self._fwd = tracked_jit(self.model, site="train.forward")
        with evaluating(self.model):
            return evaluate_batches(
                self._fwd, self.validation_dataset.data(train=False),
                self.validation_methods, self.device, cache=self._eval_cache)

    def _should_preempt(self, handler: PreemptionHandler, neval: int) -> bool:
        return handler.should_snapshot()

    def _batch_records(self, batch) -> int:
        """The records an iteration on ``batch`` trains."""
        return batch.size()

    def _end_training(self) -> None:
        """Run once when the loop ends, however it ends."""

    def _preempt_snapshot(self, opt_state: Dict, driver_state: Dict) -> None:
        """End-of-step preemption: one final snapshot and RESUME marker,
        then ``TrainingPreempted`` (never retried in process)."""
        handler = self._preemption
        reason = (handler.reason if handler is not None and handler.reason
                  else "preempted")
        if handler is not None:
            handler.run_drain_hooks()
        snap_path = None
        if self.checkpoint_path is not None:
            t0 = time.time()
            with span("resilience.snapshot"):
                self._save_checkpoint(opt_state, driver_state)
            elapsed = time.time() - t0
            instruments(get_registry()).resilience_snapshot_seconds \
                .observe(elapsed)
            tag = ("" if self.is_overwrite
                   else f".{int(driver_state['neval'])}")
            snap_path = file_io.join(self.checkpoint_path, f"model{tag}")
            logger.warning(
                "[Preempted] %s: snapshot %s written in %.2fs (grace "
                "remaining %.1fs); relaunch with auto_resume() to continue",
                reason, snap_path, elapsed,
                handler.remaining_grace() if handler is not None
                else float("inf"))
        else:
            logger.warning("[Preempted] %s: no checkpoint path configured; "
                           "stopping WITHOUT a snapshot", reason)
        raise TrainingPreempted(reason, snap_path)

    # ---------------------------------------------------------------- hooks
    def _hooks(self, opt_state: Dict, driver_state: Dict,
               flush: Optional[Callable] = None) -> None:
        if (self.validation_trigger is not None
                and self.validation_trigger(driver_state)):
            self._validate(driver_state)
        if (self.checkpoint_trigger is not None
                and self.checkpoint_trigger(driver_state)):
            if flush is not None:
                flush()  # the snapshot's trainingLoss is then exact
            self._save_checkpoint(opt_state, driver_state)

    def _summarize_parameters(self, neval: int) -> None:
        """``add_histogram`` of every parameter (reference
        ``_summarize_parameters``), tagged ``Parameters/<name>`` with the
        module path's dots as slashes."""
        for name, p in self.model.named_parameters():
            self.train_summary.add_histogram(
                "Parameters/" + name.replace(".", "/"),
                p.detach().float().cpu().numpy(), neval)

    def _validate(self, driver_state: Dict) -> None:
        if self.validation_dataset is None:
            return
        t0 = time.time()
        with span("train.validate"):
            results, count = self._evaluate_validation()
        elapsed = time.time() - t0
        self.metrics.add("validation time", elapsed)
        self._train_instruments().validation.observe(elapsed)
        logger.info("[Validation] %d records in %.3fs. Throughput is %.1f "
                    "records/s", count, elapsed, count / max(elapsed, 1e-9))
        for i, (m, r) in enumerate(zip(self.validation_methods, results)):
            if r is None:
                continue
            logger.info("%s is %s", m.name, r)
            value = r.result()[0]
            if i == 0:
                # 'score' (Trigger.max_score) tracks the FIRST method
                driver_state["score"] = value
            if self.validation_summary is not None:
                self.validation_summary.add_scalar(
                    m.name, value, int(driver_state["neval"]) - 1)
        self.validation_history.append({
            "neval": int(driver_state["neval"]), "records": count,
            "seconds": elapsed,
            "results": {m.name: r for m, r in zip(self.validation_methods,
                                                  results)}})

    # ----------------------------------------------------------------- loop
    def _run_training(self, resume) -> torch.nn.Module:
        model, dev, policy = self.model, self.device, self.precision
        params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        opt_state = self._init_opt_state(params)
        clip = make_grad_clipper(self._grad_clip)
        driver_state: Dict[str, Any] = {"epoch": 1, "neval": 1}
        driver_state.update(self.state)
        self._seed_dropout()
        resume_cursor = None
        if resume:
            marker = self._resume_state(resume, opt_state, driver_state)
            if marker is not None:
                # bit-exact mid-epoch restart: the generators' states,
                # the shuffles a fresh process has not made (the dataset
                # draws them from its own seed), and the batches the saved
                # epoch already trained on
                self._restore_rng(marker)
                for _ in range(int(driver_state["epoch"]) - 1):
                    self.dataset.shuffle()
                resume_cursor = dict(marker.get("cursor") or {})
        self._loop_cursor = None
        triggers = [t for t in (self.end_when, self.validation_trigger,
                                self.checkpoint_trigger) if t is not None]
        summary = self.train_summary
        # the reference's parameter-histogram trigger
        ptrig = (summary.get_summary_trigger("Parameters")
                 if hasattr(summary, "get_summary_trigger") else None)
        uses_loss = any(getattr(t, "uses_loss", False) for t in triggers)
        k_max = self._steps_per_dispatch
        # windows are bounded by PROBING every trigger at simulated nevals;
        # a trigger that reads the loss needs each loss on the host, and
        # one that may latch state would be corrupted by probes
        can_window = (k_max > 1 and not uses_loss
                      and self.supports_multi_dispatch
                      and all(getattr(t, "probe_safe", False)
                              for t in triggers + [ptrig] if t is not None))
        chaos_injectors = getattr(self, "_chaos_live", list(self._chaos))
        handler = self._preemption
        graphs: Dict[tuple, _WindowGraph] = {}   # one per window shape
        was_training = model.training
        model.train()
        wall_start = time.time()
        pending = None     # the dispatched window awaiting its losses
        last_done = None   # when the previous window's losses landed
        tm = self._train_instruments()

        def release():
            for p in params.values():
                p.grad = None

        recompute = (remat.Recompute(
            model, "conv" if self._remat == "conv" else None)
            if self._remat else None)

        # the parameters' regularizers (w_regularizer / b_regularizer): their
        # loss of the f32 masters joins the training loss, not the logged one
        regs = [(params[n], r) for n, r in named_regularizers(model)
                if n in params]

        def step(data, labels, scalars=None) -> torch.Tensor:
            release()
            with self._step_context():
                p_c = policy.cast_params_for_compute(params)
                if recompute is None:
                    out = torch.func.functional_call(model, p_c, (data,))
                else:
                    out = torch.func.functional_call(
                        recompute, {f"model.{n}": t for n, t in p_c.items()},
                        (data,))
                loss = self.criterion.forward(out, labels).float()
                total = loss
                for p, reg in regs:
                    total = total + reg.loss(p)
                total.backward()
            # a parameter the loss does not reach (a fused conv's pre-BN
            # bias) has the reference's zero gradient
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                     for n, p in params.items()}
            self._apply_grads(grads, opt_state, params, clip, scalars)
            return self._step_loss(loss.detach())

        def dropout_generators():
            return [m._generator for m in model.modules()
                    if isinstance(m, Dropout) and m._generator is not None]

        # the tracked programs (telemetry.profiling): a compile is the first
        # call of a signature; a window's graph is an argument of its site,
        # so each new graph is one compile (its warm-up and capture)
        step_t = tracked_jit(step, site="train.step", count_flops=True)
        multi_t = tracked_jit(
            (lambda g, inputs, scalars: g(inputs, scalars)) if dev.type ==
            "cuda" else (lambda pairs: [step(d, l) for d, l in pairs]),
            site="train.multi_step", count_flops=True)
        multi_cached_t = tracked_jit(lambda g, inputs, scalars:
                                     g(inputs, scalars),
                                     site="train.multi_step_cached",
                                     count_flops=True)

        def dispatch(window):
            """Run a window; returns its losses (a list of tensors on the
            CPU, a ``_Fetched`` on a card) and the tracked program that
            ran it. On a card a window of more than one iteration replays
            its graph."""
            if dev.type != "cuda":
                pairs = [tuple(self._to_device(a) for a in (b.data, b.labels))
                         for b in window]
                if len(pairs) == 1:
                    return [step_t(*pairs[0])], step_t
                return multi_t(pairs), multi_t
            start = _Fetched.event()
            if len(window) == 1:
                # a cached batch's data and labels are device gathers
                return _Fetched(start, step_t(*(self._to_device(a) for a in (
                    window[0].data, window[0].labels))).reshape(1)), step_t
            count0 = opt_state["evalCounter"]
            rows = [self.optim_method.step_scalars(
                {**opt_state, "evalCounter": count0 + j})
                for j in range(len(window))]
            if (all(isinstance(b, CachedSliceBatch) for b in window)
                    and len({id(b.source) for b in window}) == 1):
                # the gathers run inside the graph: only the indices move
                src = window[0].source
                inputs = [torch.stack([b.idx for b in window])]
                key = ("cached", id(src), len(window), inputs[0].shape)
                batch = lambda bufs, j, s=src: (
                    s._x.index_select(0, bufs[0][j]),
                    s._y.index_select(0, bufs[0][j]))
                reads = (src._x, src._y)
                program = multi_cached_t
            else:
                inputs = [torch.stack([torch.as_tensor(a).cpu() for a in arrs])
                          for arrs in zip(*((b.data, b.labels)
                                            for b in window))]
                key = (len(window), *((t.shape, t.dtype) for t in inputs))
                batch = lambda bufs, j: (bufs[0][j], bufs[1][j])
                reads = ()
                program = multi_t
            if key not in graphs:
                graphs[key] = _WindowGraph(
                    step, release, len(window), inputs, batch, len(rows[0]),
                    dev, dropout_generators, (params, opt_state), reads)
            losses = program(graphs[key], inputs,
                             torch.tensor(rows, dtype=torch.float32))
            # the host's counter: the warm-up and the capture each ran the
            # update's Python k times, a replay runs none of it
            opt_state["evalCounter"] = count0 + len(window)
            return _Fetched(start, losses), program

        def flush():
            nonlocal pending, last_done
            if pending is None:
                return
            p, pending = pending, None
            fetched = p["losses"]
            t_sync = time.time()
            with span("train.sync", k=len(p["iters"])):   # waits for the device
                if isinstance(fetched, _Fetched):
                    fetched.done.synchronize()
                    losses = fetched.host.tolist()
                else:
                    losses = [float(x) for x in fetched]
            tm.sync.observe(time.time() - t_sync)
            done = time.time()
            # the interval between two completions is the window's time in
            # a steady state; the first window counts from its own start.
            # On a card both ends are device events: the host may look
            # later than the device finished
            if isinstance(fetched, _Fetched):
                base = p["after"] or fetched.start
                window_time = base.elapsed_time(fetched.done) / 1e3
            else:
                window_time = done - (last_done if last_done is not None
                                      and last_done > p["t0"] else p["t0"])
            last_done = done
            seconds = window_time / len(p["iters"])
            if p["iters"][0]["neval"] == 1:
                # the first window pays the sites' first calls (warm-up,
                # capture, FlopCounterMode): its time is no step's MFU
                self.metrics.add("compile and first-step time", window_time)
                tm.compiles.inc()
            else:
                m = profiling.mfu(p["fn"].last_flops, window_time)
                if m is not None:
                    tm.mfu.set(m)
            sample_device_memory(None, dev)
            for meta, loss in zip(p["iters"], losses):
                throughput = meta["records"] / max(seconds, 1e-9)
                tm.step.observe(seconds)
                tm.steps.inc()
                tm.records.inc(meta["records"])
                tm.rps.set(throughput)
                self.metrics.add("computing time average", seconds)
                driver_state["trainingLoss"] = loss
                if summary is not None:
                    summary.add_scalar("Loss", loss, meta["neval"])
                    summary.add_scalar("Throughput", throughput,
                                       meta["neval"])
                    if meta["lr"] is not None:
                        summary.add_scalar("LearningRate", meta["lr"],
                                           meta["neval"])
                logger.info(
                    "[Epoch %d %d/%d][Iteration %d][Wall %.3fs] Trained %d "
                    "records in %.4fs. Throughput is %.1f records/second. "
                    "Loss is %.5f.", meta["epoch"], meta["epoch_records"],
                    self.dataset.size(), meta["neval"], done - wall_start,
                    meta["records"], seconds, throughput, loss)
                self.history.append({"neval": meta["neval"],
                                     "epoch": meta["epoch"], "loss": loss,
                                     "seconds": seconds,
                                     "records": meta["records"]})

        def probe(trigger, neval_at: int) -> bool:
            """``trigger`` at a simulated neval of this epoch."""
            return bool(trigger({**driver_state, "neval": neval_at}))

        def extension_ok(neval0: int, j: int) -> bool:
            """May the window grow to hold iteration neval0 + j? Iteration
            neval0 + j - 1 then loses its hook slot, so no trigger may fire
            at neval0 + j, and neither the parameter summary nor an
            injector at neval0 + j - 1."""
            if any(probe(t, neval0 + j) for t in triggers):
                return False
            if ptrig is not None and probe(ptrig, neval0 + j - 1):
                return False
            return not any(getattr(inj, "fires_at", lambda n: False)(
                neval0 + j - 1) for inj in chaos_injectors)

        profiler = _WindowProfiler(self._profile, model, dev)
        try:
            stop = False
            while not stop and not self.end_when(driver_state):
                self.dataset.shuffle()
                epoch = int(driver_state["epoch"])
                opt_state["epoch"] = epoch
                epoch_start = time.time()
                epoch_records = epoch_batches = 0
                data_wait = 0.0
                t_data = time.time()
                limit = self._epoch_limit()
                self._live_data_iter = iter(self.dataset.data(train=True))
                batches = (self._live_data_iter if limit is None else
                           itertools.islice(self._live_data_iter, limit))
                if (resume_cursor is not None
                        and int(resume_cursor.get("epoch", -1)) == epoch):
                    # past the batches the snapshot's epoch trained on
                    skip = int(resume_cursor.get("epoch_batches", 0))
                    for _ in range(skip):
                        if next(batches, None) is None:
                            break
                    epoch_batches = skip
                    epoch_records = int(resume_cursor.get("epoch_records", 0))
                resume_cursor = None   # the first resumed epoch only
                for batch in batches:
                    window = [batch]
                    neval0 = int(driver_state["neval"])
                    # grow while no hook would fire inside the window; the
                    # epoch's iterator ends it at the epoch's end
                    while (can_window and len(window) < k_max
                           and extension_ok(neval0, len(window))):
                        nxt = next(batches, None)
                        if nxt is None:
                            break
                        window.append(nxt)
                    dw = time.time() - t_data
                    data_wait += dw
                    tm.data_wait.observe(dw)
                    last_neval = neval0 + len(window) - 1
                    profiler.begin(neval0, last_neval)
                    t0 = time.time()
                    # the window in flight, whose completion starts this one's
                    # time (None: this one starts from its own dispatch)
                    after = (pending["losses"].done if pending is not None
                             and isinstance(pending["losses"], _Fetched)
                             else None)
                    with span("train.dispatch", k=len(window)), \
                            profiler.window(neval0, last_neval):
                        losses, program = dispatch(window)
                    tm.dispatch.observe(time.time() - t0)
                    flush()   # the previous window's losses
                    # one rate a window, read after its updates, as the
                    # reference snapshots it
                    lr = (float(self.optim_method.current_rate(opt_state))
                          if summary is not None and hasattr(
                              self.optim_method, "current_rate") else None)
                    iters = []
                    for j, b in enumerate(window):
                        records = self._batch_records(b)
                        epoch_records += records
                        iters.append({"neval": neval0 + j, "epoch": epoch,
                                      "records": records,
                                      "epoch_records": epoch_records,
                                      "lr": lr})
                    pending = {"losses": losses, "iters": iters, "t0": t0,
                               "after": after, "fn": program}
                    profiler.end(last_neval)
                    # the window's last iteration has the hook slot
                    driver_state["neval"] = last_neval
                    if ptrig is not None and ptrig(driver_state):
                        self._summarize_parameters(last_neval)
                    driver_state["neval"] = last_neval + 1
                    epoch_batches += len(window)
                    # the data cursor a snapshot at this boundary records
                    self._loop_cursor = {"epoch": epoch,
                                         "epoch_batches": epoch_batches,
                                         "epoch_records": epoch_records}
                    if uses_loss:
                        flush()
                    self._hooks(opt_state, driver_state, flush)
                    for inj in chaos_injectors:
                        inj.on_step(last_neval)
                    if handler is not None:
                        fresh = handler.drain_notices()
                        if fresh:
                            instruments(get_registry()) \
                                .resilience_preemptions_total.inc(fresh)
                        if self._should_preempt(handler, last_neval):
                            flush()
                            self._preempt_snapshot(opt_state, driver_state)
                    if self.end_when(driver_state):
                        stop = True
                        break
                    t_data = time.time()
                flush()
                self._close_data_iter()
                self.metrics.add("data wait time", data_wait)
                logger.info("[Epoch %d] Epoch finished. Wall clock time is "
                            "%.1f ms (%d records)", epoch,
                            (time.time() - epoch_start) * 1e3, epoch_records)
                driver_state["epoch"] = epoch + 1
                self._hooks(opt_state, driver_state)
        finally:
            profiler.close()
            for g in graphs.values():
                g.close()
            release()
            self._end_training()
            model.train(was_training)
        return model
