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
device's compute. An end trigger that reads the loss (``Trigger.min_loss``)
makes the loop fetch each loss before it checks the trigger.

``set_steps_per_dispatch(k)`` groups up to k iterations into one window
(the reference's ``train.multi_step``, a ``lax.scan`` over k stacked
batches). On a card a window of more than one iteration is one replay of a
CUDA graph of k steps (``_WindowGraph``; one graph per window length, the
first window of each length its eager warm-up); its k losses come back in
one host read. On the CPU the window's iterations run eagerly one by one,
so k changes no number there. Windows of 1, and ``k = 1``, run the eager
step. The ``train.dispatch`` and ``train.sync`` spans mark the reference's
sites.

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
``BIGDL_FAILURE_RETRY_INTERVAL`` seconds).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.dataset.base import AbstractDataSet
from bigdl_tpu_torch.interop.state_dict import import_tree_state
from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.nn.regularization import Dropout
from bigdl_tpu_torch.optim.evaluator import evaluate_batches, evaluating
from bigdl_tpu_torch.optim.methods import SGD, OptimMethod
from bigdl_tpu_torch.optim.metrics import Metrics
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.optim.validation import ValidationMethod
from bigdl_tpu_torch.ops.precision import DtypePolicy
from bigdl_tpu_torch.resilience import chaos as chaos_mod
from bigdl_tpu_torch.resilience import coordinator
from bigdl_tpu_torch.resilience.preemption import (PreemptionHandler,
                                                   TrainingPreempted)
from bigdl_tpu_torch.telemetry import get_registry, instruments
from bigdl_tpu_torch.telemetry.tracing import span
from bigdl_tpu_torch.utils import file_io
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


def _not_ported(what: str, item: str):
    raise NotImplementedError(f"Optimizer.{what} is not ported yet: ROADMAP "
                              f"{item}")


class Optimizer:
    """Facade (reference ``Optimizer``): ``Optimizer(model, dataset,
    criterion, device=...)`` yields a ``LocalOptimizer``.

    ``device`` defaults to ``"cuda"`` and must be where the model lives; the
    batches are moved there. ``seed`` seeds every ``Dropout`` of the model
    (module i of ``model.modules()`` gets ``seed + i``)."""

    def __new__(cls, model=None, dataset=None, criterion=None, **kwargs):
        if dataset is not None and dataset.is_distributed():
            raise NotImplementedError("distributed training is not ported "
                                      "yet: ROADMAP A.4 (distributed plane)")
        if cls is Optimizer:
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
        #: one entry per trained iteration: neval, epoch, loss, seconds
        #: (time between two iterations' completions), records
        self.history: List[Dict] = []
        #: one entry per validation: neval (the driver's, as the trigger
        #: saw it), records, seconds, and {method name: ValidationResult}
        self.validation_history: List[Dict] = []

    # ---------------------------------------------------------------- builder
    def set_optim_method(self, method: OptimMethod) -> "Optimizer":
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
        under ``path`` whenever ``trigger`` fires."""
        if sharded:
            raise NotImplementedError(
                f"Optimizer.set_checkpoint(sharded=True): "
                f"{coordinator.SHARDED_WAITS}")
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

    # ------------------------------------------------------------ not ported
    def set_remat(self, *args, **kwargs):
        _not_ported("set_remat", "A.3 (performance items)")

    def set_profiling(self, *args, **kwargs):
        _not_ported("set_profiling", "A.5 (telemetry)")

    def set_train_summary(self, *args, **kwargs):
        _not_ported("set_train_summary", "A.5 (telemetry)")

    def set_validation_summary(self, *args, **kwargs):
        _not_ported("set_validation_summary", "A.5 (telemetry)")

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
    reference's ``train.multi_step``): ``step`` k times over static (k, B,
    ...) data and label buffers and a (k, n) buffer of the optim method's
    ``step_scalars``, then every gradient released; its output is the (k,)
    losses. Each call fills the buffers with one pinned, non-blocking copy
    apiece and runs the program (the first call is its eager warm-up, then
    the capture; see ``utils/cuda_graph.py``); it returns a copy of the
    losses."""

    def __init__(self, step: Callable, release: Callable, k: int,
                 data: torch.Tensor, labels: torch.Tensor, n_scalars: int,
                 device: torch.device, generators: Callable, state):
        self.data = torch.empty(data.shape, dtype=data.dtype, device=device)
        self.labels = torch.empty(labels.shape, dtype=labels.dtype,
                                  device=device)
        self.scalars = torch.empty((k, n_scalars), dtype=torch.float32,
                                   device=device)

        def body():
            losses = [step(self.data[j], self.labels[j], self.scalars[j])
                      for j in range(k)]
            release()
            return torch.stack(losses)

        self.program = GraphedProgram(
            body, device, generators=generators,
            inputs=lambda: [self.data, self.labels, self.scalars,
                            *_tensors(state)])

    def __call__(self, data: torch.Tensor, labels: torch.Tensor,
                 scalars: torch.Tensor) -> torch.Tensor:
        for buf, host in ((self.data, data), (self.labels, labels),
                          (self.scalars, scalars)):
            buf.copy_(host.pin_memory(), non_blocking=True)
        # a copy: the losses are read one window late, after the next
        # replay has overwritten the graph's static output
        return self.program().clone()

    def close(self) -> None:
        self.program.close()


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
            v = torch.as_tensor(np.asarray(v))
            if tuple(v.shape) != tuple(d.shape):
                raise ValueError(f"snapshot {where}.{k}: shape "
                                 f"{tuple(v.shape)} != {tuple(d.shape)}")
            d.copy_(v)
        elif isinstance(d, dict):
            _load_into(d, v, f"{where}.{k}")
        else:
            dst[k] = v


class LocalOptimizer(Optimizer):
    """Single-card training loop (reference ``LocalOptimizer``)."""

    def _to_device(self, array) -> torch.Tensor:
        """A batch array on the training device. To a card it is copied
        from pinned memory without blocking: a pageable copy would wait for
        the whole stream and undo the one-step-late loss fetch."""
        t = torch.as_tensor(array)
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

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
        if coordinator.is_sharded(model_path):
            raise NotImplementedError(
                f"{model_path}: {coordinator.SHARDED_WAITS}")
        snap = file_io.load(model_path, device="cpu")
        st = file_io.load(state_path, device="cpu")
        if not (isinstance(snap, dict) and "params" in snap):
            raise ValueError(f"{model_path} is not a training snapshot "
                             "({'params', 'buffers'}); a saved module is "
                             "loaded with file_io.load")
        import_tree_state(self.model, snap["params"], snap.get("buffers", {}))
        with torch.no_grad():
            _load_into(opt_state, st["optim"])
        driver_state.update(st["driver"])
        elastic = coordinator.is_elastic(marker)
        instruments(get_registry()).resilience_resumes_total.labels(
            elastic="unknown" if elastic is None
            else ("true" if elastic else "false")).inc()
        logger.info("[Resume] from %s at epoch %s neval %s", model_path,
                    driver_state["epoch"], driver_state["neval"])
        return marker

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
        model = self.model
        host = file_io.to_host({
            "model": {"params": dict(model.named_parameters()),
                      "buffers": dict(model.named_buffers())},
            "state": {"optim": opt_state, "driver": dict(driver_state)}})
        model_path = file_io.join(self.checkpoint_path, f"model{tag}")
        state_path = file_io.join(self.checkpoint_path, f"state{tag}")
        files = {"model": file_io.save(host["model"], model_path),
                 "state": file_io.save(host["state"], state_path)}
        if "://" not in self.checkpoint_path and self._loop_cursor:
            cursor = self._loop_cursor
            coordinator.write_marker(
                state_path, step=int(driver_state["neval"]),
                epoch=int(driver_state["epoch"]), rng=self._rng_record(),
                epoch_batches=cursor["epoch_batches"],
                epoch_records=cursor["epoch_records"],
                mesh=coordinator.current_mesh_descriptor(),
                cursor_epoch=cursor["epoch"], files=files)
        logger.info("[Checkpoint] saved model%s to %s", tag,
                    self.checkpoint_path)

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

    def _validate(self, driver_state: Dict) -> None:
        if self.validation_dataset is None:
            return
        t0 = time.time()
        with span("train.validate"), evaluating(self.model) as model:
            results, count = evaluate_batches(
                model, self.validation_dataset.data(train=False),
                self.validation_methods, self.device)
        elapsed = time.time() - t0
        self.metrics.add("validation time", elapsed)
        instruments(get_registry()).train_validation_seconds.labels(
            mode="local").observe(elapsed)
        logger.info("[Validation] %d records in %.3fs. Throughput is %.1f "
                    "records/s", count, elapsed, count / max(elapsed, 1e-9))
        for i, (m, r) in enumerate(zip(self.validation_methods, results)):
            if r is None:
                continue
            logger.info("%s is %s", m.name, r)
            if i == 0:
                # 'score' (Trigger.max_score) tracks the FIRST method
                driver_state["score"] = r.result()[0]
        self.validation_history.append({
            "neval": int(driver_state["neval"]), "records": count,
            "seconds": elapsed,
            "results": {m.name: r for m, r in zip(self.validation_methods,
                                                  results)}})

    # ----------------------------------------------------------------- loop
    def _run_training(self, resume) -> torch.nn.Module:
        model, dev, policy = self.model, self.device, self.precision
        params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        opt_state = self.optim_method.init_state(params)
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
        uses_loss = any(getattr(t, "uses_loss", False) for t in triggers)
        k_max = self._steps_per_dispatch
        # windows are bounded by PROBING every trigger at simulated nevals;
        # a trigger that reads the loss needs each loss on the host, and
        # one that may latch state would be corrupted by probes
        can_window = (k_max > 1 and not uses_loss
                      and all(getattr(t, "probe_safe", False)
                              for t in triggers))
        chaos_injectors = getattr(self, "_chaos_live", list(self._chaos))
        handler = self._preemption
        graphs: Dict[tuple, _WindowGraph] = {}   # one per window shape
        was_training = model.training
        model.train()
        wall_start = time.time()
        pending = None     # the dispatched window awaiting its losses
        last_done = None   # when the previous window's losses landed

        def release():
            for p in params.values():
                p.grad = None

        def step(data, labels, scalars=None) -> torch.Tensor:
            release()
            out = torch.func.functional_call(
                model, policy.cast_params_for_compute(params), (data,))
            loss = self.criterion.forward(out, labels).float()
            loss.backward()
            # a parameter the loss does not reach (a fused conv's pre-BN
            # bias) has the reference's zero gradient
            grads = clip({n: p.grad if p.grad is not None
                          else torch.zeros_like(p)
                          for n, p in params.items()})
            if scalars is None:
                self.optim_method.update(grads, opt_state, params)
            else:
                self.optim_method.update(grads, opt_state, params, scalars)
            return loss.detach()

        def dropout_generators():
            return [m._generator for m in model.modules()
                    if isinstance(m, Dropout) and m._generator is not None]

        def dispatch(window):
            """Run a window; returns its losses (device tensors). On a card
            a window of more than one iteration replays its graph."""
            if len(window) == 1 or dev.type != "cuda":
                return [step(*(self._to_device(a)
                               for a in (b.data, b.labels))) for b in window]
            data = torch.stack([torch.as_tensor(b.data) for b in window])
            labels = torch.stack([torch.as_tensor(b.labels) for b in window])
            count0 = opt_state["evalCounter"]
            rows = [self.optim_method.step_scalars(
                {**opt_state, "evalCounter": count0 + j})
                for j in range(len(window))]
            key = (len(window), data.shape, data.dtype, labels.shape,
                   labels.dtype)
            if key not in graphs:
                graphs[key] = _WindowGraph(
                    step, release, len(window), data, labels, len(rows[0]),
                    dev, dropout_generators, (params, opt_state))
            losses = graphs[key](data, labels,
                                 torch.tensor(rows, dtype=torch.float32))
            # the host's counter: the warm-up and the capture each ran the
            # update's Python k times, a replay runs none of it
            opt_state["evalCounter"] = count0 + len(window)
            return losses

        def flush():
            nonlocal pending, last_done
            if pending is None:
                return
            p, pending = pending, None
            with span("train.sync", k=len(p["iters"])):   # waits for the device
                losses = p["losses"]
                losses = (losses.tolist() if torch.is_tensor(losses)
                          else [float(x) for x in losses])
            done = time.time()
            # the interval between two completions is the window's time in
            # a steady state; the first window counts from its own start
            window_time = done - (last_done if last_done is not None
                                  and last_done > p["t0"] else p["t0"])
            last_done = done
            seconds = window_time / len(p["iters"])
            for meta, loss in zip(p["iters"], losses):
                throughput = meta["records"] / max(seconds, 1e-9)
                driver_state["trainingLoss"] = loss
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
            at neval0 + j and no injector at neval0 + j - 1."""
            if any(probe(t, neval0 + j) for t in triggers):
                return False
            return not any(getattr(inj, "fires_at", lambda n: False)(
                neval0 + j - 1) for inj in chaos_injectors)

        try:
            stop = False
            while not stop and not self.end_when(driver_state):
                self.dataset.shuffle()
                epoch = int(driver_state["epoch"])
                opt_state["epoch"] = epoch
                epoch_start = time.time()
                epoch_records = epoch_batches = 0
                batches = iter(self.dataset.data(train=True))
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
                    t0 = time.time()
                    with span("train.dispatch", k=len(window)):
                        losses = dispatch(window)
                    flush()   # the previous window's losses
                    iters = []
                    for j, b in enumerate(window):
                        epoch_records += b.size()
                        iters.append({"neval": neval0 + j, "epoch": epoch,
                                      "records": b.size(),
                                      "epoch_records": epoch_records})
                    pending = {"losses": losses, "iters": iters, "t0": t0}
                    last_neval = neval0 + len(window) - 1
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
                        if handler.should_snapshot():
                            flush()
                            self._preempt_snapshot(opt_state, driver_state)
                    if self.end_when(driver_state):
                        stop = True
                        break
                flush()
                logger.info("[Epoch %d] Epoch finished. Wall clock time is "
                            "%.1f ms (%d records)", epoch,
                            (time.time() - epoch_start) * 1e3, epoch_records)
                driver_state["epoch"] = epoch + 1
                self._hooks(opt_state, driver_state)
        finally:
            for g in graphs.values():
                g.close()
            release()
            model.train(was_training)
        return model
