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
"""

from __future__ import annotations

import logging
import time
from typing import Callable, Dict, List

import torch

from bigdl_tpu_torch.dataset.base import AbstractDataSet
from bigdl_tpu_torch.nn.criterion import Criterion
from bigdl_tpu_torch.nn.regularization import Dropout
from bigdl_tpu_torch.optim.methods import SGD, OptimMethod
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.ops.precision import DtypePolicy
from bigdl_tpu_torch.telemetry.tracing import span
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
        #: one entry per trained iteration: neval, epoch, loss, seconds
        #: (time between two iterations' completions), records
        self.history: List[Dict] = []

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

    # ------------------------------------------------------------ not ported
    def set_validation(self, *args, **kwargs):
        _not_ported("set_validation", "A.5 (validation with checkpointing)")

    def set_checkpoint(self, *args, **kwargs):
        _not_ported("set_checkpoint", "A.5 (checkpoint and resume)")

    def resume(self, *args, **kwargs):
        _not_ported("resume", "A.5 (checkpoint and resume)")

    def auto_resume(self, *args, **kwargs):
        _not_ported("auto_resume", "A.5 (checkpoint and resume)")

    def set_remat(self, *args, **kwargs):
        _not_ported("set_remat", "A.3 (performance items)")

    def set_preemption_handler(self, *args, **kwargs):
        _not_ported("set_preemption_handler", "A.5 (resilience)")

    def set_chaos(self, *args, **kwargs):
        _not_ported("set_chaos", "A.5 (resilience)")

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

    def _seed_dropout(self) -> None:
        for i, m in enumerate(self.model.modules()):
            if isinstance(m, Dropout):
                m.manual_seed(self.seed + i)

    def optimize(self) -> torch.nn.Module:
        """Train until ``end_when`` fires; returns the model, whose
        parameters were updated in place and whose train/eval mode is
        restored."""
        model, dev, policy = self.model, self.device, self.precision
        params = {n: p for n, p in model.named_parameters() if p.requires_grad}
        opt_state = self.optim_method.init_state(params)
        clip = make_grad_clipper(self._grad_clip)
        driver_state = {"epoch": 1, "neval": 1}
        uses_loss = getattr(self.end_when, "uses_loss", False)
        k_max = self._steps_per_dispatch
        # windows are bounded by PROBING the end trigger at simulated
        # nevals; a trigger that reads the loss needs each loss on the
        # host, and one that may latch state would be corrupted by probes
        can_window = (k_max > 1 and not uses_loss
                      and getattr(self.end_when, "probe_safe", False))
        graphs: Dict[tuple, _WindowGraph] = {}   # one per window shape
        self._seed_dropout()
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
            grads = clip({n: p.grad for n, p in params.items()})
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

        def probe(neval_at: int) -> bool:
            """The end trigger at a simulated neval of this epoch."""
            return bool(self.end_when({**driver_state, "neval": neval_at}))

        try:
            stop = False
            while not stop and not self.end_when(driver_state):
                self.dataset.shuffle()
                epoch = int(driver_state["epoch"])
                opt_state["epoch"] = epoch
                epoch_start = time.time()
                epoch_records = 0
                batches = iter(self.dataset.data(train=True))
                for batch in batches:
                    window = [batch]
                    neval0 = int(driver_state["neval"])
                    # grow while no end would fire inside the window; the
                    # epoch's iterator ends it at the epoch's end
                    while (can_window and len(window) < k_max
                           and not probe(neval0 + len(window))):
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
                    driver_state["neval"] = neval0 + len(window)
                    if uses_loss:
                        flush()
                    if self.end_when(driver_state):
                        stop = True
                        break
                flush()
                logger.info("[Epoch %d] Epoch finished. Wall clock time is "
                            "%.1f ms (%d records)", epoch,
                            (time.time() - epoch_start) * 1e3, epoch_records)
                driver_state["epoch"] = epoch + 1
        finally:
            for g in graphs.values():
                g.close()
            release()
            model.train(was_training)
        return model
