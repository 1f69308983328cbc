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

The loss reaches the host ONE ITERATION LATE, as in the reference's
pipelined ``flush``: iteration i's loss is fetched after iteration i+1 has
been queued on the device, so the host's launch work overlaps the device's
compute. An end trigger that reads the loss (``Trigger.min_loss``) makes
the loop fetch each loss before it checks the trigger.
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
                                      "yet: ROADMAP A6 (distributed plane)")
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

    # ------------------------------------------------------------ not ported
    def set_validation(self, *args, **kwargs):
        _not_ported("set_validation", "A7 (validation with checkpointing)")

    def set_checkpoint(self, *args, **kwargs):
        _not_ported("set_checkpoint", "A7 (checkpoint and resume)")

    def resume(self, *args, **kwargs):
        _not_ported("resume", "A7 (checkpoint and resume)")

    def auto_resume(self, *args, **kwargs):
        _not_ported("auto_resume", "A7 (checkpoint and resume)")

    def set_remat(self, *args, **kwargs):
        _not_ported("set_remat", "A3 (performance items)")

    def set_steps_per_dispatch(self, k: int) -> "Optimizer":
        if int(k) != 1:
            _not_ported("set_steps_per_dispatch(k > 1)",
                        "A3 (performance items)")
        return self

    def set_preemption_handler(self, *args, **kwargs):
        _not_ported("set_preemption_handler", "A7 (resilience)")

    def set_chaos(self, *args, **kwargs):
        _not_ported("set_chaos", "A7 (resilience)")

    def set_profiling(self, *args, **kwargs):
        _not_ported("set_profiling", "A7 (telemetry)")

    def set_train_summary(self, *args, **kwargs):
        _not_ported("set_train_summary", "A7 (telemetry)")

    def set_validation_summary(self, *args, **kwargs):
        _not_ported("set_validation_summary", "A7 (telemetry)")

    def optimize(self) -> torch.nn.Module:
        raise NotImplementedError


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
        self._seed_dropout()
        was_training = model.training
        model.train()
        wall_start = time.time()
        pending: List[Dict] = []   # at most one iteration awaiting its loss
        last_done = None           # when the previous iteration's loss landed

        def flush():
            nonlocal last_done
            if not pending:
                return
            meta = pending.pop()
            loss = float(meta.pop("loss"))   # waits for the device
            done = time.time()
            # the interval between two completions is the step's time in a
            # steady state; the first iteration counts from its own start
            seconds = done - (last_done if last_done is not None
                              and last_done > meta["t0"] else meta["t0"])
            last_done = done
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

        try:
            stop = False
            while not stop and not self.end_when(driver_state):
                self.dataset.shuffle()
                epoch = int(driver_state["epoch"])
                opt_state["epoch"] = epoch
                epoch_start = time.time()
                epoch_records = 0
                for batch in self.dataset.data(train=True):
                    t0 = time.time()
                    data, labels = (self._to_device(a)
                                    for a in (batch.data, batch.labels))
                    for p in params.values():
                        p.grad = None
                    out = torch.func.functional_call(
                        model, policy.cast_params_for_compute(params),
                        (data,))
                    loss = self.criterion.forward(out, labels).float()
                    loss.backward()
                    grads = clip({n: p.grad for n, p in params.items()})
                    self.optim_method.update(grads, opt_state, params)
                    epoch_records += batch.size()
                    flush()   # the previous iteration's loss
                    pending.append({"loss": loss.detach(), "t0": t0,
                                    "neval": driver_state["neval"],
                                    "epoch": epoch,
                                    "records": batch.size(),
                                    "epoch_records": epoch_records})
                    driver_state["neval"] += 1
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
            for p in params.values():
                p.grad = None
            model.train(was_training)
        return model
