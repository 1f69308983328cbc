"""Batch evaluation and prediction (counterpart of
``bigdl_tpu/optim/evaluator.py``: ``evaluate_batches``, ``Evaluator`` and
``Predictor``).

``evaluate_batches`` is the one batch-eval loop; ``Evaluator``,
``Predictor`` and the training loop's validation delegate to it. It runs
the model in eval mode under ``torch.no_grad()`` and restores its mode
afterwards. Each batch's (value, count) pairs are added to an (M,) f32
value and an (M,) int64 count accumulator ON THE DEVICE; the host reads
them once per evaluation, not once per batch.

The programs are tracked sites (``telemetry.profiling``): a full batch goes
through ``eval.scorer`` (the forward and the device-side scoring; cached
per forward and methods in the caller's ``cache``), ``Evaluator``'s forward
is ``eval.forward`` and the training loop's validation forward
``train.forward``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Iterable, List, Optional, Sequence, Tuple

import torch

from bigdl_tpu_torch.dataset.base import (AbstractDataSet, LocalDataSet,
                                          MiniBatch, Sample, SampleToBatch)
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult)
from bigdl_tpu_torch.telemetry import get_registry, instruments, span
from bigdl_tpu_torch.telemetry.profiling import tracked_jit
from bigdl_tpu_torch.utils.device import DeviceLike, check_module_device


def _as_minibatch(item) -> MiniBatch:
    if isinstance(item, Sample):
        return MiniBatch(item.feature[None], item.label.reshape(-1))
    return item


def _device_batch(array, device: torch.device) -> torch.Tensor:
    t = torch.as_tensor(array)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


def evaluate_batches(fwd: Callable[[torch.Tensor], torch.Tensor],
                     batches: Iterable,
                     v_methods: Sequence[ValidationMethod],
                     device: torch.device, cache: Optional[dict] = None,
                     ) -> Tuple[List[Optional[ValidationResult]], int]:
    """Run ``fwd(data)`` over batches, merging each method's results.
    Returns (results, record count). The caller puts the model in eval
    mode under ``torch.no_grad()`` (``evaluating``).

    A tail batch smaller than the first is zero-padded to the first's
    shape before ``fwd`` and its padded rows are sliced off the output
    before scoring: every record is evaluated once, at one shape.
    A method that overrides only ``apply`` (no device-side
    ``batch_result``) is scored per batch on the host.

    Telemetry: ``bigdl_eval_batches_total``, ``bigdl_eval_records_total``
    and a per-batch host wall-clock histogram; the call traces as one
    ``eval.batches`` span. ``cache`` (a dict the caller keeps) holds the
    ``eval.scorer`` site between calls with the same ``fwd`` and
    methods."""
    with span("eval.batches", methods=len(v_methods)):
        return _evaluate_batches(fwd, batches, v_methods, device, cache)


def _evaluate_batches(fwd, batches, v_methods, device, cache):
    tm = instruments(get_registry())
    results: List[Optional[ValidationResult]] = [None] * len(v_methods)
    on_device = [type(m).batch_result is not ValidationMethod.batch_result
                 for m in v_methods]
    acc_v = torch.zeros(len(v_methods), dtype=torch.float32, device=device)
    acc_c = torch.zeros(len(v_methods), dtype=torch.int64, device=device)

    def score(out, labels, acc_v, acc_c):
        for i, m in enumerate(v_methods):
            if on_device[i]:
                v, c = m.batch_result(out, labels)
                acc_v[i] += v.float()
                acc_c[i] += c

    def forward_and_score(data, labels, acc_v, acc_c):
        out = fwd(data)
        score(out, labels, acc_v, acc_c)
        return out

    key = (id(fwd), tuple(id(m) for m in v_methods))
    scorer = cache.get(key) if cache is not None else None
    if scorer is None:
        scorer = tracked_jit(forward_and_score, site="eval.scorer")
        if cache is not None:
            cache.clear()   # one entry: another fwd or methods replace it
            cache[key] = scorer
    count, n_batches, full_bs, sliceable = 0, 0, None, False
    for item in batches:
        t_batch = time.perf_counter()
        n_batches += 1
        batch = _as_minibatch(item)
        n = batch.size()
        data = _device_batch(batch.data, device)
        labels = _device_batch(batch.labels, device)
        if full_bs is None:
            full_bs = n
        if n < full_bs and sliceable:
            pad = torch.zeros((full_bs - n, *data.shape[1:]),
                              dtype=data.dtype, device=device)
            out = fwd(torch.cat([data, pad]))[:n]
            score(out, labels, acc_v, acc_c)
        else:   # a structured output is scored at the exact shape
            # graftlint: ignore[JG019] -- acc_v/acc_c are sized by the validation methods' count, fixed for the whole pass (not traffic)
            out = scorer(data, labels, acc_v, acc_c)
            sliceable = torch.is_tensor(out)
        for i, m in enumerate(v_methods):
            if not on_device[i]:
                r = m.apply(out, labels)
                results[i] = r if results[i] is None else results[i] + r
        count += n
        tm.eval_batch_seconds.observe(time.perf_counter() - t_batch)
    tm.eval_batches_total.inc(n_batches)
    tm.eval_records_total.inc(count)
    if n_batches and any(on_device):
        vals, counts = acc_v.tolist(), acc_c.tolist()   # the ONE host read
        for i, m in enumerate(v_methods):
            if on_device[i]:
                results[i] = m.to_result(vals[i], counts[i])
    return results, count


@contextlib.contextmanager
def evaluating(model: torch.nn.Module):
    """``model`` in eval mode under ``torch.no_grad()``; its train/eval mode
    is restored on exit."""
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield model
    finally:
        model.train(was_training)


class Evaluator:
    """reference ``Evaluator``: ``test(dataset, methods)`` on ``device``
    (default ``"cuda"``; the model must live there)."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 128, *,
                 device: DeviceLike = "cuda"):
        self.device = check_module_device(model, device)
        self.model = model
        self.batch_size = batch_size
        self._eval_cache: dict = {}   # the eval.scorer site, kept
        self._fwd = tracked_jit(model, site="eval.forward")

    def _as_batches(self, dataset):
        if isinstance(dataset, AbstractDataSet):
            return dataset.data(train=False)
        # a list of Samples: batch them, keeping the short tail
        ds = LocalDataSet(dataset) >> SampleToBatch(self.batch_size,
                                                    drop_remainder=False)
        return ds.data(train=False)

    def test(self, dataset, v_methods: Sequence[ValidationMethod]
             ) -> List[Tuple[ValidationResult, ValidationMethod]]:
        with evaluating(self.model):
            results, _ = evaluate_batches(self._fwd, self._as_batches(dataset),
                                          v_methods, self.device,
                                          cache=self._eval_cache)
        return [(r, m) for r, m in zip(results, v_methods)]


class Predictor:
    """reference ``Predictor``: the model's eval-mode outputs per batch."""

    def __init__(self, model: torch.nn.Module, batch_size: int = 128, *,
                 device: DeviceLike = "cuda"):
        self.evaluator = Evaluator(model, batch_size, device=device)

    def predict(self, dataset) -> List[torch.Tensor]:
        ev = self.evaluator
        with evaluating(ev.model) as model:
            return [model(_device_batch(_as_minibatch(item).data, ev.device))
                    for item in ev._as_batches(dataset)]

    def predict_class(self, dataset) -> List[torch.Tensor]:
        """1-based classes, as the reference's."""
        return [o.argmax(dim=-1) + 1 for o in self.predict(dataset)]
