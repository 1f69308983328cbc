"""Loss criteria (counterpart of ``bigdl_tpu/nn/criterion.py``; every
class is ported).

A criterion's ``forward(input, target)`` returns a scalar loss tensor;
autograd gives the gradient (the reference's ``jax.grad`` of the same
function), and ``backward(input, target)`` returns it for the input. Class
targets are 1-based, as in Torch and BigDL. A table input or target is a
``utils.table.Table``, a list or a tuple (``ParallelCriterion``,
``MarginRankingCriterion``, ...).

One difference from the reference: ``MultiLabelMarginCriterion`` marks
every listed label, as Torch does. The reference's scatter writes the
padding zeros' "not a label" over class 1 and over any class whose index a
later entry repeats, so on a zero-padded target it scores class 1 (or
that class) as a non-label; on targets without zeros or repeats the two
agree.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from bigdl_tpu_torch.ops.lm_head_ce import fused_lm_head_ce
from bigdl_tpu_torch.utils.table import Table, elements


class Criterion:
    """Base criterion (reference ``AbstractCriterion``)."""

    def __init__(self):
        self.output = None

    def update_output(self, input, target) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, input, target) -> torch.Tensor:
        self.output = self.update_output(input, target)
        return self.output

    def __call__(self, input, target) -> torch.Tensor:
        return self.forward(input, target)

    def apply(self, input, target) -> torch.Tensor:
        """The loss with no state change (reference ``apply``)."""
        return self.update_output(input, target)

    def backward(self, input, target) -> torch.Tensor:
        """The loss's gradient with respect to a tensor ``input``."""
        x = input.detach().requires_grad_()
        with torch.enable_grad():
            (self.grad_input,) = torch.autograd.grad(
                self.update_output(x, target), x)
        return self.grad_input


def _reduce(x: torch.Tensor, size_average: bool,
            n: Optional[int] = None) -> torch.Tensor:
    total = x.sum()
    if size_average:
        return total / (x.numel() if n is None else n)
    return total


def _like(t, x: torch.Tensor) -> torch.Tensor:
    """A target as a tensor on ``x``'s device, in ``x``'s dtype."""
    return torch.as_tensor(t).to(device=x.device, dtype=x.dtype)


def _weights(weights) -> Optional[torch.Tensor]:
    return (None if weights is None
            else torch.as_tensor(weights, dtype=torch.float32))


def _first(target):
    """A table target's first element, else the target."""
    return elements(target)[0] if isinstance(target, (Table, list, tuple)) \
        else target


class ClassNLLCriterion(Criterion):
    """Negative log-likelihood over log-probabilities (reference
    ``ClassNLLCriterion``): ``input`` (N, C) or (C,), ``target`` (N,)
    1-based class indices, optional per-class ``weights``."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = (None if weights is None
                        else torch.as_tensor(weights, dtype=torch.float32))
        self.size_average = size_average

    def update_output(self, input, target):
        if input.dim() == 1:
            input = input[None, :]
            target = target.reshape(1)
        idx = target.to(device=input.device, dtype=torch.int64) - 1
        picked = input.gather(1, idx[:, None])[:, 0]
        if self.weights is not None:
            w = self.weights.to(input.device)[idx]
            loss = -(w * picked).sum()
            return loss / w.sum() if self.size_average else loss
        return -_reduce(picked, self.size_average)


class CrossEntropyCriterion(Criterion):
    """``log_softmax`` over the last axis, then ``ClassNLLCriterion``
    (reference ``CrossEntropyCriterion``)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.nll = ClassNLLCriterion(weights, size_average)

    def update_output(self, input, target):
        return self.nll.update_output(torch.log_softmax(input, dim=-1),
                                      target)


class TimeDistributedCriterion(Criterion):
    """Apply a criterion across the time axis (reference
    ``TimeDistributedCriterion``): input (N, T, ...) and target (N, T, ...)
    merge batch and time, and the inner criterion runs once."""

    def __init__(self, criterion: Criterion, size_average: bool = False):
        super().__init__()
        self.criterion = criterion
        self.size_average = size_average

    def update_output(self, input, target):
        n, t = input.shape[0], input.shape[1]
        x = input.reshape((n * t,) + tuple(input.shape[2:]))
        y = target.reshape((n * t,) + tuple(target.shape[2:]))
        loss = self.criterion.update_output(x, y)
        return loss / t if self.size_average else loss


class FusedLMHeadCriterion(Criterion):
    """Chunked-vocabulary cross-entropy paired with ``LMHead`` /
    ``TiedLMHead`` (reference ``FusedLMHeadCriterion``).

    Training path: ``input`` is the tuple ``(hidden, weight[, bias])`` that
    a head returns in training mode, scored by
    ``ops.lm_head_ce.fused_lm_head_ce``. Eval path: a plain tensor is taken
    as log-probabilities over the last axis (a head's eval output) and
    scored as mean NLL over every leading position."""

    def __init__(self, chunk: int = 16384, size_average: bool = True,
                 ignore_index: Optional[int] = None):
        super().__init__()
        self.chunk = chunk
        self.size_average = size_average
        self.ignore_index = ignore_index

    def update_output(self, input, target):
        if isinstance(input, (tuple, list)):
            hidden, weight = input[0], input[1]
            bias = input[2] if len(input) >= 3 else None
            return fused_lm_head_ce(hidden, weight, bias, target,
                                    chunk=self.chunk,
                                    size_average=self.size_average,
                                    ignore_index=self.ignore_index)
        logp = input
        tgt = target.to(device=logp.device, dtype=torch.int64)
        # an ignored target may lie outside 1..V: clip for the gather, the
        # mask below drops it
        idx = (tgt - 1).clamp(0, logp.shape[-1] - 1)
        picked = logp.gather(-1, idx[..., None])[..., 0]
        if self.ignore_index is not None:
            valid = tgt != int(self.ignore_index)
            total = -torch.where(valid, picked, 0.0).sum()
            if self.size_average:
                return total / valid.float().sum().clamp_min(1.0)
            return total
        return -_reduce(picked, self.size_average)


class MSECriterion(Criterion):
    """Mean squared error (reference ``MSECriterion``)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def update_output(self, input, target):
        return _reduce((input - _like(target, input)) ** 2,
                       self.size_average)


class AbsCriterion(Criterion):
    """Mean absolute error (reference ``AbsCriterion``)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def update_output(self, input, target):
        return _reduce((input - _like(target, input)).abs(),
                       self.size_average)


class BCECriterion(Criterion):
    """Binary cross-entropy on probabilities clipped into [1e-12,
    1 - 1e-12] (reference ``BCECriterion``)."""

    EPS = 1e-12

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def update_output(self, input, target):
        t = _like(target, input)
        x = input.clamp(self.EPS, 1.0 - self.EPS)
        ll = t * torch.log(x) + (1.0 - t) * torch.log(1.0 - x)
        if self.weights is not None:
            ll = ll * self.weights.to(input.device)
        return -_reduce(ll, self.size_average)


class SmoothL1Criterion(Criterion):
    """Huber loss with threshold 1 (reference ``SmoothL1Criterion``)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def update_output(self, input, target):
        d = (input - _like(target, input)).abs()
        return _reduce(torch.where(d < 1.0, 0.5 * d * d, d - 0.5),
                       self.size_average)


class SmoothL1CriterionWithWeights(Criterion):
    """Fast R-CNN's smooth L1 (reference ``SmoothL1CriterionWithWeights``):
    the target is a tensor or the table {target, inside weights, outside
    weights}; the sum is divided by ``num`` when it is positive."""

    def __init__(self, sigma: float = 1.0, num: int = 0):
        super().__init__()
        self.sigma2 = sigma * sigma
        self.num = num

    def update_output(self, input, target):
        if isinstance(target, (Table, list, tuple)):
            t, inw, outw = (_like(v, input) for v in elements(target)[:3])
        else:
            t, inw, outw = _like(target, input), None, None
        d = input - t
        if inw is not None:
            d = d * inw
        ad = d.abs()
        loss = torch.where(ad < 1.0 / self.sigma2, 0.5 * self.sigma2 * d * d,
                           ad - 0.5 / self.sigma2)
        if outw is not None:
            loss = loss * outw
        total = loss.sum()
        return total / self.num if self.num > 0 else total


class MarginCriterion(Criterion):
    """Hinge loss on {1, -1} targets (reference ``MarginCriterion``)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def update_output(self, input, target):
        return _reduce((self.margin - input * _like(target, input))
                       .clamp_min(0.0), self.size_average)


class MarginRankingCriterion(Criterion):
    """Ranking hinge ``max(0, -y (x1 - x2) + margin)`` over the input
    table {x1, x2} (reference ``MarginRankingCriterion``)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def update_output(self, input, target):
        x1, x2 = elements(input)[:2]
        y = _like(_first(target), x1)
        return _reduce((-y * (x1 - x2) + self.margin).clamp_min(0.0),
                       self.size_average)


class HingeEmbeddingCriterion(Criterion):
    """x where y = 1, max(0, margin - x) where y = -1 (reference
    ``HingeEmbeddingCriterion``)."""

    def __init__(self, margin: float = 1.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def update_output(self, input, target):
        loss = torch.where(_like(target, input) == 1, input,
                           (self.margin - input).clamp_min(0.0))
        return _reduce(loss, self.size_average)


class L1HingeEmbeddingCriterion(Criterion):
    """The L1 distance d of the pair {x1, x2}: d where y = 1, max(0,
    margin - d) otherwise (reference ``L1HingeEmbeddingCriterion``)."""

    def __init__(self, margin: float = 1.0):
        super().__init__()
        self.margin = margin

    def update_output(self, input, target):
        x1, x2 = elements(input)[:2]
        d = (x1 - x2).abs().sum()
        y = _like(_first(target), x1).reshape(())
        return torch.where(y == 1, d, (self.margin - d).clamp_min(0.0))


class CosineEmbeddingCriterion(Criterion):
    """1 - cos(x1, x2) where y = 1, max(0, cos - margin) otherwise
    (reference ``CosineEmbeddingCriterion``); norms floored at 1e-12."""

    def __init__(self, margin: float = 0.0, size_average: bool = True):
        super().__init__()
        self.margin = margin
        self.size_average = size_average

    def update_output(self, input, target):
        x1, x2 = elements(input)[:2]
        if x1.dim() == 1:
            x1, x2 = x1[None, :], x2[None, :]
        y = _like(_first(target), x1).reshape(-1)
        cos = (x1 * x2).sum(dim=-1) / (
            torch.linalg.vector_norm(x1, dim=-1)
            * torch.linalg.vector_norm(x2, dim=-1)).clamp_min(1e-12)
        loss = torch.where(y == 1, 1.0 - cos,
                           (cos - self.margin).clamp_min(0.0))
        return _reduce(loss, self.size_average)


class DistKLDivCriterion(Criterion):
    """KL(target || input) for log-probability input (reference
    ``DistKLDivCriterion``)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def update_output(self, input, target):
        t = _like(target, input)
        contrib = torch.where(
            t > 0, t * (torch.log(t.clamp_min(1e-12)) - input), 0.0)
        return _reduce(contrib, self.size_average)


class SoftMarginCriterion(Criterion):
    """log(1 + exp(-y x)) (reference ``SoftMarginCriterion``)."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def update_output(self, input, target):
        return _reduce(torch.log1p(torch.exp(-input * _like(target, input))),
                       self.size_average)


class MultiLabelSoftMarginCriterion(Criterion):
    """One-vs-all logistic loss on logits, averaged over the classes
    (reference ``MultiLabelSoftMarginCriterion``)."""

    def __init__(self, weights=None, size_average: bool = True):
        super().__init__()
        self.weights = _weights(weights)
        self.size_average = size_average

    def update_output(self, input, target):
        t = _like(target, input)
        ll = t * F.logsigmoid(input) + (1 - t) * F.logsigmoid(-input)
        if self.weights is not None:
            ll = ll * self.weights.to(input.device)
        n = input.shape[0] if input.dim() > 1 else 1
        total = -ll.sum() / input.shape[-1]
        return total / n if self.size_average else total


class MultiMarginCriterion(Criterion):
    """Multi-class margin loss, p = 1 or 2, with 1-based class targets
    (reference ``MultiMarginCriterion``)."""

    def __init__(self, p: int = 1, weights=None, margin: float = 1.0,
                 size_average: bool = True):
        super().__init__()
        if p not in (1, 2):
            raise ValueError(f"p must be 1 or 2, got {p}")
        self.p = p
        self.weights = _weights(weights)
        self.margin = margin
        self.size_average = size_average

    def update_output(self, input, target):
        if input.dim() == 1:
            input = input[None, :]
            target = torch.as_tensor(target).reshape(1)
        n, c = input.shape
        idx = torch.as_tensor(target).to(device=input.device,
                                         dtype=torch.int64) - 1
        x_y = input.gather(1, idx[:, None])
        m = (self.margin - x_y + input).clamp_min(0.0)
        if self.p == 2:
            m = m * m
        if self.weights is not None:
            m = m * self.weights.to(input.device)[idx][:, None]
        mask = 1.0 - F.one_hot(idx, c).to(input.dtype)
        loss = (m * mask).sum(dim=1) / c
        return _reduce(loss, True, n) if self.size_average else loss.sum()


class MultiLabelMarginCriterion(Criterion):
    """Multi-label margin (reference ``MultiLabelMarginCriterion``): the
    target holds 1-based labels padded with zeros; each label j against
    each class k that is no label adds max(0, 1 - (x[j] - x[k])) / C."""

    def __init__(self, size_average: bool = True):
        super().__init__()
        self.size_average = size_average

    def update_output(self, input, target):
        if input.dim() == 1:
            input = input[None, :]
            target = torch.as_tensor(target).reshape(1, -1)
        n, c = input.shape
        t = torch.as_tensor(target).to(device=input.device,
                                       dtype=torch.int64)
        valid = t > 0
        idx = (t - 1).clamp_min(0)
        is_label = (F.one_hot(idx, c).bool()
                    & valid[..., None]).any(dim=1)                 # (N, C)
        x_t = torch.where(valid, input.gather(1, idx), 0.0)        # (N, L)
        margins = (1.0 - (x_t[:, :, None] - input[:, None, :])).clamp_min(0.0)
        margins = margins * valid[:, :, None] * (~is_label)[:, None, :]
        loss = margins.sum(dim=(1, 2)) / c
        return _reduce(loss, True, n) if self.size_average else loss.sum()


class ClassSimplexCriterion(MSECriterion):
    """MSE against the class's vertex of a regular simplex (reference
    ``ClassSimplexCriterion``); targets 1-based."""

    def __init__(self, n_classes: int):
        super().__init__(size_average=True)
        self.n_classes = n_classes
        self.simplex = torch.from_numpy(self._build_simplex(n_classes))

    @staticmethod
    def _build_simplex(n: int) -> np.ndarray:
        a = np.zeros((n, n), dtype=np.float32)
        a[0, 0] = 1.0
        for k in range(1, n - 1):
            s = float(np.dot(a[k, :k], a[k - 1, :k]))
            a[k, k - 1] = ((1.0 - s) / a[k - 1, k - 1]
                           if a[k - 1, k - 1] != 0 else 0.0)
            norm2 = float(np.dot(a[k, :k + 1], a[k, :k + 1]))
            a[k, k] = np.sqrt(max(0.0, 1.0 - norm2))
        if n > 1:
            a[n - 1] = a[n - 2]
            a[n - 1, n - 1] *= -1
        return a

    def update_output(self, input, target):
        idx = torch.as_tensor(target).to(torch.int64) - 1
        t = self.simplex[idx.cpu()].to(device=input.device,
                                       dtype=input.dtype)
        return super().update_output(input, t)


class DiceCoefficientCriterion(Criterion):
    """1 - Dice overlap per row, ``epsilon`` smoothing (reference
    ``DiceCoefficientCriterion``)."""

    def __init__(self, size_average: bool = True, epsilon: float = 1.0):
        super().__init__()
        self.size_average = size_average
        self.epsilon = epsilon

    def update_output(self, input, target):
        t = _like(target, input)
        if input.dim() == 1:
            input, t = input[None, :], t.reshape(1, -1)
        inter = (input * t).sum(dim=1)
        union = input.sum(dim=1) + t.sum(dim=1)
        loss = 1.0 - (2.0 * inter + self.epsilon) / (union + self.epsilon)
        return loss.sum() / input.shape[0] if self.size_average \
            else loss.sum()


class L1Cost(Criterion):
    """sum |input|; the target is ignored (reference ``L1Cost``)."""

    def update_output(self, input, target=None):
        return input.abs().sum()


class SoftmaxWithCriterion(Criterion):
    """Caffe's softmax loss (reference ``SoftmaxWithCriterion``): input
    (N, C, *spatial) with the classes on axis 1, target (N, *spatial)
    1-based; targets equal to ``ignore_label`` count nothing; the total is
    divided per ``normalize_mode``: ``VALID`` (the counted targets),
    ``FULL`` (all targets), ``BATCH_SIZE`` (N) or ``NONE``."""

    def __init__(self, ignore_label: Optional[int] = None,
                 normalize_mode: str = "VALID"):
        super().__init__()
        self.ignore_label = ignore_label
        self.normalize_mode = normalize_mode

    def update_output(self, input, target):
        logp = torch.log_softmax(input, dim=1)
        t = torch.as_tensor(target).to(device=input.device)
        # an ignored label may lie outside 1..C: clipped for the gather,
        # masked below
        idx = (t.to(torch.int64) - 1).clamp(0, input.shape[1] - 1)
        picked = logp.gather(1, idx[:, None])[:, 0]
        if self.ignore_label is not None:
            valid = t != self.ignore_label
            picked = torch.where(valid, picked, 0.0)
            count = valid.sum()
        else:
            count = picked.numel()
        total = -picked.sum()
        mode = self.normalize_mode.upper()
        if mode == "VALID":
            return total / (count.clamp_min(1) if torch.is_tensor(count)
                            else max(count, 1))
        if mode == "FULL":
            return total / picked.numel()
        if mode == "BATCH_SIZE":
            return total / input.shape[0]
        return total


class ParallelCriterion(Criterion):
    """Weighted sum of criterion i on element i of the input table and of
    the target table, or on the whole target with ``repeat_target``
    (reference ``ParallelCriterion``)."""

    def __init__(self, repeat_target: bool = False):
        super().__init__()
        self.criterions = []
        self.weights = []
        self.repeat_target = repeat_target

    def add(self, criterion: Criterion, weight: float = 1.0
            ) -> "ParallelCriterion":
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def update_output(self, input, target):
        inputs = elements(input)
        targets = None if self.repeat_target else elements(target)
        total = 0.0
        for i, (c, w) in enumerate(zip(self.criterions, self.weights)):
            t = target if self.repeat_target else targets[i]
            total = total + w * c.update_output(inputs[i], t)
        return total


class MultiCriterion(Criterion):
    """Weighted sum of criteria on the same input and target (reference
    ``MultiCriterion``)."""

    def __init__(self):
        super().__init__()
        self.criterions = []
        self.weights = []

    def add(self, criterion: Criterion, weight: float = 1.0
            ) -> "MultiCriterion":
        self.criterions.append(criterion)
        self.weights.append(weight)
        return self

    def update_output(self, input, target):
        total = 0.0
        for c, w in zip(self.criterions, self.weights):
            total = total + w * c.update_output(input, target)
        return total


class CriterionTable(Criterion):
    """A criterion of the input table {input, target} (reference
    ``CriterionTable``)."""

    def __init__(self, criterion: Criterion):
        super().__init__()
        self.criterion = criterion

    def update_output(self, input, target=None):
        x, t = elements(input)[:2]
        return self.criterion.update_output(x, t)
