"""Validation metrics (counterpart of ``bigdl_tpu/optim/validation.py``):
``Top1Accuracy``, ``Top5Accuracy``, ``Loss`` and ``Perplexity`` with
mergeable ``ValidationResult``s.

Each method's core ``batch_result(output, target)`` returns (value, count)
as DEVICE tensors, as the reference returns device arrays, so an
evaluation loop accumulates on the device and reads the host once
(``optim/evaluator.py``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion, Criterion


class ValidationResult:
    def result(self):
        raise NotImplementedError

    def __add__(self, other):
        raise NotImplementedError

    def state(self):
        """The (numerator, count) wire form."""
        raise NotImplementedError

    @classmethod
    def from_state(cls, numerator, count):
        return cls(numerator, count)


class AccuracyResult(ValidationResult):
    """(correct, count) pair (reference ``AccuracyResult``)."""

    def __init__(self, correct: int, count: int):
        self.correct, self.count = int(correct), int(count)

    def state(self):
        return (float(self.correct), float(self.count))

    def result(self):
        return (self.correct / max(1, self.count), self.count)

    def __add__(self, other: "AccuracyResult"):
        return AccuracyResult(self.correct + other.correct,
                              self.count + other.count)

    def __repr__(self):
        acc, n = self.result()
        return (f"Accuracy(correct: {self.correct}, count: {n}, "
                f"accuracy: {acc:.6f})")

    def __eq__(self, other):
        return (self.correct, self.count) == (other.correct, other.count)


class LossResult(ValidationResult):
    """(sum loss, count) pair (reference ``LossResult``)."""

    def __init__(self, loss: float, count: int):
        self.loss, self.count = float(loss), int(count)

    def state(self):
        return (self.loss, float(self.count))

    def result(self):
        return (self.loss / max(1, self.count), self.count)

    def __add__(self, other: "LossResult"):
        return LossResult(self.loss + other.loss, self.count + other.count)

    def __repr__(self):
        mean, n = self.result()
        return f"Loss(sum: {self.loss:.4f}, count: {n}, mean: {mean:.6f})"


class PerplexityResult(ValidationResult):
    """(sum NLL over tokens, token count): result = exp(mean NLL)."""

    def __init__(self, nll: float, count: int):
        self.nll, self.count = float(nll), int(count)

    def state(self):
        return (self.nll, float(self.count))

    def result(self):
        return (math.exp(self.nll / max(1, self.count)), self.count)

    def __add__(self, other: "PerplexityResult"):
        return PerplexityResult(self.nll + other.nll,
                                self.count + other.count)

    def __repr__(self):
        ppl, n = self.result()
        return f"Perplexity(tokens: {n}, ppl: {ppl:.4f})"


class ValidationMethod:
    """Base metric (reference ``ValidationMethod``)."""

    name = "validation"

    def batch_result(self, output, target):
        """(value, count) of one batch, as device tensors."""
        raise NotImplementedError

    def to_result(self, value, count) -> ValidationResult:
        raise NotImplementedError

    def apply(self, output, target) -> ValidationResult:
        v, c = self.batch_result(output, target)
        return self.to_result(float(v), int(c))

    def __call__(self, output, target) -> ValidationResult:
        return self.apply(output, target)

    def __repr__(self):
        return self.name


def _topk_correct(output: torch.Tensor, target: torch.Tensor, k: int):
    """(hits, rows) of (N, C) scores against (N,) 1-based labels."""
    if output.dim() == 1:
        output = output[None, :]
        target = target.reshape(1)
    n, c = output.shape
    # a stable sort of the negated scores: ties go to the LOWEST class
    # index, as in the reference
    idx = torch.argsort(-output, dim=1, stable=True)[:, :min(k, c)]
    hits = (idx == (target.long() - 1)[:, None]).any(dim=1)
    return hits.sum(), torch.tensor(n, device=output.device)


class Top1Accuracy(ValidationMethod):
    """reference ``Top1Accuracy``."""

    name = "Top1Accuracy"

    def batch_result(self, output, target):
        return _topk_correct(output, target, 1)

    def to_result(self, value, count):
        return AccuracyResult(value, count)


class Top5Accuracy(ValidationMethod):
    """reference ``Top5Accuracy``."""

    name = "Top5Accuracy"

    def batch_result(self, output, target):
        return _topk_correct(output, target, 5)

    def to_result(self, value, count):
        return AccuracyResult(value, count)


class Loss(ValidationMethod):
    """Criterion as metric (reference ``Loss``): the batch's mean loss
    times its rows."""

    name = "Loss"

    def __init__(self, criterion: Optional[Criterion] = None):
        self.criterion = criterion or ClassNLLCriterion()

    def batch_result(self, output, target):
        n = output.shape[0] if output.dim() > 1 else 1
        return (self.criterion.forward(output, target).float() * n,
                torch.tensor(n, device=output.device))

    def to_result(self, value, count):
        return LossResult(value, count)


class Perplexity(ValidationMethod):
    """LM perplexity: exp of the mean per-token NLL (reference
    ``Perplexity``). ``output`` is (B, S, V) LOG-PROBS, the LM's eval-mode
    output; ``target`` is (B, S) 1-based token ids. Tokens equal to
    ``ignore_index`` (padding) are skipped."""

    name = "Perplexity"

    def __init__(self, ignore_index: Optional[int] = None):
        self.ignore_index = ignore_index

    def batch_result(self, output, target):
        tgt = target.long()
        # an ignored id may lie outside 1..V: gather a valid row, masked
        rows = (tgt - 1).clamp(0, output.shape[-1] - 1)
        picked = output.gather(-1, rows[..., None])[..., 0].float()
        if self.ignore_index is not None:
            valid = tgt != int(self.ignore_index)
            return -torch.where(valid, picked, 0.0).sum(), valid.sum()
        return -picked.sum(), torch.tensor(picked.numel(),
                                           device=output.device)

    def to_result(self, value, count):
        return PerplexityResult(value, count)
