"""Deprecated standalone validation classes and the legacy accuracy
helpers (counterpart of ``bigdl_tpu/optim/validator.py``: ``Validator``,
``LocalValidator``, ``DistriValidator``, ``calc_accuracy`` and
``calc_top5_accuracy``).

``Validator(model, dataset)`` warns that it is deprecated (use the
model's evaluation: ``Evaluator``) and returns a ``LocalValidator``, or a
``DistriValidator`` for a distributed dataset; both run the one batch-eval
loop of ``optim/evaluator.py`` on the model's own device. The accuracy
helpers count with ``optim/validation.py``'s top-k rule.
"""

from __future__ import annotations

import warnings
from typing import List, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.dataset.base import AbstractDataSet
from bigdl_tpu_torch.optim.evaluator import Evaluator
from bigdl_tpu_torch.optim.validation import (ValidationMethod,
                                              ValidationResult,
                                              _topk_correct)
from bigdl_tpu_torch.utils.device import module_device


class Validator:
    """reference ``Validator``: an abstract test runner with a deprecated
    factory."""

    def __init__(self, model: torch.nn.Module, dataset: AbstractDataSet):
        self.model = model
        self.dataset = dataset

    def test(self, v_methods: Sequence[ValidationMethod]
             ) -> List[Tuple[ValidationResult, ValidationMethod]]:
        return Evaluator(self.model, device=module_device(self.model)).test(
            self.dataset, v_methods)

    def __new__(cls, model, dataset, *a, **k):
        if cls is Validator:
            warnings.warn(
                "Validator(model, dataset) is deprecated. Please use "
                "model.evaluate instead", DeprecationWarning, stacklevel=2)
            target = (DistriValidator
                      if isinstance(dataset, AbstractDataSet)
                      and dataset.is_distributed() else LocalValidator)
            return super().__new__(target)
        return super().__new__(cls)


class LocalValidator(Validator):
    """reference ``LocalValidator``."""


class DistriValidator(Validator):
    """reference ``DistriValidator``."""


def _calc_topk(output, target, k: int) -> Tuple[int, int]:
    out = torch.as_tensor(np.asarray(output))
    tgt = torch.as_tensor(np.asarray(target).ravel())
    n = 1 if out.dim() == 1 else out.shape[0]
    if tgt.shape[0] != n:
        raise ValueError(f"output rows ({n}) != target length "
                         f"({tgt.shape[0]})")
    correct, count = _topk_correct(out, tgt, k)
    return int(correct), int(count)


def calc_accuracy(output, target) -> Tuple[int, int]:
    """(correct, count) top-1, 1-based labels (reference
    ``calc_accuracy``)."""
    return _calc_topk(output, target, 1)


def calc_top5_accuracy(output, target) -> Tuple[int, int]:
    """(correct, count) top-5 (reference ``calc_top5_accuracy``)."""
    return _calc_topk(output, target, 5)
