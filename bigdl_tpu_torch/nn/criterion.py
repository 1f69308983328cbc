"""Loss criteria of the training slice (counterpart of
``bigdl_tpu/nn/criterion.py``: ``Criterion``, ``ClassNLLCriterion``,
``CrossEntropyCriterion``, ``TimeDistributedCriterion`` and
``FusedLMHeadCriterion`` are ported).

A criterion's ``forward(input, target)`` returns a scalar loss tensor;
autograd gives the gradient (the reference's ``jax.grad`` of the same
function). Class targets are 1-based, as in Torch and BigDL.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.ops.lm_head_ce import fused_lm_head_ce


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


def _reduce(x: torch.Tensor, size_average: bool) -> torch.Tensor:
    total = x.sum()
    return total / x.numel() if size_average else total


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
