"""Dropout, the L1 penalty layer and the weight regularizers (counterpart
of ``bigdl_tpu/nn/regularization.py``).

The reference draws each mask from the step's JAX key. Here each ``Dropout``
holds its own ``torch.Generator``, made on the input's device at first use;
``manual_seed`` fixes its stream (``Optimizer`` seeds every dropout of the
model it trains), else it is seeded from the system. The two frameworks draw
different bits from the same seed, so tests compare statistics, not masks.
Masks come from ``ops.remat.keep_mask``, so that a recomputed forward
(``Optimizer.set_remat``) drops what its forward dropped.

A ``Regularizer`` rides on a parameter (``Module.register_parameter``'s
third argument, the layers' ``w_regularizer`` / ``b_regularizer``);
``Optimizer`` adds its ``loss`` of the f32 master parameter to the training
loss, so autograd adds its gradient.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module, TensorModule
from bigdl_tpu_torch.ops import remat


def drop(x: torch.Tensor, p: float, generator: torch.Generator,
         scale: bool = True) -> torch.Tensor:
    """Zero each element of ``x`` with probability ``p``; with ``scale`` the
    kept ones are divided by ``1 - p`` (inverted dropout)."""
    keep = 1.0 - p
    mask = remat.keep_mask(x.shape, keep, generator, x.device)
    out = torch.where(mask, x, 0.0)
    return out / keep if scale else out


class Dropout(Module):
    """Inverted-scale dropout (reference ``nn/Dropout.scala``); identity in
    eval mode or at ``p = 0``. The constructor takes the reference's
    ``(init_p, inplace, scale)``; ``inplace`` changes nothing."""

    def __init__(self, init_p: float = 0.5, inplace: bool = False,
                 scale: bool = True):
        super().__init__()
        self.p = init_p
        self.scale = scale
        self.seed: Optional[int] = None
        self._generator: Optional[torch.Generator] = None

    def set_p(self, p: float) -> "Dropout":
        self.p = p
        return self

    def manual_seed(self, seed: int) -> "Dropout":
        """Restart the mask stream from ``seed``."""
        self.seed = int(seed)
        self._generator = None
        return self

    def generator(self, device: torch.device) -> torch.Generator:
        """This module's generator on ``device`` (made at first use)."""
        g = self._generator
        if g is None or g.device != device:
            g = torch.Generator(device=device)
            if self.seed is None:
                g.seed()
            else:
                g.manual_seed(self.seed)
            self._generator = g
        return g

    def forward(self, input):
        if not self.training or self.p <= 0.0:
            return input
        return drop(input, self.p, self.generator(input.device), self.scale)


class _L1PenaltyGrad(torch.autograd.Function):
    """Identity forward; the backward adds ``weight * sign(x)``."""

    @staticmethod
    def forward(ctx, x, weight):
        ctx.save_for_backward(x)
        ctx.weight = weight
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad + ctx.weight * torch.sign(x), None


class L1Penalty(TensorModule):
    """Identity forward that adds ``l1weight * |x|`` to the loss through
    its gradient (reference ``nn/L1Penalty.scala``): the backward adds
    ``l1weight * sign(x)``, divided by ``x``'s element count under
    ``size_average``."""

    def __init__(self, l1weight: float, size_average: bool = False,
                 provide_output: bool = True):
        super().__init__()
        self.l1weight = l1weight
        self.size_average = size_average

    def forward(self, input):
        w = self.l1weight / (input.numel() if self.size_average else 1)
        return _L1PenaltyGrad.apply(input, w)


class Regularizer:
    """Weight penalty attached to a parameter (the reference's
    ``wRegularizer`` / ``bRegularizer``): ``loss(p) = l1 * sum|p| +
    l2 / 2 * sum p^2``, whose gradient is ``l1 * sign(p) + l2 * p``."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        self.l1, self.l2 = l1, l2

    def gradient(self, p: torch.Tensor) -> torch.Tensor:
        g = torch.zeros_like(p)
        if self.l1:
            g = g + self.l1 * torch.sign(p)
        if self.l2:
            g = g + self.l2 * p
        return g

    def loss(self, p: torch.Tensor) -> torch.Tensor:
        out = torch.zeros((), dtype=p.dtype, device=p.device)
        if self.l1:
            out = out + self.l1 * p.abs().sum()
        if self.l2:
            out = out + 0.5 * self.l2 * (p * p).sum()
        return out


class L1Regularizer(Regularizer):
    def __init__(self, l1: float):
        super().__init__(l1=l1)


class L2Regularizer(Regularizer):
    def __init__(self, l2: float):
        super().__init__(l2=l2)


class L1L2Regularizer(Regularizer):
    pass
