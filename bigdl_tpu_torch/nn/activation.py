"""Activations (counterpart of ``bigdl_tpu/nn/activation.py``; every class
is ported).

Each is the reference's elementwise expression in PyTorch. The in-place
flags (``ip``, ``inplace``) are accepted and change nothing, as in the
reference. Layout is channels-last: ``PReLU``'s channel is the last axis
and ``SoftMax`` / ``SoftMin`` / ``LogSoftMax`` reduce over the last axis.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import TensorModule
from bigdl_tpu_torch.utils.rng import RandomGenerator


class ReLU(TensorModule):
    """max(x, 0), with gradient 0 at 0 as ``jax.nn.relu`` (reference
    ``ReLU``)."""

    def __init__(self, ip: bool = False):
        super().__init__()

    def forward(self, input):
        return torch.relu(input)


class ReLU6(TensorModule):
    """min(max(x, 0), 6) (reference ``ReLU6``)."""

    def __init__(self, inplace: bool = False):
        super().__init__()

    def forward(self, input):
        return F.relu6(input)


class Threshold(TensorModule):
    """x where x > th, else v (reference ``Threshold``)."""

    def __init__(self, th: float = 1e-6, v: float = 0.0, ip: bool = False):
        super().__init__()
        self.th, self.v = th, v

    def forward(self, input):
        return torch.where(input > self.th, input, self.v)


class PReLU(TensorModule):
    """Learnable leaky slope, 0.25 at first (reference ``PReLU``): one slope
    for ``n_output_plane = 0``, else one per channel of the last axis."""

    def __init__(self, n_output_plane: int = 0):
        super().__init__()
        self.n_output_plane = n_output_plane
        self.weight = torch.nn.Parameter(
            torch.full((max(1, n_output_plane),), 0.25))

    def forward(self, input):
        w = self.weight
        if self.n_output_plane > 0:
            w = w.reshape((1,) * (input.dim() - 1) + (-1,))
        return torch.where(input >= 0, input, w * input)


class RReLU(TensorModule):
    """Randomized leaky ReLU (reference ``RReLU``): in training each
    negative element takes a slope drawn uniformly from [lower, upper), in
    eval mode the mean slope.

    The slopes come from the module's own ``torch.Generator`` on the
    input's device, seeded at first use by a draw from the port's
    ``RandomGenerator.RNG()`` (``utils/rng.py``), so
    ``utils.rng.manual_seed`` reproduces them; PyTorch's global generator
    is never read."""

    def __init__(self, lower: float = 1.0 / 8, upper: float = 1.0 / 3,
                 inplace: bool = False):
        super().__init__()
        self.lower, self.upper = lower, upper
        self._generator: Optional[torch.Generator] = None

    def _gen(self, device: torch.device) -> torch.Generator:
        g = self._generator
        if g is None or g.device != device:
            g = torch.Generator(device=device)
            g.manual_seed(int(RandomGenerator.RNG().uniform(0, 2 ** 62)))
            self._generator = g
        return g

    def forward(self, input):
        if self.training:
            a = torch.empty(input.shape, dtype=input.dtype,
                            device=input.device).uniform_(
                self.lower, self.upper, generator=self._gen(input.device))
        else:
            a = (self.lower + self.upper) / 2.0
        return torch.where(input >= 0, input, a * input)


class LeakyReLU(TensorModule):
    """reference ``LeakyReLU``."""

    def __init__(self, negval: float = 0.01, inplace: bool = False):
        super().__init__()
        self.negval = negval

    def forward(self, input):
        return torch.where(input >= 0, input, self.negval * input)


class ELU(TensorModule):
    """reference ``ELU``."""

    def __init__(self, alpha: float = 1.0, inplace: bool = False):
        super().__init__()
        self.alpha = alpha

    def forward(self, input):
        return torch.where(input > 0, input, self.alpha * torch.expm1(input))


class Sigmoid(TensorModule):
    """reference ``Sigmoid``."""

    def forward(self, input):
        return torch.sigmoid(input)


class LogSigmoid(TensorModule):
    """reference ``LogSigmoid``."""

    def forward(self, input):
        return F.logsigmoid(input)


class Tanh(TensorModule):
    """reference ``Tanh``."""

    def forward(self, input):
        return torch.tanh(input)


class TanhShrink(TensorModule):
    """x - tanh(x) (reference ``TanhShrink``)."""

    def forward(self, input):
        return input - torch.tanh(input)


class HardTanh(TensorModule):
    """Clamp into [min_value, max_value] (reference ``HardTanh``)."""

    def __init__(self, min_value: float = -1.0, max_value: float = 1.0,
                 inplace: bool = False):
        super().__init__()
        self.min_value, self.max_value = min_value, max_value

    def forward(self, input):
        return torch.clamp(input, self.min_value, self.max_value)


class HardShrink(TensorModule):
    """reference ``HardShrink``."""

    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def forward(self, input):
        return torch.where(input.abs() > self.lambd, input, 0.0)


class SoftShrink(TensorModule):
    """reference ``SoftShrink``."""

    def __init__(self, lambd: float = 0.5):
        super().__init__()
        self.lambd = lambd

    def forward(self, input):
        return torch.where(input > self.lambd, input - self.lambd,
                           torch.where(input < -self.lambd,
                                       input + self.lambd, 0.0))


class SoftPlus(TensorModule):
    """log(1 + exp(beta x)) / beta, x itself where beta x > 20 (reference
    ``SoftPlus``)."""

    def __init__(self, beta: float = 1.0):
        super().__init__()
        self.beta = beta
        self.threshold = 20.0

    def forward(self, input):
        bx = self.beta * input
        return torch.where(bx > self.threshold, input,
                           torch.log1p(torch.exp(bx)) / self.beta)


class SoftSign(TensorModule):
    """x / (1 + |x|) (reference ``SoftSign``)."""

    def forward(self, input):
        return input / (1.0 + input.abs())


class SoftMax(TensorModule):
    """softmax over the last (feature) axis (reference ``SoftMax``)."""

    def forward(self, input):
        return torch.softmax(input, dim=-1)


class SoftMin(TensorModule):
    """softmax of -x over the last axis (reference ``SoftMin``)."""

    def forward(self, input):
        return torch.softmax(-input, dim=-1)


class LogSoftMax(TensorModule):
    """log_softmax over the last axis (reference ``LogSoftMax``)."""

    def forward(self, input):
        return torch.log_softmax(input, dim=-1)


class Clamp(HardTanh):
    """reference ``Clamp``."""

    def __init__(self, min_value: float, max_value: float):
        super().__init__(float(min_value), float(max_value))


class Power(TensorModule):
    """(shift + scale x)^power (reference ``Power``)."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0):
        super().__init__()
        self.power, self.scale, self.shift = power, scale, shift

    def forward(self, input):
        return torch.pow(self.shift + self.scale * input, self.power)


class Sqrt(TensorModule):
    """reference ``Sqrt``."""

    def forward(self, input):
        return torch.sqrt(input)


class Square(TensorModule):
    """reference ``Square``."""

    def forward(self, input):
        return input * input


class Abs(TensorModule):
    """reference ``Abs``."""

    def forward(self, input):
        return input.abs()


class Log(TensorModule):
    """reference ``Log``."""

    def forward(self, input):
        return torch.log(input)


class Exp(TensorModule):
    """reference ``Exp``."""

    def forward(self, input):
        return torch.exp(input)


class AddConstant(TensorModule):
    """reference ``AddConstant``."""

    def __init__(self, constant_scalar: float, inplace: bool = False):
        super().__init__()
        self.constant_scalar = constant_scalar

    def forward(self, input):
        return input + self.constant_scalar


class MulConstant(TensorModule):
    """reference ``MulConstant``."""

    def __init__(self, scalar: float, inplace: bool = False):
        super().__init__()
        self.scalar = scalar

    def forward(self, input):
        return input * self.scalar


class _Reverse(torch.autograd.Function):
    """Identity forward, ``-lambda * grad`` backward."""

    @staticmethod
    def forward(ctx, x, the_lambda):
        ctx.the_lambda = the_lambda
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return -ctx.the_lambda * grad, None


class GradientReversal(TensorModule):
    """Identity forward whose backward multiplies the gradient by
    ``-the_lambda`` (reference ``GradientReversal``), a
    ``torch.autograd.Function``."""

    def __init__(self, the_lambda: float = 1.0):
        super().__init__()
        self.the_lambda = the_lambda

    def set_lambda(self, l: float) -> "GradientReversal":
        self.the_lambda = l
        return self

    def forward(self, input):
        return _Reverse.apply(input, self.the_lambda)
