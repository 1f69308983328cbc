"""Fused conv + batch-norm modules (counterpart of ``bigdl_tpu/nn/fused.py``:
``use_fused_1x1``, ``use_fused_3x3``, ``FusedConv1x1BN`` and
``FusedConv3x3BN`` are ported).

Each module is a conv (no bias by default) and a ``SpatialBatchNormalization``
in one: the train-mode forward runs the fused conv+statistics op (kernel K5
or K6 on the card); eval folds BN into the conv weights, in f32, and runs
one plain conv in the activation's dtype. The weight keeps the conv's HWIO
layout, ``(1, 1, in, out)`` or ``(3, 3, in, out)``, and BN's affine
parameters are named ``gamma`` and ``beta``, as in the reference, so a
fused model's parameter names differ from an unfused one's.

The ResNet builders adopt the modules behind the reference's own opt-in
environment gates, read when the model is built: ``BIGDL_TPU_FUSED_1X1``
and ``BIGDL_TPU_FUSED_3X3`` set to ``1``, ``true`` or ``yes``.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from bigdl_tpu_torch.nn import initialization as init
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.normalization import blend_running_stats
from bigdl_tpu_torch.ops.conv3x3_bn import _conv3x3, conv3x3_bn_train
from bigdl_tpu_torch.ops.conv_bn import conv1x1_bn_train

_ON = ("1", "true", "yes")


def use_fused_1x1() -> bool:
    """The builders' opt-in gate for the 1x1 fusion
    (``BIGDL_TPU_FUSED_1X1``)."""
    return os.environ.get("BIGDL_TPU_FUSED_1X1", "").strip().lower() in _ON


def use_fused_3x3() -> bool:
    """The opt-in gate for the stride-1 3x3 fusion
    (``BIGDL_TPU_FUSED_3X3``)."""
    return os.environ.get("BIGDL_TPU_FUSED_3X3", "").strip().lower() in _ON


class _FusedConvBN(Module):
    """What the two fused modules share: parameters, running statistics,
    the running-stat update and the eval-mode BN fold."""

    def __init__(self, n_input_plane: int, n_output_plane: int, k: int,
                 eps: float, momentum: float, init_method: str,
                 with_bias: bool, generator: Optional[torch.Generator]):
        super().__init__()
        self.n_input_plane, self.n_output_plane = n_input_plane, n_output_plane
        self.eps, self.momentum = eps, momentum
        self.with_bias = with_bias
        fan_in = k * k * n_input_plane
        self.weight = torch.nn.Parameter(init.conv_weight(
            init_method, (k, k, n_input_plane, n_output_plane), fan_in,
            k * k * n_output_plane, generator))
        if with_bias:
            # a pre-BN bias only shifts the batch mean: the train output
            # does not see it; it moves the running mean and the eval fold
            self.bias = torch.nn.Parameter(
                init.default_init((n_output_plane,), fan_in, generator))
        self.gamma = torch.nn.Parameter(init.ones((n_output_plane,)))
        self.beta = torch.nn.Parameter(init.zeros((n_output_plane,)))
        self.register_buffer("running_mean", init.zeros((n_output_plane,)))
        self.register_buffer("running_var", init.ones((n_output_plane,)))

    def _track(self, mean: torch.Tensor, var: torch.Tensor, n: int) -> None:
        if self.with_bias:
            mean = mean + self.bias.detach().float()
        blend_running_stats(self, mean, var, n, self.momentum)

    def _fold(self, dtype: torch.dtype):
        """(weight scaled by gamma / sqrt(running_var + eps), in f32 then
        cast to ``dtype``; the shift, in ``dtype``)."""
        scale = (self.gamma * torch.rsqrt(self.running_var + self.eps)).float()
        w_folded = (self.weight.float() * scale).to(dtype)
        shift = self.beta - self.running_mean * scale
        if self.with_bias:
            shift = shift + self.bias.float() * scale
        return w_folded, shift.to(dtype)


class FusedConv1x1BN(_FusedConvBN):
    """1x1 conv (stride by subsampling) + batch norm as one module. The
    train forward runs ``ops.conv_bn.conv1x1_bn_train`` (K5 on the card)
    on the input as an (N*H*W, Cin) matrix; a strided subsample is copied
    to a contiguous matrix first, since K5 reads x row-major and
    contiguous."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 stride: int = 1, eps: float = 1e-5, momentum: float = 0.1,
                 init_method: str = "kaiming", with_bias: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_input_plane, n_output_plane, 1, eps, momentum,
                         init_method, with_bias, generator)
        self.stride = stride

    def forward(self, input):
        x = input
        if self.stride > 1:  # a strided 1x1 conv is a subsample, then a matmul
            x = x[:, ::self.stride, ::self.stride, :]
        n, h, w, c = x.shape
        x2d = x.reshape(n * h * w, c)
        wmat = self.weight[0, 0]
        if self.training:
            out2d, mean, var = conv1x1_bn_train(x2d, wmat, self.gamma,
                                                self.beta, self.eps)
            self._track(mean, var, x2d.shape[0])
        else:
            w_folded, shift = self._fold(x2d.dtype)
            out2d = x2d @ w_folded[0, 0] + shift
        return out2d.reshape(n, h, w, self.n_output_plane)


class FusedConv3x3BN(_FusedConvBN):
    """3x3 SAME-padded stride-1 conv + batch norm as one module. The train
    forward runs ``ops.conv3x3_bn.conv3x3_bn_train`` (K6 on the card)."""

    def __init__(self, n_input_plane: int, n_output_plane: int,
                 eps: float = 1e-5, momentum: float = 0.1,
                 init_method: str = "kaiming", with_bias: bool = False, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_input_plane, n_output_plane, 3, eps, momentum,
                         init_method, with_bias, generator)

    def forward(self, input):
        if self.training:
            out, mean, var = conv3x3_bn_train(input, self.weight, self.gamma,
                                              self.beta, self.eps)
            n, h, w, _ = input.shape
            self._track(mean, var, n * h * w)
            return out
        w_folded, shift = self._fold(input.dtype)
        return _conv3x3(input, w_folded) + shift
