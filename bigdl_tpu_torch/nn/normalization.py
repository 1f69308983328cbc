"""Batch normalization (counterpart of ``bigdl_tpu/nn/normalization.py``:
``blend_running_stats``, ``BatchNormalization`` and
``SpatialBatchNormalization`` are ported).

Layout is channels-last: the channel is the last dim. Running statistics
are f32 buffers. The reference threads them functionally through its
jitted step; here they are updated IN PLACE under ``torch.no_grad()``, so
the update lands on the module's own buffers whether the model is called
directly or through ``torch.func.functional_call`` with its parameters
only (as ``Optimizer`` does), and never enters the autograd graph.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn import initialization as init
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.batch_norm import batch_norm_train


@torch.no_grad()
def blend_running_stats(module: Module, mean: torch.Tensor, var: torch.Tensor,
                        n: int, momentum: float) -> None:
    """The running-stat update shared by ``BatchNormalization`` and the
    fused conv+BN modules: the unbiased ``n / (n - 1)`` correction of the
    batch variance, then the ``momentum`` blend into ``running_mean`` and
    ``running_var``, in place."""
    unbiased = var * (n / max(1, n - 1))
    rm, rv = module.running_mean, module.running_var
    rm.copy_((1 - momentum) * rm + momentum * mean)
    rv.copy_((1 - momentum) * rv + momentum * unbiased)


class BatchNormalization(Module):
    """Batch norm over (N, C) inputs (reference ``BatchNormalization``):
    train mode normalises with the batch statistics
    (``ops.batch_norm.batch_norm_train``) and blends them into the running
    ones; eval mode uses the running ones."""

    def __init__(self, n_output: int, eps: float = 1e-5,
                 momentum: float = 0.1, affine: bool = True):
        super().__init__()
        self.n_output = n_output
        self.eps = eps
        self.momentum = momentum
        self.affine = affine
        if affine:
            self.weight = torch.nn.Parameter(init.ones((n_output,)))
            self.bias = torch.nn.Parameter(init.zeros((n_output,)))
        self.register_buffer("running_mean", init.zeros((n_output,)))
        self.register_buffer("running_var", init.ones((n_output,)))

    def forward(self, input):
        if self.training:
            if self.affine:
                gamma, beta = self.weight, self.bias
            else:
                gamma = torch.ones(self.n_output, dtype=input.dtype,
                                   device=input.device)
                beta = torch.zeros_like(gamma)
            out, mean, var = batch_norm_train(input, gamma, beta, self.eps)
            blend_running_stats(self, mean, var,
                                input.numel() // input.shape[-1],
                                self.momentum)
            return out
        out = (input - self.running_mean) * torch.rsqrt(self.running_var
                                                        + self.eps)
        if self.affine:
            out = out * self.weight + self.bias
        return out


class SpatialBatchNormalization(BatchNormalization):
    """Batch norm over (N, H, W, C): the same math, channel = last dim
    (reference ``SpatialBatchNormalization``)."""
