"""Activations (counterpart of ``bigdl_tpu/nn/activation.py``: ``ReLU`` and
``LogSoftMax`` are ported)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module


class ReLU(Module):
    """max(x, 0), with gradient 0 at 0 as ``jax.nn.relu`` (reference
    ``ReLU``)."""

    def __init__(self, ip: bool = False):
        super().__init__()

    def forward(self, input):
        return torch.relu(input)


class LogSoftMax(Module):
    """log_softmax over the last axis (reference ``LogSoftMax``)."""

    def forward(self, input):
        return torch.log_softmax(input, dim=-1)
