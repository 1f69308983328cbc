"""Weight initialization methods (counterpart of
``bigdl_tpu/nn/initialization.py``: ``default_init``, ``xavier``,
``kaiming``, ``conv_weight``, ``zeros`` and ``ones``).

The reference draws host-side numpy from its process RandomGenerator. Here
each draw takes a ``torch.Generator`` that the model builder passes down
(``None`` is PyTorch's default generator), so ``build(..., seed=...)`` is
deterministic and leaves the global generator alone. The distributions are
the reference's; the numbers are not (weights that must match another
model are carried across with ``interop.state_dict``). Every tensor is f32
on the CPU; the builder moves the model to its device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

Generator = Optional[torch.Generator]


def default_init(shape: Sequence[int], fan_in: int,
                 generator: Generator = None) -> torch.Tensor:
    """Torch default: uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    stdv = 1.0 / math.sqrt(max(1, fan_in))
    return torch.empty(tuple(shape)).uniform_(-stdv, stdv, generator=generator)


def xavier(shape: Sequence[int], fan_in: int, fan_out: int,
           generator: Generator = None) -> torch.Tensor:
    """Glorot uniform (reference ``Xavier``)."""
    stdv = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(tuple(shape)).uniform_(-stdv, stdv, generator=generator)


def kaiming(shape: Sequence[int], fan_in: int,
            generator: Generator = None) -> torch.Tensor:
    """He normal, std sqrt(2 / fan_in) (the reference ResNet's MSRinit)."""
    std = math.sqrt(2.0 / max(1, fan_in))
    return torch.empty(tuple(shape)).normal_(0.0, std, generator=generator)


def conv_weight(method: str, shape: Sequence[int], fan_in: int,
                fan_out: int, generator: Generator = None) -> torch.Tensor:
    """Conv-weight init shared by ``SpatialConvolution`` and the fused
    conv modules: ``"xavier"``, ``"kaiming"`` or anything else for the
    default."""
    if method == "xavier":
        return xavier(shape, fan_in, fan_out, generator)
    if method == "kaiming":
        return kaiming(shape, fan_in, generator)
    return default_init(shape, fan_in, generator)


def zeros(shape: Sequence[int]) -> torch.Tensor:
    return torch.zeros(tuple(shape))


def ones(shape: Sequence[int]) -> torch.Tensor:
    return torch.ones(tuple(shape))
