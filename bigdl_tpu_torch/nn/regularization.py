"""Dropout (counterpart of ``bigdl_tpu/nn/regularization.py``; ``Dropout`` is
ported).

The reference draws each mask from the step's JAX key. Here each ``Dropout``
holds its own ``torch.Generator``, made on the input's device at first use;
``manual_seed`` fixes its stream (``Optimizer`` seeds every dropout of the
model it trains), else it is seeded from the system. The two frameworks draw
different bits from the same seed, so tests compare statistics, not masks.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn.module import Module


def drop(x: torch.Tensor, p: float, generator: torch.Generator,
         scale: bool = True) -> torch.Tensor:
    """Zero each element of ``x`` with probability ``p``; with ``scale`` the
    kept ones are divided by ``1 - p`` (inverted dropout)."""
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    out = torch.where(mask, x, 0.0)
    return out / keep if scale else out


class Dropout(Module):
    """Inverted-scale dropout (reference ``nn/Dropout.scala``); identity in
    eval mode or at ``p = 0``."""

    def __init__(self, init_p: float = 0.5, scale: bool = True):
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
