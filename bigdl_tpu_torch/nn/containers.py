"""Containers and table ops (counterpart of ``bigdl_tpu/nn/containers.py``:
``Sequential``, ``Concat``, ``ConcatTable``, ``CAddTable`` and
``Identity`` are ported).

A reference ``Table`` is a Python list here. Children are registered as
``"0"``, ``"1"``, ... in both packages, so parameter names match the
reference's trees.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module


class Container(Module):
    """Ordered-children base with the reference's ``add``."""

    def add(self, module: Module) -> "Container":
        self.add_module(str(len(self._modules)), module)
        return self

    def __getitem__(self, i: int) -> Module:
        return list(self._modules.values())[i]

    def __len__(self) -> int:
        return len(self._modules)


class Sequential(Container):
    """Chain container: children run in order."""

    def forward(self, input):
        out = input
        for m in self._modules.values():
            out = m(out)
        return out


class Concat(Container):
    """Every child on the same input; the outputs concatenated on
    ``dimension`` (reference ``Concat``).

    ``dimension`` is the reference's: 1-based over the non-batch dims of
    its NCHW world (1 is the channels). On the port's channels-last
    activations it maps as the reference maps it: a 4-D (N, H, W, C)
    output's dims 1, 2, 3 are axes 3, 1, 2; a 3-D (H, W, C) output's are
    axes 2, 0, 1; any other output's dim d is axis d."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def _axis(self, out: torch.Tensor) -> int:
        d = self.dimension
        if out.dim() == 4:
            return {1: 3, 2: 1, 3: 2}[d]
        if out.dim() == 3:
            return {1: 2, 2: 0, 3: 1}[d]
        return d

    def forward(self, input):
        outs = [m(input) for m in self._modules.values()]
        return torch.cat(outs, dim=self._axis(outs[0]))


class ConcatTable(Container):
    """Every child on the same input; the outputs as a list (reference
    ``ConcatTable``)."""

    def forward(self, input):
        return [m(input) for m in self._modules.values()]


class CAddTable(Module):
    """Elementwise sum of a list's elements, in order (reference
    ``CAddTable``)."""

    def __init__(self, inplace: bool = False):
        super().__init__()

    def forward(self, input):
        out = input[0]
        for t in input[1:]:
            out = out + t
        return out


class Identity(Module):
    """reference ``Identity``."""

    def forward(self, input):
        return input
