"""Containers and table ops (counterpart of ``bigdl_tpu/nn/containers.py``:
``Sequential``, ``ConcatTable``, ``CAddTable`` and ``Identity`` are
ported).

A reference ``Table`` is a Python list here. Children are registered as
``"0"``, ``"1"``, ... in both packages, so parameter names match the
reference's trees.
"""

from __future__ import annotations

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
