"""Containers (counterpart of ``bigdl_tpu/nn/containers.py``; only
``Sequential`` is ported so far)."""

from __future__ import annotations

from bigdl_tpu_torch.nn.module import Module


class Sequential(Module):
    """Chain container with the reference's ``add``: children are registered
    as ``"0"``, ``"1"``, ... and run in that order."""

    def add(self, module: Module) -> "Sequential":
        self.add_module(str(len(self._modules)), module)
        return self

    def __getitem__(self, i: int) -> Module:
        return list(self._modules.values())[i]

    def forward(self, input):
        out = input
        for m in self._modules.values():
            out = m(out)
        return out
