"""Containers and table ops (counterpart of ``bigdl_tpu/nn/containers.py``;
every class is ported).

A module that takes a table takes a ``utils.table.Table`` (keys 1, 2, ...),
a list or a tuple alike; one that returns a table returns a list. Table
indices and dimensions are the reference's, 1-based (``SelectTable(1)`` is
the first element, ``Index``'s ids are 1-based). Children are registered as
``"0"``, ``"1"``, ... in both packages, so parameter names match the
reference's trees, and ``Bottle``, ``MapTable`` and ``ParallelTable`` hold
theirs as registered modules, so ``parameters()`` and ``Graph`` see them.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.utils.table import Table, elements


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
        items = elements(input)
        out = items[0]
        for t in items[1:]:
            out = out + t
        return out


class Identity(Module):
    """reference ``Identity``."""

    def forward(self, input):
        return input


class ParallelTable(Container):
    """Child i on element i of the input table (reference
    ``ParallelTable``)."""

    def forward(self, input):
        return [m(x) for m, x in zip(self._modules.values(),
                                     elements(input))]


class MapTable(Container):
    """One child on every element of the input table, with its parameters
    shared (reference ``MapTable``)."""

    def __init__(self, module: Module = None):
        super().__init__()
        if module is not None:
            self.add(module)

    def forward(self, input):
        m = self[0]
        return [m(x) for x in elements(input)]


def _table_axis(dimension: int, n_input_dims: int, x: torch.Tensor) -> int:
    """1-based ``dimension`` as an axis of ``x``, shifted past a leading
    batch dim when ``x`` has one more dim than ``n_input_dims`` (> 0)."""
    axis = dimension - 1
    if n_input_dims > 0 and x.dim() == n_input_dims + 1:
        axis += 1
    return axis


class JoinTable(Module):
    """Concatenate the table's elements on 1-based ``dimension``
    (reference ``JoinTable``)."""

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, input):
        items = elements(input)
        return torch.cat(items, dim=_table_axis(self.dimension,
                                                self.n_input_dims, items[0]))


class SplitTable(Module):
    """Split a tensor into a table of its slices on 1-based ``dimension``
    (reference ``SplitTable``)."""

    def __init__(self, dimension: int, n_input_dims: int = -1):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims

    def forward(self, input):
        axis = _table_axis(self.dimension, self.n_input_dims, input)
        return list(input.unbind(axis))


class SelectTable(Module):
    """Element ``index`` (1-based) of the table (reference
    ``SelectTable``)."""

    def __init__(self, index: int):
        super().__init__()
        self.index = index

    def forward(self, input):
        return elements(input)[self.index - 1]


class NarrowTable(Module):
    """``length`` elements from 1-based ``offset``; a negative length
    counts back from the end (reference ``NarrowTable``)."""

    def __init__(self, offset: int, length: int = 1):
        super().__init__()
        self.offset, self.length = offset, length

    def forward(self, input):
        items = elements(input)
        n = self.length
        if n < 0:
            n = len(items) - self.offset + 1 + (self.length + 1)
        return items[self.offset - 1:self.offset - 1 + n]


class FlattenTable(Module):
    """Nested tables flattened into one, depth first (reference
    ``FlattenTable``)."""

    def forward(self, input):
        flat = []

        def walk(t):
            for v in elements(t):
                if isinstance(v, (Table, list, tuple)):
                    walk(v)
                else:
                    flat.append(v)

        walk(input)
        return flat


class CSubTable(Module):
    """input[1] - input[2] (reference ``CSubTable``)."""

    def forward(self, input):
        a, b = elements(input)[:2]
        return a - b


class CMulTable(Module):
    """Elementwise product of the table's elements (reference
    ``CMulTable``)."""

    def forward(self, input):
        items = elements(input)
        out = items[0]
        for t in items[1:]:
            out = out * t
        return out


class CDivTable(Module):
    """input[1] / input[2] (reference ``CDivTable``)."""

    def forward(self, input):
        a, b = elements(input)[:2]
        return a / b


class CMaxTable(Module):
    """Elementwise max of the table's elements (reference ``CMaxTable``)."""

    def forward(self, input):
        items = elements(input)
        out = items[0]
        for t in items[1:]:
            out = torch.maximum(out, t)
        return out


class CMinTable(Module):
    """Elementwise min of the table's elements (reference ``CMinTable``)."""

    def forward(self, input):
        items = elements(input)
        out = items[0]
        for t in items[1:]:
            out = torch.minimum(out, t)
        return out


class MixtureTable(Module):
    """Mixture of experts (reference ``MixtureTable``): input {gater (N, E),
    experts}, the experts a table of E (N, ...) tensors or one (N, E, ...)
    tensor; output sum_e gater[:, e] * expert_e."""

    def __init__(self, dim: int = -1):
        super().__init__()
        self.dim = dim

    def forward(self, input):
        gate, experts = elements(input)[:2]
        if isinstance(experts, (Table, list, tuple)):
            experts = torch.stack(elements(experts), dim=1)
        g = gate.reshape(tuple(gate.shape)
                         + (1,) * (experts.dim() - gate.dim()))
        return (g * experts).sum(dim=1)


class MaskedSelect(Module):
    """The elements of input[1] where the mask input[2] is set, as the
    compact vector (reference ``MaskedSelect``, eagerly). Its length depends
    on the data, so the card reads the mask's count back to the host: this
    module cannot be captured in a CUDA graph."""

    def forward(self, input):
        x, mask = elements(input)[:2]
        return x[mask.to(torch.bool)]


class Index(Module):
    """``index_select`` of input[1] on 1-based ``dimension`` at the 1-based
    ids input[2] (reference ``Index``)."""

    def __init__(self, dimension: int):
        super().__init__()
        self.dimension = dimension

    def forward(self, input):
        x, idx = elements(input)[:2]
        return x.index_select(self.dimension - 1,
                              idx.to(device=x.device,
                                     dtype=torch.int64).reshape(-1) - 1
                              ).reshape(x.shape[:self.dimension - 1]
                                        + tuple(idx.shape)
                                        + x.shape[self.dimension:])


class Bottle(Container):
    """Fold the leading dims into one, run the child, unfold them
    (reference ``Bottle``): an input of more than ``n_input_dim`` dims is
    reshaped to (-1,) + its last ``n_input_dim - 1`` dims."""

    def __init__(self, module: Module, n_input_dim: int = 2,
                 n_output_dim: int = 2):
        super().__init__()
        self.n_input_dim = n_input_dim
        self.n_output_dim = n_output_dim
        self.add(module)

    def forward(self, input):
        m = self[0]
        if input.dim() <= self.n_input_dim:
            return m(input)
        cut = input.dim() - self.n_input_dim + 1
        lead, rest = tuple(input.shape[:cut]), tuple(input.shape[cut:])
        out = m(input.reshape((-1,) + rest))
        return out.reshape(lead + tuple(out.shape[1:]))


class Echo(Module):
    """Print the input's shape and pass it through (reference ``Echo``)."""

    def forward(self, input):
        print(f"{self.name}: {getattr(input, 'shape', type(input))}")
        return input
