"""Shape layers (counterpart of ``bigdl_tpu/nn/shape.py``: ``Reshape``,
``Transpose`` and ``Padding`` are ported)."""

from __future__ import annotations

from typing import Optional, Sequence

import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import Module


class Reshape(Module):
    """Reshape the non-batch dims to ``size`` (reference ``Reshape``).
    ``batch_mode=None`` infers: the whole input is reshaped when its size
    equals ``size``'s, else the leading dim is kept as the batch."""

    def __init__(self, size: Sequence[int], batch_mode: Optional[bool] = None):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode
        self._n = 1
        for s in self.size:
            self._n *= s

    def forward(self, input):
        if self.batch_mode is False or (self.batch_mode is None
                                        and input.numel() == self._n):
            return input.reshape(self.size)
        return input.reshape((input.shape[0],) + self.size)


class Transpose(Module):
    """A sequence of pairwise dim swaps, 1-based over the whole tensor, the
    batch dim included (reference ``Transpose``)."""

    def __init__(self, permutations: Sequence[Sequence[int]]):
        super().__init__()
        self.permutations = [tuple(p) for p in permutations]

    def forward(self, input):
        out = input
        for d1, d2 in self.permutations:
            out = out.transpose(d1 - 1, d2 - 1)
        return out


class Padding(Module):
    """Pad ``pad`` entries of ``value`` on 1-based dim ``dim`` (negative
    ``pad``: before, else after); a batched input (one more dim than
    ``n_input_dim``) shifts ``dim`` by one (reference ``Padding``)."""

    def __init__(self, dim: int, pad: int, n_input_dim: int,
                 value: float = 0.0, n_index: int = 1):
        super().__init__()
        self.dim, self.pad, self.n_input_dim = dim, pad, n_input_dim
        self.value = value

    def forward(self, input):
        axis = self.dim - 1
        if input.dim() == self.n_input_dim + 1:
            axis += 1
        lo_hi = [-self.pad, 0] if self.pad < 0 else [0, self.pad]
        # F.pad lists (lo, hi) pairs from the last dim backwards
        return F.pad(input, [0, 0] * (input.dim() - 1 - axis) + lo_hi,
                     value=self.value)
