"""Shape layers (counterpart of ``bigdl_tpu/nn/shape.py``; every class is
ported).

Dimensions are the reference's: 1-based, with an optional leading batch
dim that ``batch_mode`` / ``num_input_dims`` / ``n_dim`` account for, and
the reference's index arithmetic for negative values. ``Contiguous``
returns a contiguous tensor (the reference's is the identity, since XLA
arrays have no strides); the values are the same.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch.nn.functional as F

from bigdl_tpu_torch.nn.module import TensorModule


class Reshape(TensorModule):
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


class Transpose(TensorModule):
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


class Padding(TensorModule):
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


class View(Reshape):
    """reference ``View``: ``Reshape`` with the inferred batch dim."""

    def __init__(self, *sizes: int):
        if len(sizes) == 1 and isinstance(sizes[0], (tuple, list)):
            sizes = tuple(sizes[0])
        super().__init__(sizes, batch_mode=None)
        self.num_input_dims = 0

    def set_num_input_dims(self, n: int) -> "View":
        self.num_input_dims = n
        return self


class InferReshape(TensorModule):
    """Reshape where an entry of ``size`` may be -1 (inferred) or 0 (the
    input's size on that dim) (reference ``InferReshape``); with
    ``batch_mode`` the leading dim is kept and not counted."""

    def __init__(self, size: Sequence[int], batch_mode: bool = False):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.batch_mode = batch_mode

    def forward(self, input):
        in_shape = input.shape[1:] if self.batch_mode else input.shape
        out = tuple(in_shape[i] if s == 0 else s
                    for i, s in enumerate(self.size))
        if self.batch_mode:
            return input.reshape((input.shape[0],) + out)
        return input.reshape(out)


def _shifted(axis: int, n_dims: int, input) -> int:
    """A 1-based dim's 0-based axis, shifted past a leading batch dim when
    the input has one more dim than ``n_dims`` (> 0)."""
    if n_dims > 0 and input.dim() == n_dims + 1:
        return axis + 1
    return axis


class Squeeze(TensorModule):
    """Drop 1-based dim ``dim`` (0: every size-1 dim) (reference
    ``Squeeze``)."""

    def __init__(self, dim: int = 0, num_input_dims: int = -1):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def forward(self, input):
        if self.dim == 0:
            return input.squeeze()
        return input.squeeze(_shifted(self.dim - 1, self.num_input_dims,
                                      input))


class Unsqueeze(TensorModule):
    """Insert a size-1 dim at 1-based ``pos`` (reference ``Unsqueeze``)."""

    def __init__(self, pos: int, num_input_dims: int = -1):
        super().__init__()
        self.pos = pos
        self.num_input_dims = num_input_dims

    def forward(self, input):
        return input.unsqueeze(_shifted(self.pos - 1, self.num_input_dims,
                                        input))


class Replicate(TensorModule):
    """Repeat ``n_features`` times along a new 1-based dim ``dim``
    (reference ``Replicate``)."""

    def __init__(self, n_features: int, dim: int = 1, n_dim: int = -1):
        super().__init__()
        self.n_features, self.dim, self.n_dim = n_features, dim, n_dim

    def forward(self, input):
        axis = _shifted(self.dim - 1, self.n_dim, input)
        out = input.unsqueeze(axis)
        reps = [1] * out.dim()
        reps[axis] = self.n_features
        return out.repeat(reps)


class SpatialZeroPadding(TensorModule):
    """Zero-pad H and W of a channels-last (N,) H, W, C image; a negative
    pad crops (reference ``SpatialZeroPadding``)."""

    def __init__(self, pad_left: int, pad_right: Optional[int] = None,
                 pad_top: Optional[int] = None,
                 pad_bottom: Optional[int] = None):
        super().__init__()
        self.pl = pad_left
        self.pr = pad_right if pad_right is not None else pad_left
        self.pt = pad_top if pad_top is not None else pad_left
        self.pb = pad_bottom if pad_bottom is not None else pad_left

    def forward(self, input):
        squeeze = input.dim() == 3
        x = input[None] if squeeze else input
        h, w = x.shape[1], x.shape[2]
        t, b = max(0, -self.pt), max(0, -self.pb)
        l, r = max(0, -self.pl), max(0, -self.pr)
        x = x[:, t:h - b, l:w - r, :]
        x = F.pad(x, (0, 0, max(0, self.pl), max(0, self.pr),
                      max(0, self.pt), max(0, self.pb)))
        return x[0] if squeeze else x


class Narrow(TensorModule):
    """``length`` entries from 1-based ``offset`` on 1-based
    ``dimension``; a negative length counts back from the end (reference
    ``Narrow``)."""

    def __init__(self, dimension: int, offset: int, length: int = 1):
        super().__init__()
        self.dimension, self.offset, self.length = dimension, offset, length

    def forward(self, input):
        axis = self.dimension - 1
        start = self.offset - 1
        length = self.length
        if length < 0:
            length = input.shape[axis] - start + length + 1
        return input.narrow(axis, start, length)


class Select(TensorModule):
    """Index ``index`` of dim ``dimension``, dropping the dim (1-based;
    negative values count from the end) (reference ``Select``)."""

    def __init__(self, dimension: int, index: int):
        super().__init__()
        self.dimension, self.index = dimension, index

    def forward(self, input):
        axis = (self.dimension - 1 if self.dimension > 0
                else input.dim() + self.dimension)
        idx = (self.index - 1 if self.index > 0
               else input.shape[axis] + self.index)
        return input.select(axis, idx)


class Reverse(TensorModule):
    """Flip 1-based dim ``dimension`` (reference ``Reverse``)."""

    def __init__(self, dimension: int = 1):
        super().__init__()
        self.dimension = dimension

    def forward(self, input):
        return input.flip(self.dimension - 1)


class Contiguous(TensorModule):
    """reference ``Contiguous``: the same values, laid out contiguously."""

    def forward(self, input):
        return input.contiguous()
