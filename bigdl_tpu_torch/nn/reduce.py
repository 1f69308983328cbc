"""Dimension-reduction and pairwise-distance layers (counterpart of
``bigdl_tpu/nn/reduce.py``: ``Sum``, ``Mean``, ``Max``, ``Min``,
``CosineDistance`` and ``PairwiseDistance``).

The reference's dimension rule: ``dimension`` is 1-based; a negative one
counts from the end; with ``n_input_dims`` given, an input with one more
(batch) dim than that shifts the dimension by one. The reduced axis is
squeezed from the output. The distance layers take the reference's
``Table`` as a pair ``(x1, x2)`` (a list, a tuple or a ``Table``).
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.module import Module


def _positive_axis(input: torch.Tensor, dimension: int,
                   n_input_dims: int) -> int:
    """The 0-based axis of the reference's 1-based ``dimension``."""
    d = dimension
    if d < 0:
        d = input.dim() + d + 1
    elif n_input_dims > 0 and input.dim() == n_input_dims + 1:
        d += 1  # batched input: shift past the batch dim
    if not 1 <= d <= input.dim():
        raise IndexError(f"dimension {dimension} out of range for "
                         f"{input.dim()}-d input")
    return d - 1


def _pair(input):
    """``(x1, x2)`` of a two-tensor input (a sequence, or a 1-based
    ``Table``)."""
    if isinstance(input, dict):
        return input[1], input[2]
    x1, x2 = input
    return x1, x2


class Sum(Module):
    """Sum over one dimension (reference ``Sum``)."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1,
                 size_average: bool = False):
        super().__init__()
        self.dimension = dimension
        self.n_input_dims = n_input_dims
        self.size_average = size_average

    def forward(self, input):
        ax = _positive_axis(input, self.dimension, self.n_input_dims)
        out = input.sum(dim=ax)
        if self.size_average:
            out = out / input.shape[ax]
        return out

    def extra_repr(self) -> str:
        return str(self.dimension)


class Mean(Sum):
    """Mean over one dimension (reference ``Mean``)."""

    def __init__(self, dimension: int = 1, n_input_dims: int = -1):
        super().__init__(dimension, n_input_dims, size_average=True)


class Max(Module):
    """Max over one dimension (reference ``Max``); the gradient is shared
    evenly by tied maxima, as ``jnp.max``'s is."""

    _largest = True

    def __init__(self, dim: int = 1, num_input_dims: int = -1):
        super().__init__()
        self.dim = dim
        self.num_input_dims = num_input_dims

    def forward(self, input):
        ax = _positive_axis(input, self.dim, self.num_input_dims)
        return input.amax(dim=ax) if self._largest else input.amin(dim=ax)

    def extra_repr(self) -> str:
        return str(self.dim)


class Min(Max):
    """Min over one dimension (reference ``Min``)."""

    _largest = False


class CosineDistance(Module):
    """Cosine similarity of a pair ``(x1, x2)`` of (N, D) rows -> (N, 1),
    or of two (D,) vectors -> (1,) (reference ``CosineDistance``)."""

    def forward(self, input):
        x1, x2 = _pair(input)
        squeeze = x1.dim() == 1
        if squeeze:
            x1, x2 = x1[None], x2[None]
        num = (x1 * x2).sum(dim=1, keepdim=True)
        n1 = torch.clamp((x1 * x1).sum(dim=1, keepdim=True), min=1e-12)
        n2 = torch.clamp((x2 * x2).sum(dim=1, keepdim=True), min=1e-12)
        out = num / torch.sqrt(n1 * n2)
        return out[0] if squeeze else out


class PairwiseDistance(Module):
    """p-norm distance of a pair ``(x1, x2)`` -> (N,) (reference
    ``PairwiseDistance``). ``eps`` is added to every |difference|, which
    keeps the p-th root differentiable at distance 0."""

    def __init__(self, norm: int = 2, eps: float = 1e-6):
        super().__init__()
        self.norm = norm
        self.eps = eps

    def forward(self, input):
        x1, x2 = _pair(input)
        squeeze = x1.dim() == 1
        if squeeze:
            x1, x2 = x1[None], x2[None]
        d = x1 - x2
        # |d| whose derivative at 0 is 1, as jnp.abs's (torch.abs's is 0)
        diff = torch.where(d >= 0, d, -d) + self.eps
        out = (diff ** self.norm).sum(dim=1) ** (1.0 / self.norm)
        return out[0] if squeeze else out
