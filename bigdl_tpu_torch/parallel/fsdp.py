"""FSDP (ZeRO-3) parameter layout over the data axis (counterpart of
``bigdl_tpu/parallel/fsdp.py``: ``fsdp_param_specs`` and
``shard_fraction``).

Each leaf is sharded on its canonical OUTPUT dimension, dim 0 for 1-2D
leaves (Linear ``(out, in)``, biases) and the last dim for >= 3D ones
(conv HWIO's O), when that dimension is at least the rank count and
divides by it; any other leaf stays replicated. A spec is a tuple as the
reference's ``PartitionSpec`` reads: ``()`` replicated, ``(None, "data")``
sharded on dim 1. ``DistriOptimizer(sync_mode="fsdp")`` keeps each
sharded leaf and its optimizer state as this rank's slab of that
dimension. Composing with a tensor axis (``base_specs``) is the next
slice's: ROADMAP A.4 (distributed plane: model-parallel axes).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_PARALLEL


def shard_dim(shape: Tuple[int, ...], n_dev: int) -> Optional[int]:
    """The dimension ``fsdp_param_specs`` shards a leaf of ``shape`` on,
    or None when it stays replicated."""
    if not shape:
        return None
    d = 0 if len(shape) <= 2 else len(shape) - 1
    if shape[d] >= n_dev and shape[d] % n_dev == 0:
        return d
    return None


def _spec(leaf, n_dev: int, axis: str) -> Tuple:
    shape = tuple(np.shape(leaf)) if not hasattr(leaf, "shape") \
        else tuple(leaf.shape)
    d = shard_dim(shape, n_dev)
    return () if d is None else tuple([None] * d + [axis])


def fsdp_param_specs(params: Any, n_dev: int, axis: str = DATA_AXIS,
                     base_specs: Any = None) -> Any:
    """A spec tree matching ``params`` (nested dicts, lists and tuples of
    tensors or arrays); see the module docstring."""
    if base_specs is not None:
        raise NotImplementedError(
            f"fsdp over a tensor axis is not ported yet: ROADMAP "
            f"{MODEL_PARALLEL}")

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v) for v in tree)
        return _spec(tree, n_dev, axis)

    return walk(params)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _nbytes(leaf) -> int:
    if hasattr(leaf, "element_size"):      # a tensor
        return leaf.numel() * leaf.element_size()
    return int(np.size(leaf)) * np.dtype(
        getattr(leaf, "dtype", np.float32)).itemsize


def shard_fraction(params: Any, n_dev: int) -> float:
    """Fraction of parameter bytes ``fsdp_param_specs`` shards (the rest
    stays replicated)."""
    total = sharded = 0
    for leaf in _leaves(params):
        nbytes = _nbytes(leaf)
        total += nbytes
        if _spec(leaf, n_dev, DATA_AXIS):
            sharded += nbytes
    return sharded / max(1, total)
