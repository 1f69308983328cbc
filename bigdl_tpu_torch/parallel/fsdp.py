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
dimension. ``base_specs`` (fsdp x tp): a spec tree from
``tensor_parallel.infer_param_specs`` whose tensor-axis entries are kept,
the data axis landing on a dimension the base spec leaves free, as the
reference's.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from bigdl_tpu_torch.parallel.mesh import DATA_AXIS


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


def _composed(leaf, base: Tuple, n_dev: int, axis: str) -> Tuple:
    """``base``'s entries with ``axis`` on the canonical output dim when it
    is free and divisible, else the first free divisible dim (the base
    alone when none is)."""
    shape = tuple(np.shape(leaf)) if not hasattr(leaf, "shape") \
        else tuple(leaf.shape)
    if not shape:
        return base
    entries = list(base) + [None] * (len(shape) - len(base))
    canonical = 0 if len(shape) <= 2 else len(shape) - 1
    for d in [canonical] + [i for i in range(len(shape)) if i != canonical]:
        if entries[d] is None and shape[d] >= n_dev and shape[d] % n_dev == 0:
            entries[d] = axis
            return tuple(entries)
    return base


def fsdp_param_specs(params: Any, n_dev: int, axis: str = DATA_AXIS,
                     base_specs: Any = None) -> Any:
    """A spec tree matching ``params`` (nested dicts, lists and tuples of
    tensors or arrays); see the module docstring. ``base_specs`` has the
    structure of ``params`` (a leaf it lacks: replicated)."""
    def base_of(path):
        if base_specs is None:
            return None
        node = base_specs
        for key in path:
            node = node.get(key, ()) if isinstance(node, dict) else node[key]
        return node

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, path + (i,))
                              for i, v in enumerate(tree))
        base = base_of(path)
        if base is None:
            return _spec(tree, n_dev, axis)
        return _composed(tree, base, n_dev, axis)

    return walk(params, ())



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
