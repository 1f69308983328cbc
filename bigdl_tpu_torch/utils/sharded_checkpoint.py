"""Sharded checkpoints: per-process shard files and a manifest (counterpart
of ``bigdl_tpu/utils/sharded_checkpoint.py``, in its format 2).

- ``save_sharded(path, tree)``, called by every process of the group,
  writes this process's ``shard-{pidx:05d}.npz`` (``pidx`` from
  ``Engine.process_index()``) and, from process 0, ``manifest.json``:
  ``{"format": 2, "shards": [...], "leaves": {key: {"shape", "dtype"}}}``,
  naming every process's shard file. A ``Slab`` leaf (this process's
  block of a sharded array, with the array's global shape and the block's
  offsets) is written by its process; any other leaf is replicated and
  written by process 0 alone, once. Leaf keys are the reference's
  ``jax.tree_util.keystr`` form over nested dicts, lists and tuples
  (``['params']['w']``, ``['optim'][0]``); npz members are named
  ``<leafkey>||<offsets>||<shape>``. Each file is written to a temporary
  name and moved into place with ``os.replace``, so a file under its final
  name is complete; process 0 first deletes shard files of an earlier,
  wider save that this save does not name.
- ``load_sharded(path, targets)`` rebuilds the tree whose structure
  ``targets`` gives: a ``None`` leaf comes back as host numpy, a device
  (``torch.device`` or its name) as a tensor there. A leaf stored as
  several slabs is assembled by their offsets; missing coverage raises.
  Format-1 manifests (a bare leaves dict, shard files found by name) load.
  Every process reads every slab, so a snapshot saved by N processes
  restores into any other number (resharding restore: each process then
  takes its own blocks of the full leaves).

bfloat16 leaves are written as the reference writes them, the raw 2-byte
patterns (numpy dtype ``V2``) with ``"bfloat16"`` in the manifest, and read
back by their bits into ``torch.bfloat16`` (a ``None`` target gives a CPU
bf16 tensor: numpy has no bfloat16 without ``ml_dtypes``). The reference's
own loader cannot read such a leaf back (ROADMAP C, known differences).

Torch is imported inside the functions.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["save_sharded", "load_sharded", "is_sharded_checkpoint",
           "read_manifest", "shard_filename", "manifest_targets", "Slab"]

_SEP = "||"
_BF16 = "bfloat16"


class Slab:
    """This process's block ``data`` of a sharded array of
    ``global_shape``, at ``offsets``."""

    __slots__ = ("data", "global_shape", "offsets")

    def __init__(self, data, global_shape, offsets):
        self.data = data
        self.global_shape = tuple(int(v) for v in global_shape)
        self.offsets = tuple(int(v) for v in offsets)


def _keystr(path: Tuple) -> str:
    """``jax.tree_util.keystr`` of a key path: ``[repr(key)]`` per level."""
    return "".join(f"[{k!r}]" for k in path)


def _flatten(tree, path: Tuple = (), is_leaf=lambda x: False) -> List:
    """(key path, leaf) pairs over nested dicts (keys sorted, as jax flattens
    them), lists and tuples."""
    if not is_leaf(tree):
        if isinstance(tree, dict):
            return [kv for k in sorted(tree)
                    for kv in _flatten(tree[k], path + (k,), is_leaf)]
        if isinstance(tree, (list, tuple)):
            return [kv for i, x in enumerate(tree)
                    for kv in _flatten(x, path + (i,), is_leaf)]
    return [(path, tree)]


def _rebuild(tree, leaves, is_leaf=lambda x: False):
    """``tree``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if not is_leaf(tree):
        if isinstance(tree, dict):
            out = {k: None for k in tree}
            for k in sorted(tree):
                out[k] = _rebuild(tree[k], leaves, is_leaf)
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(_rebuild(x, leaves, is_leaf) for x in tree)
    return next(leaves)


def _slab_name(key: str, offsets, shape) -> str:
    return _SEP.join([key, ",".join(map(str, offsets)),
                      ",".join(map(str, shape))])


def _parse_slab(name: str):
    key, offs, shape = name.rsplit(_SEP, 2)
    to_tuple = lambda s: tuple(int(v) for v in s.split(",")) if s else ()
    return key, to_tuple(offs), to_tuple(shape)


def shard_filename(pidx: int) -> str:
    return f"shard-{pidx:05d}.npz"


def _atomic_write_npz(path: str, blobs) -> None:
    # a file object, not a name: numpy would append ".npz" to the tmp name
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            np.savez(f, **blobs)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _host_leaves(leaves: List) -> List[Tuple[np.ndarray, str]]:
    """(array to store, manifest dtype) per leaf: tensors copied off the
    card without blocking and waited for once; bf16 as its bit patterns."""
    import torch
    staged, from_card = [], False
    for leaf in leaves:
        if torch.is_tensor(leaf):
            t = leaf.detach()
            from_card |= t.is_cuda
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            staged.append((t.to("cpu", non_blocking=True),
                           leaf.dtype == torch.bfloat16))
        else:
            staged.append((np.asarray(leaf), False))
    if from_card:
        torch.cuda.synchronize()
    out = []
    for arr, bf16 in staged:
        if torch.is_tensor(arr):
            arr = arr.numpy()
        if bf16:
            out.append((arr.view("V2"), _BF16))
        else:
            out.append((arr, str(arr.dtype)))
    return out


def save_sharded(path: str, tree: Any) -> None:
    """Write this process's shard of ``tree`` (nested dicts, lists and
    tuples of tensors, numpy arrays, scalars and ``Slab``s) under the
    directory ``path``; process 0 also writes the manifest. Every process
    of the group calls it with a tree of the same structure."""
    from bigdl_tpu_torch.utils.engine import Engine
    os.makedirs(path, exist_ok=True)
    pidx, nproc = Engine.process_index(), Engine.process_count()
    shard_names = [shard_filename(i) for i in range(nproc)]
    if pidx == 0:
        # stale shards of an earlier, wider save into this directory: no
        # live writer uses their names
        for fname in os.listdir(path):
            if (fname.startswith("shard-") and fname.endswith(".npz")
                    and fname not in shard_names):
                os.unlink(os.path.join(path, fname))
    flat = _flatten(tree)
    mine = [(kp, leaf) for kp, leaf in flat
            if isinstance(leaf, Slab) or pidx == 0]
    blobs, leaves = {}, {}
    for (keypath, leaf), (arr, dtype) in zip(mine, _host_leaves(
            [leaf.data if isinstance(leaf, Slab) else leaf
             for _, leaf in mine])):
        key = _keystr(keypath)
        if isinstance(leaf, Slab):
            shape, offsets = leaf.global_shape, leaf.offsets
        else:
            shape, offsets = arr.shape, (0,) * arr.ndim
        leaves[key] = {"shape": list(shape), "dtype": dtype}
        blobs[_slab_name(key, offsets, arr.shape)] = arr
    _atomic_write_npz(os.path.join(path, shard_names[pidx]), blobs)
    if pidx != 0:
        return
    manifest = {"format": 2, "shards": shard_names, "leaves": leaves}
    tmp = os.path.join(path, f".manifest.tmp-{os.getpid()}")
    with open(tmp, "w") as f:
        json.dump(manifest, f)
    os.replace(tmp, os.path.join(path, "manifest.json"))


def is_sharded_checkpoint(path: str) -> bool:
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "manifest.json"))


def read_manifest(path: str):
    """(leaves, shard_names) of ``manifest.json``; format 1 (a bare leaves
    dict) gives ``shard_names=None``."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if isinstance(manifest, dict) and "leaves" in manifest:
        return manifest["leaves"], manifest.get("shards")
    return manifest, None


def _parse_keystr(key: str) -> Tuple:
    """The key path of a ``keystr``: ``"['a'][0]"`` -> ``('a', 0)``."""
    import ast
    path, i = [], 0
    while i < len(key):
        if key[i] != "[":
            raise ValueError(f"not a key path: {key!r}")
        j, quote = i + 1, None
        while key[j] != "]" or quote:
            if quote and key[j] == "\\":
                j += 1
            elif key[j] in "'\"" and quote in (None, key[j]):
                quote = None if quote else key[j]
            j += 1
        path.append(ast.literal_eval(key[i + 1:j]))
        i = j + 1
    return tuple(path)


def manifest_targets(path: str) -> Any:
    """A ``load_sharded`` target tree of ``None`` leaves built from the
    manifest's keys: a string key makes a dict, an integer one a list."""
    root: Dict = {}
    for key in read_manifest(path)[0]:
        node, kp = root, _parse_keystr(key)
        for k in kp[:-1]:
            node = node.setdefault(k, {})
        node[kp[-1]] = None

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(isinstance(k, int) for k in out) and \
                sorted(out) == list(range(len(out))):
            return [out[i] for i in range(len(out))]
        return out
    return listify(root)


def _slab_index(path: str, shard_names: Optional[List[str]]) -> Dict:
    """key -> [(npz file, member, offsets, shape)] over the shard files
    (their zip directories only). A file the manifest names and that is
    missing is an incomplete snapshot."""
    if shard_names is None:
        shard_names = sorted(
            f for f in os.listdir(path)
            if f.startswith("shard-") and f.endswith(".npz"))
    index: Dict[str, list] = {}
    for fname in shard_names:
        full = os.path.join(path, fname)
        if not os.path.exists(full):
            raise ValueError(
                f"snapshot {path} is incomplete: manifest names {fname} "
                "but the file is missing (writer killed mid-save, or not "
                "all processes' shard files were copied)")
        with np.load(full) as z:
            names = list(z.files)
        for name in names:
            key, offs, shape = _parse_slab(name)
            index.setdefault(key, []).append((full, name, offs, shape))
    return index


def _is_target(x) -> bool:
    import torch
    return x is None or isinstance(x, (str, torch.device))


def load_sharded(path: str, targets: Any) -> Any:
    """Rebuild the snapshot at ``path`` in the structure of ``targets``,
    a tree whose leaves are ``None`` (host numpy) or a device."""
    import torch
    manifest, shard_names = read_manifest(path)
    index = _slab_index(path, shard_names)
    open_files: dict = {}

    def read_leaf(key: str, dtype: np.dtype, shape) -> np.ndarray:
        out = np.empty(shape, dtype)
        filled = 0
        for fname, member, offs, sshape in index.get(key, ()):
            z = open_files.setdefault(fname, np.load(fname))
            slab = z[member]
            if slab.dtype != dtype:
                slab = slab.view(dtype)
            dst = tuple(slice(o, o + s) for o, s in zip(offs, sshape))
            out[dst] = slab
            filled += int(np.prod(sshape))
        if filled < out.size:
            raise ValueError(
                f"checkpoint slabs do not cover {key} ({filled}/{out.size} "
                "elements): an incomplete checkpoint")
        return out

    def restore(keypath, target):
        key = _keystr(keypath)
        if key not in manifest:
            raise KeyError(f"{key} not in checkpoint manifest at {path}")
        meta = manifest[key]
        shape = tuple(meta["shape"])
        if meta["dtype"] == _BF16:
            bits = read_leaf(key, np.dtype(np.int16), shape)
            value = torch.from_numpy(bits).view(torch.bfloat16)
        else:
            value = read_leaf(key, np.dtype(meta["dtype"]), shape)
            if target is None:
                return value
            value = torch.from_numpy(value)
        return value if target is None else value.to(torch.device(target))

    flat = _flatten(targets, is_leaf=_is_target)
    try:
        leaves = [restore(kp, t) for kp, t in flat]
    finally:
        for z in open_files.values():
            z.close()
    return _rebuild(targets, iter(leaves), is_leaf=_is_target)
