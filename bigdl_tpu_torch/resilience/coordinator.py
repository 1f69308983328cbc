"""Resume coordination (counterpart of
``bigdl_tpu/resilience/coordinator.py``, its single-process part): find the
newest COMPLETE snapshot, reject partial writes, and restart from it.

- ``latest_resume_point(path)`` walks ``model.N``/``state.N`` pairs newest
  first (numeric tag, then mtime: the reference's ``getLatestFile``
  order) and returns the first complete one as a ``ResumePoint``; partial
  snapshots are skipped, not fatal.
- A plain (single-file) pair is complete when both files exist and are
  non-empty, as in the reference, and, where its RESUME marker records
  the files' sizes and CRC-32s (the port's markers do), when both files
  still have them: a truncated or bit-flipped snapshot
  (``chaos.corrupt_snapshot``) reads as partial.
- The RESUME marker (``<state>.resume.json``, written last and
  atomically) records ``step``, ``epoch``, the data ``cursor`` and
  ``format``, as the reference's does, and the port's own ``rng`` entry:
  what makes a mid-epoch restart bit-exact (``optim/optimizer.py``).
- A sharded pair (two directories, ``utils/sharded_checkpoint.py``) is
  complete when each has its ``manifest.json`` and every shard file the
  manifest names, and the state directory its ``driver.json``, as in the
  reference; where the marker (inside the state directory) records each
  shard file's size and CRC-32 (the port's do), when every file still has
  them.
- ``current_mesh_descriptor`` and ``is_elastic``: the marker's ``mesh``
  record of the saving run against this one's process and device counts
  (a snapshot of world 2 resumed by world 1 is elastic). The agreed
  preemption step of a process group is ``DistriOptimizer``'s.

Filesystem-only and torch-free at import: ``python -m
bigdl_tpu_torch.resilience validate`` runs on a bare host.
"""

from __future__ import annotations

import json
import os
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

MARKER_NAME = "resume.json"
MARKER_FORMAT = 1


# --------------------------------------------------------------- the marker
def _marker_path(state_path: str) -> str:
    if os.path.isdir(state_path):
        return os.path.join(state_path, MARKER_NAME)
    return state_path + "." + MARKER_NAME


def write_marker(state_path: str, *, step: int, epoch: int,
                 rng: Optional[Dict[str, Any]], epoch_batches: int,
                 epoch_records: int, mesh: Dict[str, Any],
                 cursor_epoch: Optional[int] = None,
                 files: Optional[Dict[str, Dict[str, int]]] = None) -> str:
    """Atomically write the RESUME marker beside a plain state snapshot,
    as ``<state>.resume.json``. Written LAST, after the snapshot itself,
    so a marker's presence implies the saver got that far.
    ``cursor_epoch`` is the epoch the batch counts refer to: at an
    epoch-boundary save it is the FINISHED epoch while ``epoch`` already
    names the next one, and the resuming loop only skips batches when they
    match. ``rng`` is the port's generator record; ``files`` maps
    ``"model"`` and ``"state"`` to their ``{"bytes", "crc32"}`` (for a
    sharded pair, to ``{shard file: {"bytes", "crc32"}}``)."""
    marker = {
        "format": MARKER_FORMAT,
        "step": int(step),
        "epoch": int(epoch),
        "rng": rng,
        "cursor": {"epoch": int(epoch if cursor_epoch is None
                                else cursor_epoch),
                   "epoch_batches": int(epoch_batches),
                   "epoch_records": int(epoch_records)},
        "mesh": mesh,
        "files": files,
        "complete": True,
    }
    path = _marker_path(state_path)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(marker, f)
    os.replace(tmp, path)
    return path


def read_marker(state_path: str) -> Optional[Dict[str, Any]]:
    """The RESUME marker of a state snapshot, or None (an absent marker is
    legal: such a snapshot resumes epoch-granular; an unreadable or
    incomplete one reads as absent too)."""
    try:
        with open(_marker_path(state_path)) as f:
            marker = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(marker, dict) or not marker.get("complete"):
        return None
    return marker


# ------------------------------------------------------------- completeness
def _digest(path: str) -> Dict[str, int]:
    import zlib
    crc, n = 0, 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 24)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            n += len(chunk)
    return {"bytes": n, "crc32": crc}


def sharded_digests(path: str) -> Dict[str, Dict[str, int]]:
    """``{shard file: {"bytes", "crc32"}}`` of a sharded snapshot
    directory, for its RESUME marker's ``files``."""
    from bigdl_tpu_torch.utils.sharded_checkpoint import read_manifest
    _, shards = read_manifest(path)
    return {s: _digest(os.path.join(path, s)) for s in shards}


def sharded_snapshot_complete(path: str) -> bool:
    """Manifest present and every shard file it names present (format 2).
    Format-1 manifests (no shard list) are complete when at least one
    shard file exists, the strongest check that format allows."""
    manifest_path = os.path.join(path, "manifest.json")
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    shards = (manifest.get("shards")
              if isinstance(manifest, dict) and "leaves" in manifest
              else None)
    if shards is None:
        return any(f.startswith("shard-") and f.endswith(".npz")
                   for f in os.listdir(path))
    return all(os.path.exists(os.path.join(path, s)) for s in shards)


def validate_pair(model_path: str, state_path: str) -> bool:
    """Is (model, state) a complete, restartable snapshot pair?"""
    if "://" in model_path:
        # scheme'd snapshots: existence is the strongest check the handler
        # contract offers
        from bigdl_tpu_torch.utils import file_io
        try:
            return file_io.exists(model_path) and file_io.exists(state_path)
        except NotImplementedError:
            return True  # no exists hook: trust the names
    if os.path.isdir(model_path):
        if not (sharded_snapshot_complete(model_path)
                and os.path.isdir(state_path)
                and sharded_snapshot_complete(state_path)
                and os.path.exists(os.path.join(state_path, "driver.json"))):
            return False
        files = (read_marker(state_path) or {}).get("files")
        if not files:
            return True
        try:
            return (sharded_digests(model_path) == files.get("model")
                    and sharded_digests(state_path) == files.get("state"))
        except (OSError, ValueError):
            return False
    if os.path.isdir(state_path):
        return False
    try:
        if not (os.path.getsize(model_path) > 0
                and os.path.getsize(state_path) > 0):
            return False
    except OSError:
        return False
    files = (read_marker(state_path) or {}).get("files")
    if not files:
        return True
    try:
        return (_digest(model_path) == files.get("model")
                and _digest(state_path) == files.get("state"))
    except OSError:
        return False


# ---------------------------------------------------------------- discovery
@dataclass
class ResumePoint:
    """One validated restart point under a checkpoint directory."""

    model_path: str
    state_path: str
    neval: int                                  # numeric tag; -1 = untagged
    sharded: bool
    marker: Optional[Dict[str, Any]] = field(default=None, repr=False)

    def saved_mesh(self) -> Optional[Dict[str, Any]]:
        """The RESUME marker's ``mesh`` entry, if it has one."""
        return (self.marker or {}).get("mesh")


def _listdir(path: str) -> List[str]:
    if "://" in path:
        from bigdl_tpu_torch.utils import file_io
        return file_io.listdir(path)
    return os.listdir(path)


def _mtime(path: str) -> float:
    if "://" in path:
        from bigdl_tpu_torch.utils import file_io
        return file_io.getmtime(path)
    return os.path.getmtime(path)


def _join(base: str, name: str) -> str:
    if "://" in base:
        return base.rstrip("/") + "/" + name
    return os.path.join(base, name)


def snapshot_pairs(checkpoint_path: str) -> List[Tuple[int, float, str, str]]:
    """All (neval, mtime, model_name, state_name) snapshot pairs under
    ``checkpoint_path``, best last (numeric tag order, mtime tie-break)."""
    try:
        names = set(_listdir(checkpoint_path))
    except (OSError, NotImplementedError):
        return []
    pairs = []
    for name in names:
        if name != "model" and not name.startswith("model."):
            continue
        state_name = "state" + name[len("model"):]
        if state_name not in names:
            continue
        try:
            neval = int(name[len("model."):])
        except ValueError:
            neval = -1
        try:
            mtime = _mtime(_join(checkpoint_path, name))
        except OSError:
            continue
        pairs.append((neval, mtime, name, state_name))
    pairs.sort()
    return pairs


def latest_resume_point(checkpoint_path: Optional[str]
                        ) -> Optional[ResumePoint]:
    """The newest COMPLETE snapshot pair, plain or sharded, or None.
    Partial pairs (a save killed mid-write, a corrupted file) are skipped
    in favour of the previous complete one."""
    if not checkpoint_path:
        return None
    for neval, _, model_name, state_name in reversed(
            snapshot_pairs(checkpoint_path)):
        model_path = _join(checkpoint_path, model_name)
        state_path = _join(checkpoint_path, state_name)
        if not validate_pair(model_path, state_path):
            continue
        return ResumePoint(model_path=model_path, state_path=state_path,
                           neval=neval, sharded=os.path.isdir(model_path),
                           marker=read_marker(state_path))
    return None


# ------------------------------------------------------------------ elastic
def current_mesh_descriptor() -> Dict[str, Any]:
    """This run's topology in marker ``mesh`` form: the process group's
    size (one device a process; one process without a group). A
    ``DistriOptimizer`` adds its mesh shape and sync mode."""
    n = 1
    if "torch" in sys.modules:   # no group can be up without torch
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            n = dist.get_world_size()
    return {"process_count": n, "device_count": n, "mesh_shape": None,
            "sync_mode": "local"}


def is_elastic(marker: Optional[Dict[str, Any]]) -> Optional[bool]:
    """Did the topology change between save and resume? None when the
    marker is absent or carries no mesh record (unknowable)."""
    mesh = (marker or {}).get("mesh") or {}
    if "process_count" not in mesh:
        return None
    now = current_mesh_descriptor()
    return (int(mesh["process_count"]) != now["process_count"]
            or int(mesh.get("device_count", 1)) != now["device_count"])


# ------------------------------------------------- host-side snapshot loads
def manifest_leaf_keys(path: str) -> List[str]:
    """Leaf key paths stored in a sharded snapshot (format 1 or 2)."""
    from bigdl_tpu_torch.utils.sharded_checkpoint import read_manifest
    leaves, _ = read_manifest(path)
    return list(leaves)


def load_snapshot_host(model_path: str, state_path: str):
    """(params, opt_state, driver) of a plain or sharded snapshot pair as
    host values, for loops that do not go through ``Optimizer.resume``. A
    saved module (``model_final``) gives its parameters as host numpy; a
    sharded pair's trees come from its manifests (a bf16 leaf as a CPU
    bf16 tensor)."""
    from bigdl_tpu_torch.utils import sharded_checkpoint as sckpt
    if sckpt.is_sharded_checkpoint(model_path):
        snap = sckpt.load_sharded(model_path, sckpt.manifest_targets(
            model_path))
        st = sckpt.load_sharded(state_path, sckpt.manifest_targets(
            state_path))
        with open(os.path.join(state_path, "driver.json")) as f:
            driver = json.load(f)
        return snap["params"], st["optim"], driver
    from bigdl_tpu_torch.utils import file_io
    snap = file_io.load(model_path, device="cpu")
    if not isinstance(snap, dict):      # a saved Module
        snap = {"params": {n: p.detach().numpy()
                           for n, p in snap.named_parameters()}}
    st = file_io.load(state_path, device="cpu")
    return snap["params"], st["optim"], dict(st.get("driver", {}))
