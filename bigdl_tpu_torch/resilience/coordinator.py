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
- A sharded snapshot (a directory) is reported and refused: it waits for
  ``utils/sharded_checkpoint.py``, ROADMAP A.5 (sharded_checkpoint).

Filesystem-only and torch-free at import: ``python -m
bigdl_tpu_torch.resilience validate`` runs on a bare host.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

MARKER_NAME = "resume.json"
MARKER_FORMAT = 1
SHARDED_WAITS = ("sharded snapshots are not ported yet: ROADMAP A.5 "
                 "(sharded_checkpoint)")


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
    ``"model"`` and ``"state"`` to their ``{"bytes", "crc32"}``."""
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


def validate_pair(model_path: str, state_path: str) -> bool:
    """Is (model, state) a complete, restartable plain snapshot? A sharded
    one (a directory) is not: the port cannot read it yet."""
    if "://" in model_path:
        # scheme'd snapshots: existence is the strongest check the handler
        # contract offers
        from bigdl_tpu_torch.utils import file_io
        try:
            return file_io.exists(model_path) and file_io.exists(state_path)
        except NotImplementedError:
            return True  # no exists hook: trust the names
    if os.path.isdir(model_path) or os.path.isdir(state_path):
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


def is_sharded(path: str) -> bool:
    """A sharded snapshot is a directory (the reference's
    ``utils/sharded_checkpoint.py`` layout)."""
    return "://" not in path and os.path.isdir(path)


def latest_resume_point(checkpoint_path: Optional[str]
                        ) -> Optional[ResumePoint]:
    """The newest COMPLETE plain snapshot pair, or None. Partial pairs (a
    save killed mid-write, a corrupted file) are skipped in favour of the
    previous complete one. A newer sharded pair raises: silently resuming
    from an older plain one would lose work."""
    if not checkpoint_path:
        return None
    for neval, _, model_name, state_name in reversed(
            snapshot_pairs(checkpoint_path)):
        model_path = _join(checkpoint_path, model_name)
        state_path = _join(checkpoint_path, state_name)
        if is_sharded(model_path):
            raise NotImplementedError(f"{model_path}: {SHARDED_WAITS}")
        if not validate_pair(model_path, state_path):
            continue
        return ResumePoint(model_path=model_path, state_path=state_path,
                           neval=neval, sharded=False,
                           marker=read_marker(state_path))
    return None


# ------------------------------------------------------------------ elastic
def current_mesh_descriptor() -> Dict[str, Any]:
    """This run's topology in marker ``mesh`` form: the port trains in one
    process on one device."""
    return {"process_count": 1, "device_count": 1, "mesh_shape": None,
            "sync_mode": "local"}


def is_elastic(marker: Optional[Dict[str, Any]]) -> Optional[bool]:
    """Did the topology change between save and resume? None when the
    marker is absent or carries no mesh record (unknowable). The port runs
    one process, so a snapshot of its own is never elastic."""
    mesh = (marker or {}).get("mesh") or {}
    if "process_count" not in mesh:
        return None
    now = current_mesh_descriptor()
    return (int(mesh["process_count"]) != now["process_count"]
            or int(mesh.get("device_count", 1)) != now["device_count"])


# ------------------------------------------------- host-side snapshot loads
def load_snapshot_host(model_path: str, state_path: str):
    """(params, opt_state, driver) of a plain snapshot pair as host values,
    for loops that do not go through ``Optimizer.resume``. A saved module
    (``model_final``) gives its parameters as host numpy."""
    if is_sharded(model_path):
        raise NotImplementedError(f"{model_path}: {SHARDED_WAITS}")
    from bigdl_tpu_torch.utils import file_io
    snap = file_io.load(model_path, device="cpu")
    if not isinstance(snap, dict):      # a saved Module
        snap = {"params": {n: p.detach().numpy()
                           for n, p in snap.named_parameters()}}
    st = file_io.load(state_path, device="cpu")
    return snap["params"], st["optim"], dict(st.get("driver", {}))
