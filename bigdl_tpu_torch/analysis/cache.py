"""Content-hash result cache for the port's whole-program lint passes
(counterpart of ``bigdl_tpu/analysis/cache.py``).

graftlint findings are a pure function of (analyzer source, selected
rule set, every linted file's content) — the whole-program pass means
ANY file can change another file's findings through exports, resolved
constants, or call summaries, so the sound cache granularity is the
whole pass, not the single file. The key is therefore one digest over:

- the port analyser's own sources (a rule edit busts everything),
- the selected rule codes,
- every (path, content-sha256) pair in the lint set.

A hit returns the stored findings without parsing a single file: the
warm full-tree gate pass drops from seconds of AST work to the cost of
hashing the tree (``tests/test_torch_graftlint_gate.py`` holds a warm
hit to the cold pass, and to parsing no file). Storage is one JSON file
per key under ``$GRAFTLINT_CACHE`` (default
``~/.cache/graftlint-torch``), written atomically; ``--no-cache`` or
``GRAFTLINT_NO_CACHE=1`` bypasses it entirely.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from functools import lru_cache
from typing import Dict, List, Optional, Sequence

FORMAT_VERSION = 1
_KEEP_ENTRIES = 32  # cap the cache dir: drop oldest beyond this many


def cache_dir() -> str:
    return os.environ.get("GRAFTLINT_CACHE") or os.path.join(
        os.path.expanduser("~"), ".cache", "graftlint-torch")


def enabled() -> bool:
    return os.environ.get("GRAFTLINT_NO_CACHE", "") not in ("1", "true")


@lru_cache(maxsize=1)
def analysis_digest() -> str:
    """sha256 over the analyzer's own sources, so rule/core edits
    invalidate every cached result."""
    root = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256(f"graftlint-torch-cache-v{FORMAT_VERSION}".encode())
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for name in sorted(filenames):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            h.update(os.path.relpath(path, root).encode())
            with open(path, "rb") as f:
                h.update(hashlib.sha256(f.read()).digest())
    return h.hexdigest()


def program_key(sources: Dict[str, str], rule_codes: Sequence[str]) -> str:
    """One digest for a whole lint pass: analyzer + rules + all inputs."""
    h = hashlib.sha256(analysis_digest().encode())
    h.update(",".join(sorted(rule_codes)).encode())
    for path in sorted(sources):
        h.update(path.encode())
        h.update(hashlib.sha256(sources[path].encode()).digest())
    return h.hexdigest()


def _entry_path(key: str) -> str:
    return os.path.join(cache_dir(), f"{key}.json")


def lookup(key: str, order: Sequence[str]) -> Optional[List["FileResult"]]:
    """Stored results for ``key``, re-ordered to the caller's file order
    (walk order is part of the lint_paths contract). None on miss or on
    any mismatch with the requested file set."""
    from bigdl_tpu_torch.analysis.core import FileResult, Finding

    try:
        with open(_entry_path(key), encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if doc.get("format") != FORMAT_VERSION:
        return None
    by_path = {}
    for rec in doc.get("results", []):
        by_path[rec["path"]] = FileResult(
            rec["path"],
            [Finding(**fd) for fd in rec["findings"]],
            [Finding(**fd) for fd in rec["suppressed"]])
    if set(by_path) != set(order):
        return None
    os.utime(_entry_path(key), None)  # LRU recency for _evict
    return [by_path[p] for p in order]


def store(key: str, results: Sequence["FileResult"]) -> None:
    """Atomically persist one pass's results; best-effort (a read-only
    cache dir silently disables storing, never the lint)."""
    from dataclasses import asdict

    doc = {"format": FORMAT_VERSION,
           "results": [{"path": r.path,
                        "findings": [asdict(f) for f in r.findings],
                        "suppressed": [asdict(f) for f in r.suppressed]}
                       for r in results]}
    try:
        os.makedirs(cache_dir(), exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=cache_dir(), suffix=".tmp")
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(doc, f)
        os.replace(tmp, _entry_path(key))
        _evict()
    except OSError:
        pass


def _evict() -> None:
    entries = []
    for name in os.listdir(cache_dir()):
        if name.endswith(".json"):
            path = os.path.join(cache_dir(), name)
            try:
                entries.append((os.path.getmtime(path), path))
            except OSError:
                continue
    for _, path in sorted(entries)[:-_KEEP_ENTRIES]:
        try:
            os.remove(path)
        except OSError:
            pass
