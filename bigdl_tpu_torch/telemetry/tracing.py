"""Low-overhead span tracer: ``span("name")`` -> bounded ring buffer ->
Chrome ``trace_event`` JSON (loads in ``chrome://tracing`` / Perfetto);
counterpart of ``bigdl_tpu/telemetry/tracing.py``, copied.

The host-side companion of ``torch.profiler`` device traces: the profiler
answers "what did the card do", this answers "where did the HOST spend a
request" — batcher waits, prefill vs decode blocks — across threads, cheap
enough to leave in. CUDA runs asynchronously: a span around eager launches
measures the host's enqueue, and it includes device time only where the
span closes after a copy to the host (the serving decode block does; the
prefill and insert spans do not). No span synchronizes to look exact.

Disabled is the default and the whole cost: ``span()`` checks one
module-global flag and returns a shared no-op context manager — no
allocation, no clock read, nothing appended. Enable for a window with
``enable()`` (or process-wide via ``BIGDL_TPU_TRACE=/path.json``, dumped
at exit), then ``dump()``/``to_chrome_trace()``. The buffer is a
``deque(maxlen=capacity)``: a forgotten-enabled tracer costs bounded
memory and keeps the newest events, matching how operators actually use
a flight recorder.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
from collections import deque
from typing import List, Optional

__all__ = ["span", "enable", "disable", "is_enabled", "clear", "events",
           "to_chrome_trace", "dump", "set_capacity", "capacity",
           "async_begin", "async_instant", "async_end", "complete_event",
           "DEFAULT_CAPACITY"]

DEFAULT_CAPACITY = 65536

_enabled = False
_lock = threading.Lock()
_buffer: deque = deque(maxlen=DEFAULT_CAPACITY)
# perf_counter origin for µs timestamps: monotonic, shared by every
# thread, zeroed at import so traces start near t=0
_T0 = time.perf_counter()


def is_enabled() -> bool:
    return _enabled


def enable(capacity: Optional[int] = None) -> None:
    """Turn the tracer on (optionally resizing the ring buffer; existing
    events carry over, newest-first retention)."""
    global _enabled
    if capacity is not None:
        set_capacity(capacity)
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def set_capacity(capacity: int) -> None:
    global _buffer
    if int(capacity) < 1:
        raise ValueError(f"trace capacity must be >= 1, got {capacity}")
    with _lock:
        _buffer = deque(_buffer, maxlen=int(capacity))


def capacity() -> int:
    return _buffer.maxlen or DEFAULT_CAPACITY


def clear() -> None:
    with _lock:
        _buffer.clear()


def events() -> List[dict]:
    """Snapshot of buffered events (oldest first)."""
    with _lock:
        return list(_buffer)


class _NoopSpan:
    """The disabled path: one shared, stateless, reentrant instance."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def annotate(self, **kwargs) -> None:
        pass


_NOOP = _NoopSpan()


class _Span:
    __slots__ = ("_name", "_cat", "_args", "_t0")

    def __init__(self, name: str, cat: str, args: dict):
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def annotate(self, **kwargs) -> None:
        """Attach key/values mid-span (they land in the event's args)."""
        self._args.update(kwargs)

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        ev = {"name": self._name, "cat": self._cat, "ph": "X",
              "ts": (self._t0 - _T0) * 1e6, "dur": (t1 - self._t0) * 1e6,
              "pid": os.getpid(), "tid": threading.get_ident()}
        if exc_type is not None:
            self._args["error"] = exc_type.__name__
        if self._args:
            ev["args"] = self._args
        with _lock:
            _buffer.append(ev)
        return False


def span(name: str, cat: str = "bigdl", **args):
    """Context manager timing one named region.

    Disabled (the default): a single branch returning the shared no-op —
    safe on the hottest host paths. Enabled: records a Chrome
    ``trace_event`` complete event ("ph": "X") with µs timestamps, the
    thread id, and any keyword args."""
    if not _enabled:
        return _NOOP
    return _Span(name, cat, dict(args))


def _async_event(ph: str, name: str, id: int, cat: str, args: dict) -> None:
    ev = {"name": name, "cat": cat, "ph": ph, "id": int(id),
          "ts": (time.perf_counter() - _T0) * 1e6,
          "pid": os.getpid(), "tid": threading.get_ident()}
    if args:
        ev["args"] = args
    with _lock:
        _buffer.append(ev)


def async_begin(name: str, id: int, cat: str = "bigdl", **args) -> None:
    """Open a Chrome async phase (``ph: "b"``) under ``id``. Async events
    sharing (cat, id, name) render as one lifecycle lane in Perfetto —
    the per-request linkage the serving engines use: every phase of one
    request carries the same id, so a single trace dump reconstructs its
    submit -> queue -> admit -> decode -> complete journey."""
    if _enabled:
        _async_event("b", name, id, cat, args)


def async_instant(name: str, id: int, cat: str = "bigdl", **args) -> None:
    """Mark a point inside an open async phase (``ph: "n"``)."""
    if _enabled:
        _async_event("n", name, id, cat, args)


def async_end(name: str, id: int, cat: str = "bigdl", **args) -> None:
    """Close the async phase opened by ``async_begin`` with the same
    (cat, id, name)."""
    if _enabled:
        _async_event("e", name, id, cat, args)


def complete_event(name: str, t0: float, t1: float, cat: str = "bigdl",
                   **args) -> None:
    """Record an X event for an ALREADY-elapsed [t0, t1] window
    (``time.perf_counter()`` values) — e.g. a request's queue wait, whose
    start happened on another thread before anyone knew how long it would
    be. ``span()`` covers the with-block case; this covers retrodiction."""
    if not _enabled:
        return
    ev = {"name": name, "cat": cat, "ph": "X", "ts": (t0 - _T0) * 1e6,
          "dur": max(0.0, (t1 - t0) * 1e6),
          "pid": os.getpid(), "tid": threading.get_ident()}
    if args:
        ev["args"] = args
    with _lock:
        _buffer.append(ev)


def to_chrome_trace() -> dict:
    """The buffered events as a Chrome trace_event JSON object — load the
    dumped file in chrome://tracing or https://ui.perfetto.dev."""
    return {"traceEvents": events(), "displayTimeUnit": "ms"}


def dump(path: str) -> str:
    """Write the Chrome trace JSON to ``path``; returns the path."""
    with open(path, "w") as f:
        json.dump(to_chrome_trace(), f)
    return path


# BIGDL_TPU_TRACE=/path.json: process-wide flight recorder — enable at
# import, dump on interpreter exit (the reference's variable and
# behaviour).
_env_path = os.environ.get("BIGDL_TPU_TRACE", "")
if _env_path:
    enable()
    atexit.register(dump, _env_path)
