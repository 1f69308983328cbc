"""Preemption notices -> a cooperative flag (counterpart of
``bigdl_tpu/resilience/preemption.py``, copied).

A platform preempts with a SIGTERM and a grace window. ``PreemptionHandler``
turns the signal into a COOPERATIVE flag that a loop polls: the
``serve`` command of ``apps/transformer.py`` drains its server or fleet on
it (in-flight requests leave as handoff cursors) and exits;
``Optimizer.set_preemption_handler`` polls it at every step boundary, and
the training loop then writes one final snapshot and raises
``TrainingPreempted``.

Signal-handler discipline: the handler body only flips plain attributes
and a ``threading.Event`` — no locks shared with the metrics registry
(a registry-lock acquire inside a signal handler could deadlock against
the interrupted main thread).
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Optional, Sequence

logger = logging.getLogger("bigdl_tpu_torch.resilience")

#: default grace window a platform allows between notice and kill; purely
#: advisory here (``remaining_grace`` lets snapshot code log overrun risk)
DEFAULT_GRACE_SECONDS = 30.0


class TrainingPreempted(Exception):
    """Training stopped on a preemption notice AFTER writing a resumable
    snapshot. Deliberately not retried by the optimizer's
    crash-retry loop: the host is going away — relaunch and
    ``auto_resume()`` instead."""

    def __init__(self, reason: str, snapshot: Optional[str] = None):
        super().__init__(
            f"training preempted ({reason})"
            + (f"; snapshot at {snapshot}" if snapshot else
               "; no checkpoint path configured — nothing was saved"))
        self.reason = reason
        self.snapshot = snapshot


def _parse_signals(spec: str) -> tuple:
    out = []
    for name in spec.split(","):
        name = name.strip()
        if not name:
            continue
        if not name.startswith("SIG"):
            name = "SIG" + name
        out.append(getattr(signal, name))
    return tuple(out)


class PreemptionHandler:
    """Installable SIGTERM (by default) hook with a cooperative flag.

    - ``install()``/``uninstall()``: register/restore the OS handlers
      (main thread only; off the main thread installation degrades to
      cooperative-``trigger()``-only with a warning).
    - ``should_snapshot()``: polled by the training loop at step
      boundaries.
    - ``trigger(reason)``: cooperative path — chaos injectors and tests
      preempt without involving the OS.
    - second notice while one is pending: the previous disposition is
      restored and the signal re-delivered, so an impatient platform
      still gets a prompt exit.

    Env knobs: ``BIGDL_PREEMPT_SIGNALS`` (comma list, default
    ``SIGTERM``), ``BIGDL_PREEMPT_GRACE_SECONDS`` (advisory budget for
    the final snapshot, default 30).
    """

    def __init__(self, signals: Optional[Sequence[int]] = None,
                 grace_seconds: Optional[float] = None):
        if signals is None:
            signals = _parse_signals(
                os.environ.get("BIGDL_PREEMPT_SIGNALS", "SIGTERM"))
        self.signals = tuple(signals)
        if grace_seconds is None:
            grace_seconds = float(
                os.environ.get("BIGDL_PREEMPT_GRACE_SECONDS",
                               str(DEFAULT_GRACE_SECONDS)))
        self.grace_seconds = float(grace_seconds)
        self._flag = threading.Event()
        self._reason: Optional[str] = None
        self._t_notice: Optional[float] = None
        self._notices = 0          # set by handler/trigger, read by drain
        self._drained = 0          # consumer-side counter (metrics)
        self._prev: dict = {}
        self.installed = False
        self._drain_hooks: list = []  # consumer-thread only, never the handler

    # ------------------------------------------------------------- lifecycle
    def install(self) -> "PreemptionHandler":
        if self.installed:
            return self
        try:
            for sig in self.signals:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            self.installed = True
        except ValueError:
            # signal.signal outside the main thread: cooperative-only mode
            self._prev.clear()
            logger.warning(
                "[Preemption] cannot install signal handlers off the main "
                "thread; only cooperative trigger() preemption is active")
        return self

    def uninstall(self) -> None:
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, TypeError):  # non-main thread / exotic prev
                pass
        self._prev.clear()
        self.installed = False

    # ------------------------------------------------------------- the flag
    def _on_signal(self, signum, frame) -> None:
        if self._flag.is_set():
            # second notice: restore previous disposition and re-deliver —
            # the platform is out of patience, exit promptly
            self.uninstall()
            os.kill(os.getpid(), signum)
            return
        self._reason = f"signal {signal.Signals(signum).name}"
        self._t_notice = time.monotonic()
        self._notices += 1
        self._flag.set()

    def trigger(self, reason: str = "cooperative trigger") -> None:
        """Preempt without a signal (chaos injectors, tests)."""
        if not self._flag.is_set():
            self._reason = reason
            self._t_notice = time.monotonic()
            self._notices += 1
            self._flag.set()

    def should_snapshot(self) -> bool:
        return self._flag.is_set()

    @property
    def reason(self) -> Optional[str]:
        return self._reason

    def remaining_grace(self) -> float:
        """Seconds left of the advisory grace window (inf before any
        notice) — snapshot code can log when it is about to overrun."""
        if self._t_notice is None:
            return float("inf")
        return self.grace_seconds - (time.monotonic() - self._t_notice)

    # ---------------------------------------------------------- drain hooks
    def add_drain_hook(self, fn) -> None:
        """Register a callable the SNAPSHOT PATH runs before writing the
        final snapshot (normal thread context, never the signal handler).
        The optimizer registers its dataset's ingest ``drain()`` here so
        reader/decoder threads are stopped and joined before checkpoint
        IO starts — a live ingest pipeline would race shard reads and
        device transfers against the snapshot inside the grace window."""
        if fn not in self._drain_hooks:
            self._drain_hooks.append(fn)

    def run_drain_hooks(self) -> None:
        """Run (and clear) the registered drain hooks; hook failures are
        logged, not raised — a drain error must not cost the snapshot."""
        hooks, self._drain_hooks = self._drain_hooks, []
        for fn in hooks:
            try:
                fn()
            except Exception:
                logger.exception("[Preemption] drain hook %r failed "
                                 "(continuing to snapshot)", fn)

    def drain_notices(self) -> int:
        """Notices received since the last drain — called from the
        training loop (normal thread context) to account
        ``resilience_preemptions_total`` outside the signal handler."""
        seen = self._notices
        fresh = seen - self._drained
        self._drained = seen
        return fresh
