"""Named performance counters (counterpart of ``bigdl_tpu/optim/metrics.py``),
bridged onto the port's telemetry registry.

Each ``Metrics`` instance is a view over ``bigdl_legacy_metric{scope=...,
name=...}`` gauge children of ``bigdl_tpu_torch.telemetry``, so the
training loop's counters land in the same ``GET /metrics`` scrape as the
serving metrics, with no second bookkeeping copy (the registry child IS
the store; this class keeps only the ``parallel`` divisors and its name
set). ``scope`` is a per-instance label, and a finalizer removes the
instance's children when it is collected, so repeated ``Optimizer``
construction does not grow the scrape.

``summary()`` prints the reference's per-phase report.
"""

from __future__ import annotations

import itertools
import threading
import weakref
from typing import Tuple

from bigdl_tpu_torch.telemetry import get_registry, instruments

_scope_ids = itertools.count()


def _drop_children(family, scope, names):
    """weakref.finalize callback: must not close over the instance."""
    for name in list(names):
        family.remove(scope=scope, name=name)


class Metrics:
    def __init__(self, registry=None):
        reg = registry if registry is not None else get_registry()
        self._family = instruments(reg).legacy_metric
        self._scope = f"m{next(_scope_ids)}"
        self._lock = threading.Lock()
        self._parallel = {}     # name -> divisor (config, not a counter)
        weakref.finalize(self, _drop_children, self._family, self._scope,
                         self._parallel)

    def _child(self, name: str):
        return self._family.labels(scope=self._scope, name=name)

    def set(self, name: str, value: float, parallel: int = 1) -> None:
        with self._lock:
            self._parallel[name] = parallel
        self._child(name).set(value)

    def add(self, name: str, value: float) -> None:
        with self._lock:
            self._parallel.setdefault(name, 1)
        self._child(name).inc(value)

    def get(self, name: str) -> Tuple[float, int]:
        with self._lock:
            if name not in self._parallel:
                return (0.0, 1)
            n = self._parallel[name]
        return (self._child(name).value, n)

    def value(self, name: str) -> float:
        v, n = self.get(name)
        return v / max(1, n)

    def summary(self, unit: str = "s", scale: float = 1.0) -> str:
        with self._lock:
            names = sorted(self._parallel)
            divisors = dict(self._parallel)
        lines = ["========== Metrics Summary =========="]
        for name in names:
            v = self._child(name).value
            lines.append(f"{name} : {v / max(1, divisors[name]) / scale} "
                         f"{unit}")
        lines.append("=====================================")
        return "\n".join(lines)
