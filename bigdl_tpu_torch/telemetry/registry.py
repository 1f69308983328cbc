"""Thread-safe metrics registry: labeled counters, gauges, fixed-bucket
histograms (counterpart of ``bigdl_tpu/telemetry/registry.py``, copied:
the module is plain Python, and the port imports nothing of the reference).

The reference's Metrics class is a bag of named driver-side accumulators
that exists only for the training loop's debug summary; a serving system
needs the operator trio — counters (monotonic totals), gauges (current
level) and histograms (latency distributions) — scrapeable while the
process runs. One registry instance per process is the norm
(``get_registry()``); private instances exist for tests and for callers
that need isolation (``MetricsRegistry()``).

Concurrency contract: every child mutation takes that child's lock, so
counters observed by a scraper thread are monotonic and histogram
(bucket, sum, count) triples are never torn. Family/child creation takes
the registry lock; creation is idempotent (same name + same shape returns
the existing family) and shape conflicts raise at the second
registration site, not at scrape time.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

__all__ = ["MetricSpec", "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "CounterFamily", "GaugeFamily", "HistogramFamily",
           "get_registry", "set_registry", "DEFAULT_LATENCY_BUCKETS"]

# Latency-shaped default buckets (seconds): sub-ms serving steps through
# multi-second compiles. Fixed at family creation — fixed buckets keep
# ``observe`` O(#buckets) with no rebalancing and make cross-scrape deltas
# meaningful.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)


class MetricSpec(NamedTuple):
    """Declarative description of one family (see ``catalogue.py`` for the
    well-known inventory; ``MetricsRegistry.from_spec`` instantiates)."""
    name: str
    kind: str                              # "counter" | "gauge" | "histogram"
    help: str
    labels: Tuple[str, ...] = ()
    buckets: Optional[Tuple[float, ...]] = None   # histograms only


def _check_name(name: str) -> None:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(f"invalid metric name {name!r} (use "
                         "[a-zA-Z0-9_:] only)")


class _Child:
    """One labeled time series. Subclasses define the mutation surface;
    all of them guard state with ``self._lock`` so concurrent writers and
    a scraper thread never tear a read."""

    __slots__ = ("_lock",)

    def __init__(self):
        self._lock = threading.Lock()


class Counter(_Child):
    """Monotonic total. ``inc`` rejects negative amounts — a counter that
    can go down is a gauge, and monotonicity is what lets a scraper
    compute rates across restarts-free windows."""

    __slots__ = ("_value",)

    def __init__(self):
        super().__init__()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counter increment must be >= 0, got {amount}")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge(_Child):
    """Current level; settable both ways."""

    __slots__ = ("_value",)

    def __init__(self):
        super().__init__()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value -= amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram(_Child):
    """Fixed-bucket distribution: per-bucket counts + sum + count.

    ``snapshot()`` returns CUMULATIVE bucket counts keyed by upper bound
    (Prometheus ``le`` semantics, +Inf last == count), taken under the
    lock so (buckets, sum, count) always agree with each other.
    """

    __slots__ = ("_bounds", "_counts", "_sum", "_count")

    def __init__(self, bounds: Sequence[float]):
        super().__init__()
        bounds = tuple(float(b) for b in bounds)
        if not bounds or list(bounds) != sorted(bounds):
            raise ValueError(f"histogram buckets must be a sorted non-empty "
                             f"sequence, got {bounds}")
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)   # final slot = +Inf overflow
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        v = float(value)
        # C bisect, not an interpreted scan: observe sits on the serving
        # decode loop, and the scan costs ~1µs/call at 15 buckets
        i = bisect_left(self._bounds, v)
        with self._lock:
            self._counts[i] += 1
            self._sum += v
            self._count += 1

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> dict:
        with self._lock:
            raw = list(self._counts)
            total, s = self._count, self._sum
        cum, acc = [], 0
        for c in raw:
            acc += c
            cum.append(acc)
        return {"buckets": list(zip(self._bounds, cum[:-1])),
                "inf": cum[-1], "sum": s, "count": total}

    def summary(self) -> dict:
        """Bucket-estimated quantiles for humans/JSON embedding (BENCH
        snapshots): count, sum, mean, p50/p90/p99 (upper bound of the
        bucket holding the quantile; +Inf reported as the last bound)."""
        snap = self.snapshot()
        count = snap["count"]
        out = {"count": count, "sum": round(snap["sum"], 6),
               "mean": round(snap["sum"] / count, 6) if count else 0.0}
        for q in (0.5, 0.9, 0.99):
            target, est = q * count, None
            for bound, cum in snap["buckets"]:
                if cum >= target and count:
                    est = bound
                    break
            if est is None:
                est = self._bounds[-1] if count else 0.0
            out[f"p{int(q * 100)}"] = est
        return out


class _Family:
    """A named metric with a fixed label schema; children per label-value
    tuple. With an empty schema the family proxies its single child, so
    ``registry.counter("x", "...").inc()`` works without ``.labels()``."""

    kind = ""
    _child_cls = _Child

    def __init__(self, name: str, help: str, labels: Tuple[str, ...]):
        self.name = name
        self.help = help
        self.label_names = labels
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._lock = threading.Lock()
        self._solo_child: Optional[_Child] = None  # label-less fast path

    def _new_child(self):
        return self._child_cls()

    def labels(self, **labelvalues) -> _Child:
        if tuple(sorted(labelvalues)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got "
                f"{tuple(sorted(labelvalues))}")
        key = tuple(str(labelvalues[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._new_child())
        return child

    def _solo(self) -> _Child:
        # hot-path shortcut: family-level ops on a label-less family skip
        # the labels() schema check (it costs ~2µs of dict/sort work per
        # call — the difference between "free" and "shows up in a decode
        # block" on the serving loop)
        child = self._solo_child
        if child is not None:
            return child
        if self.label_names:
            raise ValueError(f"{self.name} has labels {self.label_names}; "
                             "address a child via .labels(...)")
        child = self.labels()
        self._solo_child = child
        return child

    def remove(self, **labelvalues) -> None:
        """Drop one labeled child (no-op if absent) — the lifecycle hook
        for per-instance scopes (``optim.Metrics``) so a long-lived
        process's scrape does not accumulate dead series forever."""
        key = tuple(str(labelvalues.get(k, "")) for k in self.label_names)
        with self._lock:
            self._children.pop(key, None)
            if not self.label_names:
                self._solo_child = None

    def children(self) -> List[Tuple[Tuple[str, ...], _Child]]:
        with self._lock:
            return sorted(self._children.items())


class CounterFamily(_Family):
    kind = "counter"
    _child_cls = Counter

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    @property
    def value(self) -> float:
        return self._solo().value


class GaugeFamily(_Family):
    kind = "gauge"
    _child_cls = Gauge

    def set(self, value: float) -> None:
        self._solo().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    @property
    def value(self) -> float:
        return self._solo().value


class HistogramFamily(_Family):
    kind = "histogram"
    _child_cls = Histogram

    def __init__(self, name, help, labels, buckets):
        super().__init__(name, help, labels)
        self.buckets = tuple(buckets)

    def _new_child(self):
        return Histogram(self.buckets)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    def summary(self) -> dict:
        return self._solo().summary()


class MetricsRegistry:
    """Name -> family map; creation idempotent, shape conflicts raise."""

    def __init__(self):
        self._families: Dict[str, _Family] = {}
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labels, **extra):
        _check_name(name)
        labels = tuple(labels)
        for ln in labels:
            _check_name(ln)
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if not isinstance(fam, cls) or fam.label_names != labels:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{fam.kind}{fam.label_names}, cannot re-register "
                        f"as {cls.kind}{labels}")
                if (isinstance(fam, HistogramFamily) and "buckets" in extra
                        and tuple(extra["buckets"]) != fam.buckets):
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {fam.buckets}")
                return fam
            fam = cls(name, help, labels, **extra)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> CounterFamily:
        return self._get_or_create(CounterFamily, name, help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> GaugeFamily:
        return self._get_or_create(GaugeFamily, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> HistogramFamily:
        return self._get_or_create(HistogramFamily, name, help, labels,
                                   buckets=tuple(buckets))

    def from_spec(self, spec: MetricSpec) -> _Family:
        if spec.kind == "counter":
            return self.counter(spec.name, spec.help, spec.labels)
        if spec.kind == "gauge":
            return self.gauge(spec.name, spec.help, spec.labels)
        if spec.kind == "histogram":
            return self.histogram(spec.name, spec.help, spec.labels,
                                  spec.buckets or DEFAULT_LATENCY_BUCKETS)
        raise ValueError(f"unknown metric kind {spec.kind!r}")

    def get(self, name: str) -> Optional[_Family]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def collect(self) -> List[dict]:
        """Plain-data snapshot: the one structure both exposition formats
        render from (``exposition.py``)."""
        out = []
        for fam in self.families():
            samples = []
            for labelvalues, child in fam.children():
                labels = dict(zip(fam.label_names, labelvalues))
                if isinstance(child, Histogram):
                    samples.append({"labels": labels,
                                    "histogram": child.snapshot()})
                else:
                    samples.append({"labels": labels, "value": child.value})
            out.append({"name": fam.name, "kind": fam.kind,
                        "help": fam.help,
                        "label_names": list(fam.label_names),
                        "samples": samples})
        return out


_global_registry = MetricsRegistry()
_global_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-global registry every default instrument writes to —
    one scrape covers serving + training + eval in one place."""
    return _global_registry


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-global registry (tests); returns the previous."""
    global _global_registry
    with _global_lock:
        prev, _global_registry = _global_registry, registry
    return prev
