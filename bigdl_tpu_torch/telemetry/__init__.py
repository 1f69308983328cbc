"""Runtime observability of the port (counterpart of ``bigdl_tpu/telemetry``):

- ``registry``: thread-safe labeled counters / gauges / fixed-bucket
  histograms (``get_registry()`` is the process-global instance);
- ``exposition``: Prometheus text 0.0.4 + JSON, served as ``GET
  /metrics`` by the serving HTTP rim (``models/lm_server.py``);
- ``tracing``: ``span("name")`` -> bounded ring buffer -> Chrome
  ``trace_event`` JSON, off by default at the cost of one branch;
- ``catalogue``: the reference's metric and span inventory;
- ``profiling``: the compile flight recorder (``tracked_jit(site=...)``:
  one event, seconds and cost, per first call of a signature at every
  tracked site), ``peak_flops``, ``mfu`` and ``sample_device_memory``;
- ``scoreboard``: the serving scoreboard (seeded Zipf workload driver,
  ``/metrics`` scrape, markdown table, regression diff);
- ``python -m bigdl_tpu_torch.telemetry metrics|trace|scoreboard``.

Importing the package imports no torch (``profiling`` and ``scoreboard``
import it when a program is wrapped or a workload driven). Like the rest
of the port, nothing here imports ``jax`` or ``bigdl_tpu``.
"""

from bigdl_tpu_torch.telemetry.registry import (Counter, CounterFamily, Gauge,
                                                GaugeFamily, Histogram,
                                                HistogramFamily, MetricSpec,
                                                MetricsRegistry,
                                                DEFAULT_LATENCY_BUCKETS,
                                                get_registry, set_registry)
from bigdl_tpu_torch.telemetry.exposition import (PROMETHEUS_CONTENT_TYPE,
                                                  render_json,
                                                  render_prometheus)
from bigdl_tpu_torch.telemetry import profiling, scoreboard, tracing
from bigdl_tpu_torch.telemetry.tracing import span
from bigdl_tpu_torch.telemetry.catalogue import (METRIC_SPECS, SPAN_SPECS,
                                                 instruments)
from bigdl_tpu_torch.telemetry.profiling import (CompileEvent, TrackedJit,
                                                 mfu, peak_flops,
                                                 sample_device_memory,
                                                 tracked_jit)

__all__ = [
    "MetricsRegistry", "MetricSpec", "Counter", "Gauge", "Histogram",
    "CounterFamily", "GaugeFamily", "HistogramFamily",
    "DEFAULT_LATENCY_BUCKETS", "get_registry", "set_registry",
    "render_prometheus", "render_json", "PROMETHEUS_CONTENT_TYPE",
    "tracing", "span", "METRIC_SPECS", "SPAN_SPECS", "instruments",
    "profiling", "scoreboard", "tracked_jit", "TrackedJit", "CompileEvent",
    "peak_flops", "mfu", "sample_device_memory",
]
