"""Metric exposition: Prometheus text format 0.0.4 and JSON (counterpart
of ``bigdl_tpu/telemetry/exposition.py``; the same bytes for the same
recorded operations).

Both render from ``MetricsRegistry.collect()`` — one snapshot, two
serializations — so a scrape never observes two formats disagreeing.
``GET /metrics`` on the serving HTTP rim (``models/lm_server.py
make_http_server``) serves the Prometheus form.
"""

from __future__ import annotations

import json
from typing import Optional

from bigdl_tpu_torch.telemetry.registry import MetricsRegistry, get_registry

__all__ = ["render_prometheus", "render_json", "PROMETHEUS_CONTENT_TYPE"]

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _escape_help(s: str) -> str:
    return s.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(v: float) -> str:
    # integers print bare (Prometheus idiom: counters are usually whole);
    # floats print via repr for round-trip fidelity
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_str(labels: dict, extra: Optional[dict] = None) -> str:
    items = dict(labels)
    if extra:
        items.update(extra)
    if not items:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in items.items())
    return "{" + inner + "}"


def render_prometheus(registry: Optional[MetricsRegistry] = None) -> str:
    """Text exposition format 0.0.4 (scrapeable by Prometheus, readable
    over curl). Histograms expose cumulative ``_bucket{le=...}`` series
    plus ``_sum``/``_count`` (the +Inf bucket equals count by
    construction — taken from one locked snapshot)."""
    reg = registry if registry is not None else get_registry()
    lines = []
    for fam in reg.collect():
        lines.append(f"# HELP {fam['name']} {_escape_help(fam['help'])}")
        lines.append(f"# TYPE {fam['name']} {fam['kind']}")
        for sample in fam["samples"]:
            labels = sample["labels"]
            if fam["kind"] == "histogram":
                h = sample["histogram"]
                for bound, cum in h["buckets"]:
                    lines.append(
                        f"{fam['name']}_bucket"
                        f"{_labels_str(labels, {'le': _fmt(bound)})} {cum}")
                lines.append(f"{fam['name']}_bucket"
                             f"{_labels_str(labels, {'le': '+Inf'})} "
                             f"{h['inf']}")
                lines.append(f"{fam['name']}_sum{_labels_str(labels)} "
                             f"{_fmt(h['sum'])}")
                lines.append(f"{fam['name']}_count{_labels_str(labels)} "
                             f"{h['count']}")
            else:
                lines.append(f"{fam['name']}{_labels_str(labels)} "
                             f"{_fmt(sample['value'])}")
    return "\n".join(lines) + ("\n" if lines else "")


def render_json(registry: Optional[MetricsRegistry] = None, *,
                indent: Optional[int] = None) -> str:
    """JSON exposition: ``{"metrics": [collect() entries]}``."""
    reg = registry if registry is not None else get_registry()
    return json.dumps({"metrics": reg.collect()}, indent=indent)
