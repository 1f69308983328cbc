"""The port's telemetry (``bigdl_tpu_torch/telemetry``) against the
reference's, on the CPU.

The same sequence of counter, gauge and histogram operations on a registry
of each package renders byte-equal Prometheus text and equal JSON; the
metric and span catalogue is the reference's, name for name; the span ring
buffer gives the same Chrome trace apart from timestamps and thread ids.
"""

import json

import numpy as np
import pytest
import torch

from bigdl_tpu import telemetry as jt
from bigdl_tpu.telemetry import tracing as jtracing
from bigdl_tpu_torch import telemetry as pt
from bigdl_tpu_torch.telemetry import tracing as ptracing

torch.set_num_threads(1)


def _script(seed: int):
    """A seeded list of registry operations: (family kind, name, labels,
    buckets, op, labelvalues, amount)."""
    rng = np.random.default_rng(seed)
    fams = [("counter", "t_requests_total", (), None),
            ("counter", "t_by_path_total", ("path",), None),
            ("gauge", "t_depth", (), None),
            ("gauge", "t_level", ("stage", "kind"), None),
            ("histogram", "t_latency_seconds", (), None),
            ("histogram", "t_sizes", ("mode",), (1.0, 2.0, 4.0, 8.0))]
    ops = []
    for _ in range(60):
        kind, name, labels, buckets = fams[rng.integers(len(fams))]
        lv = {ln: f"v{rng.integers(3)}\"\n\\" if rng.random() < 0.2
              else f"v{rng.integers(3)}" for ln in labels}
        if kind == "counter":
            op, amount = "inc", float(rng.choice([1, 2.5, 0, 1e16]))
        elif kind == "gauge":
            op = str(rng.choice(["set", "inc", "dec"]))
            amount = float(rng.normal() * 10.0 ** rng.integers(-3, 4))
        else:
            op, amount = "observe", float(rng.exponential(0.3))
        ops.append((kind, name, labels, buckets, op, lv, amount))
    return ops


def _apply(mod, ops):
    reg = mod.MetricsRegistry()
    for kind, name, labels, buckets, op, lv, amount in ops:
        kw = {} if buckets is None else {"buckets": buckets}
        fam = getattr(reg, kind)(name, f"help of {name}\nline two \\",
                                 labels, **kw)
        target = fam.labels(**lv) if labels else fam
        getattr(target, op)(amount)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_same_operations_render_the_same_bytes(seed):
    ops = _script(seed)
    ref, port = _apply(jt, ops), _apply(pt, ops)
    assert pt.render_prometheus(port) == jt.render_prometheus(ref)
    assert (json.loads(pt.render_json(port))
            == json.loads(jt.render_json(ref)))
    assert pt.render_json(port, indent=2) == jt.render_json(ref, indent=2)


def test_catalogue_instruments_render_like_the_reference():
    ref, port = jt.MetricsRegistry(), pt.MetricsRegistry()
    rt, ptm = jt.instruments(ref), pt.instruments(port)
    for tm in (rt, ptm):
        tm.serving_ttft_seconds.observe(0.02)
        tm.router_requests_total.inc(3)
        tm.lmserver_batch_size.observe(4)
        tm.train_steps_total.labels(mode="local").inc()
        tm.device_memory_bytes.set(123456789)
    assert pt.render_prometheus(port) == jt.render_prometheus(ref)


def test_catalogue_is_the_references():
    assert ([tuple(s) for s in pt.METRIC_SPECS]
            == [tuple(s) for s in jt.METRIC_SPECS])
    assert pt.SPAN_SPECS == jt.SPAN_SPECS
    assert pt.DEFAULT_LATENCY_BUCKETS == jt.DEFAULT_LATENCY_BUCKETS
    names = {s.name for s in pt.METRIC_SPECS}
    assert "bigdl_serving_recompiles_total" in names


@pytest.mark.parametrize("mod", [jt, pt], ids=["reference", "port"])
def test_name_and_shape_checks(mod):
    reg = mod.MetricsRegistry()
    with pytest.raises(ValueError, match="invalid metric name"):
        reg.counter("bad name")
    with pytest.raises(ValueError, match=">= 0"):
        reg.counter("c_total").inc(-1)
    reg.histogram("h", buckets=(1.0, 2.0))
    with pytest.raises(ValueError, match="buckets"):
        reg.histogram("h", buckets=(1.0, 3.0))
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("c_total")
    with pytest.raises(ValueError, match="sorted"):
        reg.histogram("h2", buckets=(2.0, 1.0)).observe(1.0)


def test_histogram_summary_equals_reference():
    vals = np.random.default_rng(5).exponential(0.05, 200)
    ref = jt.MetricsRegistry().histogram("x")
    port = pt.MetricsRegistry().histogram("x")
    for v in vals:
        ref.observe(float(v))
        port.observe(float(v))
    assert port.summary() == ref.summary()


@pytest.fixture
def both_tracers():
    for mod in (jtracing, ptracing):
        mod.clear()
        mod.enable()
    yield
    for mod in (jtracing, ptracing):
        mod.disable()
        mod.clear()


def _trace(mod):
    with mod.span("serving.decode_block", live=3) as sp:
        sp.annotate(rids=[1, 2, 3])
    try:
        with mod.span("serving.prefill", plen=7, rid=1, mode="chunked"):
            raise KeyError("boom")
    except KeyError:
        pass
    mod.async_begin("serving.request", 7, prompt_len=5, max_new=4)
    mod.async_instant("serving.request", 7, phase="admitted", slot=0)
    mod.async_end("serving.request", 7, tokens=4)
    mod.complete_event("serving.queue_wait", 1.0, 1.5, rid=7)
    return mod.to_chrome_trace()


def _untimed(trace):
    return [{k: v for k, v in ev.items() if k not in ("ts", "dur", "tid")}
            for ev in trace["traceEvents"]]


def test_chrome_trace_equals_reference_apart_from_timestamps(both_tracers):
    ref, port = _trace(jtracing), _trace(ptracing)
    assert port["displayTimeUnit"] == ref["displayTimeUnit"]
    assert _untimed(port) == _untimed(ref)
    assert [ev["name"] for ev in port["traceEvents"]] == [
        "serving.decode_block", "serving.prefill", "serving.request",
        "serving.request", "serving.request", "serving.queue_wait"]
    assert port["traceEvents"][1]["args"]["error"] == "KeyError"


def test_tracer_is_off_by_default_and_bounded(tmp_path):
    assert not ptracing.is_enabled()
    assert ptracing.span("x") is ptracing.span("y")   # the shared no-op
    ptracing.clear()
    ptracing.enable(capacity=4)
    try:
        for i in range(10):
            with ptracing.span(f"s{i}"):
                pass
        assert [e["name"] for e in ptracing.events()] == ["s6", "s7", "s8",
                                                          "s9"]
        path = ptracing.dump(str(tmp_path / "t.json"))
        assert len(json.load(open(path))["traceEvents"]) == 4
    finally:
        ptracing.disable()
        ptracing.set_capacity(ptracing.DEFAULT_CAPACITY)
        ptracing.clear()


def test_device_memory_is_not_sampled_on_the_cpu():
    reg = pt.MetricsRegistry()
    assert pt.sample_device_memory(reg, torch.device("cpu")) is None
    assert pt.instruments(reg).device_memory_bytes.value == 0


def test_global_registry_swap():
    mine = pt.MetricsRegistry()
    prev = pt.set_registry(mine)
    try:
        assert pt.get_registry() is mine
    finally:
        pt.set_registry(prev)
    assert pt.get_registry() is prev
