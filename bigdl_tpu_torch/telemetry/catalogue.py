"""Well-known metric and span inventory (counterpart of
``bigdl_tpu/telemetry/catalogue.py``).

Every name, type, help text, label set and bucket ladder is the
reference's, so a scrape of the port reads like a scrape of the reference
and one dashboard covers both. The help texts are the reference's words,
including those that speak of XLA programs. What the port fills:

- the serving families (``ContinuousLMServer``, ``LMServer``, ``LMRouter``,
  the prefix cache, speculative serving) and the device-memory gauges;
- ``bigdl_serving_recompiles_total`` counts the continuous engine's CUDA
  graph captures on a card (one per server and round kind: the
  reference's ``serving.step`` and ``serving.spec_step``); it stays 0 on
  the CPU, which runs the eager body;
- the compile families (``telemetry/profiling.py``'s ``tracked_jit`` at
  the reference's sites: ``train.*``, ``eval.*``, ``generation.*``,
  ``serving.*``), the training families (``optim/optimizer.py``,
  ``mode="local"``, with ``bigdl_train_mfu``) and the ingest families
  (``dataset/ingest/``);
- the eval families (``optim/evaluator.py``), the resilience families
  (``optim/optimizer.py``: preemptions, the preemption snapshot's
  seconds, resumes), ``bigdl_train_validation_seconds``,
  ``bigdl_legacy_metric`` (``optim/metrics.py``) and
  ``bigdl_int8_fallbacks_total`` (``ops/int8_matmul.py``).

Bucket choices: serving latencies use the sub-ms-to-seconds default;
training step phases reuse it; batch sizes use power-of-two buckets
matching the bucketed batcher's padding.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from bigdl_tpu_torch.telemetry.registry import (DEFAULT_LATENCY_BUCKETS,
                                          MetricSpec, MetricsRegistry)

__all__ = ["METRIC_SPECS", "SPAN_SPECS", "instruments"]

BATCH_SIZE_BUCKETS: Tuple[float, ...] = (1, 2, 4, 8, 16, 32, 64, 128)

METRIC_SPECS: List[MetricSpec] = [
    # ---- continuous-batching serving engine (models/serving.py)
    MetricSpec("bigdl_serving_ttft_seconds", "histogram",
               "Time to first token: request submit to first sampled token "
               "(prefill + queue wait).", (), DEFAULT_LATENCY_BUCKETS),
    MetricSpec("bigdl_serving_token_latency_seconds", "histogram",
               "Per-token decode latency, observed once per decode block "
               "as block wall-clock / tokens.", (), DEFAULT_LATENCY_BUCKETS),
    MetricSpec("bigdl_serving_request_latency_seconds", "histogram",
               "Whole-request latency: submit to completion (one "
               "observation per completed request).",
               (), DEFAULT_LATENCY_BUCKETS),
    MetricSpec("bigdl_serving_queue_depth", "gauge",
               "Requests waiting for a slot (admission queue)."),
    MetricSpec("bigdl_serving_slots_occupied", "gauge",
               "Slots currently decoding a live request."),
    MetricSpec("bigdl_serving_slots_total", "gauge",
               "Configured slot count of the continuous server."),
    MetricSpec("bigdl_serving_admissions_total", "counter",
               "Requests admitted into a slot (prefill + insert done)."),
    MetricSpec("bigdl_serving_requests_completed_total", "counter",
               "Requests finished (eos or token budget)."),
    MetricSpec("bigdl_serving_request_errors_total", "counter",
               "Requests failed (admission or decode error)."),
    MetricSpec("bigdl_serving_recompiles_total", "counter",
               "New XLA program builds: the O(1) chunked-prefill pair "
               "(or a first-seen pow2 length bucket in bucketed mode), "
               "the step program, the insert program."),
    MetricSpec("bigdl_serving_decode_blocks_total", "counter",
               "Jitted decode blocks dispatched over all slots."),
    MetricSpec("bigdl_serving_tokens_total", "counter",
               "Tokens emitted to live requests (dead-slot lanes "
               "excluded)."),
    MetricSpec("bigdl_serving_ttft_hit_seconds", "histogram",
               "TTFT of admissions whose prefix-cache lookup hit "
               "(>= one chunk of prefill skipped). Only populated while "
               "the prefix cache is enabled.",
               (), DEFAULT_LATENCY_BUCKETS),
    MetricSpec("bigdl_serving_ttft_miss_seconds", "histogram",
               "TTFT of admissions that prefilled cold (prefix-cache "
               "miss). Only populated while the prefix cache is enabled.",
               (), DEFAULT_LATENCY_BUCKETS),
    # ---- serving fleet: drain / handoff / router (models/router.py)
    MetricSpec("bigdl_serving_drains_total", "counter",
               "Graceful drains entered by a continuous server (SIGTERM "
               "or drain()): admission stops, in-flight slots leave as "
               "handoff cursors."),
    MetricSpec("bigdl_router_requests_total", "counter",
               "Requests accepted by the fleet router (counted once per "
               "request, before any dispatch attempts)."),
    MetricSpec("bigdl_router_retries_total", "counter",
               "Dispatch attempts re-tried against another replica after "
               "a failed or rejected attempt (bounded, with backoff)."),
    MetricSpec("bigdl_router_requeues_total", "counter",
               "Requests re-dispatched WITH a handoff cursor after their "
               "replica died or drained mid-flight (a subset of "
               "retries: the request had been accepted)."),
    MetricSpec("bigdl_handoff_seconds", "histogram",
               "Wall-clock of producing one serialized prefill handoff "
               "partition on a prefill replica (disaggregation's ship "
               "cost, observed by the router).",
               (), DEFAULT_LATENCY_BUCKETS),
    # ---- cross-request KV prefix cache (models/prefix_cache.py)
    MetricSpec("bigdl_prefix_cache_hits", "counter",
               "Admissions whose chunk-aligned token prefix matched a "
               "cached prefill-state snapshot (tail-only prefill)."),
    MetricSpec("bigdl_prefix_cache_misses", "counter",
               "Admissions that found no cached chunk-aligned prefix and "
               "prefilled from token 0."),
    MetricSpec("bigdl_prefix_cache_evictions", "counter",
               "Prefix-state snapshots dropped LRU-first from the "
               "size-bounded trie, counted one entry at a time (never "
               "clear-at-cap)."),
    MetricSpec("bigdl_prefix_cache_bytes", "gauge",
               "Bytes of prefill-state snapshots currently held by the "
               "serving prefix trie(s) (target + draft in speculative "
               "mode)."),
    # ---- speculative serving (models/serving.py draft=...)
    MetricSpec("bigdl_spec_proposed_tokens_total", "counter",
               "Draft tokens proposed by speculative serving rounds "
               "(spec_len per live slot per round)."),
    MetricSpec("bigdl_spec_accepted_tokens_total", "counter",
               "Draft proposals accepted by target verification (the "
               "per-round bonus token is not counted, so accept rate = "
               "accepted / proposed)."),
    # ---- bucketed batch server (models/lm_server.py)
    MetricSpec("bigdl_lmserver_batch_size", "histogram",
               "Requests per dispatched batch (pre-padding).",
               (), BATCH_SIZE_BUCKETS),
    MetricSpec("bigdl_lmserver_batch_wait_seconds", "histogram",
               "Anchor request's wait from submit to batch dispatch.",
               (), DEFAULT_LATENCY_BUCKETS),
    MetricSpec("bigdl_lmserver_batches_total", "counter",
               "Batches decoded by the bucketed server."),
    MetricSpec("bigdl_lmserver_requests_total", "counter",
               "Requests served by the bucketed server."),
    MetricSpec("bigdl_lmserver_queue_depth", "gauge",
               "Requests queued or held awaiting same-length company."),
    # ---- training loops (optim/optimizer.py, parallel/distri_optimizer.py)
    MetricSpec("bigdl_train_step_seconds", "histogram",
               "Per-iteration device step time (window wall-clock / "
               "iterations in the dispatch window).",
               ("mode",), DEFAULT_LATENCY_BUCKETS),
    MetricSpec("bigdl_train_data_wait_seconds", "histogram",
               "Host wait on the data pipeline per dispatch window.",
               ("mode",), DEFAULT_LATENCY_BUCKETS),
    MetricSpec("bigdl_train_dispatch_seconds", "histogram",
               "Host time handing a window to the device (H2D + enqueue; "
               "async — excludes device compute).",
               ("mode",), DEFAULT_LATENCY_BUCKETS),
    MetricSpec("bigdl_train_sync_seconds", "histogram",
               "Host block fetching the pipelined losses (device->host "
               "sync point).", ("mode",), DEFAULT_LATENCY_BUCKETS),
    MetricSpec("bigdl_train_steps_total", "counter",
               "Optimizer iterations completed.", ("mode",)),
    MetricSpec("bigdl_train_records_total", "counter",
               "Training records consumed.", ("mode",)),
    MetricSpec("bigdl_train_records_per_second", "gauge",
               "Most recent per-iteration throughput (records or tokens "
               "per second).", ("mode",)),
    MetricSpec("bigdl_train_compiles_total", "counter",
               "Trace+compile events charged to the loop (first dispatch "
               "of a step program).", ("mode",)),
    MetricSpec("bigdl_train_validation_seconds", "histogram",
               "Wall-clock of in-training validation passes.",
               ("mode",), DEFAULT_LATENCY_BUCKETS),
    # ---- staged ingest engine (dataset/ingest/)
    MetricSpec("bigdl_ingest_queue_depth", "gauge",
               "Items waiting between ingest stages (stage = shards "
               "done-but-unordered, chunks awaiting decode, batches "
               "done-but-unordered, out = device-ready hand-off queue).",
               ("stage",)),
    MetricSpec("bigdl_ingest_stage_seconds", "histogram",
               "Wall-clock of one ingest work unit (stage = read one "
               "shard / decode one chunk / device_put one batch).",
               ("stage",), DEFAULT_LATENCY_BUCKETS),
    MetricSpec("bigdl_ingest_records_total", "counter",
               "Records handed to the consumer by the ingest engine."),
    MetricSpec("bigdl_ingest_bytes_total", "counter",
               "Raw shard payload bytes read by the reader pool."),
    MetricSpec("bigdl_ingest_batches_total", "counter",
               "Batches handed to the consumer by the ingest engine."),
    MetricSpec("bigdl_ingest_stall_seconds_total", "counter",
               "Starvation attribution: time a stage waited for INPUT "
               "while the pipeline had admission room (waits under "
               "downstream backpressure are charged to nobody). "
               "stage=step is the consumer starving (ingest-bound "
               "training); stage=materialize is DeviceCachedDataSet's "
               "blocking first-fill.", ("stage",)),
    # ---- batch evaluation (optim/evaluator.py)
    MetricSpec("bigdl_eval_batches_total", "counter",
               "Evaluation batches scored."),
    MetricSpec("bigdl_eval_records_total", "counter",
               "Evaluation records scored."),
    MetricSpec("bigdl_eval_batch_seconds", "histogram",
               "Host wall-clock per evaluation batch (async dispatch in "
               "the device-accumulation steady state).",
               (), DEFAULT_LATENCY_BUCKETS),
    # ---- resilience (bigdl_tpu/resilience/, docs/RESILIENCE.md)
    MetricSpec("bigdl_resilience_preemptions_total", "counter",
               "Preemption notices received (SIGTERM/SIGINT or a "
               "cooperative chaos/test trigger)."),
    MetricSpec("bigdl_resilience_snapshot_seconds", "histogram",
               "Wall-clock of the end-of-step preemption snapshot "
               "(model + state + RESUME marker).",
               (), DEFAULT_LATENCY_BUCKETS + (30.0, 120.0)),
    MetricSpec("bigdl_resilience_resumes_total", "counter",
               "Training restarts from a discovered snapshot; "
               "elastic=true when the process/device count changed "
               "(unknown = markerless legacy snapshot).", ("elastic",)),
    # ---- kernel dispatch (ops/int8_matmul.py, parallel/expert.py)
    MetricSpec("bigdl_moe_dispatch_total", "counter",
               "MoE forwards by dispatch formulation (path label: "
               "sort / scatter / einsum). Counted once per eager call / "
               "once per TRACE under jit — the branch runs at trace "
               "time, so this records which formulation each compiled "
               "MoE program uses, not per-step traffic. 'sort' (the "
               "round-10 default) replaces the k-fold one-hot+cumsum+"
               "scatter-add chains with one stable argsort plus "
               "gathers.", ("path",)),
    MetricSpec("bigdl_int8_fallbacks_total", "counter",
               "int8_matmul decode-shaped calls that LOST the fused "
               "kernel because K is off the 128-lane quantum (XLA "
               "dequant fallback at ~2x the int8 byte floor). Any output "
               "dim takes the kernel since the round-10 full-coverage "
               "tiling (the ceil grid masks the partial final tile), so "
               "this stays 0 on real model shapes — V=32000 and "
               "V=151936 included. Counted once per eager call / once "
               "per TRACE under jit (the decision runs at trace time), "
               "and warned once per shape."),
    # ---- compile flight recorder (telemetry/profiling.py tracked_jit)
    MetricSpec("bigdl_compiles_total", "counter",
               "XLA program compilations recorded by tracked_jit — one "
               "per new (site, abstract arg signature).", ("site",)),
    MetricSpec("bigdl_compile_seconds", "histogram",
               "Wall-clock of one tracked_jit trace+lower+compile.",
               ("site",), DEFAULT_LATENCY_BUCKETS + (60.0, 120.0)),
    MetricSpec("bigdl_program_flops", "gauge",
               "cost_analysis FLOPs of the site's most recently compiled "
               "program (per execution of that program).", ("site",)),
    MetricSpec("bigdl_program_bytes_accessed", "gauge",
               "cost_analysis HBM bytes accessed per execution of the "
               "site's most recently compiled program.", ("site",)),
    MetricSpec("bigdl_program_temp_bytes", "gauge",
               "memory_analysis temp (scratch) allocation of the site's "
               "most recently compiled program.", ("site",)),
    MetricSpec("bigdl_program_output_bytes", "gauge",
               "memory_analysis output allocation of the site's most "
               "recently compiled program.", ("site",)),
    MetricSpec("bigdl_compile_cache_evictions_total", "counter",
               "Compiled programs dropped oldest-first from a bounded "
               "program cache (tracked_jit executables, the serving "
               "prefill family, generate() signature family).", ("site",)),
    MetricSpec("bigdl_train_mfu", "gauge",
               "Live model-FLOPs utilization of the training loop: "
               "cost-analysis FLOPs per dispatch / dispatch wall seconds "
               "/ peak chip FLOP/s (absent when the backend reports no "
               "cost analysis or the peak is unknown — override with "
               "BIGDL_TPU_PEAK_FLOPS).", ("mode",)),
    MetricSpec("bigdl_device_memory_bytes", "gauge",
               "Device 0 bytes currently allocated (sampled at step "
               "boundaries and slot admission; absent on runtimes "
               "without allocator stats, e.g. CPU)."),
    MetricSpec("bigdl_device_memory_peak_bytes", "gauge",
               "Device 0 peak-bytes-in-use watermark (same sampling "
               "points as bigdl_device_memory_bytes)."),
    # ---- legacy bridge (optim/metrics.py)
    MetricSpec("bigdl_legacy_metric", "gauge",
               "Legacy optim.Metrics counters bridged onto the registry "
               "(scope = one Metrics instance, name = reference counter "
               "name).", ("scope", "name")),
    # ---- bench harness (bench.py)
    MetricSpec("bigdl_bench_step_seconds", "histogram",
               "Benchmark timed-loop per-step wall-clock (chunk time / "
               "steps; embedded in BENCH_*.json).",
               (), DEFAULT_LATENCY_BUCKETS + (60.0, 120.0)),
]

#: Span inventory (tracing.span names) with where they fire.
SPAN_SPECS: List[Tuple[str, str]] = [
    ("serving.request", "Async lifecycle of ONE continuous-serving "
     "request (Chrome async events sharing the request id): begins at "
     "submit, instants at admission, ends at completion/failure — with "
     "serving.queue_wait/prefill/insert carrying the same rid arg, a "
     "single dump reconstructs the whole journey."),
    ("serving.queue_wait", "Retrodicted span from a request's submit to "
     "the start of its admission (queue-wait attribution; rid arg links "
     "it to its serving.request lifecycle)."),
    ("serving.prefill", "Out-of-band b=1 prompt prefill + admission "
     "sampling (models/serving.py _admit)."),
    ("serving.insert", "Jitted cache scatter of a prefilled request into "
     "a free slot row."),
    ("serving.decode_block", "One jitted decode_block-token step over all "
     "slots."),
    ("lmserver.request", "Async lifecycle of one bucketed-server request "
     "(submit -> batch dispatch -> completion) under the request id."),
    ("lmserver.gather", "Batcher wait assembling one same-length batch."),
    ("lmserver.decode_batch", "One batched prefill+decode program "
     "(models/lm_server.py)."),
    ("ingest.read_shard", "Reader-pool thread reading + CRC-verifying one "
     "shard (and applying its seeded record shuffle) "
     "(dataset/ingest/engine.py)."),
    ("ingest.decode", "Decode-pool thread running one record chunk "
     "through its cloned decode/collate chain."),
    ("ingest.device_put", "Device-feed thread issuing the async H2D "
     "transfer of one batch (overlaps the step consuming the previous "
     "one)."),
    ("ingest.step", "Consumer-side work between batch pops in "
     "apps/ingest_bench.py's pipelined measurement (the lane the "
     "read/decode/device_put spans overlap with)."),
    ("ingest.materialize", "DeviceCachedDataSet building its whole-epoch "
     "device cache on first use; the same wall time lands in "
     "bigdl_ingest_stall_seconds_total{stage=materialize} "
     "(dataset/device_cache.py)."),
    ("train.dispatch", "Handing one training window to the device (H2D + "
     "enqueue)."),
    ("train.sync", "Blocking fetch of the pipelined window losses."),
    ("train.validate", "In-training validation pass."),
    ("resilience.snapshot", "End-of-step preemption snapshot: model + "
     "state + RESUME marker (optim/optimizer.py)."),
    ("eval.batches", "One evaluate_batches call (all batches + the final "
     "device->host merge)."),
    ("profiling.compile", "One tracked_jit compilation of a new "
     "(site, signature) — trace+lower+compile wall time "
     "(telemetry/profiling.py)."),
]


class _Instruments:
    """Attribute-addressed families for one registry: ``ins.<name>`` with
    the ``bigdl_`` prefix stripped. Built once per (registry) and cached
    on the registry object — instrument sites pay one dict lookup."""

    def __init__(self, registry: MetricsRegistry):
        for spec in METRIC_SPECS:
            fam = registry.from_spec(spec)
            if not spec.labels:
                fam.labels()  # expose at 0 before first use (scrape-friendly)
            setattr(self, spec.name[len("bigdl_"):], fam)


def instruments(registry: MetricsRegistry) -> _Instruments:
    """Get-or-build the catalogue's families on ``registry``."""
    ins = getattr(registry, "_bigdl_instruments", None)
    if ins is None:
        ins = _Instruments(registry)
        registry._bigdl_instruments = ins
    return ins
