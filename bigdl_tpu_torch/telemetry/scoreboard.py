"""Automated serving scoreboard (counterpart of
``bigdl_tpu/telemetry/scoreboard.py``).

Drives a seeded Zipf mixed-length prompt workload against a live
``ContinuousLMServer`` (or an ``LMRouter`` fleet) per slot count, and
aggregates the serving SLO surface out of the telemetry registry: tok/s,
p50/p95 TTFT, per-token latency, compile counts from the flight recorder
(``telemetry/profiling.py``'s tracked sites ``serving.prefill``,
``serving.insert``, ``serving.step`` / ``serving.spec_step``), peak device
memory; into a JSON artifact plus a markdown table; and diffs two
artifacts with regression thresholds (nonzero exit = regression).

Three modes behind ``python -m bigdl_tpu_torch.telemetry scoreboard``:

- **run** (default): build the configured LM on ``device`` (default
  ``cuda``), run the workload per slot count against an in-process
  server, each row with a private registry and, on a card, its own peak
  (``torch.cuda.reset_peak_memory_stats`` at the row's start);
- **scrape <url>**: snapshot an existing server's ``/metrics`` into a
  one-row artifact;
- **diff <old> <new>**: compare artifacts row by row (slots plus fleet
  shape) and exit 1 past the thresholds.

Prompts are drawn exactly as the reference draws them (one
``random.Random(seed)``), so two runs and the two packages submit the same
prompts in the same order. ``scrape`` and ``diff`` import no torch: they
run on a bare host; ``run`` imports the model and server stack lazily.
"""

from __future__ import annotations

import json
import random
import re
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["ScoreboardConfig", "zipf_lengths", "make_prompts",
           "shared_prefix_prompts", "run", "scrape", "render_markdown",
           "diff", "DEFAULT_THRESHOLDS", "quantile_from_snapshot",
           "load_artifact"]

SCHEMA = 1
DEFAULT_SLOTS = (8, 16, 32)

#: Regression gates for ``diff`` (fractions of the OLD value; compiles
#: is an absolute count allowance). Loose enough for run-to-run noise on
#: a shared host, tight enough that an eviction storm or a lost kernel
#: cannot hide.
DEFAULT_THRESHOLDS: Dict[str, float] = {
    "tok_s_drop": 0.15,          # throughput may drop <= 15%
    "ttft_p50_rise": 0.30,
    "ttft_p95_rise": 0.30,
    "token_latency_rise": 0.30,
    "compiles_rise": 0,          # absolute extra programs allowed
    "peak_memory_rise": 0.10,
}


class ScoreboardConfig:
    """Workload + model shape for the run mode (defaults are sized to
    produce a meaningful mixed-length compile profile on one chip — or
    CPU — in minutes)."""

    def __init__(self, slots: Sequence[int] = DEFAULT_SLOTS,
                 requests: int = 48, clients: int = 8, seed: int = 0,
                 lmin: int = 4, lmax: int = 24, alpha: float = 1.1,
                 max_new: int = 16, decode_block: int = 4,
                 vocab: int = 256, embed: int = 32, heads: int = 2,
                 ffn: int = 64, layers: int = 2,
                 timeout: float = 600.0, prefill_mode: str = "chunked",
                 prefill_chunk: int = 16, workload: str = "zipf",
                 templates: int = 4, template_len: int = 48,
                 prefix_cache: bool = True, draft: bool = False,
                 spec_len: int = 4, replicas: int = 1,
                 disaggregate: Optional[str] = None, device: str = "cuda"):
        self.slots = [int(s) for s in slots]
        self.device = device
        self.requests = int(requests)
        self.clients = max(1, int(clients))
        self.seed = int(seed)
        self.lmin, self.lmax = int(lmin), int(lmax)
        self.alpha = float(alpha)
        self.max_new = int(max_new)
        self.decode_block = int(decode_block)
        self.vocab = int(vocab)
        self.embed, self.heads = int(embed), int(heads)
        self.ffn, self.layers = int(ffn), int(layers)
        self.timeout = float(timeout)
        # chunked (default) vs bucketed prefill — the PR-15 O(1)-compile
        # modes; the chunk default is sized to the Zipf lmax so a toy
        # workload still exercises a multi-chunk prompt now and then
        self.prefill_mode = str(prefill_mode)
        self.prefill_chunk = int(prefill_chunk)
        # workload "zipf" (the mixed-length draw) or
        # "shared-prefix": Zipf draws over a small pool of LONG shared
        # templates plus unique random tails — the prefix-cache stress
        # profile (real traffic: few system prompts, many continuations)
        if workload not in ("zipf", "shared-prefix"):
            raise ValueError(f"workload must be 'zipf' or 'shared-prefix',"
                             f" got {workload!r}")
        self.workload = workload
        self.templates = int(templates)
        self.template_len = int(template_len)
        # serving-mode levers under measurement: cross-request prefix
        # cache (chunked mode) and speculative decode. Draft modes:
        # "identical" = a same-seed copy of the target (the acceptance-
        # rate CEILING, 1.0 by construction), "int8" = a quantized twin
        # (self-speculation: the acceptance an actual deployment
        # pattern measures). A bool is accepted too (True ==
        # "identical"), as the reference's config takes it.
        self.prefix_cache = bool(prefix_cache)
        if draft in (False, None, ""):
            self.draft = None
        elif draft in (True, "identical"):
            self.draft = "identical"
        elif draft == "int8":
            self.draft = "int8"
        else:
            raise ValueError(f"draft must be False, 'identical' or "
                             f"'int8', got {draft!r}")
        self.spec_len = int(spec_len)
        # fleet levers: replicas > 1 routes the workload over N
        # in-process servers via models.router.LMRouter; disaggregate
        # "P:D" splits admission prefill onto dedicated prefill replicas
        # shipping serialized state partitions to D decode replicas
        # (overrides replicas). Rows then carry replicas/split columns
        # and the diff gate keys on (slots, replicas, split).
        if disaggregate:
            from bigdl_tpu_torch.resilience.serving_drill import parse_split
            p, d = parse_split(str(disaggregate))
            self.disaggregate = f"{p}:{d}"
            self.replicas = d
            self.prefill_replicas = p
        else:
            self.disaggregate = None
            self.replicas = max(1, int(replicas))
            self.prefill_replicas = 0
        if self.draft and (self.replicas > 1 or self.prefill_replicas):
            raise ValueError("draft does not compose with a fleet (state "
                             "handoff is incompatible with speculative "
                             "serving)")
        tpl = self.template_len if workload == "shared-prefix" else 0
        self.max_len = tpl + self.lmax + self.max_new + 8

    def workload_dict(self) -> dict:
        d = {"requests": self.requests, "clients": self.clients,
             "seed": self.seed, "workload": self.workload,
             "zipf": {"lmin": self.lmin, "lmax": self.lmax,
                      "alpha": self.alpha},
             "max_new": self.max_new,
             "prefill": {"mode": self.prefill_mode,
                         "chunk": self.prefill_chunk},
             "prefix_cache": self.prefix_cache,
             "model": {"vocab": self.vocab, "embed": self.embed,
                       "heads": self.heads, "ffn": self.ffn,
                       "layers": self.layers}}
        if self.workload == "shared-prefix":
            d["shared_prefix"] = {"templates": self.templates,
                                  "template_len": self.template_len}
        if self.draft:
            d["speculative"] = {"spec_len": self.spec_len,
                                "draft": ("identical-weights"
                                          if self.draft == "identical"
                                          else "int8-self")}
        if self.replicas > 1 or self.prefill_replicas:
            d["fleet"] = {"replicas": self.replicas,
                          "disaggregate": self.disaggregate}
        return d


def zipf_lengths(n: int, *, seed: int, lmin: int, lmax: int,
                 alpha: float = 1.1) -> List[int]:
    """``n`` prompt lengths: rank r of the shuffled [lmin, lmax] length
    set is drawn with probability ∝ r^-alpha — a few lengths dominate
    (real traffic), but the tail keeps minting NEW lengths (the compile-
    storm trigger the scoreboard exists to measure). Deterministic under
    ``seed``."""
    if lmax < lmin:
        raise ValueError(f"lmax {lmax} < lmin {lmin}")
    rng = random.Random(seed)
    lengths = list(range(lmin, lmax + 1))
    rng.shuffle(lengths)                 # rank -> length is seed-dependent
    weights = [1.0 / (r + 1) ** alpha for r in range(len(lengths))]
    return rng.choices(lengths, weights=weights, k=n)


def shared_prefix_prompts(cfg: ScoreboardConfig) -> List[List[int]]:
    """The prefix-cache stress workload: a Zipf-weighted draw over a
    SMALL pool of long shared templates, each request appending a unique
    random tail — the few-system-prompts/many-continuations shape real
    serving traffic has. Deterministic under the config seed; tail
    lengths reuse the Zipf length machinery over [lmin, lmax]."""
    rng = random.Random(cfg.seed + 2)
    pool = [[rng.randint(1, cfg.vocab) for _ in range(cfg.template_len)]
            for _ in range(max(1, cfg.templates))]
    ranks = list(range(len(pool)))
    weights = [1.0 / (r + 1) ** cfg.alpha for r in ranks]
    tails = zipf_lengths(cfg.requests, seed=cfg.seed + 3, lmin=cfg.lmin,
                         lmax=cfg.lmax, alpha=cfg.alpha)
    out = []
    for ln in tails:
        tpl = pool[rng.choices(ranks, weights=weights)[0]]
        out.append(tpl + [rng.randint(1, cfg.vocab) for _ in range(ln)])
    return out


def make_prompts(cfg: ScoreboardConfig) -> List[List[int]]:
    """The seeded workload: one 1-based id list per request."""
    if cfg.workload == "shared-prefix":
        return shared_prefix_prompts(cfg)
    rng = random.Random(cfg.seed + 1)
    out = []
    for ln in zipf_lengths(cfg.requests, seed=cfg.seed, lmin=cfg.lmin,
                           lmax=cfg.lmax, alpha=cfg.alpha):
        out.append([rng.randint(1, cfg.vocab) for _ in range(ln)])
    return out


def quantile_from_snapshot(snap: dict, q: float) -> Optional[float]:
    """Bucket-estimated quantile (upper bound of the bucket holding it)
    from a registry ``Histogram.snapshot()``; None on empty."""
    count = snap["count"]
    if not count:
        return None
    target = q * count
    for bound, cum in snap["buckets"]:
        if cum >= target:
            return float(bound)
    return float(snap["buckets"][-1][0]) if snap["buckets"] else None


def _build_model(cfg: ScoreboardConfig):
    from bigdl_tpu_torch.models import transformer
    return transformer.build_lm(cfg.vocab, cfg.embed, cfg.heads, cfg.ffn,
                                num_layers=cfg.layers, max_len=cfg.max_len,
                                rope=True, norm="rms", device=cfg.device,
                                seed=cfg.seed + 17)


def _drive_one(cfg: ScoreboardConfig, slots: int) -> dict:
    """One scoreboard row: a fresh model + server + PRIVATE registry (so
    compile counts and latency histograms belong to THIS run), the full
    seeded workload, aggregation from the registry."""
    import torch

    from bigdl_tpu_torch.models.serving import ContinuousLMServer
    from bigdl_tpu_torch.telemetry import MetricsRegistry, instruments
    from bigdl_tpu_torch.utils.device import resolve_device
    registry = MetricsRegistry()
    tm = instruments(registry)
    dev = resolve_device(cfg.device)
    if dev.type == "cuda":
        # a row claims only the peak it raised itself, not an earlier row's
        torch.cuda.reset_peak_memory_stats(dev)
    model = _build_model(cfg)
    # "identical" draft (same seeded build) is the acceptance-rate
    # CEILING for the speculative machinery; "int8" is self-speculation
    # against a quantized twin — the acceptance a real deployment
    # pattern measures. Either way the row's headline is the verify-
    # dispatch economics at the measured acceptance, not a wall-clock
    # win: at toy scale no draft is cheaper than the target.
    draft = None
    if cfg.draft == "identical":
        draft = _build_model(cfg)
    elif cfg.draft == "int8":
        from bigdl_tpu_torch.nn.quantized import quantize_model
        draft = quantize_model(_build_model(cfg), device=cfg.device)

    def mk_server(mdl, n_slots):
        return ContinuousLMServer(mdl, slots=n_slots, max_len=cfg.max_len,
                                  decode_block=cfg.decode_block, greedy=True,
                                  max_new_tokens=cfg.max_new,
                                  seed=cfg.seed, registry=registry,
                                  prefill_mode=cfg.prefill_mode,
                                  prefill_chunk=cfg.prefill_chunk,
                                  prefix_cache=cfg.prefix_cache,
                                  draft=draft, spec_len=cfg.spec_len,
                                  device=cfg.device)

    if cfg.replicas > 1 or cfg.prefill_replicas:
        # fleet row: each replica needs its own module instance (one
        # module cannot hold two decode states); same-seed rebuilds keep
        # the weights bit-identical, the handoff contract
        from bigdl_tpu_torch.models.router import LMRouter
        decode = [mk_server(model if i == 0 else _build_model(cfg), slots)
                  for i in range(cfg.replicas)]
        prefill = [mk_server(_build_model(cfg), 1)
                   for _ in range(cfg.prefill_replicas)]
        server = LMRouter(decode, prefill_replicas=prefill,
                          registry=registry)
        prefix_enabled = decode[0].prefix_cache_enabled
    else:
        server = mk_server(model, slots)
        prefix_enabled = server.prefix_cache_enabled
    prompts = make_prompts(cfg)
    errors: List[str] = []
    lock = threading.Lock()
    cursor = {"i": 0}

    def client():
        while True:
            with lock:
                i = cursor["i"]
                if i >= len(prompts):
                    return
                cursor["i"] = i + 1
            try:
                server.submit(prompts[i], max_new_tokens=cfg.max_new,
                              timeout=cfg.timeout)
            except Exception as e:      # noqa: BLE001 — a failed request
                # is a row-level fact, not a scoreboard crash
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")

    t0 = time.perf_counter()
    try:
        threads = [threading.Thread(target=client, daemon=True)
                   for _ in range(min(cfg.clients, len(prompts)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        server.close()

    ttft = tm.serving_ttft_seconds.labels().snapshot()
    tok = tm.serving_token_latency_seconds.labels().snapshot()
    compiles = sum(child.value
                   for _, child in tm.compiles_total.children())
    evictions = sum(child.value
                    for _, child in
                    tm.compile_cache_evictions_total.children())
    compile_seconds = sum(
        child.sum for _, child in tm.compile_seconds.children())
    peak_mem = tm.device_memory_peak_bytes.value or None
    tokens = tm.serving_tokens_total.value
    # serving modes: hit rate counts ADMISSIONS (one verdict per
    # prefill), accept rate counts DRAFT tokens (the target's bonus token
    # is excluded on both sides of the ratio)
    p_hits = tm.prefix_cache_hits.value
    p_miss = tm.prefix_cache_misses.value
    hit_rate = (round(p_hits / (p_hits + p_miss), 3)
                if prefix_enabled and (p_hits + p_miss)
                else None)
    proposed = tm.spec_proposed_tokens_total.value
    accepted = tm.spec_accepted_tokens_total.value
    accept_rate = (round(accepted / proposed, 3)
                   if cfg.draft and proposed else None)
    ttft_hit = tm.serving_ttft_hit_seconds.labels().snapshot()
    ttft_miss = tm.serving_ttft_miss_seconds.labels().snapshot()
    return {
        "slots": slots,
        "replicas": cfg.replicas,
        "split": cfg.disaggregate,
        "prefill_mode": cfg.prefill_mode,
        "requests": len(prompts),
        "failed": len(errors),
        "wall_s": round(wall, 3),
        "tok_s": round(tokens / wall, 2) if wall > 0 else 0.0,
        "ttft_p50_s": quantile_from_snapshot(ttft, 0.5),
        "ttft_p95_s": quantile_from_snapshot(ttft, 0.95),
        "ttft_hit_p50_s": quantile_from_snapshot(ttft_hit, 0.5),
        "ttft_miss_p50_s": quantile_from_snapshot(ttft_miss, 0.5),
        "token_latency_s": (round(tok["sum"] / tok["count"], 6)
                            if tok["count"] else None),
        "prefix_hit_rate": hit_rate,
        "spec_accept_rate": accept_rate,
        "compiles": int(compiles),
        "compile_seconds": round(compile_seconds, 3),
        "cache_evictions": int(evictions),
        "peak_memory_bytes": (int(peak_mem)
                              if peak_mem is not None else None),
        "errors": errors[:5],
    }


def run(cfg: ScoreboardConfig) -> dict:
    """The full artifact: one row per configured slot count; ``backend``
    is the device type (``cuda`` or ``cpu``)."""
    from bigdl_tpu_torch.utils.device import resolve_device
    backend = resolve_device(cfg.device).type
    rows = [_drive_one(cfg, s) for s in cfg.slots]
    return {"schema": SCHEMA, "kind": "bigdl_tpu_serving_scoreboard",
            "backend": backend, "workload": cfg.workload_dict(),
            "rows": rows}


# ---------------------------------------------------------------------------
# Scrape mode: one row out of a live /metrics endpoint
# ---------------------------------------------------------------------------

def _parse_prometheus(text: str) -> Tuple[Dict[str, float],
                                          Dict[str, dict]]:
    """Minimal parser for OUR exposition: plain and labeled samples sum
    into ``values[name]``; ``_bucket``/``_sum``/``_count`` triples build
    ``hists[name]`` snapshots shaped like ``Histogram.snapshot()``.

    A LABELED family exposes one series per label set
    (``bigdl_compile_seconds_sum{site="serving.prefill"}`` next to
    ``{site="serving.step"}``); everything ACCUMULATES across label
    sets — sums, counts, and per-bound bucket counts (all children of
    one family share the same bounds, and a sum of cumulative counts is
    the cumulative count of the merged distribution)."""
    values: Dict[str, float] = {}
    buckets: Dict[str, Dict[float, float]] = {}
    hists: Dict[str, dict] = {}
    sample = re.compile(
        r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([0-9.eE+-]+|NaN)$")
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        m = sample.match(line.strip())
        if not m:
            continue
        name, labels, val = m.group(1), m.group(2) or "", float(m.group(3))
        if name.endswith("_bucket"):
            base = name[:-len("_bucket")]
            le = re.search(r'le="([^"]+)"', labels)
            if le:
                bound = (float("inf") if le.group(1) == "+Inf"
                         else float(le.group(1)))
                by_bound = buckets.setdefault(base, {})
                by_bound[bound] = by_bound.get(bound, 0.0) + val
            continue
        if name.endswith("_sum"):
            h = hists.setdefault(name[:-4], {})
            h["sum"] = h.get("sum", 0.0) + val
            continue
        if name.endswith("_count"):
            h = hists.setdefault(name[:-6], {})
            h["count"] = h.get("count", 0) + int(val)
            continue
        values[name] = values.get(name, 0.0) + val
    for base, by_bound in buckets.items():
        h = hists.setdefault(base, {})
        h["buckets"] = sorted((b, c) for b, c in by_bound.items()
                              if b != float("inf"))
        h["inf"] = by_bound.get(float("inf"), h.get("count", 0))
        h.setdefault("count", int(h["inf"]))
        h.setdefault("sum", 0.0)
    return values, hists


def scrape(url: str, timeout: float = 5.0) -> dict:
    """One-row artifact from a LIVE server's /metrics (operator mode: no
    torch, no model: whatever the server accumulated since boot)."""
    import urllib.request
    if "://" not in url:
        url = "http://" + url
    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        text = resp.read().decode("utf-8", errors="replace")
    values, hists = _parse_prometheus(text)
    empty = {"buckets": [], "count": 0, "sum": 0.0, "inf": 0}
    ttft = hists.get("bigdl_serving_ttft_seconds", empty)
    tok = hists.get("bigdl_serving_token_latency_seconds", empty)
    ttft_hit = hists.get("bigdl_serving_ttft_hit_seconds", empty)
    ttft_miss = hists.get("bigdl_serving_ttft_miss_seconds", empty)
    peak = values.get("bigdl_device_memory_peak_bytes")
    p_hits = values.get("bigdl_prefix_cache_hits", 0.0)
    p_miss = values.get("bigdl_prefix_cache_misses", 0.0)
    proposed = values.get("bigdl_spec_proposed_tokens_total", 0.0)
    accepted = values.get("bigdl_spec_accepted_tokens_total", 0.0)
    row = {
        "slots": int(values.get("bigdl_serving_slots_total", 0)),
        "prefill_mode": None,       # not exposed by /metrics; unknown
        "requests": int(values.get(
            "bigdl_serving_requests_completed_total", 0)),
        "failed": int(values.get("bigdl_serving_request_errors_total", 0)),
        "wall_s": None,              # a scrape has no workload wall-clock
        "tok_s": None,
        "tokens": int(values.get("bigdl_serving_tokens_total", 0)),
        "ttft_p50_s": quantile_from_snapshot(ttft, 0.5),
        "ttft_p95_s": quantile_from_snapshot(ttft, 0.95),
        "ttft_hit_p50_s": quantile_from_snapshot(ttft_hit, 0.5),
        "ttft_miss_p50_s": quantile_from_snapshot(ttft_miss, 0.5),
        "token_latency_s": (round(tok["sum"] / tok["count"], 6)
                            if tok.get("count") else None),
        "prefix_hit_rate": (round(p_hits / (p_hits + p_miss), 3)
                            if (p_hits + p_miss) else None),
        "spec_accept_rate": (round(accepted / proposed, 3)
                             if proposed else None),
        "compiles": int(values.get("bigdl_compiles_total", 0)),
        "compile_seconds": round(
            hists.get("bigdl_compile_seconds", {}).get("sum", 0.0), 3),
        "cache_evictions": int(values.get(
            "bigdl_compile_cache_evictions_total", 0)),
        "peak_memory_bytes": int(peak) if peak else None,
        "errors": [],
    }
    return {"schema": SCHEMA, "kind": "bigdl_tpu_serving_scoreboard",
            "backend": "scrape", "workload": {"source": url},
            "rows": [row]}


# ---------------------------------------------------------------------------
# Rendering + diff
# ---------------------------------------------------------------------------

def _fmt_ms(v: Optional[float]) -> str:
    return "—" if v is None else f"{v * 1e3:.1f}"


def _fmt_mem(v: Optional[float]) -> str:
    return "—" if not v else f"{v / (1 << 20):.1f}"


def _fmt_rate(v: Optional[float]) -> str:
    return "—" if v is None else f"{v:.2f}"


def render_markdown(artifact: dict) -> str:
    """The serving-scoreboard markdown table, as the reference renders
    it. The serving-mode columns (prefix hit rate + hit/miss TTFT split,
    speculative accept rate) render only when some row carries them, so
    artifacts without them keep the shorter table."""
    rows = artifact.get("rows", [])
    with_prefix = any(r.get("prefix_hit_rate") is not None or
                      r.get("ttft_hit_p50_s") is not None for r in rows)
    with_spec = any(r.get("spec_accept_rate") is not None for r in rows)
    with_fleet = any((r.get("replicas") or 1) != 1 or r.get("split")
                     for r in rows)
    w = artifact.get("workload", {})
    z = w.get("zipf", {})
    head = "| slots |"
    rule = "|------:|"
    if with_fleet:
        head += " replicas | split |"
        rule += "---------:|:------|"
    head += (" prefill | tok/s | TTFT p50 (ms) | TTFT p95 (ms) |"
             " per-token (ms) |")
    rule += (":--------|------:|--------------:|--------------:|"
             "---------------:|")
    if with_prefix:
        head += " hit rate | TTFT hit p50 (ms) | TTFT miss p50 (ms) |"
        rule += "---------:|------------------:|-------------------:|"
    if with_spec:
        head += " accept |"
        rule += "-------:|"
    head += (" compiles | compile s | evictions | peak mem (MiB) |")
    rule += ("---------:|----------:|----------:|---------------:|")
    lines = [head, rule]
    for r in rows:
        tok_s = r.get("tok_s")
        cells = [f"{r.get('slots', '?')}"]
        if with_fleet:
            cells += [f"{r.get('replicas') or 1}",
                      f"{r.get('split') or '—'}"]
        cells += [
            f"{r.get('prefill_mode') or '—'}",
            f"{tok_s if tok_s is not None else '—'}",
            _fmt_ms(r.get("ttft_p50_s")),
            _fmt_ms(r.get("ttft_p95_s")),
            _fmt_ms(r.get("token_latency_s")),
        ]
        if with_prefix:
            cells += [_fmt_rate(r.get("prefix_hit_rate")),
                      _fmt_ms(r.get("ttft_hit_p50_s")),
                      _fmt_ms(r.get("ttft_miss_p50_s"))]
        if with_spec:
            cells.append(_fmt_rate(r.get("spec_accept_rate")))
        cells += [f"{r.get('compiles', '—')}",
                  f"{r.get('compile_seconds', '—')}",
                  f"{r.get('cache_evictions', '—')}",
                  _fmt_mem(r.get("peak_memory_bytes"))]
        lines.append("| " + " | ".join(cells) + " |")
    meta = (f"backend={artifact.get('backend', '?')}, "
            f"requests={w.get('requests', '?')}/slot-count, "
            f"Zipf({z.get('alpha', '?')}) prompt lengths "
            f"[{z.get('lmin', '?')}, {z.get('lmax', '?')}], "
            f"seed={w.get('seed', '?')}")
    if w.get("workload") == "shared-prefix":
        sp = w.get("shared_prefix", {})
        meta += (f", shared-prefix {sp.get('templates', '?')} templates × "
                 f"{sp.get('template_len', '?')} tokens")
    if w.get("speculative"):
        meta += (f", speculative k={w['speculative'].get('spec_len', '?')}"
                 f" ({w['speculative'].get('draft', '?')} draft)")
    fl = w.get("fleet") or {}
    if fl.get("replicas"):
        meta += f", fleet replicas={fl['replicas']}"
        if fl.get("disaggregate"):
            meta += f" disaggregated {fl['disaggregate']} prefill:decode"
    lines.append("")
    lines.append(f"<small>{meta}</small>")
    return "\n".join(lines)


def _row_key(r: dict) -> tuple:
    """Diff identity of a row: fleet shape included, with artifacts that
    have no replicas/split keys reading as single-replica rows."""
    return (r.get("slots"), r.get("replicas") or 1, r.get("split") or None)


def _row_tag(r: dict) -> str:
    tag = f"slots={r.get('slots')}"
    if (r.get("replicas") or 1) != 1:
        tag += f",replicas={r.get('replicas')}"
    if r.get("split"):
        tag += f",split={r.get('split')}"
    return tag


def _rise(old: Optional[float], new: Optional[float]) -> Optional[float]:
    if old is None or new is None or old <= 0:
        return None
    return (new - old) / old


def diff(old: dict, new: dict,
         thresholds: Optional[Dict[str, float]] = None) -> List[str]:
    """Row-by-row (matched on slots) regression check. Returns human-
    readable regression messages — empty means the gate passes. Metrics
    absent on either side (CPU peak memory, scrape tok/s) are skipped:
    the gate never fails on missing data, only on measured regressions."""
    th = dict(DEFAULT_THRESHOLDS)
    th.update(thresholds or {})
    by_key = {_row_key(r): r for r in old.get("rows", [])}
    out: List[str] = []
    for nr in new.get("rows", []):
        orow = by_key.get(_row_key(nr))
        if orow is None:
            continue           # new slot count / fleet shape: no gate yet
        tag = _row_tag(nr)
        o_tok, n_tok = orow.get("tok_s"), nr.get("tok_s")
        if o_tok and n_tok is not None and \
                n_tok < o_tok * (1 - th["tok_s_drop"]):
            out.append(f"{tag}: tok/s {o_tok} -> {n_tok} "
                       f"(drop > {th['tok_s_drop']:.0%})")
        for key, thr in (("ttft_p50_s", "ttft_p50_rise"),
                         ("ttft_p95_s", "ttft_p95_rise"),
                         ("token_latency_s", "token_latency_rise")):
            r = _rise(orow.get(key), nr.get(key))
            if r is not None and r > th[thr]:
                out.append(f"{tag}: {key} {orow[key]} -> {nr[key]} "
                           f"(rise > {th[thr]:.0%})")
        o_c, n_c = orow.get("compiles"), nr.get("compiles")
        if o_c is not None and n_c is not None and \
                n_c > o_c + th["compiles_rise"]:
            out.append(f"{tag}: compiles {o_c} -> {n_c} "
                       f"(allowed +{int(th['compiles_rise'])})")
        r = _rise(orow.get("peak_memory_bytes"), nr.get("peak_memory_bytes"))
        if r is not None and r > th["peak_memory_rise"]:
            out.append(f"{tag}: peak_memory_bytes "
                       f"{orow['peak_memory_bytes']} -> "
                       f"{nr['peak_memory_bytes']} "
                       f"(rise > {th['peak_memory_rise']:.0%})")
    new_keys = {_row_key(r) for r in new.get("rows", [])}
    for key, orow in by_key.items():
        if key not in new_keys:
            out.append(f"{_row_tag(orow)}: row present in old artifact "
                       "but missing from new")
    return out


def load_artifact(path: str) -> dict:
    """A scoreboard artifact from ``path``; raises ``ValueError`` for any
    other JSON."""
    with open(path) as f:
        obj = json.load(f)
    if obj.get("kind") != "bigdl_tpu_serving_scoreboard":
        raise ValueError(f"{path} is not a scoreboard artifact")
    return obj
