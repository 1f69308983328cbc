"""Telemetry CLI (counterpart of ``bigdl_tpu/telemetry/__main__.py``):
``python -m bigdl_tpu_torch.telemetry {metrics|trace|scoreboard} ...``.

``metrics``     scrape a running server's ``/metrics`` (URL positional)
                and print it; ``--selftest`` exercises the registry +
                exposition pipeline in-process instead.
``trace``       validate a dumped Chrome trace_event JSON file and print
                a per-span summary; ``--selftest`` records demo spans
                and dumps a valid trace (to ``--out`` or stdout).
``scoreboard``  the serving scoreboard (``telemetry/scoreboard.py``):
                drive the seeded Zipf workload in-process (``scoreboard``,
                on ``--device``, default ``cuda``), snapshot a live server
                (``scoreboard scrape <url>``), or gate two artifacts
                (``scoreboard diff <old> <new>``, exit 1 on a regression
                past the thresholds).

Exit status: 0 ok, 1 invalid trace / failed scrape / regression, 2 usage
errors. metrics, trace, scoreboard scrape and diff import no torch.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import List, Optional

from bigdl_tpu_torch.telemetry.exposition import render_json, render_prometheus
from bigdl_tpu_torch.telemetry.registry import MetricsRegistry
from bigdl_tpu_torch.telemetry import tracing
from bigdl_tpu_torch.telemetry.catalogue import instruments


def _selftest_registry() -> MetricsRegistry:
    """A private registry exercising every metric kind through the
    catalogue specs (never the global one: a selftest must not pollute a
    live process's scrape)."""
    reg = MetricsRegistry()
    ins = instruments(reg)
    ins.serving_admissions_total.inc(3)
    ins.serving_queue_depth.set(1)
    ins.serving_slots_total.set(8)
    ins.serving_slots_occupied.set(2)
    for v in (0.004, 0.012, 0.03):
        ins.serving_ttft_seconds.observe(v)
    ins.train_steps_total.labels(mode="local").inc(5)
    ins.train_step_seconds.labels(mode="local").observe(0.02)
    return reg


def cmd_metrics(args) -> int:
    if args.selftest:
        reg = _selftest_registry()
        if args.format == "json":
            print(render_json(reg, indent=2))
        else:
            sys.stdout.write(render_prometheus(reg))
        return 0
    if not args.url:
        print("metrics: give a scrape URL (e.g. "
              "http://127.0.0.1:8000/metrics) or --selftest", file=sys.stderr)
        return 2
    import urllib.request
    url = args.url
    if "://" not in url:
        url = "http://" + url
    if not url.rstrip("/").endswith("/metrics"):
        url = url.rstrip("/") + "/metrics"
    try:
        with urllib.request.urlopen(url, timeout=args.timeout) as resp:
            body = resp.read().decode("utf-8", errors="replace")
    except Exception as e:  # noqa: BLE001 — report, don't traceback
        print(f"metrics: scrape of {url} failed: {type(e).__name__}: {e}",
              file=sys.stderr)
        return 1
    sys.stdout.write(body)
    if body and not body.endswith("\n"):
        sys.stdout.write("\n")
    return 0


def _validate_chrome_trace(obj) -> List[str]:
    """Schema errors ([] == valid): the subset chrome://tracing/Perfetto
    require of the JSON object form."""
    errors = []
    if not isinstance(obj, dict) or "traceEvents" not in obj:
        return ["top level must be an object with a 'traceEvents' array"]
    evs = obj["traceEvents"]
    if not isinstance(evs, list):
        return ["'traceEvents' must be an array"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                errors.append(f"event {i}: missing {key!r}")
        if ev.get("ph") == "X" and "dur" not in ev:
            errors.append(f"event {i}: complete event missing 'dur'")
        if errors and len(errors) > 10:
            errors.append("... (truncated)")
            break
    return errors


def _trace_summary(evs: List[dict]) -> str:
    by_name = {}
    for ev in evs:
        tot, n = by_name.get(ev.get("name", "?"), (0.0, 0))
        by_name[ev.get("name", "?")] = (tot + float(ev.get("dur", 0.0)),
                                        n + 1)
    lines = [f"{len(evs)} events, {len(by_name)} span names"]
    width = max((len(n) for n in by_name), default=4)
    for name, (tot, n) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][0]):
        lines.append(f"  {name:<{width}}  n={n:<6} total={tot / 1e3:.3f}ms "
                     f"mean={tot / n / 1e3:.3f}ms")
    return "\n".join(lines)


def cmd_trace(args) -> int:
    if args.selftest:
        was_enabled = tracing.is_enabled()
        tracing.enable()
        try:
            with tracing.span("selftest.outer", kind="demo"):
                for i in range(3):
                    with tracing.span("selftest.inner", i=i):
                        time.sleep(0.001)
        finally:
            if not was_enabled:
                tracing.disable()
        obj = tracing.to_chrome_trace()
        errors = _validate_chrome_trace(obj)
        if errors:
            print("trace selftest produced an INVALID trace:",
                  file=sys.stderr)
            print("\n".join(errors), file=sys.stderr)
            return 1
        if args.out:
            tracing.dump(args.out)
            print(f"wrote {args.out}: {_trace_summary(obj['traceEvents'])}")
        else:
            print(json.dumps(obj))
        return 0
    if not args.file:
        print("trace: give a dumped trace file to validate, or --selftest",
              file=sys.stderr)
        return 2
    try:
        with open(args.file) as f:
            obj = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        print(f"trace: cannot read {args.file}: {e}", file=sys.stderr)
        return 1
    errors = _validate_chrome_trace(obj)
    if errors:
        print(f"{args.file}: INVALID Chrome trace:", file=sys.stderr)
        print("\n".join(errors), file=sys.stderr)
        return 1
    print(f"{args.file}: valid Chrome trace_event JSON")
    print(_trace_summary(obj["traceEvents"]))
    return 0


def cmd_scoreboard(args) -> int:
    from bigdl_tpu_torch.telemetry import scoreboard as sb

    if args.mode == "diff":
        if len(args.paths) != 2:
            print("scoreboard diff: give exactly two artifact paths "
                  "(old new)", file=sys.stderr)
            return 2
        try:
            old = sb.load_artifact(args.paths[0])
            new = sb.load_artifact(args.paths[1])
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"scoreboard diff: {e}", file=sys.stderr)
            return 2
        thresholds = {
            "tok_s_drop": args.max_tok_drop,
            "ttft_p50_rise": args.max_ttft_rise,
            "ttft_p95_rise": args.max_ttft_rise,
            "token_latency_rise": args.max_latency_rise,
            "compiles_rise": args.max_compile_rise,
            "peak_memory_rise": args.max_mem_rise,
        }
        regressions = sb.diff(old, new, thresholds)
        if regressions:
            print("scoreboard REGRESSIONS:", file=sys.stderr)
            for r in regressions:
                print(f"  {r}", file=sys.stderr)
            return 1
        print(f"scoreboard: no regressions across "
              f"{len(new.get('rows', []))} row(s)")
        return 0

    if args.mode == "scrape":
        if len(args.paths) != 1:
            print("scoreboard scrape: give the server URL", file=sys.stderr)
            return 2
        try:
            artifact = sb.scrape(args.paths[0], timeout=args.timeout)
        except Exception as e:      # noqa: BLE001 — report, don't traceback
            print(f"scoreboard scrape failed: {type(e).__name__}: {e}",
                  file=sys.stderr)
            return 1
    else:                           # run: drive the seeded workload
        if args.paths:
            print("scoreboard: the run mode takes no positional arguments "
                  "(use 'diff'/'scrape' as the first)", file=sys.stderr)
            return 2
        cfg = sb.ScoreboardConfig(
            slots=[int(s) for s in args.slots.split(",")],
            requests=args.requests, clients=args.clients, seed=args.seed,
            lmin=args.lmin, lmax=args.lmax, alpha=args.alpha,
            max_new=args.max_new, vocab=args.vocab, embed=args.embed,
            heads=args.heads, ffn=args.ffn, layers=args.layers,
            timeout=args.timeout, prefill_mode=args.prefill_mode,
            prefill_chunk=args.prefill_chunk, workload=args.workload,
            templates=args.templates, template_len=args.template_len,
            prefix_cache=(args.prefix_cache == "on"), draft=args.draft,
            spec_len=args.spec_len, replicas=args.replicas,
            disaggregate=args.disaggregate, device=args.device)
        artifact = sb.run(cfg)
    body = json.dumps(artifact, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(body + "\n")
        print(f"wrote {args.out}")
    else:
        print(body)
    if args.markdown:
        print(sb.render_markdown(artifact))
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.telemetry",
        description="metrics scrape, trace validation and the serving "
                    "scoreboard")
    sub = parser.add_subparsers(dest="cmd", required=True)

    pm = sub.add_parser("metrics", help="scrape and print /metrics")
    pm.add_argument("url", nargs="?", default="",
                    help="server base URL or host:port (the /metrics path "
                         "is appended if missing)")
    pm.add_argument("--format", choices=("prometheus", "json"),
                    default="prometheus",
                    help="--selftest output format (scrapes print the "
                         "server's body verbatim)")
    pm.add_argument("--timeout", type=float, default=5.0)
    pm.add_argument("--selftest", action="store_true",
                    help="exercise registry+exposition in-process (CI "
                         "smoke; no server)")
    pm.set_defaults(fn=cmd_metrics)

    pt = sub.add_parser("trace", help="validate/summarize a Chrome trace "
                                      "dump")
    pt.add_argument("file", nargs="?", default="",
                    help="trace_event JSON file to validate")
    pt.add_argument("--out", default="",
                    help="--selftest: write the demo trace here instead "
                         "of stdout")
    pt.add_argument("--selftest", action="store_true",
                    help="record demo spans and dump a valid trace")
    pt.set_defaults(fn=cmd_trace)

    ps = sub.add_parser(
        "scoreboard",
        help="serving scoreboard: run the seeded workload, scrape a live "
             "server, or diff two artifacts")
    ps.add_argument("mode", nargs="?", default="run",
                    choices=("run", "diff", "scrape"),
                    help="run (default): drive the workload in-process; "
                         "diff OLD NEW: regression gate; scrape URL: "
                         "snapshot a live /metrics")
    ps.add_argument("paths", nargs="*", default=[],
                    help="diff: two artifact files; scrape: server URL")
    ps.add_argument("--slots", default="8,16,32",
                    help="comma-separated slot counts, one row each")
    ps.add_argument("--requests", type=int, default=48,
                    help="requests per slot count")
    ps.add_argument("--clients", type=int, default=8,
                    help="concurrent submitter threads")
    ps.add_argument("--seed", type=int, default=0)
    ps.add_argument("--lmin", type=int, default=4)
    ps.add_argument("--lmax", type=int, default=24)
    ps.add_argument("--alpha", type=float, default=1.1,
                    help="Zipf exponent over the prompt-length ranks")
    ps.add_argument("--max-new", type=int, default=16, dest="max_new")
    ps.add_argument("--vocab", type=int, default=256)
    ps.add_argument("--embed", type=int, default=32)
    ps.add_argument("--heads", type=int, default=2)
    ps.add_argument("--ffn", type=int, default=64)
    ps.add_argument("--layers", type=int, default=2)
    ps.add_argument("--timeout", type=float, default=600.0)
    ps.add_argument("--prefill-mode", dest="prefill_mode",
                    choices=("chunked", "bucketed"), default="chunked",
                    help="serving prefill strategy (both O(1)-compile; "
                         "chunked = fixed-size chunks, bucketed = pow2 "
                         "length buckets)")
    ps.add_argument("--prefill-chunk", type=int, dest="prefill_chunk",
                    default=16, help="chunked-mode chunk width")
    ps.add_argument("--workload", choices=("zipf", "shared-prefix"),
                    default="zipf",
                    help="zipf (default): mixed-length random prompts; "
                         "shared-prefix: Zipf draws over a small pool of "
                         "long shared templates + unique tails (the "
                         "prefix-cache stress profile)")
    ps.add_argument("--templates", type=int, default=4,
                    help="shared-prefix: template pool size")
    ps.add_argument("--template-len", type=int, dest="template_len",
                    default=48, help="shared-prefix: shared-prefix length "
                                     "in tokens")
    ps.add_argument("--prefix-cache", dest="prefix_cache",
                    choices=("on", "off"), default="on",
                    help="cross-request KV prefix cache (chunked prefill)")
    ps.add_argument("--draft", nargs="?", const="identical", default=None,
                    choices=("identical", "int8"),
                    help="speculative decode: 'identical' (same-weights "
                         "draft — the acceptance-rate ceiling) or 'int8' "
                         "(quantized-twin self-speculation)")
    ps.add_argument("--replicas", type=int, default=1,
                    help="route the workload over N in-process replicas "
                    "behind the fleet router (models.router.LMRouter)")
    ps.add_argument("--disaggregate", default=None, metavar="P:D",
                    help="prefill:decode replica split, e.g. 1:2 — "
                    "dedicated prefill replicas ship serialized state "
                    "partitions to decode replicas (overrides --replicas)")
    ps.add_argument("--spec-len", type=int, dest="spec_len", default=4,
                    help="draft tokens proposed per speculative round")
    ps.add_argument("--device", default="cuda",
                    help="run mode: where the model serves (default cuda; "
                    "cpu on request)")
    ps.add_argument("--out", default="",
                    help="write the JSON artifact here (default: stdout)")
    ps.add_argument("--markdown", action="store_true",
                    help="also print the PERF.md table")
    ps.add_argument("--max-tok-drop", type=float, dest="max_tok_drop",
                    default=0.15, help="diff: allowed tok/s drop fraction")
    ps.add_argument("--max-ttft-rise", type=float, dest="max_ttft_rise",
                    default=0.30, help="diff: allowed TTFT rise fraction")
    ps.add_argument("--max-latency-rise", type=float,
                    dest="max_latency_rise", default=0.30,
                    help="diff: allowed per-token latency rise fraction")
    ps.add_argument("--max-compile-rise", type=float,
                    dest="max_compile_rise", default=0,
                    help="diff: allowed absolute extra compiles")
    ps.add_argument("--max-mem-rise", type=float, dest="max_mem_rise",
                    default=0.10, help="diff: allowed peak-memory rise")
    ps.set_defaults(fn=cmd_scoreboard)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
