"""The serving scoreboard and the telemetry CLI of the port
(``telemetry/scoreboard.py``, ``telemetry/__main__.py``) against the
reference's on the CPU: the seeded workloads equal the reference's lists,
``render_markdown`` and ``diff`` give the reference's text and verdicts on
the same artifacts, the Prometheus text parses back, a tiny live run and a
scrape of a live server work, and the CLI's ``--selftest`` modes and exit
codes are the reference's.
"""

import copy
import json
import threading

import pytest
import torch

from bigdl_tpu.telemetry import __main__ as ref_cli
from bigdl_tpu.telemetry import scoreboard as ref_sb
from bigdl_tpu_torch.models.lm_server import make_http_server
from bigdl_tpu_torch.models.serving import ContinuousLMServer
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.telemetry import (MetricsRegistry, instruments,
                                       render_prometheus)
from bigdl_tpu_torch.telemetry import __main__ as cli
from bigdl_tpu_torch.telemetry import scoreboard as sb

TINY = dict(vocab=64, embed=32, heads=2, ffn=64, layers=2, lmin=4, lmax=12,
            max_new=4, prefill_chunk=8, requests=4, clients=2)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_workloads_equal_the_reference(seed):
    kw = dict(seed=seed, lmin=3, lmax=40, alpha=1.3)
    assert sb.zipf_lengths(25, **kw) == ref_sb.zipf_lengths(25, **kw)
    for extra in ({}, {"workload": "shared-prefix", "templates": 3,
                       "template_len": 20}):
        cfg = dict(requests=20, seed=seed, vocab=500, lmin=2, lmax=30,
                   **extra)
        assert sb.make_prompts(sb.ScoreboardConfig(**cfg)) == \
            ref_sb.make_prompts(ref_sb.ScoreboardConfig(**cfg))
    cfg = dict(requests=9, seed=seed, templates=2, template_len=8)
    assert sb.shared_prefix_prompts(sb.ScoreboardConfig(**cfg)) == \
        ref_sb.shared_prefix_prompts(ref_sb.ScoreboardConfig(**cfg))
    assert sb.ScoreboardConfig(**cfg).workload_dict() == \
        ref_sb.ScoreboardConfig(**cfg).workload_dict()


def _row(slots, tok_s, **kw):
    row = {"slots": slots, "replicas": 1, "split": None,
           "prefill_mode": "chunked", "requests": 8, "failed": 0,
           "wall_s": 1.5, "tok_s": tok_s, "ttft_p50_s": 0.05,
           "ttft_p95_s": 0.25, "ttft_hit_p50_s": None,
           "ttft_miss_p50_s": None, "token_latency_s": 0.004,
           "prefix_hit_rate": None, "spec_accept_rate": None, "compiles": 4,
           "compile_seconds": 1.25, "cache_evictions": 0,
           "peak_memory_bytes": 3 << 30, "errors": []}
    row.update(kw)
    return row


def _artifact(rows, **workload):
    w = {"requests": 8, "seed": 0, "workload": "zipf",
         "zipf": {"lmin": 4, "lmax": 24, "alpha": 1.1}, **workload}
    return {"schema": 1, "kind": "bigdl_tpu_serving_scoreboard",
            "backend": "cuda", "workload": w, "rows": rows}


ARTIFACTS = [
    _artifact([_row(8, 120.0), _row(16, 200.0)]),
    _artifact([_row(8, 100.0, prefix_hit_rate=0.5, ttft_hit_p50_s=0.01,
                    ttft_miss_p50_s=0.1)], workload="shared-prefix",
              shared_prefix={"templates": 4, "template_len": 48}),
    _artifact([_row(8, 90.0, spec_accept_rate=0.97, replicas=2,
                    split="1:2")],
              speculative={"spec_len": 4, "draft": "int8-self"},
              fleet={"replicas": 2, "disaggregate": "1:2"}),
]


@pytest.mark.parametrize("i", range(len(ARTIFACTS)))
def test_markdown_equals_the_reference(i):
    assert sb.render_markdown(ARTIFACTS[i]) == \
        ref_sb.render_markdown(ARTIFACTS[i])


def test_diff_verdicts_equal_the_reference():
    old = ARTIFACTS[0]
    cases = []
    for key, factor in (("tok_s", 0.7), ("tok_s", 0.9), ("ttft_p50_s", 1.5),
                        ("token_latency_s", 1.2), ("compiles", 2),
                        ("peak_memory_bytes", 1.2), ("ttft_p95_s", None)):
        new = copy.deepcopy(old)
        for r in new["rows"]:
            r[key] = None if factor is None else r[key] * factor
        cases.append(new)
    missing = copy.deepcopy(old)
    missing["rows"].pop()
    cases.append(missing)
    for new in cases:
        for th in (None, {"tok_s_drop": 0.5}):
            assert sb.diff(old, new, th) == ref_sb.diff(old, new, th)
    assert sb.diff(old, old) == []
    assert len(sb.diff(old, cases[0])) == 2


def test_prometheus_text_parses_back():
    reg = MetricsRegistry()
    tm = instruments(reg)
    tm.serving_slots_total.set(8)
    tm.serving_tokens_total.inc(40)
    tm.compiles_total.labels(site="serving.step").inc()
    tm.compiles_total.labels(site="serving.prefill").inc(2)
    for v in (0.004, 0.02, 0.3):
        tm.serving_ttft_seconds.observe(v)
    text = render_prometheus(reg)
    values, hists = sb._parse_prometheus(text)
    assert (values, hists) == ref_sb._parse_prometheus(text)
    assert values["bigdl_compiles_total"] == 3
    assert values["bigdl_serving_slots_total"] == 8
    ttft = hists["bigdl_serving_ttft_seconds"]
    assert ttft["count"] == 3 and ttft["sum"] == pytest.approx(0.324)
    assert sb.quantile_from_snapshot(ttft, 0.5) == \
        sb.quantile_from_snapshot(tm.serving_ttft_seconds.labels()
                                  .snapshot(), 0.5)


def test_tiny_live_run_and_scrape(tmp_path):
    art = sb.run(sb.ScoreboardConfig(slots=[2, 3], device="cpu", **TINY))
    assert art["backend"] == "cpu" and len(art["rows"]) == 2
    for row in art["rows"]:
        # the chunked prefill's two programs, the slot insert, the round
        assert row["failed"] == 0 and row["requests"] == 4
        assert row["compiles"] == 4 and row["tok_s"] > 0
        assert row["peak_memory_bytes"] is None
    path = tmp_path / "a.json"
    path.write_text(json.dumps(art))
    assert sb.load_artifact(str(path)) == art
    model = build_lm(64, embed_dim=32, num_heads=2, ffn_dim=64,
                     num_layers=1, max_len=32, rope=True, norm="rms",
                     device="cpu", seed=3)
    server = ContinuousLMServer(model, slots=2, max_len=32, greedy=True,
                                max_new_tokens=3, registry=MetricsRegistry(),
                                device="cpu")
    http = make_http_server(server, "127.0.0.1", 0)
    thread = threading.Thread(target=http.serve_forever, daemon=True)
    thread.start()
    try:
        for i in range(3):
            server.submit([1 + i, 2, 3], 3, timeout=60)
        got = sb.scrape(f"127.0.0.1:{http.server_address[1]}")
    finally:
        http.shutdown()
        http.server_close()
        thread.join(timeout=10)
        server.close()
    (row,) = got["rows"]
    assert got["backend"] == "scrape"
    assert row["slots"] == 2 and row["requests"] == 3 and row["tokens"] == 9
    assert row["compiles"] == 4 and row["tok_s"] is None


def test_load_artifact_refuses_other_json(tmp_path):
    p = tmp_path / "x.json"
    p.write_text(json.dumps({"kind": "other"}))
    with pytest.raises(ValueError, match="not a scoreboard artifact"):
        sb.load_artifact(str(p))


def test_cli_selftests_and_exit_codes(tmp_path, capsys):
    old, slow = tmp_path / "old.json", tmp_path / "slow.json"
    old.write_text(json.dumps(ARTIFACTS[0]))
    slower = copy.deepcopy(ARTIFACTS[0])
    for r in slower["rows"]:
        r["tok_s"] *= 0.7
    slow.write_text(json.dumps(slower))
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"traceEvents": [{"name": "x"}]}))
    trace = tmp_path / "t.json"
    cases = [
        (["metrics", "--selftest"], 0), (["metrics", "--selftest",
                                          "--format", "json"], 0),
        (["metrics"], 2), (["metrics", "127.0.0.1:1", "--timeout", "0.2"], 1),
        (["trace", "--selftest", "--out", str(trace)], 0),
        (["trace", str(trace)], 0), (["trace", str(bad)], 1),
        (["trace", str(tmp_path / "none.json")], 1), (["trace"], 2),
        (["scoreboard", "diff", str(old), str(old)], 0),
        (["scoreboard", "diff", str(old), str(slow)], 1),
        (["scoreboard", "diff", str(old), str(slow), "--max-tok-drop",
          "0.5"], 0),
        (["scoreboard", "diff", str(old)], 2),
        (["scoreboard", "diff", str(old), str(bad)], 2),
        (["scoreboard", "scrape"], 2),
        (["scoreboard", "scrape", "127.0.0.1:1", "--timeout", "0.2"], 1),
        (["scoreboard", "extra-arg"], 2)]
    for argv, want in cases:
        if argv == ["scoreboard", "extra-arg"]:
            with pytest.raises(SystemExit) as e:    # argparse: a bad mode
                cli.main(argv)
            with pytest.raises(SystemExit) as r:
                ref_cli.main(argv)
            assert e.value.code == r.value.code == want
            continue
        assert cli.main(argv) == want, argv
        assert ref_cli.main(argv) == want, argv
    capsys.readouterr()
    assert cli.main(["metrics", "--selftest"]) == 0
    ours = capsys.readouterr().out
    ref_cli.main(["metrics", "--selftest"])
    assert ours == capsys.readouterr().out
