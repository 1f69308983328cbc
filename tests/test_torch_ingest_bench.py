"""``apps/ingest_bench.py`` of the port against the reference's
(``bigdl_tpu/apps/ingest_bench.py``) on the CPU, at tiny sizes: every mode
runs, ``generate`` writes the same shard files, and each JSON line (and the
``pipeline`` artifact) has the reference's keys.
"""

import json
import os

import pytest
import torch

from bigdl_tpu.apps import ingest_bench as ref_bench
from bigdl_tpu_torch.apps import ingest_bench

RECORDS, PER_SHARD, BATCH = 12, 4, 4
# the reference's train line (bigdl_tpu/apps/ingest_bench.py:305-308); its
# ResNet-50 run is not repeated here
REF_TRAIN_KEYS = {"mode", "iterations", "records_per_sec", "wall_s"}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("ingest_bench")
    return {side: str(root / side) for side in ("port", "ref")}


def _line(main, argv, capsys) -> dict:
    main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_generate_writes_the_reference_files(shards, capsys):
    args = ["-n", str(RECORDS), "--perShard", str(PER_SHARD)]
    got = _line(ingest_bench.main, ["generate", "-o", shards["port"], *args],
                capsys)
    want = _line(ref_bench.main, ["generate", "-o", shards["ref"], *args],
                 capsys)
    assert set(got) == set(want) and got["records"] == RECORDS
    names = sorted(os.listdir(shards["port"]))
    assert names == sorted(os.listdir(shards["ref"])) and len(names) == 3
    for name in names:
        with open(os.path.join(shards["port"], name), "rb") as a, \
                open(os.path.join(shards["ref"], name), "rb") as b:
            assert a.read() == b.read(), name


@pytest.mark.parametrize("mode", ["read", "decode"])
def test_measuring_modes_have_the_reference_keys(shards, capsys, mode):
    if not os.path.isdir(shards["port"]):
        test_generate_writes_the_reference_files(shards, capsys)
    argv = [mode, "-s", shards["port"], "-b", str(BATCH), "-w", "2",
            "--budget", "0.3"]
    got = _line(ingest_bench.main, [*argv, "--device", "cpu"], capsys)
    want = _line(ref_bench.main, argv, capsys)
    assert set(got) == set(want) and got["records_per_sec"] > 0


def test_pipeline_artifact_and_trace(shards, capsys, tmp_path, monkeypatch):
    if not os.path.isdir(shards["port"]):
        test_generate_writes_the_reference_files(shards, capsys)
    # the serial stages' 5 s floor, cut for the test (the reference's
    # literal is patched through its max)
    monkeypatch.setattr(ingest_bench, "STAGE_BUDGET_FLOOR_S", 0.2)
    monkeypatch.setattr(ref_bench, "max", lambda a, b: 0.2, raising=False)
    arts = {}
    for side, main, extra in (("port", ingest_bench.main, ["--device", "cpu"]),
                              ("ref", ref_bench.main, [])):
        art, trace = tmp_path / f"{side}.json", tmp_path / f"{side}_t.json"
        line = _line(main, ["pipeline", "-s", shards["port"], "-b",
                            str(BATCH), "--workers", "2", "--budget", "0.3",
                            "--engine", "both", "--jsonOut", str(art),
                            "--traceOut", str(trace), *extra], capsys)
        assert line["mode"] == "pipeline" and line["wrote"] == str(art)
        arts[side] = json.loads(art.read_text())
        events = json.loads(trace.read_text())["traceEvents"]
        assert {"ingest.read_shard", "ingest.decode"} <= {
            e["name"] for e in events}
    got, want = arts["port"], arts["ref"]
    assert set(want) <= set(got) and set(want["config"]) <= set(got["config"])
    for engine in ("serial", "pipelined"):
        assert set(want[engine]) == set(got[engine]), engine
        assert got[engine]["records_per_sec"] > 0
    assert set(want["serial"]["stages"]) == set(got["serial"]["stages"])
    assert got["pipelined"]["records"] > 0
    assert {"read", "decode"} <= set(got["pipelined"]["stage_seconds"])


@pytest.mark.parametrize("engine", ["serial", "pipelined"])
def test_train_runs_resnet50_from_shards(shards, capsys, engine):
    if not os.path.isdir(shards["port"]):
        test_generate_writes_the_reference_files(shards, capsys)
    line = _line(ingest_bench.main, [
        "train", "-s", shards["port"], "-b", "2", "-w", "2", "-i", "2",
        "--warmup", "1", "--deviceNormalize", "--engine", engine,
        "--device", "cpu"], capsys)
    assert REF_TRAIN_KEYS <= set(line) and line["iterations"] == 2
    assert line["records_per_sec"] > 0 and line["iteration_ms"] > 0


def test_optimizer_exposes_the_run(shards, capsys):
    if not os.path.isdir(shards["port"]):
        test_generate_writes_the_reference_files(shards, capsys)
    opt, args = ingest_bench.optimizer(["-s", shards["port"], "-b", "2",
                                        "--engine", "pipelined",
                                        "--deviceNormalize", "--device",
                                        "cpu"])
    assert args.iterations == 10 and opt.dataset.config.device == "cpu"
    assert type(opt.model[0]).__name__ == "InputNormalize"
    assert opt.precision.compute_dtype == torch.bfloat16
