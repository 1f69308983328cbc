"""The port's causal-LM command line (``python -m
bigdl_tpu_torch.apps.transformer``) on the CPU.

``generate`` and ``serve`` run as subprocesses with ``--device cpu``, each
training its default tiny LM on the synthetic grammar first, as the
reference's does. ``serve --continuous --replicas 2 --int8`` answers POSTs
through the fleet router, reports both replicas on ``/health`` and the
router and serving families on ``/metrics``, and drains on SIGTERM with
exit code 0. ``train --checkpoint`` writes its snapshots and
``model_final``, ``train --model/--state`` resumes, ``generate --model``
answers as ``generate`` on the loaded module, and ``serve --continuous
--model --draft`` serves a saved target with a saved draft. The options
that wait for later ROADMAP items stop with a message naming the item.
"""

import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import pytest
import torch

from bigdl_tpu_torch.apps import transformer as app
from bigdl_tpu_torch.apps.transformer import main

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, OMP_NUM_THREADS="1")


def _cli(*args):
    return [sys.executable, "-m", "bigdl_tpu_torch.apps.transformer", *args]


def test_generate_beams_prints_its_two_lines():
    out = subprocess.run(_cli("generate", "--device", "cpu", "--numBeams",
                              "4", "--bf16", "--maxNewTokens", "6",
                              "--prompt", "3,5,7"),
                         cwd=ROOT, env=ENV, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 2
    assert lines[0].startswith("prompt:") and "[3, 5, 7]" in lines[0]
    cont = json.loads(lines[1].split(":", 1)[1])
    assert len(cont) == 6 and all(1 <= t <= 64 for t in cont)


def _read_port(proc, deadline):
    """The port from serve's 'serving on http://host:PORT' stderr line."""
    seen = []
    while time.time() < deadline:
        line = proc.stderr.readline()
        if not line:
            break
        seen.append(line)
        m = re.search(r"serving on http://[\d.]+:(\d+)", line)
        if m:
            return int(m.group(1))
    raise AssertionError("serve never reported its port: " + "".join(seen))


def test_serve_fleet_answers_reports_and_drains_on_sigterm():
    proc = subprocess.Popen(
        _cli("serve", "--continuous", "--replicas", "2", "--int8",
             "--port", "0", "--device", "cpu", "--greedy",
             "--maxNewTokens", "8", "--maxLen", "64", "--slots", "2"),
        cwd=ROOT, env=ENV, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True)
    try:
        base = f"http://127.0.0.1:{_read_port(proc, time.time() + 180)}"
        results = [None] * 4

        def post(i):
            req = urllib.request.Request(
                base + "/generate",
                data=json.dumps({"prompt": [i + 1, 2, 3]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                results[i] = json.loads(r.read())["ids"]

        threads = [threading.Thread(target=post, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert all(r is not None and len(r) == 8 for r in results), results
        with urllib.request.urlopen(base + "/health", timeout=30) as r:
            health = json.loads(r.read())
        assert health["ok"]
        assert [x["state"] for x in health["replicas"]] == ["ok", "ok"]
        with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
            body = r.read().decode()
        lines = body.splitlines()
        assert "bigdl_router_requests_total 4" in lines
        assert "bigdl_serving_admissions_total 4" in lines
        assert "bigdl_serving_recompiles_total 0" in lines
        t0 = time.time()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert time.time() - t0 < 30
        assert "draining: signal SIGTERM" in proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


RES = ROOT / "tests" / "resources" / "hf_tiny_gpt2"
JAX_ENV = dict(ENV, JAX_PLATFORMS="cpu")


def _both_clis(args):
    """stdout of the port's and the reference's ``generate`` on ``args``,
    run side by side."""
    procs = [subprocess.Popen([sys.executable, "-m", mod, "generate", *args,
                               *extra], cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for mod, env, extra in (
                 ("bigdl_tpu_torch.apps.transformer", ENV,
                  ["--device", "cpu"]),
                 ("bigdl_tpu.apps.transformer", JAX_ENV, []))]
    outs = [p.communicate(timeout=240) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    return [o.strip().splitlines()[-2:] for o, _ in outs]


def test_generate_from_hf_matches_the_reference_cli(tmp_path):
    # with the checkpoint's tokenizer --prompt is text
    ours, ref = _both_clis(["--fromHF", str(RES), "--prompt",
                            "Hello world, it is", "--maxNewTokens", "6",
                            "--greedy"])
    assert ours == ref and ours[0].startswith("prompt:")
    assert "'Hello world, it is'" in ours[0]
    # without one the prompt and the output are raw HF ids
    for name in ("config.json", "model.safetensors"):
        (tmp_path / name).write_bytes((RES / name).read_bytes())
    ours, ref = _both_clis(["--fromHF", str(tmp_path), "--prompt", "0,5,7",
                            "--maxNewTokens", "5", "--greedy"])
    assert ours == ref and "[0, 5, 7]" in ours[0]


def test_serve_from_hf_answers_text_as_the_reference_cli():
    procs = [subprocess.Popen(
        [sys.executable, "-m", mod, "serve", "--fromHF", str(RES), "--port",
         "0", "--greedy", "--maxNewTokens", "6", *extra],
        cwd=ROOT, env=env, stderr=subprocess.PIPE,
        stdout=subprocess.DEVNULL, text=True)
        for mod, env, extra in (
            ("bigdl_tpu_torch.apps.transformer", ENV, ["--device", "cpu"]),
            ("bigdl_tpu.apps.transformer", JAX_ENV, []))]
    try:
        answers = []
        for proc in procs:
            base = f"http://127.0.0.1:{_read_port(proc, time.time() + 180)}"
            req = urllib.request.Request(
                base + "/generate",
                data=json.dumps({"text": "Hello world"}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=120) as r:
                answers.append(json.loads(r.read()))
        assert answers[0] == answers[1]
        assert isinstance(answers[0]["text"], str)
        assert len(answers[0]["ids"]) == 6
    finally:
        for proc in procs:
            proc.send_signal(signal.SIGTERM)
        for proc in procs:
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()


@pytest.mark.parametrize("argv, match", [
    # ported: ring attention over the one process of the group trains;
    # tensor parallelism needs its ranks
    (["train", "--contextParallel", "ring", "-e", "1", "--synthetic-size",
      "4", "-b", "2", "--seqLen", "8", "--vocab", "16", "--embedDim", "16",
      "--numLayers", "1"], None),
    (["train", "--tensorParallel", "2"], "must divide the process count"),
    # ported: a routed MoE FFN trains
    (["train", "--moeExperts", "4", "-e", "1", "--synthetic-size", "4",
      "-b", "2", "--seqLen", "8", "--vocab", "16", "--embedDim", "16",
      "--numLayers", "1"], None),
    (["train", "--textFile", "x.txt", "--bpeVocab", "255"],
     "must be >= 256"),
    (["train", "--summary", "logs", "--textFile", "x.txt", "--bpeVocab",
      "100"], "must be >= 256"),
    (["generate", "--fromHF", "d", "--model", "m"], "not both"),
    (["generate", "--fromHF", "d", "--tokenizer", "t"], "does not compose"),
    (["generate", "--int8", "--bf16"], "one of"),
    (["generate", "--prompt", ","], "empty prompt"),
    (["serve", "--fromHF", "d", "--tokenizer", "t"], "does not compose"),
    (["serve", "--tokenizer", "t", "--replicas", "2"],
     "require --continuous"),
    (["serve", "--continuous", "--draft", "d", "--replicas", "2"],
     "does not compose"),
    (["serve", "--draft", "d"], "require --continuous"),
    (["serve", "--replicas", "2"], "require --continuous"),
    (["serve", "--continuous", "--disaggregate", "2"], "P:D"),
    (["bogus"], "usage"),
    (["train", "--moeExperts", "4", "--llamaBlock"],
     "does not compose with --moeExperts"),
    (["train", "--moeExperts", "4", "--contextParallel", "ring"],
     "does not compose with --contextParallel")])
def test_waiting_and_bad_options_stop_with_a_message(argv, match,
                                                     monkeypatch):
    # refused before any model is built or trained (match None: the
    # option works and trains)
    monkeypatch.setattr(app, "_default_model", lambda *a, **k: (
        pytest.fail("a model was built")))
    if match is None:
        main(argv + ["--device", "cpu"])
        return
    with pytest.raises((SystemExit, ValueError), match=match):
        main(argv + (["--device", "cpu"] if argv[0] != "bogus" else []))


def test_device_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        main(["train", "-e", "1", "--synthetic-size", "8", "--seqLen", "4"])


def _tiny_train(ckpt, *extra):
    return app.train(["--device", "cpu", "-b", "4", "--seqLen", "16",
                      "--synthetic-size", "16", "--vocab", "48",
                      "--embedDim", "32", "--numHeads", "2", "--llamaBlock",
                      "--checkpoint", str(ckpt), *extra])


def test_train_checkpoints_and_resumes(tmp_path):
    from bigdl_tpu_torch.resilience import coordinator
    from bigdl_tpu_torch.utils import file_io
    trained = _tiny_train(tmp_path, "-e", "2")
    names = sorted(p.name for p in tmp_path.iterdir())
    assert {"model.5", "state.5", "model.9", "state.9",
            "model_final"} <= set(names)
    final = file_io.load(str(tmp_path / "model_final"), device="cpu")
    for a, b in zip(final.parameters(), trained.parameters()):
        assert torch.equal(a, b)
    # a third epoch from the second's snapshot: one more pair
    _tiny_train(tmp_path, "-e", "3", "--model", str(tmp_path / "model.9"),
                "--state", str(tmp_path / "state.9"))
    assert coordinator.latest_resume_point(str(tmp_path)).neval == 13
    # --autoResume finds it: a fourth epoch
    _tiny_train(tmp_path, "-e", "4", "--autoResume")
    assert coordinator.latest_resume_point(str(tmp_path)).neval == 17


def test_generate_model_equals_generate_on_the_loaded_module(tmp_path,
                                                             capsys):
    from bigdl_tpu_torch.models.generation import generate
    from bigdl_tpu_torch.utils import file_io
    _tiny_train(tmp_path, "-e", "1")
    path = str(tmp_path / "model_final")
    capsys.readouterr()
    main(["generate", "--device", "cpu", "--model", path, "--greedy",
          "--prompt", "3,5,7", "--maxNewTokens", "6"])
    lines = capsys.readouterr().out.strip().splitlines()
    want = generate(file_io.load(path, device="cpu").evaluate_mode(),
                    [[3, 5, 7]], 6, greedy=True, device="cpu")
    assert lines == ["prompt:       [3, 5, 7]",
                     f"continuation: {want[0, 3:].tolist()}"]
    with pytest.raises(SystemExit, match="no saved module"):
        main(["generate", "--device", "cpu", "--model",
              str(tmp_path / "model.5")])


def test_serve_continuous_with_saved_model_and_draft(tmp_path):
    from bigdl_tpu_torch.models.generation import generate
    from bigdl_tpu_torch.utils import file_io
    _tiny_train(tmp_path / "target", "-e", "1", "--numLayers", "2")
    _tiny_train(tmp_path / "draft", "-e", "1", "--numLayers", "1")
    target = str(tmp_path / "target" / "model_final")
    proc = subprocess.Popen(
        _cli("serve", "--continuous", "--model", target, "--draft",
             str(tmp_path / "draft" / "model_final"), "--specLen", "3",
             "--port", "0", "--device", "cpu", "--greedy",
             "--maxNewTokens", "8", "--maxLen", "64", "--slots", "2"),
        cwd=ROOT, env=ENV, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True)
    try:
        base = f"http://127.0.0.1:{_read_port(proc, time.time() + 180)}"
        req = urllib.request.Request(
            base + "/generate", data=json.dumps({"prompt": [4, 9, 2]}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as r:
            ids = json.loads(r.read())["ids"]
        want = generate(file_io.load(target, device="cpu").evaluate_mode(),
                        [[4, 9, 2]], 8, greedy=True, device="cpu")
        assert ids == want[0, 3:].tolist()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
