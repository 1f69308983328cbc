"""``python -m bigdl_tpu_torch.resilience validate|latest|chaos corrupt`` as
subprocesses, as the reference's ``test_validate_and_latest`` drives its
own CLI, on snapshots a short CPU training run writes.

``validate`` lists every pair newest first with a complete/PARTIAL verdict
and exits 0 iff a resume point exists; ``latest`` prints the newest
complete pair; ``chaos corrupt`` damages a file deterministically. The
reference's CLI reads the same directory and agrees on which pair is the
newest complete one (the port's markers add CRC-32s that the reference's
validation does not read, so only a truncation is partial to both).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.base import MiniBatch
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

ROOT = Path(__file__).resolve().parent.parent
ENV = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _Batches:
    def __init__(self):
        rng = np.random.RandomState(0)
        self.batches = [(rng.randn(8, 4).astype(np.float32),
                         rng.randint(1, 3, 8).astype(np.float32))
                        for _ in range(2)]

    def data(self, train):
        for x, y in self.batches:
            yield MiniBatch(x, y)

    def size(self):
        return 16

    def shuffle(self):
        pass

    def is_distributed(self):
        return False


def _snapshots(tmp_path):
    """model.3, model.5 and model.7 (every epoch of 2 batches)."""
    model = (nn.Sequential().add(nn.Linear(4, 2)).add(nn.LogSoftMax()))
    (Optimizer(model, _Batches(), nn.ClassNLLCriterion(), device="cpu")
     .set_optim_method(SGD(learningrate=0.1))
     .set_end_when(Trigger.max_epoch(3))
     .set_checkpoint(str(tmp_path), Trigger.every_epoch())).optimize()
    return tmp_path


def _cli(module, *args):
    return subprocess.run([sys.executable, "-m", module, *map(str, args)],
                          capture_output=True, text=True, timeout=120,
                          env=ENV, cwd=ROOT)


def _port(*args):
    return _cli("bigdl_tpu_torch.resilience", *args)


def test_validate_and_latest(tmp_path):
    ck = _snapshots(tmp_path)
    r = _port("chaos", "corrupt", ck / "model.7", "--seed", "1")
    assert r.returncode == 0 and "corrupted" in r.stdout
    r = _port("validate", ck)
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.splitlines()
    assert lines[0].startswith("PARTIAL") and "model.7" in lines[0]
    assert lines[1].startswith("complete") and "marker: step 5 epoch 3" \
        in lines[1]
    r = _port("latest", ck)
    assert r.returncode == 0
    assert r.stdout.splitlines()[0].endswith("model.5")
    assert r.stdout.splitlines()[1].endswith("state.5")


def test_reference_cli_agrees_on_a_truncated_snapshot(tmp_path):
    ck = _snapshots(tmp_path)
    assert _port("chaos", "corrupt", ck / "state.7", "--mode",
                 "truncate").returncode == 0
    ours = _port("latest", ck)
    ref = _cli("bigdl_tpu.resilience", "latest", ck)
    assert ours.returncode == 0 and ours.stdout.splitlines()[0].endswith(
        "model.5")
    # the reference's plain-pair check is size-only: a half file passes it
    assert ref.returncode == 0 and ref.stdout.splitlines()[0].endswith(
        "model.7")
    r = _port("validate", ck)
    assert "PARTIAL" in r.stdout.splitlines()[0]


def test_nothing_to_resume(tmp_path):
    r = _port("validate", tmp_path)
    assert r.returncode == 1 and "no snapshot pairs" in r.stdout
    r = _port("latest", tmp_path)
    assert r.returncode == 1 and "no complete snapshot" in r.stderr
    ck = _snapshots(tmp_path / "ck")
    for name in ("model.3", "model.5", "model.7"):
        assert _port("chaos", "corrupt", ck / name, "--mode",
                     "truncate").returncode == 0
    assert _port("validate", ck).returncode == 1
    assert _port("latest", ck).returncode == 1


def test_sharded_snapshot_is_reported_as_waiting(tmp_path):
    """A complete sharded pair is reported as valid and ``latest`` returns
    it (the name is kept from when sharded pairs waited for their port);
    empty directories read as partial."""
    ck = _snapshots(tmp_path)
    model = (nn.Sequential().add(nn.Linear(4, 2)).add(nn.LogSoftMax()))
    (Optimizer(model, _Batches(), nn.ClassNLLCriterion(), device="cpu")
     .set_optim_method(SGD(learningrate=0.1))
     .set_end_when(Trigger.max_epoch(4))
     .set_checkpoint(str(ck), Trigger.several_iteration(9), sharded=True)
     ).optimize()
    (ck / "model.11").mkdir()
    (ck / "state.11").mkdir()
    r = _port("validate", ck)
    assert r.returncode == 0
    lines = r.stdout.splitlines()
    assert lines[0].startswith("PARTIAL") and "model.11" in lines[0]
    assert lines[1].startswith("complete") and "model.9 / state.9" in \
        lines[1] and "sharded" in lines[1]
    r = _port("latest", ck)
    assert r.returncode == 0
    assert r.stdout.splitlines() == [str(ck / "model.9"), str(ck / "state.9")]


def test_corrupt_is_deterministic_across_processes(tmp_path):
    for name in ("a", "b"):
        (tmp_path / name).write_bytes(bytes(range(256)) * 16)
        assert _port("chaos", "corrupt", tmp_path / name, "--seed",
                     "9").returncode == 0
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()
    assert (tmp_path / "a").read_bytes() != bytes(range(256)) * 16


def test_validate_imports_no_torch(tmp_path):
    ck = _snapshots(tmp_path)
    code = ("import sys; from bigdl_tpu_torch.resilience.__main__ import "
            f"main; rc = main(['validate', {str(ck)!r}]); "
            "print('torch' in sys.modules, rc)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=ENV, cwd=ROOT)
    assert r.stdout.splitlines()[-1] == "False 0"
