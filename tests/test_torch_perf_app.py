"""``apps/perf.py`` and the train summaries on the CPU.

``perf.main([..., "--device", "cpu"])`` trains each model it is given and
prints the reference's JSON line (the same keys, ``records_per_sec`` > 0):
LeNet-5, the LSTM classifier (T=500), ViT-S/16 at full width and a small
batch, and the 4-layer transformer under ``--remat block --optim adamw
--optStateDtype bf16``; ``--distributed`` trains data-parallel and
``--moeExperts`` a routed MoE FFN; ``--memStats`` prints the reference's four keys on a
card and nothing on the CPU, on stderr, as the reference does, so that
stdout holds the result line alone. A summary sink receives ``Loss``,
``Throughput`` and ``LearningRate`` for every iteration with k = 1 and
k = 2, parameter histograms where its ``Parameters`` trigger fires (which
bounds windows), and the validation summary each method's value.
"""

import json

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.apps import perf
from bigdl_tpu_torch.dataset.base import DataSet, MiniBatch
from bigdl_tpu_torch.models import lenet
from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger

KEYS = {"harness", "model", "batch", "iterations", "wall_s",
        "records_per_sec", "records_per_sec_incl_compile", "devices",
        "distributed", "precision"}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("model,extra", [
    ("lenet5", ["-b", "4", "-i", "2"]),
    ("lstm", ["-b", "4", "-i", "2", "--warmup", "1"]),
    ("vit_s16", ["-b", "1", "-i", "2", "--warmup", "1"]),
    ("transformer", ["-b", "1", "-i", "2", "--warmup", "1", "--remat",
                     "block", "--optim", "adamw", "--optStateDtype",
                     "bf16"]),
])
def test_perf_prints_the_reference_line(model, extra, capsys):
    result = perf.main(["--model", model, *extra, "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result and set(line) == KEYS
    assert line["model"] == model and line["harness"] == "perf"
    assert line["records_per_sec"] > 0 and not line["distributed"]


def test_k_windows_leave_the_first_windows_out():
    result, opt = perf.run(["--model", "lenet5", "-b", "4", "-i", "4",
                            "--warmup", "1", "-k", "2", "--device", "cpu"])
    assert len(opt.history) == 5 and result["records_per_sec"] > 0
    assert result["iterations"] == 4


@pytest.mark.parametrize("flag,item", [
    (["--distributed"], "A.4 (distributed plane)"),
    (["--moeExperts", "4"], "A.4 (expert)")])
def test_unported_modes_stop_naming_roadmap(flag, item):
    """Both modes are ported: ``--distributed`` trains data-parallel, here
    over a mesh of one, and says so in its line; ``--moeExperts`` trains
    the transformer with a routed MoE FFN in every block, dispatched as
    ``--moeDispatch`` says, and refuses a model that is not a
    transformer."""
    if flag == ["--distributed"]:
        result, opt = perf.run(["--model", "lenet5", "-b", "4", "-i", "2",
                                "--warmup", "1", *flag, "--device", "cpu"])
        assert result["distributed"] is True
        assert type(opt).__name__ == "DistriOptimizer"
        assert len(opt.history) == 3
        return
    from bigdl_tpu_torch.parallel.expert import MoE
    result, opt = perf.run(["--model", "transformer", "-b", "2", "-i", "1",
                            "--warmup", "1", *flag, "--moeDispatch",
                            "einsum", "--device", "cpu"])
    moes = [m for m in opt.model.modules() if isinstance(m, MoE)]
    assert len(moes) == 4 and {m.dispatch for m in moes} == {"einsum"}
    assert len(opt.history) == 2 and np.isfinite(
        [h["loss"] for h in opt.history]).all()
    with pytest.raises(SystemExit, match="applies to transformer models"):
        perf.main(["--model", "lenet5", *flag, "--device", "cpu"])


def test_mem_stats_are_empty_on_the_cpu():
    assert perf.memory_stats(torch.device("cpu")) == {}


def test_mem_stats_line_goes_to_stderr(capsys):
    result = perf.main(["--model", "lenet5", "-b", "4", "-i", "2",
                        "--warmup", "1", "--precision", "fp32", "--memStats",
                        "--device", "cpu"])
    out, err = capsys.readouterr()
    lines = [json.loads(x) for x in out.strip().splitlines()]
    assert lines == [result]
    mem = [json.loads(x) for x in err.strip().splitlines()
           if x.startswith('{"memory_stats"')]
    assert mem == [{"memory_stats": {}}]


class Sink:
    """A summary sink: every scalar and histogram it is given."""

    def __init__(self, every=None):
        self.scalars, self.histograms = [], []
        self.every = every

    def add_scalar(self, tag, value, step):
        self.scalars.append((tag, step, float(value)))

    def add_histogram(self, tag, values, step):
        self.histograms.append((tag, step, np.asarray(values).shape))

    def get_summary_trigger(self, name):
        return (Trigger.several_iteration(self.every)
                if name == "Parameters" and self.every else None)


def _lenet_opt(k, steps=4):
    rng = np.random.default_rng(0)
    batches = [MiniBatch(rng.standard_normal((4, 28, 28, 1)).astype(
        np.float32), rng.integers(1, 11, (4,)).astype(np.float32))
        for _ in range(4)]
    model = lenet.build(10, device="cpu", seed=1)
    opt = Optimizer(model, DataSet.array(batches, seed=2),
                    nn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(SGD(learningrate=0.1)) \
       .set_end_when(Trigger.max_iteration(steps)) \
       .set_steps_per_dispatch(k)
    return opt, model, batches


@pytest.mark.parametrize("k", [1, 2])
def test_train_summary_gets_every_iteration(k):
    opt, _, _ = _lenet_opt(k)
    sink = Sink()
    opt.set_train_summary(sink)
    opt.optimize()
    for tag in ("Loss", "Throughput", "LearningRate"):
        assert [s for t, s, _ in sink.scalars if t == tag] == [1, 2, 3, 4]
    losses = [v for t, _, v in sink.scalars if t == "Loss"]
    assert losses == [h["loss"] for h in opt.history]
    assert all(v > 0 for t, _, v in sink.scalars if t == "Throughput")
    assert {v for t, _, v in sink.scalars if t == "LearningRate"} == {0.1}


@pytest.mark.parametrize("k", [1, 2])
def test_parameters_trigger_writes_histograms(k):
    opt, model, _ = _lenet_opt(k, steps=5)
    sink = Sink(every=3)
    opt.set_train_summary(sink)
    opt.optimize()
    names = {"Parameters/" + n.replace(".", "/")
             for n, _ in model.named_parameters()}
    steps = sorted({s for _, s, _ in sink.histograms})
    assert steps == [3] and {t for t, _, _ in sink.histograms} == names


def test_validation_summary_gets_each_method():
    opt, _, batches = _lenet_opt(1, steps=2)
    opt.set_validation(Trigger.every_epoch(), DataSet.array(batches[:2]),
                       [Top1Accuracy()])
    val = Sink()
    opt.set_validation_summary(val)
    opt.set_end_when(Trigger.max_epoch(1)).optimize()
    assert [(t, s) for t, s, _ in val.scalars] == [("Top1Accuracy", 4)]
    assert 0.0 <= val.scalars[0][2] <= 1.0
