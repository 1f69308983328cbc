"""The conv zoo's apps and ``Validator`` in the port against the JAX
package's, on the CPU.

``lenet`` (on the vendored MNIST) and ``resnet`` (``--depth 8`` on a CIFAR
binary file the test writes) each train for a few iterations in both
packages with ``device="cpu"`` in the port: the same weights (the
builders are patched to return models carrying the reference's),
``RandomGenerator.RNG()`` seeded alike in both (so the augmentations draw
the same crops and flips), and the datasets' shuffles turned off in both
(the packages shuffle from different generators). Every iteration's loss
agrees within 1e-4 (relative), and ``test --model`` on the saved model
gives the reference's trained model's Top-1. ``vgg``'s run is in
``test_torch_vision_apps_vgg.py``.

``Validator`` warns that it is deprecated, returns a ``LocalValidator``
and gives the reference's results; ``calc_accuracy`` and
``calc_top5_accuracy`` count as the reference's. The inception app's
options that need machinery the port lacks stop with their ROADMAP label.
"""

import logging
from pathlib import Path

import numpy as np
import pytest
import torch

from bigdl_tpu.apps import lenet as jlenet_app
from bigdl_tpu.apps import resnet as jresnet_app
from bigdl_tpu.dataset import base as jbase
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.optim import Top1Accuracy as JaxTop1
from bigdl_tpu.optim import Top5Accuracy as JaxTop5
from bigdl_tpu.optim import validator as jvalidator
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.apps import inception as inception_app
from bigdl_tpu_torch.apps import lenet as lenet_app
from bigdl_tpu_torch.apps import resnet as resnet_app
from bigdl_tpu_torch.dataset import base
from bigdl_tpu_torch.interop.state_dict import flatten_tree, import_tree_state
from bigdl_tpu_torch.models import lenet, resnet
from bigdl_tpu_torch.optim import (DistriValidator, LocalValidator,
                                   Top1Accuracy, Top5Accuracy, Validator,
                                   calc_accuracy, calc_top5_accuracy)
from bigdl_tpu_torch.utils.rng import RandomGenerator

MNIST = str(Path(__file__).resolve().parent / "resources" / "mnist")
LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    for g in ("BIGDL_TPU_FUSED_1X1", "BIGDL_TPU_FUSED_3X3"):
        monkeypatch.delenv(g, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Losses(logging.Handler):
    """The reference's per-iteration losses, read from its log records'
    arguments (the float before it is formatted)."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def emit(self, record):
        if "Loss is" in str(record.msg):
            self.losses.append(float(record.args[-1]))


def _carried(jm, tm):
    import_tree_state(tm, flatten_tree(jm.parameter_tree()),
                      flatten_tree(jm.buffer_tree()))
    return tm


def run_both(monkeypatch, app, japp, module_name, jm, tm, argv, tmp_path):
    """``train`` of the port's and the reference's app on the same
    weights; returns (port losses, reference losses, the port's trained
    model, the reference's)."""
    monkeypatch.setattr(base.LocalDataSet, "shuffle", lambda self: None)
    monkeypatch.setattr(jbase.LocalDataSet, "shuffle", lambda self: None)
    monkeypatch.setattr(getattr(app, module_name), "build" if module_name
                        != "resnet" else "build_cifar",
                        lambda *a, **k: tm)
    monkeypatch.setattr(getattr(japp, module_name), "build" if module_name
                        != "resnet" else "build_cifar",
                        lambda *a, **k: jm)
    opts = []
    real = app.build_optimizer

    def recording(*a, **k):
        opts.append(real(*a, **k))
        return opts[-1]
    monkeypatch.setattr(app, "build_optimizer", recording)
    RandomGenerator.RNG().set_seed(17)
    trained = app.train(argv + ["--device", "cpu", "--checkpoint",
                                str(tmp_path / "port")])
    handler = _Losses()
    log = logging.getLogger("bigdl_tpu.optim")
    level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    JaxRNG.RNG().set_seed(17)
    try:
        japp.train(argv)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    return ([h["loss"] for h in opts[0].history], handler.losses, trained)


def _hold_losses(got, ref, n):
    assert len(got) == len(ref) == n
    for g, r in zip(got, ref):
        assert abs(g - r) <= LOSS_RTOL * abs(r), (got, ref)


def test_lenet_app_train_and_test(monkeypatch, tmp_path):
    jm = jlenet.build(10)
    tm = _carried(jm, lenet.build(10, device="cpu", seed=3))
    got, ref, trained = run_both(
        monkeypatch, lenet_app, jlenet_app, "lenet", jm, tm,
        ["-f", MNIST, "-b", "8", "-e", "2"], tmp_path)
    _hold_losses(got, ref, 8)   # 32 images, batches of 8, 2 epochs
    assert trained is tm
    results = lenet_app.test(["--model", str(tmp_path / "port" /
                                             "model_final"),
                              "-f", MNIST, "-b", "8", "--device", "cpu"])
    (result, method), = results
    assert method.name == "Top1Accuracy"
    ref_set = jlenet_app._dataset(MNIST, 8, False, 0)
    (ref_result, _), = jm.evaluate(ref_set, [JaxTop1()])
    assert (result.correct, result.count) == (ref_result.correct,
                                              ref_result.count)


def _write_cifar(folder, n_train, n_test):
    rng = np.random.default_rng(6)

    def write(path, n):
        path.write_bytes(b"".join(
            bytes([int(rng.integers(0, 10))])
            + rng.integers(0, 256, 3072, np.uint8).tobytes()
            for _ in range(n)))
    for i in range(1, 6):
        write(folder / f"data_batch_{i}.bin", n_train)
    write(folder / "test_batch.bin", n_test)


def test_resnet_app_train_and_test(monkeypatch, tmp_path):
    """Depth 8, shortcut A, nesterov, weight decay 1e-4, the Regime rate,
    ``CrossEntropyCriterion``, flips and padded crops, prefetched
    batches."""
    data = tmp_path / "cifar"
    data.mkdir()
    _write_cifar(data, 2, 4)
    jm = jresnet.build_cifar(10, depth=8, shortcut_type="A")
    tm = _carried(jm, resnet.build_cifar(10, depth=8, shortcut_type="A",
                                         device="cpu", seed=3))
    got, ref, _ = run_both(
        monkeypatch, resnet_app, jresnet_app, "resnet", jm, tm,
        ["-f", str(data), "-b", "4", "-e", "2", "--depth", "8"], tmp_path)
    _hold_losses(got, ref, 4)   # 10 images, batches of 4, 2 epochs
    (result, _), = resnet_app.test(["--model", str(tmp_path / "port" /
                                                   "model_final"),
                                    "-f", str(data), "-b", "4",
                                    "--device", "cpu"])
    ref_set = jresnet_app._val_set(str(data), 4, 0)
    (ref_result, _), = jm.evaluate(ref_set, [JaxTop1()])
    assert (result.correct, result.count) == (ref_result.correct,
                                              ref_result.count)


def test_validator_matches_the_reference(recwarn):
    jm = jlenet.build(10)
    tm = _carried(jm, lenet.build(10, device="cpu", seed=3))
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (10, 28, 28, 1)).astype(np.float32)
    y = rng.integers(1, 11, (10,)).astype(np.float32)
    samples = [base.Sample(f, l) for f, l in zip(x, y)]
    jsamples = [jbase.Sample(f, l) for f, l in zip(x, y)]
    ds = base.DataSet.array(samples) >> base.SampleToBatch(
        4, drop_remainder=False)
    jds = jbase.DataSet.array(jsamples) >> jbase.SampleToBatch(
        4, drop_remainder=False)
    with pytest.warns(DeprecationWarning, match="model.evaluate"):
        v = Validator(tm, ds)
    assert type(v) is LocalValidator
    with pytest.warns(DeprecationWarning):
        jv = jvalidator.Validator(jm, jds)
    got = v.test([Top1Accuracy(), Top5Accuracy()])
    ref = jv.test([JaxTop1(), JaxTop5()])
    for (g, _), (r, _) in zip(got, ref):
        assert (g.correct, g.count) == (r.correct, r.count)
    assert isinstance(DistriValidator(tm, ds), DistriValidator)


def test_accuracy_helpers_count_as_the_reference():
    rng = np.random.default_rng(9)
    out = rng.normal(0, 1, (12, 7)).astype(np.float32)
    out[3, :] = 0.0   # ties go to the lowest class in both
    tgt = rng.integers(1, 8, (12,)).astype(np.float32)
    tgt[3] = 1.0
    assert calc_accuracy(out, tgt) == jvalidator.calc_accuracy(out, tgt)
    assert calc_top5_accuracy(out, tgt) == jvalidator.calc_top5_accuracy(
        out, tgt)
    assert calc_accuracy(out[0], tgt[:1]) == jvalidator.calc_accuracy(
        out[0], tgt[:1])
    with pytest.raises(ValueError, match="target length"):
        calc_accuracy(out, tgt[:5])


@pytest.mark.parametrize("flag,label", [
    (["--folder", "/nowhere"], r"ROADMAP A\.5 \(shards\)"),
    (["--caffeModel", "m.caffemodel"], r"ROADMAP A\.6 \(caffe\)"),
    (["--torchModel", "m.t7"], r"ROADMAP A\.6 \(torch_file\)")])
def test_inception_app_refuses_what_is_not_ported(flag, label):
    with pytest.raises(SystemExit, match=label):
        inception_app.main(["train", "--device", "cpu", *flag])


def test_app_usage_messages():
    for app in (lenet_app, resnet_app):
        with pytest.raises(SystemExit, match="usage"):
            app.main([])
    with pytest.raises(SystemExit, match="usage"):
        inception_app.main(["test"])


def test_optimizer_steps_past_a_parameter_without_gradient():
    """A fused conv's pre-BN bias is not on the training path: the port's
    step gives it the reference's zero gradient (it used to raise), so
    SGD with momentum leaves it where it was."""
    from bigdl_tpu_torch.nn import (ClassNLLCriterion, FusedConv3x3BN,
                                    Linear, LogSoftMax, ReLU, Reshape,
                                    Sequential)
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    gen = torch.Generator().manual_seed(0)
    model = (Sequential()
             .add(FusedConv3x3BN(3, 8, with_bias=True, generator=gen))
             .add(ReLU()).add(Reshape((8 * 4 * 4,), batch_mode=True))
             .add(Linear(8 * 4 * 4, 3, generator=gen)).add(LogSoftMax()))
    bias = model[0].bias.detach().clone()
    weight = model[0].weight.detach().clone()
    rng = np.random.default_rng(1)
    batch = base.MiniBatch(rng.normal(0, 1, (4, 4, 4, 3)).astype(np.float32),
                           np.array([1, 2, 3, 1], np.float32))
    (Optimizer(model, base.DataSet.array([batch] * 2, seed=0),
               ClassNLLCriterion(), device="cpu")
     .set_optim_method(SGD(learningrate=0.1, momentum=0.9))
     .set_end_when(Trigger.max_iteration(2)).optimize())
    assert torch.equal(model[0].bias.detach(), bias)
    assert not torch.equal(model[0].weight.detach(), weight)
