"""``inception train`` of the port against the reference's on the same
files, on the CPU (``--device cpu``).

A seeded image tree (``test_torch_image_apps.py``'s ``tree``) is packed by
``seqfilegen``. ``inception train --folder`` then trains on the shards
(the stream, the decode on 8 threads, flips and random crops from one
``RandomGenerator`` seed, the centre-cropped validation, prefetch), and
again with ``--caffeModel`` (a caffemodel's weights copied in by layer
name) or ``--torchModel`` (the whole model from a ``.t7`` file), on a tiny
model carried into both packages (the builders patched). Every
iteration's loss is within 1e-4 (relative) of the reference's, and the
validation's Top-1 and Top-5 lines are the reference's. Batches of 8:
the reference trains a shard dataset, which is distributed, over its
8-device CPU mesh.
"""

import logging

import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.apps import inception as jinception_app
from bigdl_tpu.dataset import shards as jshards
from bigdl_tpu.interop import torch_file as jtf
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.apps import inception as inception_app
from bigdl_tpu_torch.apps import seqfilegen
from bigdl_tpu_torch.dataset import shards
from bigdl_tpu_torch.utils.rng import RandomGenerator
from test_torch_caffe import write_caffemodel
from test_torch_image_apps import _carried, tree  # noqa: F401 (fixture)

LOSS_RTOL = 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Losses(logging.Handler):
    """Per-iteration losses and validation results from log records."""

    def __init__(self):
        super().__init__()
        self.losses, self.results = [], []

    def emit(self, record):
        if "Loss is" in str(record.msg):
            self.losses.append(float(record.args[-1]))
        elif "Accuracy(" in record.getMessage():
            self.results.append(record.getMessage())


def _inception_tiny(mod):
    return (mod.Sequential()
            .add(mod.SpatialConvolution(3, 4, 7, 7, 4, 4).set_name("conv1"))
            .add(mod.ReLU())
            .add(mod.SpatialMaxPooling(5, 5, 5, 5))
            .add(mod.Reshape((4 * 11 * 11,)))
            .add(mod.Linear(4 * 11 * 11, 1000).set_name("loss3/classifier"))
            .add(mod.LogSoftMax()))


def _run_inception(monkeypatch, argv, jm, tm):
    """Both apps' train on ``argv``; returns (the port's optimizer, the
    reference's losses, the reference's validation lines)."""
    monkeypatch.setattr(shards.StreamingShardDataSet, "shuffle",
                        lambda self: None)
    monkeypatch.setattr(jshards.StreamingShardDataSet, "shuffle",
                        lambda self: None)
    monkeypatch.setattr(inception_app.inception, "build", lambda *a, **k: tm)
    monkeypatch.setattr(jinception_app.inception, "build",
                        lambda *a, **k: jm)
    RandomGenerator.RNG().set_seed(17)
    opt, _ = inception_app.optimizer(argv + ["--device", "cpu"])
    assert not opt.history   # not started
    opt.optimize()
    handler = _Losses()
    log = logging.getLogger("bigdl_tpu.optim")
    level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    JaxRNG.RNG().set_seed(17)
    try:
        jinception_app.train(argv)
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    return opt, handler.losses, handler.results


@pytest.mark.parametrize("source", ["folder", "caffeModel", "torchModel"])
def test_inception_train_matches_the_reference(tree, tmp_path, monkeypatch,
                                               source):
    packed = str(tmp_path / "shards")
    seqfilegen.main(["-f", str(tree), "-o", packed, "-b", "5"])
    argv = ["-f", packed, "-b", "8", "-e", "2", "-r", "0.05"]
    jm = _inception_tiny(jnn)
    tm = _carried(jm, _inception_tiny(nn))
    if source == "caffeModel":
        # the caffemodel's weights replace the built models' own
        other = _inception_tiny(jnn)
        conv, ip = other[0], other[4]
        mp = str(tmp_path / "m.caffemodel")
        write_caffemodel(mp, [
            ("conv1", "Convolution",
             [np.transpose(np.asarray(conv.weight), (3, 2, 0, 1)),
              np.asarray(conv.bias)]),
            ("loss3/classifier", "InnerProduct",
             [np.asarray(ip.weight), np.asarray(ip.bias)])])
        argv += ["--caffeModel", mp]
    elif source == "torchModel":
        path = str(tmp_path / "m.t7")
        jtf.save_torch(_inception_tiny(jnn), path)
        argv += ["--torchModel", path]
    opt, ref_losses, ref_results = _run_inception(monkeypatch, argv, jm, tm)
    got = [h["loss"] for h in opt.history]
    assert len(got) == len(ref_losses) == 4   # 16 images, batches of 8
    for g, r in zip(got, ref_losses):
        assert abs(g - r) <= LOSS_RTOL * abs(r), (got, ref_losses)
    lines = [f"{name} is {result}" for val in opt.validation_history
             for name, result in val["results"].items()]
    assert len(lines) == 4 and lines == ref_results
