"""Regularized training and the autoencoder app in the port against the
JAX package, on the CPU.

The MNIST autoencoder (784 -> 32 -> 784, ``apps/autoencoder.py`` on the
vendored MNIST, batches of 8, shuffles off in both packages) with
``L2Regularizer(1e-3)`` on both weights trains 3 steps of each optim
method this slice ports (``RMSprop``, ``Adamax``, ``Adadelta``), the
app's SGD and, for 6 steps across an epoch boundary, SGD under
``EpochStep``: the per-iteration losses and the final parameters agree
within 1e-5 of max|ref|. ``RMSprop`` and ``Adamax`` take epsilon 1e-3
here: their first updates are about ``lr * g / (c |g| + epsilon)``, whose
sensitivity to a last-bit difference in a near-zero gradient element is
``lr / epsilon``; at RMSprop's 1e-8 that multiplies the two packages'
f32 rounding differences past 1e-5 (28 of 25,088 weights), and Adamax's
default 1e-38 is a subnormal that the reference's CPU flushes to zero,
so a zero gradient gives it 0/0 (``test_torch_layer_zoo_optim.py`` holds
both updates at their defaults on random gradients). The regularizer's loss enters the gradient but
not the logged loss, as in the reference; without it the parameters
differ. ``train`` of the app runs end to end and validates
``Loss(MSECriterion())`` every epoch; ``enable_timing`` on the app's
model lists every module with positive times.
"""

import logging
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.apps import autoencoder as japp
from bigdl_tpu.dataset import base as jbase
from bigdl_tpu.models import autoencoder as jautoencoder
from bigdl_tpu.optim import Optimizer as JOptimizer
from bigdl_tpu.optim import Trigger as JTrigger
from bigdl_tpu.optim import methods as jm
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.utils.rng import RandomGenerator as PortRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.apps import autoencoder as app
from bigdl_tpu_torch.apps.common import build_optimizer
from bigdl_tpu_torch.dataset import base
from bigdl_tpu_torch.models import autoencoder
from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                flatten_tree,
                                                import_tree_state)
from bigdl_tpu_torch.optim import Trigger
from bigdl_tpu_torch.optim import methods as tm

MNIST = str(Path(__file__).resolve().parent / "resources" / "mnist")
TOL = 1e-5
L2 = 1e-3


@pytest.fixture(autouse=True)
def setup(monkeypatch):
    monkeypatch.setattr(base.LocalDataSet, "shuffle", lambda self: None)
    monkeypatch.setattr(jbase.LocalDataSet, "shuffle", lambda self: None)
    yield


@pytest.fixture(autouse=True)
def one_thread():
    """One thread; and the global generators the test draws from (both
    packages' ``RandomGenerator`` and PyTorch's) left as it found them, so
    that no later test in the process sees other draws."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    gens = [JaxRNG.RNG(), PortRNG.RNG()]
    saved = [(g._seed, g._np.bit_generator.state, getattr(g, "_key", None))
             for g in gens]
    torch_state = torch.get_rng_state()
    yield
    for g, (seed, state, key) in zip(gens, saved):
        g._seed, g._np.bit_generator.state = seed, state
        if key is not None:
            g._key = key
    torch.set_rng_state(torch_state)
    torch.set_num_threads(n)


class _Losses(logging.Handler):
    """The reference's per-iteration losses, from its log records."""

    def __init__(self):
        super().__init__()
        self.losses = []

    def emit(self, record):
        if "Loss is" in str(record.msg):
            self.losses.append(float(record.args[-1]))


def _close(got, ref, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= TOL, (what, err)


def _reference(method, steps, l2):
    model = jautoencoder.build(32)
    if l2:
        for i in ("1", "3"):
            model._modules[i]._param_regularizers["weight"] = \
                jnn.L2Regularizer(l2)
    init = flatten_tree(model.parameter_tree())
    ds = japp._dataset(MNIST, 8, 0)
    opt = JOptimizer(model, ds, jnn.MSECriterion())
    opt.set_optim_method(method).set_end_when(JTrigger.max_iteration(steps))
    handler = _Losses()
    log = logging.getLogger("bigdl_tpu.optim")
    level = log.level
    log.addHandler(handler)
    log.setLevel(logging.INFO)
    try:
        trained = opt.optimize()
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
    return init, handler.losses, flatten_tree(trained.parameter_tree())


def _port(init, method, steps, l2):
    model = autoencoder.build(32, device="cpu")
    if l2:
        for linear in (model[1], model[3]):
            linear.register_parameter("weight", linear.weight,
                                      nn.L2Regularizer(l2))
    args = app.parser().parse_args(["-f", MNIST, "-b", "8", "--device",
                                    "cpu"])
    ds = app.dataset(MNIST, 8)
    opt = build_optimizer(model, ds, nn.MSECriterion(), args,
                          optim_method=method)
    assert [n for n, _ in nn.named_regularizers(opt.model)] == (
        ["1.weight", "3.weight"] if l2 else [])
    import_tree_state(opt.model, init, {})
    opt.set_end_when(Trigger.max_iteration(steps))
    opt.optimize()
    return [h["loss"] for h in opt.history], export_tree_state(opt.model)[0]


METHODS = {
    "rmsprop": lambda m: m.RMSprop(0.01, 0.0, 0.99, 1e-3),
    "adamax": lambda m: m.Adamax(0.01, 0.9, 0.999, 1e-3),
    "adadelta": lambda m: m.Adadelta(),
    "sgd": lambda m: m.SGD(learningrate=0.01, momentum=0.9),
    "sgd_epoch_step": lambda m: m.SGD(learningrate=0.5, momentum=0.9,
                                      learningrate_schedule=m.EpochStep(1,
                                                                        0.1)),
}


@pytest.mark.parametrize("name", list(METHODS))
def test_regularized_training_matches_reference(name):
    steps = 6 if name == "sgd_epoch_step" else 3
    init, jlosses, jparams = _reference(METHODS[name](jm), steps, L2)
    losses, params = _port(init, METHODS[name](tm), steps, L2)
    assert len(losses) == len(jlosses) == steps
    _close(losses, jlosses, "losses")
    assert sorted(params) == sorted(jparams)
    for k in params:
        _close(params[k], jparams[k], k)


def test_regularizer_moves_the_parameters_not_the_logged_loss():
    start = flatten_tree(jautoencoder.build(32).parameter_tree())
    plain_losses, plain = _port(start, tm.SGD(learningrate=0.01), 2, 0.0)
    reg_losses, reg = _port(start, tm.SGD(learningrate=0.01), 2, 0.5)
    assert plain_losses[0] == reg_losses[0]        # the criterion's alone
    # the first step takes a further lr * l2 * w off each weight
    np.testing.assert_allclose(
        reg["1.weight"], plain["1.weight"], atol=1e-3)
    assert not np.allclose(plain["1.weight"], reg["1.weight"], atol=1e-7)
    assert np.abs(reg["1.weight"]).sum() < np.abs(plain["1.weight"]).sum()


def test_app_train_runs_and_validates(tmp_path):
    trained = app.train(["-f", MNIST, "-b", "8", "-e", "1", "--device",
                         "cpu", "--checkpoint", str(tmp_path)])
    assert isinstance(trained[4], nn.Sigmoid)
    assert (tmp_path / "model_final").exists()
    out = trained(torch.zeros(2, 28, 28, 1))
    assert out.shape == (2, 784)
    with pytest.raises(SystemExit, match="usage"):
        app.main([])


def test_app_defaults_are_the_reference():
    args = app.parser().parse_args([])
    assert (args.batchSize, args.learningRate, args.device) == (150, 0.01,
                                                                "cuda")
    ref = japp.train_parser("x", default_batch=150,
                            default_lr=0.01).parse_args([])
    assert (ref.batchSize, ref.learningRate) == (150, 0.01)


def test_timing_on_the_autoencoder():
    opt = app.optimizer(["-f", MNIST, "-b", "8", "--device", "cpu"])
    model = opt.model
    nn.enable_timing()
    try:
        opt.set_end_when(Trigger.max_iteration(2)).optimize()
    finally:
        nn.enable_timing(False)
    times = model.get_times()
    assert len(times) == 6
    assert all(f > 0 and b > 0 for _, f, b in times), times
