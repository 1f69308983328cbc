"""The port's optim methods, schedules, triggers and gradient clippers
against the JAX package's.

Each method runs 5 updates on the same numpy parameter and gradient trees
(dicts of arrays) through the reference's pure ``update`` and the port's
in-place one; parameters and moments must agree within 1e-6 (absolute and
relative, f32). The reference's ``Adam`` and ``AdamW`` take no schedule
object (their rate is ``lr / (1 + n * learningrate_decay)``), so the
``Warmup(CosineDecay)`` composition is held against the reference through
``SGD``, which takes one, and every schedule's rate is compared directly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.optim import methods as jm
from bigdl_tpu.optim.optimizer import make_grad_clipper as jax_clipper
from bigdl_tpu.optim.triggers import Trigger as JaxTrigger
from bigdl_tpu_torch.optim import methods as tm
from bigdl_tpu_torch.optim.optimizer import make_grad_clipper
from bigdl_tpu_torch.optim.triggers import Trigger

torch.set_num_threads(1)

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"w": (4, 3), "b": (3,), "e": (5, 2)}
STEPS = 5


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _run(jax_method, port_method, seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng, 0.5) for _ in range(STEPS)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jax_method.init_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = port_method.init_state(tp)
    for g in grads:
        jp, js = jax_method.update({k: jnp.asarray(v) for k, v in g.items()},
                                   js, jp)
        port_method.update({k: torch.from_numpy(v) for k, v in g.items()},
                           ts, tp)
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **TOL,
                                   err_msg=k)
    assert ts["evalCounter"] == int(js["evalCounter"]) == STEPS
    return js, ts


def _moments_close(js, ts, *names):
    for name in names:
        for k in SHAPES:
            np.testing.assert_allclose(
                ts[name][k].float().numpy(),
                np.asarray(js[name][k], np.float32), **TOL,
                err_msg=f"{name}[{k}]")


@pytest.mark.parametrize("nesterov", [True, False])
def test_sgd_momentum_weight_decay(nesterov):
    kw = dict(learningrate=0.1, weightdecay=1e-2, momentum=0.9,
              dampening=0.0 if nesterov else 0.3, nesterov=nesterov,
              learningrate_decay=0.05)
    js, ts = _run(jm.SGD(**kw), tm.SGD(**kw))
    _moments_close(js, ts, "velocity")


def test_sgd_warmup_cosine_schedule():
    kw = dict(learningrate=0.1, momentum=0.5)
    js, ts = _run(jm.SGD(**kw, learningrate_schedule=jm.Warmup(
        2, jm.CosineDecay(4, min_lr=0.01))),
        tm.SGD(**kw, learningrate_schedule=tm.Warmup(
            2, tm.CosineDecay(4, min_lr=0.01))))
    _moments_close(js, ts, "velocity")


def test_adagrad():
    kw = dict(learningrate=0.1, learningrate_decay=0.1, weightdecay=1e-3)
    js, ts = _run(jm.Adagrad(**kw), tm.Adagrad(**kw))
    _moments_close(js, ts, "accum")


@pytest.mark.parametrize("state_dtype", [None, "bfloat16"])
def test_adam(state_dtype):
    kw = dict(learningrate=1e-2, learningrate_decay=0.1, weightdecay=1e-2,
              state_dtype=state_dtype)
    js, ts = _run(jm.Adam(**kw), tm.Adam(**kw))
    _moments_close(js, ts, "m", "v")
    want = torch.bfloat16 if state_dtype else torch.float32
    assert ts["m"]["w"].dtype == ts["v"]["w"].dtype == want


@pytest.mark.parametrize("decay", [0.0, 0.1])
def test_adamw(decay):
    kw = dict(learningrate=1e-2, learningrate_decay=0.2, weightdecay=decay)
    js, ts = _run(jm.AdamW(**kw), tm.AdamW(**kw))
    _moments_close(js, ts, "m", "v")


@pytest.mark.parametrize("name", ["Default", "Poly", "Step", "MultiStep",
                                  "CosineDecay", "Warmup"])
def test_schedule_rates(name):
    make = {
        "Default": lambda m: m.Default(),
        "Poly": lambda m: m.Poly(0.5, 10),
        "Step": lambda m: m.Step(3, 0.5),
        "MultiStep": lambda m: m.MultiStep([2, 5, 7], 0.1),
        "CosineDecay": lambda m: m.CosineDecay(8, min_lr=0.01),
        "Warmup": lambda m: m.Warmup(3, m.CosineDecay(8)),
    }[name]
    ref, port = make(jm), make(tm)
    for it in range(14):
        want = float(ref.rate(0.3, {"evalCounter": jnp.asarray(it),
                                    "learningRateDecay": 0.1}))
        got = port.rate(0.3, {"evalCounter": it, "learningRateDecay": 0.1})
        np.testing.assert_allclose(got, want, **TOL, err_msg=f"iter {it}")


def test_triggers_match_reference():
    names = ["several_iteration", "max_epoch", "max_iteration", "min_loss",
             "max_score", "and_", "or_"]
    states = [dict(epoch=e, neval=n, trainingLoss=loss, score=sc)
              for e in (1, 2, 3) for n in (1, 4, 5, 6)
              for loss in (0.5, 2.0) for sc in (0.1, 0.9)]

    def make(T, name):
        return {
            "several_iteration": lambda: T.several_iteration(2),
            "max_epoch": lambda: T.max_epoch(2),
            "max_iteration": lambda: T.max_iteration(5),
            "min_loss": lambda: T.min_loss(1.0),
            "max_score": lambda: T.max_score(0.5),
            "and_": lambda: T.and_(T.max_epoch(1), T.min_loss(1.0)),
            "or_": lambda: T.or_(T.max_iteration(4), T.max_score(0.5)),
        }[name]()

    for name in names:
        ref, port = make(JaxTrigger, name), make(Trigger, name)
        assert port.uses_loss == ref.uses_loss, name
        assert [port(s) for s in states] == [ref(s) for s in states], name
    ref, port = JaxTrigger.every_epoch(), Trigger.every_epoch()
    seq = [dict(epoch=e) for e in (1, 1, 2, 2, 3)]
    assert [port(s) for s in seq] == [ref(s) for s in seq]


@pytest.mark.parametrize("clip", [{"l2": 0.5}, {"l2": 100.0},
                                  {"constant": (-0.2, 0.3)},
                                  {"constant": (-0.2, 0.3), "l2": 0.4}, {}])
def test_grad_clippers_match_reference(clip):
    grads = _tree(np.random.default_rng(11))
    ref = jax_clipper(clip)({k: jnp.asarray(v) for k, v in grads.items()})
    got = make_grad_clipper(clip)({k: torch.from_numpy(v.copy())
                                   for k, v in grads.items()})
    for k in SHAPES:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), **TOL)
