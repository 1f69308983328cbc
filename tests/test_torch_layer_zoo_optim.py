"""The optim methods this slice ports against the JAX package's, on the
CPU: ``Adamax``, ``Adadelta``, ``RMSprop``, the ``EpochStep`` and
``EpochDecay`` schedules (through ``SGD``, which takes a schedule), and
``LBFGS`` with its strong-Wolfe line search.

Each minibatch method runs 5 updates on the same numpy parameter and
gradient trees through the reference's pure ``update`` and the port's
in-place one; parameters and moments agree within 1e-6 (absolute and
relative, f32), and the update from ``step_scalars`` as a tensor (what a
captured window reads) tracks the Python-float update. ``LBFGS`` on a
seeded full-batch least-squares problem gives the same losses and final
iterate within 1e-5, with and without the line search, for a tensor and a
dict of tensors; ``Optimizer.set_optim_method`` refuses it with the
reference's message, and ``OptimMethod.optimize`` takes one Torch-style
step.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.optim import methods as jm
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.utils.rng import RandomGenerator as PortRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.base import DataSet, MiniBatch
from bigdl_tpu_torch.optim import methods as tm
from bigdl_tpu_torch.optim import Optimizer

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"w": (4, 3), "b": (3,), "e": (5, 2)}
STEPS = 5


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


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _run(jax_method, port_method, epochs=(1,) * STEPS, seed=0):
    rng = np.random.default_rng(seed)
    params = _tree(rng)
    grads = [_tree(rng, 0.5) for _ in range(STEPS)]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jax_method.init_state(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ts = port_method.init_state(tp)
    for g, epoch in zip(grads, epochs):
        js = {**js, "epoch": jnp.asarray(epoch, jnp.int32)}
        ts["epoch"] = epoch
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
            np.testing.assert_allclose(ts[name][k].numpy(),
                                       np.asarray(js[name][k]), **TOL,
                                       err_msg=f"{name}.{k}")


METHODS = {
    "adamax": lambda m: m.Adamax(),
    "adamax_wd": lambda m: m.Adamax(0.01, 0.8, 0.99, 1e-8, 1e-3),
    "adadelta": lambda m: m.Adadelta(),
    "adadelta_rho": lambda m: m.Adadelta(0.5, 1e-6),
    "rmsprop": lambda m: m.RMSprop(),
    "rmsprop_decay": lambda m: m.RMSprop(0.05, 0.1, 0.9, 1e-6),
}
MOMENTS = {"adamax": ("m", "u"), "adadelta": ("accum", "delta_accum"),
           "rmsprop": ("accum",)}


@pytest.mark.parametrize("name", list(METHODS))
def test_method_matches_reference(name):
    js, ts = _run(METHODS[name](jm), METHODS[name](tm))
    _moments_close(js, ts, *MOMENTS[name.split("_")[0]])


@pytest.mark.parametrize("name", list(METHODS))
def test_update_from_step_scalars_tracks_the_float_update(name):
    method = METHODS[name](tm)
    rng = np.random.default_rng(4)
    w = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
    pa, pb = {"w": w.clone()}, {"w": w.clone()}
    sa, sb = method.init_state(pa), method.init_state(pb)
    for _ in range(5):
        g = torch.from_numpy(rng.standard_normal((6, 5)).astype(np.float32))
        row = torch.tensor(method.step_scalars(sb), dtype=torch.float32)
        method.update({"w": g.clone()}, sa, pa)
        method.update({"w": g.clone()}, sb, pb, row)
    assert sa["evalCounter"] == sb["evalCounter"] == 5
    torch.testing.assert_close(pb["w"], pa["w"], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("make,epochs", [
    (lambda m: m.EpochStep(2, 0.5), (1, 1, 2, 3, 5)),
    (lambda m: m.EpochDecay(lambda e: e // 2), (1, 2, 2, 3, 4))])
def test_epoch_schedules_through_sgd(make, epochs):
    js, ts = _run(jm.SGD(0.1, momentum=0.9, learningrate_schedule=make(jm)),
                  tm.SGD(0.1, momentum=0.9, learningrate_schedule=make(tm)),
                  epochs)
    _moments_close(js, ts, "velocity")
    for epoch in range(1, 8):
        state = {"evalCounter": 3, "epoch": epoch}
        jstate = {"evalCounter": jnp.asarray(3),
                  "epoch": jnp.asarray(epoch)}
        assert abs(make(tm).rate(0.1, state)
                   - float(make(jm).rate(0.1, jstate))) < 1e-7


# ------------------------------------------------------------------ LBFGS
def _least_squares(seed=0, n=12, d=5):
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (n, d)).astype(np.float32)
    b = rng.normal(0, 1, (n,)).astype(np.float32)
    x0 = rng.normal(0, 1, (d,)).astype(np.float32)
    return a, b, x0


@pytest.mark.parametrize("linesearch", [False, True])
@pytest.mark.parametrize("as_dict", [False, True])
def test_lbfgs_matches_reference(linesearch, as_dict):
    a, b, x0 = _least_squares()
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    import jax

    def jloss(x):
        x = jnp.concatenate([x["p"], x["q"]]) if as_dict else x
        r = ja @ x - jb
        return 0.5 * jnp.sum(r * r)

    def jfeval(x):
        return jloss(x), jax.grad(jloss)(x)

    def tfeval(x):
        flat = torch.cat([x["p"], x["q"]]) if as_dict else x
        r = ta @ flat - tb
        g = ta.T @ r
        grad = {"p": g[:2], "q": g[2:]} if as_dict else g
        return 0.5 * (r * r).sum(), grad

    def start(conv):
        return ({"p": conv(x0[:2]), "q": conv(x0[2:])} if as_dict
                else conv(x0))

    kw = dict(max_iter=6, linesearch=linesearch)
    jx, jlosses = jm.LBFGS(**kw).optimize(jfeval, start(jnp.asarray))
    tx, tlosses = tm.LBFGS(**kw).optimize(
        tfeval, start(lambda v: torch.from_numpy(v.copy())))
    assert len(tlosses) == len(jlosses) > 3
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-5, atol=1e-6)
    for k in (("p", "q") if as_dict else (None,)):
        got = tx[k] if k else tx
        want = jx[k] if k else jx
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert tlosses[-1] < tlosses[0]


def test_wolfe_line_search_matches_reference():
    a, b, x0 = _least_squares(3)

    def jf(x):
        r = jnp.asarray(a) @ x - jnp.asarray(b)
        return 0.5 * jnp.sum(r * r), jnp.asarray(a).T @ r

    def tf(x):
        r = torch.from_numpy(a) @ x - torch.from_numpy(b)
        return 0.5 * (r * r).sum(), torch.from_numpy(a).T @ r

    jf0, jg0 = jf(jnp.asarray(x0))
    tf0, tg0 = tf(torch.from_numpy(x0))
    for t0 in (1e-3, 1.0, 50.0):
        ref = jm._wolfe_line_search(jf, jnp.asarray(x0), -jg0, float(jf0),
                                    jg0, t0)
        got = tm._wolfe_line_search(tf, torch.from_numpy(x0), -tg0,
                                    float(tf0), tg0, t0)
        assert got[3] == ref[3]
        assert abs(got[0] - ref[0]) <= 1e-6 * max(1.0, abs(ref[0]))
        assert abs(got[1] - ref[1]) <= 1e-5 * abs(ref[1])


def test_adamax_default_epsilon_keeps_a_zero_gradient_finite():
    """Adamax's default epsilon 1e-38 is a float32 subnormal. PyTorch keeps
    it, so a zero gradient (a dead unit's bias) gives m / u = 0 / 1e-38 and
    no step; the reference's XLA CPU flushes it to zero and gives NaN
    there (ROADMAP C, known differences)."""
    p = {"w": torch.tensor([0.5, -0.25])}
    method = tm.Adamax()
    state = method.init_state(p)
    for _ in range(3):
        method.update({"w": torch.tensor([0.0, 1.0])}, state, p)
    assert torch.isfinite(p["w"]).all() and float(p["w"][0]) == 0.5


def test_optimizer_refuses_a_full_batch_method():
    model = nn.Sequential().add(nn.Linear(3, 2))
    ds = DataSet.array([MiniBatch(np.zeros((2, 3), np.float32),
                                  np.zeros((2, 2), np.float32))])
    opt = Optimizer(model, ds, nn.MSECriterion(), device="cpu")
    assert tm.LBFGS.supports_minibatch is False
    assert tm.SGD.supports_minibatch is True
    with pytest.raises(ValueError, match="full-batch method and cannot "
                       "drive the minibatch training loop"):
        opt.set_optim_method(tm.LBFGS())
    with pytest.raises(NotImplementedError, match="optimize"):
        tm.LBFGS().update({}, {}, {})


def test_optimize_takes_one_torch_style_step():
    x = torch.ones(3)
    method = tm.RMSprop(0.1)
    x2, losses = method.optimize(lambda v: ((v * v).sum(), 2 * v), x)
    assert x2 is x and losses == [pytest.approx(3.0)]
    assert method._state["evalCounter"] == 1
    jx, jlosses = jm.RMSprop(0.1).optimize(
        lambda v: ((v * v).sum(), 2 * v), jnp.ones(3))
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-6)
