"""The table criteria and ``MultiLabelMarginCriterion`` in the port against
the JAX package's, on the CPU: the loss and its gradient for each input
(``jax.grad`` against autograd), within 1e-6 of max|ref|.

The criteria over a table of inputs (``MarginRankingCriterion``,
``CosineEmbeddingCriterion``, ``L1HingeEmbeddingCriterion``, with plain
and table targets, both ``size_average`` modes), ``ParallelCriterion``
with and without ``repeat_target``, ``MultiCriterion`` and
``CriterionTable`` (a reference ``Table`` against a port ``Table`` or
list), and ``backward``. ``MultiLabelMarginCriterion`` agrees with the
reference on unpadded targets; on a zero-padded one the port keeps
Torch's rule, the one difference from the reference (the module
docstring of ``bigdl_tpu_torch/nn/criterion.py``), pinned by hand here.
``SoftmaxWithCriterion``'s modes: ``test_torch_layer_zoo_softmax_with.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.utils.rng import RandomGenerator as PortRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.utils.table import T

TOL = 1e-6
R = np.random.RandomState(1)
N, C = 4, 5


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


def _close(got, ref, tol=TOL, what=""):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, (what, err)


def _jt(v):
    if isinstance(v, list):
        return JT(*[_jt(a) for a in v])
    return None if v is None else jnp.asarray(v)


def _tt(v):
    if isinstance(v, list):
        return [_tt(a) for a in v]
    return None if v is None else torch.from_numpy(np.array(v))


def _crit(jc, tc, x, t, tol=TOL):
    """Loss and input gradients of the two criteria on input ``x`` (an
    array, or a list of arrays: a table) and target ``t``."""
    xs = x if isinstance(x, list) else [x]

    def f(*a):
        return jc.apply(JT(*a) if isinstance(x, list) else a[0], _jt(t))

    ref = f(*map(jnp.asarray, xs))
    ref_g = jax.grad(f, argnums=tuple(range(len(xs))))(*map(jnp.asarray, xs))
    txs = [torch.from_numpy(np.array(a)).requires_grad_() for a in xs]
    got = tc(txs if isinstance(x, list) else txs[0], _tt(t))
    _close(got.detach().numpy(), ref, tol, "loss")
    got.backward()
    for a, g in zip(txs, ref_g):
        _close(a.grad.numpy(), g, tol, "grad")


def _logp():
    return np.log(R.dirichlet(np.ones(C), N)).astype(np.float32)


def _labels():
    return (R.randint(0, C, N) + 1).astype(np.float32)


def _scores():
    return R.randn(N, C).astype(np.float32)


def _probs():
    return R.uniform(0.05, 0.95, (N, C)).astype(np.float32)


def _pm_ones(shape=(N, C)):
    return (R.randint(0, 2, shape) * 2 - 1).astype(np.float32)


def _bits():
    return R.randint(0, 2, (N, C)).astype(np.float32)


# (id, class name, constructor args, input, target)
CASES = [
    ("multilabel_margin", "MultiLabelMarginCriterion", (), _scores(),
     np.stack([R.permutation(C)[:C] + 1.0 for _ in range(N)]).astype(
         np.float32)[:, :3]),
    ("multilabel_margin_sum", "MultiLabelMarginCriterion", (False,),
     _scores(), np.stack([R.permutation(C)[:2] + 1.0 for _ in range(N)])
     .astype(np.float32)),
    ("margin_ranking", "MarginRankingCriterion", (0.3,),
     [R.randn(N).astype(np.float32), R.randn(N).astype(np.float32)],
     _pm_ones((N,))),
    ("margin_ranking_table", "MarginRankingCriterion", (0.3, False),
     [R.randn(N).astype(np.float32), R.randn(N).astype(np.float32)],
     [_pm_ones((N,))]),
    ("cosine_embed", "CosineEmbeddingCriterion", (0.1,),
     [_scores(), _scores()], _pm_ones((N,))),
    ("cosine_embed_1d", "CosineEmbeddingCriterion", (0.0, False),
     [R.randn(C).astype(np.float32), R.randn(C).astype(np.float32)],
     np.array([-1.0], np.float32)),
    ("l1_hinge_pos", "L1HingeEmbeddingCriterion", (2.0,),
     [_scores(), _scores()], np.asarray(1.0, np.float32)),
    ("l1_hinge_neg", "L1HingeEmbeddingCriterion", (40.0,),
     [_scores(), _scores()], [np.asarray(-1.0, np.float32)]),
]


@pytest.mark.parametrize("name,cls,args,x,t", CASES, ids=[c[0] for c in CASES])
def test_criterion_matches_reference(name, cls, args, x, t):
    _crit(getattr(jnn, cls)(*args), getattr(nn, cls)(*args), x, t)


@pytest.mark.parametrize("repeat", [False, True])
def test_parallel_criterion(repeat):
    def build(pkg):
        return (pkg.ParallelCriterion(repeat)
                .add(pkg.MSECriterion(), 0.5).add(pkg.AbsCriterion(), 2.0))
    x = [_scores(), _scores()]
    t = _scores() if repeat else [_scores(), _scores()]
    _crit(build(jnn), build(nn), x, t)


def test_multi_criterion_and_criterion_table():
    def multi(pkg):
        return (pkg.MultiCriterion().add(pkg.MSECriterion(), 0.3)
                .add(pkg.SmoothL1Criterion(), 1.7))
    _crit(multi(jnn), multi(nn), _scores() * 2, _scores())
    x, t = _scores(), _scores()
    ref = jnn.CriterionTable(jnn.MSECriterion()).apply(
        JT(jnp.asarray(x), jnp.asarray(t)), None)
    got = nn.CriterionTable(nn.MSECriterion())(
        T(torch.from_numpy(x), torch.from_numpy(t)), None)
    _close(got.numpy(), ref)


def test_backward_returns_the_input_gradient():
    x, t = _scores(), _scores()
    ref = jax.grad(lambda a: jnn.MSECriterion().apply(a, jnp.asarray(t)))(
        jnp.asarray(x))
    got = nn.MSECriterion().backward(torch.from_numpy(x), torch.from_numpy(t))
    _close(got.numpy(), ref)


def test_multilabel_margin_marks_every_listed_label():
    """Torch's rule on a zero-padded target: labels 1 and 3 of 4 classes
    against the non-labels 2 and 4, divided by C. (The reference's scatter
    unmarks class 1 here, the difference the module docstring names.)"""
    x = torch.tensor([[0.1, 0.2, 0.4, 0.8]])
    got = nn.MultiLabelMarginCriterion()(x, torch.tensor([[3.0, 1.0, 0.0,
                                                          0.0]]))
    want = 0.0
    for j in (0, 2):
        for k in (1, 3):
            want += max(0.0, 1.0 - (float(x[0, j]) - float(x[0, k])))
    assert abs(float(got) - want / 4) < 1e-6
