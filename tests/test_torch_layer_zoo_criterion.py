"""Every criterion of ``bigdl_tpu/nn/criterion.py`` in the port against the
JAX package's, on the CPU: the loss and its gradient for each input
(``jax.grad`` against autograd), within 1e-6 of max|ref|.

The cases are those of ``tests/test_criterion_sweep.py`` (the reference's
sweep of the family) at smooth points, in both ``size_average`` modes
where the criterion has one, with the reference's target conventions
(1-based class targets, {1, -1} targets, tables of inputs or targets as a
reference ``Table`` against a port list). The table criteria
(``MarginRankingCriterion``, ``CosineEmbeddingCriterion``,
``L1HingeEmbeddingCriterion``, ``ParallelCriterion``, ...),
``MultiLabelMarginCriterion`` and ``SoftmaxWithCriterion``'s modes are in
``test_torch_layer_zoo_criterion_tables.py``.
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

TOL = 1e-6
R = np.random.RandomState(0)
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


W = np.linspace(0.5, 1.5, C).astype(np.float32)

# (id, class name, constructor args, input, target)
CASES = [
    ("class_nll", "ClassNLLCriterion", (), _logp(), _labels()),
    ("class_nll_w", "ClassNLLCriterion", (W, False), _logp(), _labels()),
    ("cross_entropy", "CrossEntropyCriterion", (), _scores(), _labels()),
    ("mse", "MSECriterion", (), _scores(), _scores()),
    ("mse_sum", "MSECriterion", (False,), _scores(), _scores()),
    ("abs", "AbsCriterion", (), _scores(), _scores()),
    ("abs_sum", "AbsCriterion", (False,), _scores(), _scores()),
    ("bce", "BCECriterion", (), _probs(), _bits()),
    ("bce_w", "BCECriterion", (W, False), _probs(), _bits()),
    ("smooth_l1", "SmoothL1Criterion", (), _scores() * 2, _scores()),
    ("smooth_l1_sum", "SmoothL1Criterion", (False,), _scores() * 2,
     _scores()),
    ("smooth_l1_weighted", "SmoothL1CriterionWithWeights", (2.0, 3),
     _scores(), [_scores(), _probs(), _probs()]),
    ("smooth_l1_weighted_plain", "SmoothL1CriterionWithWeights", (),
     _scores() * 2, _scores()),
    ("margin", "MarginCriterion", (0.5,), _scores(), _pm_ones()),
    ("margin_sum", "MarginCriterion", (1.0, False), _scores(), _pm_ones()),
    ("hinge_embed", "HingeEmbeddingCriterion", (1.5,), _scores() + 0.1,
     _pm_ones()),
    ("hinge_embed_sum", "HingeEmbeddingCriterion", (1.0, False), _scores(),
     _pm_ones()),
    ("kldiv", "DistKLDivCriterion", (), _logp(),
     R.dirichlet(np.ones(C), N).astype(np.float32)),
    ("kldiv_zeros", "DistKLDivCriterion", (False,), _logp(),
     _bits() * 0.5),
    ("soft_margin", "SoftMarginCriterion", (), _scores(), _pm_ones()),
    ("multilabel_soft", "MultiLabelSoftMarginCriterion", (), _scores(),
     _bits()),
    ("multilabel_soft_w", "MultiLabelSoftMarginCriterion", (W, False),
     _scores(), _bits()),
    ("multi_margin", "MultiMarginCriterion", (), _scores(), _labels()),
    ("multi_margin_p2", "MultiMarginCriterion", (2, W, 0.5, False),
     _scores(), _labels()),
    ("class_simplex", "ClassSimplexCriterion", (C,), _scores(), _labels()),
    ("dice", "DiceCoefficientCriterion", (), _probs(), _bits()),
    ("dice_sum", "DiceCoefficientCriterion", (False, 0.5), _probs(),
     _bits()),
    ("l1cost", "L1Cost", (), _scores(), None),
    ("softmax_with", "SoftmaxWithCriterion", (), _scores(), _labels()),
]


@pytest.mark.parametrize("name,cls,args,x,t", CASES, ids=[c[0] for c in CASES])
def test_criterion_matches_reference(name, cls, args, x, t):
    _crit(getattr(jnn, cls)(*args), getattr(nn, cls)(*args), x, t)


def test_every_reference_criterion_is_covered():
    import bigdl_tpu.nn.criterion as ref
    names = {n for n, v in vars(ref).items()
             if isinstance(v, type) and v.__module__ == ref.__name__}
    # the table and multi-label criteria: test_torch_layer_zoo_criterion_tables
    covered = {c[1] for c in CASES} | {
        "MultiLabelMarginCriterion", "MarginRankingCriterion",
        "CosineEmbeddingCriterion", "L1HingeEmbeddingCriterion",
        "Criterion", "SoftmaxWithCriterion", "ParallelCriterion",
        "MultiCriterion", "CriterionTable", "TimeDistributedCriterion",
        "FusedLMHeadCriterion"}
    assert names <= covered, names - covered
