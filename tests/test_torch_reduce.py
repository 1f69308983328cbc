"""``nn/reduce.py`` and ``CAdd``/``Mul``/``CMul`` in the port against the
JAX package's, on the CPU.

Each module gets the same seeded numpy input (and, for the learnable
ones, the reference's parameters through ``flatten_tree`` ->
``import_tree_state``) in both packages; the output and the gradient of
``sum(out * cot)`` for a seeded cotangent, with respect to every input and
parameter, agree within 1e-6 relative (elementwise, over max|ref|) in
f32. The dimension cases cover a 1-based dimension, a negative one, and
``n_input_dims`` with and without the batch shift.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop.state_dict import flatten_tree, import_tree_state

RTOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    assert np.abs(got - ref).max() <= RTOL * scale, np.abs(got - ref).max()


def _hold(jm, tm, xs, pair=False, seed=1):
    """Forward and gradients of both modules on inputs ``xs``; ``pair``
    passes them as the reference's Table / the port's tuple."""
    params = flatten_tree(jm.parameter_tree())
    if params:
        import_tree_state(tm, params, {})

    def ref_fn(p, *a):
        inp = JT(*a) if pair else a[0]
        out, _ = functional_apply(jm, p, jm.buffer_tree(), inp,
                                  training=True)
        return out

    ref_out = np.asarray(ref_fn(jm.parameter_tree(), *map(jnp.asarray, xs)))
    cot = np.random.default_rng(seed).standard_normal(
        ref_out.shape).astype(np.float32)
    grads = jax.grad(lambda p, *a: jnp.sum(ref_fn(p, *a) * cot),
                     argnums=tuple(range(len(xs) + 1)))(
        jm.parameter_tree(), *map(jnp.asarray, xs))
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = tm(tuple(ts) if pair else ts[0])
    (out * torch.from_numpy(cot)).sum().backward()
    _close(out.detach().numpy(), ref_out)
    for t, g in zip(ts, grads[1:]):
        _close(t.grad.numpy(), g)
    ref_p = flatten_tree(grads[0])
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), ref_p[name])


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# (reference module, port module, input shape)
REDUCE_CASES = {
    "sum_dim2": (lambda: jnn.Sum(2), lambda: nn.Sum(2), (3, 4, 5)),
    "sum_negative": (lambda: jnn.Sum(-1), lambda: nn.Sum(-1), (3, 4, 5)),
    "sum_batched_shift": (lambda: jnn.Sum(1, n_input_dims=2),
                          lambda: nn.Sum(1, n_input_dims=2), (3, 4, 5)),
    "sum_unbatched": (lambda: jnn.Sum(1, n_input_dims=2),
                      lambda: nn.Sum(1, n_input_dims=2), (4, 5)),
    "sum_size_average": (lambda: jnn.Sum(3, size_average=True),
                         lambda: nn.Sum(3, size_average=True), (3, 4, 5)),
    "mean_vit_tokens": (lambda: jnn.Mean(dimension=2),
                        lambda: nn.Mean(dimension=2), (2, 16, 8)),
    "mean_negative": (lambda: jnn.Mean(-2), lambda: nn.Mean(-2), (2, 6, 3)),
    "mean_batched_shift": (lambda: jnn.Mean(2, n_input_dims=2),
                           lambda: nn.Mean(2, n_input_dims=2), (2, 6, 3)),
    "max_dim1": (lambda: jnn.Max(1), lambda: nn.Max(1), (5, 7)),
    "max_negative": (lambda: jnn.Max(-1), lambda: nn.Max(-1), (3, 4, 5)),
    "max_batched_shift": (lambda: jnn.Max(1, num_input_dims=1),
                          lambda: nn.Max(1, num_input_dims=1), (5, 7)),
    "min_dim2": (lambda: jnn.Min(2), lambda: nn.Min(2), (3, 4, 5)),
    "min_batched_shift": (lambda: jnn.Min(2, num_input_dims=2),
                          lambda: nn.Min(2, num_input_dims=2), (3, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(REDUCE_CASES))
def test_reductions_match_reference(case):
    jm, tm, shape = REDUCE_CASES[case]
    _hold(jm(), tm(), [_x(*shape)])


def test_ties_share_the_gradient_as_the_reference():
    x = np.array([[1.0, 3.0, 3.0, 0.5], [2.0, 2.0, 2.0, 2.0]], np.float32)
    _hold(jnn.Max(2), nn.Max(2), [x])
    _hold(jnn.Min(2), nn.Min(2), [x])


def test_dimension_out_of_range_raises():
    with pytest.raises(IndexError):
        nn.Sum(4)(torch.zeros(2, 3))
    with pytest.raises(IndexError):
        nn.Mean(-3)(torch.zeros(2, 3))


@pytest.mark.parametrize("rows", [True, False])
def test_cosine_distance_matches_reference(rows):
    shape = (4, 6) if rows else (6,)
    _hold(jnn.CosineDistance(), nn.CosineDistance(),
          [_x(*shape, seed=2), _x(*shape, seed=3)], pair=True)


@pytest.mark.parametrize("norm", [1, 2, 3])
def test_pairwise_distance_matches_reference(norm):
    x1 = _x(4, 6, seed=4)
    x2 = _x(4, 6, seed=5)
    x2[0] = x1[0]   # a pair at distance 0: eps keeps its gradient finite
    _hold(jnn.PairwiseDistance(norm), nn.PairwiseDistance(norm), [x1, x2],
          pair=True)


def test_distance_takes_a_table():
    from bigdl_tpu_torch.utils.table import T
    x1, x2 = torch.from_numpy(_x(3, 4)), torch.from_numpy(_x(3, 4, seed=1))
    torch.testing.assert_close(nn.CosineDistance()(T(x1, x2)),
                               nn.CosineDistance()((x1, x2)))


# (reference module, port module, input shape)
GAIN_CASES = {
    "cadd_vit_positions": (lambda: jnn.CAdd((16, 8)),
                           lambda: nn.CAdd((16, 8)), (2, 16, 8)),
    "cadd_broadcast_channel": (lambda: jnn.CAdd((1, 5)),
                               lambda: nn.CAdd((1, 5)), (3, 4, 5)),
    "mul": (lambda: jnn.Mul(), lambda: nn.Mul(), (3, 4)),
    "cmul_full": (lambda: jnn.CMul((4, 5)), lambda: nn.CMul((4, 5)),
                  (3, 4, 5)),
    "cmul_broadcast": (lambda: jnn.CMul((1, 5)), lambda: nn.CMul((1, 5)),
                       (3, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(GAIN_CASES))
def test_learnable_gains_match_reference(case):
    build_ref, build_port, shape = GAIN_CASES[case]
    jm, tm = build_ref(), build_port()
    if case.startswith("cadd"):
        # CAdd starts at zeros in both: give the bias values to carry
        jm.load_parameter_tree({"bias": jnp.asarray(
            _x(*jm.size, seed=7))})
    assert sorted(n for n, _ in tm.named_parameters()) == sorted(
        flatten_tree(jm.parameter_tree()))
    _hold(jm, tm, [_x(*shape)])


def test_gain_initialisers_follow_the_reference():
    assert torch.count_nonzero(nn.CAdd((3, 4)).bias) == 0
    w = nn.CMul((4, 5), generator=torch.Generator().manual_seed(0)).weight
    bound = 1.0 / np.sqrt(20)
    assert w.shape == (4, 5) and float(w.abs().max()) <= bound
    assert float(nn.Mul().weight.abs().max()) <= 1.0
