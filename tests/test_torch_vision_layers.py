"""The conv zoo's layers in the port against the JAX package's, on the CPU:
``Tanh``, ``Concat`` (4-D, 3-D and 2-D outputs, every dimension),
``SpatialCrossMapLRN`` (f32 and bf16, windows of 3 and 5 over few and many
channels), ``Transpose``, average and max pooling with ``ceil`` and
padding, and ``Graph`` (child names and order, several inputs and outputs,
its two construction errors).

The same numpy inputs (from a seed) go through both packages; forward
outputs and input gradients (one random cotangent, ``jax.vjp`` against
autograd) agree within 1e-6 of max|ref| in f32. In bf16 the LRN is held to
two bf16 steps of each element (2^-6 |ref|): both compute in bf16 and add
the window in the same order, but XLA's CPU ``pow`` and PyTorch's round
differently (a seeded run differs in 13 of 960 elements, by one or two
steps, with the f32 result between the two).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                flatten_tree,
                                                import_tree_state)

TOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _close(got, ref, tol=TOL):
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


def _both(jm, tm, x, seed=1):
    """Forward and input gradient of the reference module ``jm`` and the
    port module ``tm`` on ``x``, with one random cotangent."""
    ref, vjp = jax.vjp(lambda a: jm.forward(a), jnp.asarray(x))
    g = _x(np.shape(ref), seed)
    (ref_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    out.backward(torch.from_numpy(g))
    _close(out.detach().numpy(), ref)
    _close(xt.grad.numpy(), ref_dx)


def test_tanh():
    _both(jnn.Tanh(), nn.Tanh(), _x((4, 5, 6)))


@pytest.mark.parametrize("shape,dim", [((2, 5, 6, 3), 1), ((2, 5, 6, 3), 2),
                                       ((2, 5, 6, 3), 3), ((5, 6, 3), 1),
                                       ((5, 6, 3), 2), ((5, 6, 3), 3),
                                       ((4, 7), 1)])
def test_concat_dimension_map(shape, dim):
    """The reference's 1-based NCHW dimension on channels-last outputs."""
    def build(pkg):
        return (pkg.Concat(dim).add(pkg.Tanh()).add(pkg.ReLU())
                .add(pkg.Tanh()))
    _both(build(jnn), build(nn), _x(shape))
    out = build(nn)(torch.from_numpy(_x(shape)))
    axis = {4: {1: 3, 2: 1, 3: 2}, 3: {1: 2, 2: 0, 3: 1}}.get(len(shape),
                                                              {1: 1})[dim]
    assert out.shape[axis] == 3 * shape[axis]


def test_concat_of_convs_carries_weights():
    """Branch parameters are named as the reference's tree names them."""
    jm = (jnn.Concat(1)
          .add(jnn.SpatialConvolution(3, 4, 1, 1))
          .add(jnn.Sequential().add(jnn.SpatialConvolution(3, 2, 3, 3, 1, 1,
                                                           1, 1))
               .add(jnn.ReLU())))
    tm = (nn.Concat(1)
          .add(nn.SpatialConvolution(3, 4, 1, 1))
          .add(nn.Sequential().add(nn.SpatialConvolution(3, 2, 3, 3, 1, 1,
                                                         1, 1))
               .add(nn.ReLU())))
    params = flatten_tree(jm.parameter_tree())
    assert sorted(params) == sorted(export_tree_state(tm)[0])
    import_tree_state(tm, params, {})
    _both(jm, tm, _x((2, 6, 5, 3)))


@pytest.mark.parametrize("size", [3, 5])
@pytest.mark.parametrize("channels", [4, 16])
def test_lrn_f32(size, channels):
    """Windows at the channel edges (4 channels under a window of 5 reach
    both pads) and inside."""
    args = (size, 1e-2, 0.75, 2.0)
    _both(jnn.SpatialCrossMapLRN(*args), nn.SpatialCrossMapLRN(*args),
          _x((2, 3, 4, channels)) * 3)


@pytest.mark.parametrize("size", [3, 5])
def test_lrn_bf16(size):
    x = _x((2, 5, 4, 12)) * 3
    ref = np.asarray(jnn.SpatialCrossMapLRN(size, 1e-2, 0.75).forward(
        jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    got = nn.SpatialCrossMapLRN(size, 1e-2, 0.75)(
        torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    two_steps = 2.0 ** -6 * np.abs(ref)
    assert np.all(np.abs(got - ref) <= two_steps), np.abs(got - ref).max()


@pytest.mark.parametrize("perms,shape", [([(2, 4), (3, 4)], (2, 3, 4, 5)),
                                         ([(1, 2)], (3, 4, 5)),
                                         ([(1, 3), (2, 3)], (2, 3, 4))])
def test_transpose(perms, shape):
    _both(jnn.Transpose(perms), nn.Transpose(perms), _x(shape))


@pytest.mark.parametrize("hw", [(7, 7), (5, 8)])
@pytest.mark.parametrize("args,include", [((3, 3, 1, 1, 1, 1), True),
                                          ((3, 3, 2, 2, 1, 1), True),
                                          ((3, 3, 2, 2, 1, 1), False),
                                          ((2, 2, 2, 2, 0, 0), True)])
def test_average_pooling_ceil_and_pad(hw, args, include):
    """Inception v2's ``SpatialAveragePooling(3, 3, 1, 1, 1, 1).ceil()``
    divides by k*k; also strided, odd and without the pad in the count."""
    jm = jnn.SpatialAveragePooling(*args, count_include_pad=include).ceil()
    tm = nn.SpatialAveragePooling(*args, count_include_pad=include).ceil()
    _both(jm, tm, _x((2, *hw, 3)))


@pytest.mark.parametrize("hw", [(7, 7), (5, 8), (112, 112)])
@pytest.mark.parametrize("args", [(3, 3, 1, 1, 1, 1), (3, 3, 2, 2),
                                  (2, 2, 2, 2)])
def test_max_pooling_ceil(hw, args):
    _both(jnn.SpatialMaxPooling(*args).ceil(),
          nn.SpatialMaxPooling(*args).ceil(), _x((1, *hw, 2)))


def _diamond(pkg):
    """Two inputs, a fan-out and a join, two outputs."""
    a = pkg.Input().inputs()
    b = pkg.Input().inputs()
    h = pkg.Linear(4, 3).inputs(a)
    t = pkg.Tanh().inputs(h)
    r = pkg.ReLU().inputs(h)
    s = pkg.CAddTable().inputs(t, r, b)
    out2 = pkg.Linear(3, 2).inputs(t)
    return pkg.Graph([a, b], [s, out2])


def test_graph_names_order_and_multiple_inputs_and_outputs():
    jm, tm = _diamond(jnn), _diamond(nn)
    assert list(tm._modules) == list(jm._modules)
    assert list(tm._modules)[0].startswith("n0_")
    params = flatten_tree(jm.parameter_tree())
    assert sorted(params) == sorted(export_tree_state(tm)[0])
    import_tree_state(tm, params, {})
    xa, xb = _x((5, 4), 2), _x((5, 3), 3)
    ga, gb = _x((5, 3), 4), _x((5, 2), 5)

    def ref_fn(a, b):
        return tuple(jm.forward((a, b)))

    ref, vjp = jax.vjp(ref_fn, jnp.asarray(xa), jnp.asarray(xb))
    ref_da, ref_db = vjp((jnp.asarray(ga), jnp.asarray(gb)))
    ta = torch.from_numpy(xa).requires_grad_()
    tb = torch.from_numpy(xb).requires_grad_()
    out = tm((ta, tb))
    assert isinstance(out, tuple) and len(out) == 2
    torch.autograd.backward(out, (torch.from_numpy(ga), torch.from_numpy(gb)))
    for got, want in zip(out, ref):
        _close(got.detach().numpy(), want)
    _close(ta.grad.numpy(), ref_da)
    _close(tb.grad.numpy(), ref_db)


def test_graph_default_and_set_names():
    def build(pkg):
        inp = pkg.Input().inputs()
        x = pkg.Linear(3, 3).set_name("fc").inputs(inp)
        x = pkg.Tanh().inputs(x)
        return pkg.Graph(inp, pkg.Linear(3, 2).inputs(x))
    assert list(build(nn)._modules) == list(build(jnn)._modules) == [
        "n0_Input", "n1_fc", "n2_Tanh", "n3_Linear"]
    assert nn.Tanh().name == "Tanh"
    assert nn.Tanh().set_name("t").get_name() == "t"


def test_graph_refuses_a_cycle_and_an_unconnected_input():
    a = nn.Input().inputs()
    x = nn.Tanh().inputs(a)
    y = nn.ReLU().inputs(x)
    x.prev.append(y)   # x <- y <- x
    with pytest.raises(ValueError, match="cycle"):
        nn.Graph(a, y)
    a, b = nn.Input().inputs(), nn.Input().inputs()
    out = nn.Tanh().inputs(a)
    with pytest.raises(ValueError, match="not connected"):
        nn.Graph([a, b], out)
    with pytest.raises(ValueError, match="no predecessors"):
        nn.Input().inputs(a)
