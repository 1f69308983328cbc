"""The ResNet slice's layers against the JAX package's, on the CPU.

Initialization distributions; ``ConcatTable``, ``CAddTable``, ``Identity``;
``ReLU``, ``LogSoftMax``; ``Reshape``, ``Padding``; ``SpatialMaxPooling``,
``SpatialAveragePooling``; ``SpatialConvolution``, ``SpaceToDepthConv7``,
``stem_conv7``; ``batch_norm_train``; ``BatchNormalization`` and
``SpatialBatchNormalization`` in train and eval modes with their running
statistics, also under ``torch.func.functional_call`` with the parameters
only, as ``Optimizer`` calls a model. Each layer is built in both packages,
the reference's weights are carried into the port (``import_tree_state``),
and the same numpy inputs go through both.

Tolerances: f32 outputs and running statistics within 1e-5 of max|ref|
(sums in another order); gradients within 1e-4 of max|ref|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.nn.conv import SpaceToDepthConv7 as JaxSpaceToDepthConv7
from bigdl_tpu.ops.batch_norm import batch_norm_train as jax_batch_norm_train
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop.state_dict import flatten_tree, import_tree_state
from bigdl_tpu_torch.nn import initialization as init
from bigdl_tpu_torch.ops.batch_norm import batch_norm_train

torch.set_num_threads(1)

RTOL = 1e-5
GRAD_RTOL = 1e-4


def _rand(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close(got, ref, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= rtol * max(np.abs(ref).max(), 1e-30), (what, err)


def _carry(jmod, tmod):
    """The reference module's weights and buffers into the port's."""
    import_tree_state(tmod, flatten_tree(jmod.parameter_tree()),
                      flatten_tree(jmod.buffer_tree()))
    return tmod


def _both(jmod, tmod, x):
    return (np.asarray(jmod.forward(jnp.asarray(x))),
            tmod(torch.from_numpy(x)))


# ------------------------------------------------------------ initialization
def test_kaiming_mean_and_std():
    g = torch.Generator().manual_seed(0)
    w = init.kaiming((3, 3, 64, 256), 9 * 64, g)
    assert w.dtype == torch.float32 and w.shape == (3, 3, 64, 256)
    assert abs(w.mean().item()) < 5e-3
    assert abs(w.std().item() / np.sqrt(2.0 / (9 * 64)) - 1) < 0.01


def test_uniform_inits_bounds_and_means():
    g = torch.Generator().manual_seed(1)
    d = init.default_init((200, 300), 300, g)
    bound = 1 / np.sqrt(300)
    assert d.abs().max().item() <= bound and abs(d.mean().item()) < 2e-3
    assert abs(d.std().item() / (bound / np.sqrt(3)) - 1) < 0.01
    x = init.xavier((200, 300), 300, 200, g)
    bound = np.sqrt(6.0 / 500)
    assert x.abs().max().item() <= bound and abs(x.mean().item()) < 5e-3
    assert torch.equal(init.zeros((2, 3)), torch.zeros(2, 3))
    assert torch.equal(init.ones((4,)), torch.ones(4))


def test_conv_weight_dispatch_and_generator_determinism():
    state = torch.random.get_rng_state()
    a = init.conv_weight("kaiming", (8, 8), 8, 8,
                         torch.Generator().manual_seed(3))
    b = init.conv_weight("kaiming", (8, 8), 8, 8,
                         torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert torch.equal(torch.random.get_rng_state(), state)
    g = torch.Generator().manual_seed(4)
    assert init.conv_weight("xavier", (50, 50), 50, 50, g).abs().max() <= \
        np.sqrt(6.0 / 100)
    assert init.conv_weight("default", (50, 50), 50, 50, g).abs().max() <= \
        1 / np.sqrt(50)


# ---------------------------------------------- containers and activations
def test_concat_add_identity_and_names_match_reference():
    jm = (jnn.Sequential()
          .add(jnn.ConcatTable().add(jnn.Linear(6, 4)).add(jnn.Linear(6, 4)))
          .add(jnn.CAddTable()).add(jnn.ReLU()).add(jnn.Identity()))
    tm = (nn.Sequential()
          .add(nn.ConcatTable().add(nn.Linear(6, 4)).add(nn.Linear(6, 4)))
          .add(nn.CAddTable()).add(nn.ReLU()).add(nn.Identity()))
    assert sorted(flatten_tree(jm.parameter_tree())) == \
        sorted(n for n, _ in tm.named_parameters())
    _carry(jm, tm)
    ref, got = _both(jm, tm, _rand(5, 6))
    _close(got, ref)
    assert len(tm) == 4 and isinstance(tm[0], nn.ConcatTable)
    branches = nn.ConcatTable().add(nn.Identity()).add(nn.ReLU())
    out = branches(torch.tensor([-1.0, 2.0]))
    assert isinstance(out, list) and len(out) == 2


def test_relu_gradient_is_zero_at_zero_and_logsoftmax_matches():
    x = torch.tensor([-1.0, 0.0, 2.0], requires_grad=True)
    nn.ReLU()(x).sum().backward()
    ref = np.asarray(jax.grad(lambda v: jax.nn.relu(v).sum())(
        jnp.asarray([-1.0, 0.0, 2.0])))
    np.testing.assert_array_equal(x.grad.numpy(), ref)
    assert x.grad[1].item() == 0.0
    x = _rand(4, 7)
    _close(nn.LogSoftMax()(torch.from_numpy(x)),
           np.asarray(jnn.LogSoftMax().forward(jnp.asarray(x))))


# ------------------------------------------------------------------- shapes
@pytest.mark.parametrize("size,batch_mode,shape", [
    ((12,), True, (5, 2, 2, 3)), ((2, 6), None, (5, 2, 2, 3)),
    ((60,), None, (5, 12)), ((3, 20), False, (5, 12))])
def test_reshape_matches_reference(size, batch_mode, shape):
    x = _rand(*shape)
    ref, got = _both(jnn.Reshape(size, batch_mode=batch_mode),
                     nn.Reshape(size, batch_mode=batch_mode), x)
    _close(got, ref)


@pytest.mark.parametrize("dim,pad,n_input_dim,shape,value", [
    (3, 4, 3, (2, 3, 3, 5), 0.0), (3, -2, 3, (3, 3, 5), 0.0),
    (1, 2, 3, (2, 3, 3, 5), 1.5), (2, -1, 2, (4, 6), 0.0)])
def test_padding_matches_reference(dim, pad, n_input_dim, shape, value):
    x = _rand(*shape)
    ref, got = _both(jnn.Padding(dim, pad, n_input_dim, value=value),
                     nn.Padding(dim, pad, n_input_dim, value=value), x)
    _close(got, ref)


# ------------------------------------------------------------------ pooling
@pytest.mark.parametrize("args,ceil,shape", [
    ((3, 3, 2, 2, 1, 1), False, (2, 8, 8, 3)),     # ResNet's stem pool
    ((3, 3, 2, 2, 1, 1), False, (2, 7, 9, 3)),
    ((3, 3, 2, 2, 0, 0), True, (2, 8, 7, 3)),      # the -inf padded path
    ((2, 2, 2, 2, 0, 0), False, (1, 5, 5, 4)),
    ((3, 2, 1, 2, 1, 0), True, (3, 6, 4, 2))])
def test_max_pooling_matches_reference(args, ceil, shape):
    jm, tm = jnn.SpatialMaxPooling(*args), nn.SpatialMaxPooling(*args)
    if ceil:
        jm.ceil()
        tm.ceil()
    x = _rand(*shape)
    ref, got = _both(jm, tm, x)
    _close(got, ref)
    cot = _rand(*ref.shape, seed=3)
    jgrad = jax.vjp(lambda v: jm.forward(v), jnp.asarray(x))[1](
        jnp.asarray(cot))[0]
    xt = torch.from_numpy(x).requires_grad_()
    tm(xt).backward(torch.from_numpy(cot))
    _close(xt.grad, np.asarray(jgrad), GRAD_RTOL)


@pytest.mark.parametrize("args,kw,shape", [
    ((7, 7, 1, 1), {}, (2, 7, 7, 6)),              # ResNet's head pool
    ((1, 1, 2, 2), {}, (2, 8, 8, 3)),              # shortcut A's subsample
    ((3, 3, 2, 2, 1, 1), {"count_include_pad": False}, (2, 7, 8, 3)),
    ((3, 3, 2, 2, 1, 1), {"ceil_mode": True}, (1, 6, 6, 2)),
    ((2, 2, 2, 2), {"divide": False}, (2, 5, 5, 2))])
def test_average_pooling_matches_reference(args, kw, shape):
    x = _rand(*shape)
    ref, got = _both(jnn.SpatialAveragePooling(*args, **kw),
                     nn.SpatialAveragePooling(*args, **kw), x)
    _close(got, ref)


def test_pooling_takes_unbatched_input():
    x = _rand(6, 6, 2)
    ref, got = _both(jnn.SpatialMaxPooling(3, 3, 2, 2, 1, 1),
                     nn.SpatialMaxPooling(3, 3, 2, 2, 1, 1), x)
    _close(got, ref)


# -------------------------------------------------------------------- convs
@pytest.mark.parametrize("args,kw,shape", [
    ((3, 8, 3, 3, 1, 1, 1, 1), {}, (2, 6, 6, 3)),
    ((4, 6, 1, 1, 2, 2), {"with_bias": False}, (2, 7, 5, 4)),
    ((4, 8, 3, 5, 2, 1, 1, 2), {"n_group": 2}, (1, 9, 8, 4)),
    ((3, 4, 7, 7, 2, 2, 3, 3), {"init_method": "kaiming"}, (2, 11, 10, 3))])
def test_spatial_convolution_matches_reference(args, kw, shape):
    jm = jnn.SpatialConvolution(*args, **kw)
    tm = _carry(jm, nn.SpatialConvolution(*args, **kw))
    x = _rand(*shape)
    ref, got = _both(jm, tm, x)
    _close(got, ref)
    ref, got = _both(jm, tm, x[0])            # unbatched (H, W, C)
    _close(got, ref)


@pytest.mark.parametrize("shape", [(2, 16, 16, 3), (1, 15, 13, 3)])
def test_space_to_depth_stem_matches_reference_and_plain_conv(shape):
    jm = JaxSpaceToDepthConv7(3, 8, with_bias=True)
    tm = _carry(jm, nn.SpaceToDepthConv7(3, 8, with_bias=True))
    x = _rand(*shape)
    ref, got = _both(jm, tm, x)
    _close(got, ref)
    plain = nn.SpatialConvolution(3, 8, 7, 7, 2, 2, 3, 3)
    with torch.no_grad():
        plain.weight.copy_(tm.weight)
        plain.bias.copy_(tm.bias)
    _close(got, plain(torch.from_numpy(x)).detach().numpy())


def test_stem_conv7_gate(monkeypatch):
    monkeypatch.delenv("BIGDL_TPU_NO_S2D", raising=False)
    assert isinstance(nn.stem_conv7(3, 4), nn.SpaceToDepthConv7)
    monkeypatch.setenv("BIGDL_TPU_NO_S2D", "1")
    stem = nn.stem_conv7(3, 4, with_bias=False)
    assert isinstance(stem, nn.SpatialConvolution)
    assert stem.weight.shape == (7, 7, 3, 4) and not stem.with_bias


# ------------------------------------------------------------- batch norm
def test_batch_norm_train_matches_reference_vjp():
    x = _rand(3, 5, 4, 6) * 2 + 1
    g, b = _rand(6, seed=1) * 0.1 + 1, _rand(6, seed=2) * 0.1
    cot = _rand(3, 5, 4, 6, seed=3)
    (out, mean, var), vjp = jax.vjp(
        lambda *a: jax_batch_norm_train(*a, 1e-5), *map(jnp.asarray, (x, g, b)))
    ref = [out, mean, var, *vjp((jnp.asarray(cot), jnp.zeros_like(mean),
                                 jnp.zeros_like(var)))]
    ts = [torch.from_numpy(a).requires_grad_() for a in (x, g, b)]
    t_out, t_mean, t_var = batch_norm_train(*ts, 1e-5)
    assert not t_mean.requires_grad and not t_var.requires_grad
    t_out.backward(torch.from_numpy(cot))
    got = [t_out, t_mean, t_var] + [t.grad for t in ts]
    for name, r, o in zip(["out", "mean", "var", "dx", "dg", "db"], ref, got):
        _close(o, np.asarray(r), RTOL if len(name) > 2 or name == "out"
               else GRAD_RTOL, name)


def test_batch_norm_train_keeps_bf16_output_and_f32_stats():
    x = torch.from_numpy(_rand(4, 3, 3, 5)).to(torch.bfloat16)
    g = torch.ones(5, dtype=torch.bfloat16)
    out, mean, var = batch_norm_train(x, g, torch.zeros_like(g), 1e-5)
    assert out.dtype == torch.bfloat16
    assert mean.dtype == var.dtype == torch.float32


def test_batch_norm_train_in_f64_matches_autograd_of_the_formula():
    # f64 input stays f64 (the reference the card's f32 gradients are
    # measured against): forward and backward within 1e-12 of autograd
    # through the same formula in f64
    x = torch.from_numpy(_rand(3, 5, 4, 6)).double() * 2 + 1
    g = torch.from_numpy(_rand(6, seed=1)).double() * 0.1 + 1
    b = torch.from_numpy(_rand(6, seed=2)).double() * 0.1
    cot = torch.from_numpy(_rand(3, 5, 4, 6, seed=3)).double()
    grads = []
    for fn in ("op", "formula"):
        ts = [t.clone().requires_grad_() for t in (x, g, b)]
        if fn == "op":
            out, mean, var = batch_norm_train(*ts, 1e-5)
        else:
            mean = ts[0].mean((0, 1, 2))
            var = (ts[0] * ts[0]).mean((0, 1, 2)) - mean * mean
            out = (ts[0] - mean) * torch.rsqrt(var + 1e-5) * ts[1] + ts[2]
        assert out.dtype == mean.dtype == var.dtype == torch.float64
        out.backward(cot)
        grads.append([out.detach(), mean.detach(), var.detach()]
                     + [t.grad for t in ts])
    for got, ref in zip(*grads):
        torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("cls,shape,affine", [
    ("SpatialBatchNormalization", (3, 4, 5, 6), True),
    ("BatchNormalization", (7, 6), True),
    ("BatchNormalization", (7, 6), False)])
def test_batch_normalization_train_and_eval_match_reference(cls, shape,
                                                            affine):
    jm = getattr(jnn, cls)(6, affine=affine)
    tm = getattr(nn, cls)(6, affine=affine)
    if affine:
        jm.load_parameter_tree({"weight": jnp.asarray(_rand(6, seed=1) + 2),
                                "bias": jnp.asarray(_rand(6, seed=2))})
    _carry(jm, tm)
    x = _rand(*shape) * 3 + 1
    for step in range(2):   # two updates of the running statistics
        ref, got = _both(jm, tm, x + step)
        _close(got, ref, what="train")
        bufs = flatten_tree(jm.buffer_tree())
        for name, buf in tm.named_buffers():
            _close(buf, bufs[name], what=name)
    jm.evaluate_mode()
    tm.evaluate_mode()
    ref, got = _both(jm, tm, x)
    _close(got, ref, what="eval")


def test_running_stats_update_through_functional_call():
    model = (nn.Sequential()
             .add(nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1))
             .add(nn.SpatialBatchNormalization(4)))
    twin = (nn.Sequential()
            .add(nn.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1))
            .add(nn.SpatialBatchNormalization(4)))
    twin.load_state_dict(model.state_dict())
    x = torch.from_numpy(_rand(2, 5, 5, 3))
    params = {n: p for n, p in model.named_parameters()}
    out = torch.func.functional_call(model, params, (x,))
    out.sum().backward()
    twin(x)
    rm = model[1].running_mean
    assert rm.abs().sum() > 0 and rm.grad_fn is None and not rm.requires_grad
    for (name, a), (_, b) in zip(model.named_buffers(), twin.named_buffers()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
