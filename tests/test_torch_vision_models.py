"""The classic conv zoo in the port against the JAX package's, on the CPU.

Every builder (LeNet's ``build`` and ``graph``, VGG-CIFAR, VGG-16 and
VGG-19, Inception v1 and v2, AlexNet), with the fusion gates off and on
where they apply, has the reference's parameter and buffer names and
shapes, so ``flatten_tree`` -> ``import_tree_state`` carries the
reference's weights across (the names are checked before any number).

Then the same weights and seeded numpy inputs go through both packages in
training mode: the loss (``ClassNLLCriterion``, or a random cotangent for
the blocks), every parameter gradient, every updated running statistic and
the input gradient agree within 1e-4 relative L2 per tensor (f32 sums in
other orders through batch norms; a gradient that is zero in exact
arithmetic, a conv bias before batch norm, is f32 noise in both packages,
so each tensor's distance is taken over the larger of its norm and 1e-3 of
the largest gradient norm of the model) for LeNet (Sequential and Graph),
an Inception v1 block and Inception v2's plain and reduction blocks at
14x14 with the gates off and on. VGG-CIFAR's numbers are in
``test_torch_vision_vgg.py``; the whole Inception towers and AlexNet are
held in ``test_torch_vision_towers.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import alexnet as jalexnet
from bigdl_tpu.models import inception as jinception
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.nn.criterion import ClassNLLCriterion as JaxNLL
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                flatten_tree,
                                                import_tree_state)
from bigdl_tpu_torch.models import alexnet, inception, lenet, vgg
from bigdl_tpu_torch.nn import (ClassNLLCriterion, FusedConv1x1BN,
                                FusedConv3x3BN)

RTOL = 1e-4
GATES = ("BIGDL_TPU_FUSED_1X1", "BIGDL_TPU_FUSED_3X3")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gates(monkeypatch, on):
    for g in GATES:
        if on:
            monkeypatch.setenv(g, "1")
        else:
            monkeypatch.delenv(g, raising=False)


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _carry(jm, tm):
    """The reference's trees into the port model, names checked first."""
    params = flatten_tree(jm.parameter_tree())
    buffers = flatten_tree(jm.buffer_tree())
    got_p, got_b = export_tree_state(tm)
    assert sorted(got_p) == sorted(params)
    assert sorted(got_b) == sorted(buffers)
    import_tree_state(tm, params, buffers)
    return tm


# -------------------------------------------------------------- structure
BUILDERS = {
    "lenet": (lambda: jlenet.build(10), lambda: lenet.build(10, device="cpu")),
    "lenet_graph": (lambda: jlenet.graph(10),
                    lambda: lenet.graph(10, device="cpu")),
    "vgg_cifar": (lambda: jvgg.build(10), lambda: vgg.build(10, device="cpu")),
    "vgg16": (lambda: jvgg.build_imagenet(1000, 16),
              lambda: vgg.build_imagenet(1000, 16, device="cpu")),
    "vgg19": (lambda: jvgg.build_imagenet(1000, 19),
              lambda: vgg.build_imagenet(1000, 19, device="cpu")),
    "inception_v1": (lambda: jinception.build(1000),
                     lambda: inception.build(1000, device="cpu")),
    "inception_v2": (lambda: jinception.build_v2(1000),
                     lambda: inception.build_v2(1000, device="cpu")),
    "alexnet": (lambda: jalexnet.build(1000),
                lambda: alexnet.build(1000, device="cpu")),
}
#: parameters of each tower (the reference's count, gates off)
N_PARAMS = {"lenet": 22278, "lenet_graph": 22278, "vgg_cifar": 14991946,
            "vgg16": 138365992, "vgg19": 143678248,
            "inception_v1": 6998552, "inception_v2": 11204936,
            "alexnet": 60965224}


def _shapes(tree):
    return {k: v.shape for k, v in flatten_tree(tree).items()}


#: fused modules of the builders that read the gates, with both set
FUSED = {"vgg_cifar": 13, "vgg16": 13, "vgg19": 16, "inception_v2": 64}


#: the ImageNet VGGs' names are checked in test_torch_vision_towers.py
#: (this file's time budget)
BIG = ("vgg16", "vgg19")


@pytest.mark.parametrize(
    "name,gates", [(n, "off") for n in sorted(BUILDERS) if n not in BIG]
    + [(n, "on") for n in sorted(FUSED) if n not in BIG])
def test_tree_names_and_parameter_counts(name, gates, monkeypatch):
    check_names(name, gates, monkeypatch)


def check_names(name, gates, monkeypatch):
    """The builder's names, shapes and counts against the reference's. The
    reference's draws are replaced by zeros here (names and shapes do not
    depend on them), which keeps its 143M-parameter builds cheap."""
    _gates(monkeypatch, gates == "on")
    monkeypatch.setattr(JaxRNG, "uniform",
                        lambda self, lo=0.0, hi=1.0, size=None: np.zeros(size))
    monkeypatch.setattr(JaxRNG, "normal",
                        lambda self, m=0.0, s=1.0, size=None: np.zeros(size))
    build_ref, build_port = BUILDERS[name]
    jm = build_ref()
    tm = build_port()
    want_p, want_b = _shapes(jm.parameter_tree()), _shapes(jm.buffer_tree())
    got_p = {n: tuple(p.shape) for n, p in tm.named_parameters()}
    got_b = {n: tuple(b.shape) for n, b in tm.named_buffers()}
    assert got_p == want_p
    assert got_b == want_b
    n = sum(int(np.prod(s)) for s in got_p.values())
    fused = sum(isinstance(m, (FusedConv1x1BN, FusedConv3x3BN))
                for m in tm.modules())
    if gates == "off":
        assert n == N_PARAMS[name] and fused == 0
    else:
        assert fused == FUSED[name]


def test_inception_v2_fuses_every_stride_1_pair(monkeypatch):
    """Under both gates Inception v2 fuses 37 1x1 and 27 stride-1 3x3
    pairs; its reduction blocks' stride-2 3x3s and the stem stay
    unfused."""
    _gates(monkeypatch, True)
    v2 = inception.build_v2(1000, device="cpu")
    ones = sum(isinstance(m, FusedConv1x1BN) for m in v2.modules())
    threes = sum(isinstance(m, FusedConv3x3BN) for m in v2.modules())
    assert (ones, threes) == (37, 27)


# -------------------------------------------------------------- numerics
def _train_grads_ref(jm, x, y=None, cot=None):
    """(loss or output, {name: grad}, {name: updated buffer}, dx) of one
    training forward and backward in the reference."""
    def fn(params, xin):
        out, bufs = functional_apply(jm, params, jm.buffer_tree(), xin,
                                     training=True)
        if y is not None:
            return JaxNLL().apply(out, jnp.asarray(y)), bufs
        return jnp.sum(out * jnp.asarray(cot)), bufs
    (loss, bufs), (grads, dx) = jax.jit(jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True))(jm.parameter_tree(),
                                           jnp.asarray(x))
    return (float(loss), flatten_tree(grads), flatten_tree(bufs),
            np.asarray(dx))


def _train_grads_port(tm, x, y=None, cot=None):
    tm.train()
    tm.zero_grad(set_to_none=True)
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    if y is not None:
        loss = ClassNLLCriterion()(out, torch.from_numpy(y))
    else:
        loss = (out * torch.from_numpy(cot)).sum()
    loss.backward()
    # a fused conv's pre-BN bias is not on the training path: no gradient
    # in PyTorch, the reference's zeros
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)
                 ).numpy() for n, p in tm.named_parameters()}
    bufs = {n: b.numpy() for n, b in tm.named_buffers()}
    return loss.item(), grads, bufs, xt.grad.numpy()


def _hold(jm, tm, x, y=None, cot=None):
    ref = _train_grads_ref(jm, x, y, cot)
    got = _train_grads_port(tm, x, y, cot)
    assert abs(got[0] - ref[0]) <= RTOL * max(abs(ref[0]), 1e-6)
    assert sorted(got[1]) == sorted(ref[1])
    floor = 1e-3 * max(np.linalg.norm(g) for g in ref[1].values())
    for name in ref[1]:
        got_g, ref_g = np.asarray(got[1][name]), np.asarray(ref[1][name])
        err = np.linalg.norm(got_g - ref_g) / max(np.linalg.norm(ref_g),
                                                   floor)
        assert err <= RTOL, (name, err)
    for name in ref[2]:
        assert _rel_l2(got[2][name], ref[2][name]) <= RTOL, name
    assert _rel_l2(got[3], ref[3]) <= RTOL


def _images(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _labels(n, classes, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(1, classes + 1, (n,)).astype(np.float32)


@pytest.mark.parametrize("kind", ["build", "graph"])
def test_lenet_loss_and_gradients(kind):
    jm = getattr(jlenet, kind)(10)
    tm = _carry(jm, getattr(lenet, kind)(10, device="cpu", seed=3))
    _hold(jm, tm, _images((4, 28, 28, 1)), _labels(4, 10))


def test_lenet_graph_equals_sequential():
    """``graph`` draws its weights as ``build`` does: one seed, one net."""
    x = torch.from_numpy(_images((3, 28, 28, 1)))
    seq, gr = lenet.build(10, device="cpu", seed=5), lenet.graph(10,
                                                                 device="cpu",
                                                                 seed=5)
    assert torch.equal(seq(x), gr(x))


def test_inception_v1_block():
    jm = jinception.inception_module(192, 64, 96, 128, 16, 32, 32, "b")
    tm = _carry(jm, inception.inception_module(192, 64, 96, 128, 16, 32, 32,
                                               "b"))
    x = _images((2, 14, 14, 192))
    _hold(jm, tm, x, cot=_images((2, 14, 14, 256), 2))


@pytest.mark.parametrize("gates", ["off", "on"])
@pytest.mark.parametrize("block", ["plain", "reduction"])
def test_inception_v2_block(block, gates, monkeypatch):
    """4a (avg pool and projection) and 4e (stride 2, max pool, no 1x1)."""
    _gates(monkeypatch, gates == "on")
    args = {"plain": (576, 224, 64, 96, 96, 128, "avg", 128),
            "reduction": (576, 0, 128, 192, 192, 256, "max", 0)}[block]
    jm = jinception.inception_module_v2(*args, name="b")
    tm = _carry(jm, inception.inception_module_v2(*args, name="b"))
    x = _images((2, 14, 14, 576))
    cout = (1024 if block == "reduction" else 576)
    hw = 7 if block == "reduction" else 14
    _hold(jm, tm, x, cot=_images((2, hw, hw, cout), 2))
