"""The recurrent layers (``nn/recurrent.py``) and ``models/rnn.py`` in the
port against the JAX package's, on the CPU.

Each case builds the reference's module, carries its parameters into the
port's (``flatten_tree`` -> ``import_tree_state``, names checked: the gate
layouts and names are the reference's), feeds both the same seeded numpy
input at T=7, B=3, and holds the output and the gradients of
``sum(out * cot)`` (every parameter and the input) within 1e-5 absolute +
1e-5 relative in f32: each cell over one step and inside ``Recurrent``
(forward and reversed), ``BiRecurrent`` (concat and sum),
``RecurrentDecoder``, ``rnn.build`` and ``rnn.build_classifier`` with each
cell, the last end to end through ``ClassNLLCriterion``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.models import rnn as jrnn
from bigdl_tpu.nn.criterion import ClassNLLCriterion as JaxNLL
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                flatten_tree,
                                                import_tree_state)
from bigdl_tpu_torch.models import rnn

TOL = 1e-5
B, T, F, H = 3, 7, 5, 4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=TOL,
                               rtol=TOL, err_msg=what)


def _carry(jm, tm):
    params = flatten_tree(jm.parameter_tree())
    got, _ = export_tree_state(tm)
    assert sorted(got) == sorted(params)
    import_tree_state(tm, params, {})
    return tm


def _x(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _hold(jm, tm, x, seed=9):
    """Output and gradients (parameters and input) of sum(out * cot)."""
    _carry(jm, tm)

    def fn(p, xin):
        out, _ = functional_apply(jm, p, jm.buffer_tree(), xin,
                                  training=True)
        return out

    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    cot = _x(*out.shape, seed=seed)
    (out * torch.from_numpy(cot)).sum().backward()

    def loss(p, xin):
        o = fn(p, xin)
        return jnp.sum(o * cot), o

    (_, ref), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jm.parameter_tree(),
                                             jnp.asarray(x))
    _close(out.detach().numpy(), ref, "output")
    _close(xt.grad.numpy(), gx, "input gradient")
    ref_g = flatten_tree(gp)
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), ref_g[name], name)


CELLS = {
    "rnn": (lambda i, h: jnn.RnnCell(i, h), lambda i, h: nn.RnnCell(i, h)),
    "lstm": (lambda i, h: jnn.LSTM(i, h), lambda i, h: nn.LSTM(i, h)),
    "lstm_forget_bias": (lambda i, h: jnn.LSTM(i, h, forget_bias=1.0),
                         lambda i, h: nn.LSTM(i, h, forget_bias=1.0)),
    "peephole": (lambda i, h: jnn.LSTMPeephole(i, h),
                 lambda i, h: nn.LSTMPeephole(i, h)),
    "gru": (lambda i, h: jnn.GRU(i, h), lambda i, h: nn.GRU(i, h)),
}


def _state(cell_name, seed):
    h = _x(B, H, seed=seed)
    if cell_name in ("rnn", "gru"):
        return h
    return (h, _x(B, H, seed=seed + 1))


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_step_matches_reference(cell):
    """One step, ``(x_t, state) -> (out, new_state)``, with a non-zero
    state: the output, every new state tensor and the gradients."""
    make_ref, make_port = CELLS[cell]
    JaxRNG.RNG().set_seed(1)
    jm = make_ref(F, H)
    tm = _carry(jm, make_port(F, H))
    x, state = _x(B, F, seed=2), _state(cell, 3)
    cot = _x(B, H, seed=4)

    def fn(p, xin, st):
        out, _ = functional_apply(jm, p, {}, JT(xin, st), training=True)
        leaves = jax.tree_util.tree_leaves(out[2])
        return jnp.sum(out[1] * cot) + sum(jnp.sum(s * s) for s in leaves), \
            (out[1], leaves)

    (_, (ref_out, ref_state)), (gp, gx) = jax.jit(jax.value_and_grad(
        fn, argnums=(0, 1), has_aux=True))(jm.parameter_tree(),
                                          jnp.asarray(x),
                                          jax.tree_util.tree_map(
                                              jnp.asarray, state))
    xt = torch.from_numpy(x).requires_grad_()
    st = (torch.from_numpy(state) if isinstance(state, np.ndarray)
          else tuple(map(torch.from_numpy, state)))
    out, new_state = tm((xt, st))
    leaves = [new_state] if torch.is_tensor(new_state) else list(new_state)
    loss = (out * torch.from_numpy(cot)).sum() + sum((s * s).sum()
                                                     for s in leaves)
    loss.backward()
    _close(out.detach().numpy(), ref_out, "out")
    for got, ref in zip(leaves, ref_state):
        _close(got.detach().numpy(), ref, "state")
    _close(xt.grad.numpy(), gx, "input gradient")
    ref_g = flatten_tree(gp)
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), ref_g[name], name)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_recurrent_matches_reference(cell, reverse):
    make_ref, make_port = CELLS[cell]
    JaxRNG.RNG().set_seed(5)
    jm = jnn.Recurrent(reverse=reverse).add(make_ref(F, H))
    tm = nn.Recurrent(reverse=reverse).add(make_port(F, H))
    _hold(jm, tm, _x(B, T, F, seed=6))


@pytest.mark.parametrize("cell,merge", [("lstm", "concat"), ("gru", "sum")])
def test_birecurrent_matches_reference(cell, merge):
    make_ref, make_port = CELLS[cell]
    JaxRNG.RNG().set_seed(7)
    jm = jnn.BiRecurrent(merge).add(make_ref(F, H))
    tm = nn.BiRecurrent(merge).add(make_port(F, H))
    _hold(jm, tm, _x(B, T, F, seed=8))


@pytest.mark.parametrize("cell", ["rnn", "lstm", "gru"])
def test_recurrent_decoder_matches_reference(cell):
    make_ref, make_port = CELLS[cell]
    JaxRNG.RNG().set_seed(9)
    jm = jnn.RecurrentDecoder(T).add(make_ref(H, H))
    tm = nn.RecurrentDecoder(T).add(make_port(H, H))
    _hold(jm, tm, _x(B, H, seed=10))


def test_simple_rnn_build_matches_reference():
    JaxRNG.RNG().set_seed(11)
    jm = jrnn.build(F, H, 6)
    tm = rnn.build(F, H, 6, device="cpu")
    _hold(jm, tm, _x(B, T, F, seed=12))


@pytest.mark.parametrize("cell", ["lstm", "gru", "rnn"])
def test_classifier_trains_as_the_reference(cell):
    """``build_classifier`` end to end: 1-based token ids, the NLL loss
    and every parameter gradient."""
    vocab, embed, classes = 30, 6, 4
    JaxRNG.RNG().set_seed(13)
    jm = jrnn.build_classifier(vocab, embed, H, classes, cell)
    tm = _carry(jm, rnn.build_classifier(vocab, embed, H, classes, cell,
                                         device="cpu"))
    rng = np.random.default_rng(14)
    ids = rng.integers(1, vocab + 1, (B, T)).astype(np.float32)
    y = rng.integers(1, classes + 1, (B,)).astype(np.float32)

    def loss_fn(p):
        out, _ = functional_apply(jm, p, jm.buffer_tree(), jnp.asarray(ids),
                                  training=True)
        return JaxNLL().apply(out, jnp.asarray(y))

    ref_loss, gp = jax.jit(jax.value_and_grad(loss_fn))(jm.parameter_tree())
    loss = nn.ClassNLLCriterion()(tm(torch.from_numpy(ids)),
                                  torch.from_numpy(y))
    loss.backward()
    _close(loss.item(), float(ref_loss), "loss")
    ref_g = flatten_tree(gp)
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), ref_g[name], name)


def test_classifier_rejects_an_unknown_cell():
    with pytest.raises(ValueError, match="cell"):
        rnn.build_classifier(10, 4, 4, 2, "transformer", device="cpu")


def test_input_projection_is_hoisted_out_of_the_loop(monkeypatch):
    """One input product for the whole sequence, as the reference's
    ``project_input`` outside its scan; the loop runs the hidden one."""
    cell = nn.LSTM(F, H)
    calls = []
    orig = cell.project_input
    monkeypatch.setattr(cell, "project_input",
                        lambda xs: calls.append(tuple(xs.shape)) or orig(xs))
    nn.Recurrent().add(cell)(torch.from_numpy(_x(B, T, F)))
    assert calls == [(T, B, F)]
