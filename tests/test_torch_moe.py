"""The port's mixture of experts (``parallel/expert.py``) against the
reference's ``MoE`` on one device, on the CPU.

Weights cross through ``flatten_tree`` -> ``import_tree_state``; the same
seeded numpy inputs go through both. Tolerances are the reference's own
tests' (f32): forward 2e-5 relative and absolute, gradients 1e-4; the
three dispatches of the port are held bit for bit against each other
(forward, input and parameter gradients, with the aux loss in the graph
and real drops). At T = 8192 tokens, d = 32, 8 experts and capacity factor
0.25 (4 x 512 slots for 16384 picks) the dropped picks must be the
reference's; a routing difference is reported with the two softmax
probabilities it split (a near tie), not hidden. The 2-layer MoE LM's
log-probs, gradients (training mode, aux loss included) and greedy tokens
are held to the reference's ``build_lm(moe_experts=4)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.parallel.expert import MoE as JMoE
from bigdl_tpu.parallel.expert import inject_loss as jinject_loss
from bigdl_tpu_torch.interop.state_dict import (export_lm_state_dict,
                                                flatten_tree,
                                                import_tree_state)
from bigdl_tpu_torch.parallel import expert
from bigdl_tpu_torch.parallel.expert import MoE, inject_loss

FWD = dict(rtol=2e-5, atol=2e-5)
GRAD = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(d, h, e, seed, **kw):
    """(reference MoE, port MoE) with the reference's weights."""
    from bigdl_tpu.utils.rng import manual_seed
    manual_seed(seed)
    jm = JMoE(d, h, n_experts=e, **kw)
    pm = MoE(d, h, n_experts=e, **kw)
    import_tree_state(pm, flatten_tree(jm.parameter_tree()), {})
    return jm, pm


def _x(shape, seed):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _ref_forward(jm, x):
    """The reference's eval forward, compiled once (eager JAX dispatches
    op by op)."""
    fn = jax.jit(lambda p, b, x: functional_apply(jm, p, b, x,
                                                  training=False)[0])
    return np.asarray(fn(jm.parameter_tree(), jm.buffer_tree(),
                         jnp.asarray(x)))


def _ref_grads(jm, x, cot):
    def loss(p, b, x, cot):
        y, _ = functional_apply(jm, p, b, x, training=True)
        return jnp.sum(y * cot)
    g = jax.jit(jax.grad(loss))(jm.parameter_tree(), jm.buffer_tree(),
                                jnp.asarray(x), jnp.asarray(cot))
    return flatten_tree(g)


def _port_grads(pm, x, cot):
    pm.train()
    xt = torch.from_numpy(x).requires_grad_()
    y = pm(xt)
    (y * torch.from_numpy(cot)).sum().backward()
    return y.detach(), xt.grad, {n: p.grad.clone()
                                 for n, p in pm.named_parameters()}


def _routes(probs: np.ndarray, k: int) -> np.ndarray:
    """The reference's iterative top-k picks of f32 ``probs``."""
    masked, out = probs.copy(), []
    for _ in range(k):
        pick = masked.argmax(-1)
        out.append(pick)
        masked[np.arange(len(pick)), pick] = 0.0
    return np.stack(out)


@pytest.mark.parametrize("dispatch", expert.DISPATCHES)
@pytest.mark.parametrize("cf", [0.5, 1.25])
def test_forward_matches_reference(dispatch, cf):
    jm, pm = _pair(16, 32, 4, 7, k=2, capacity_factor=cf, dispatch=dispatch)
    x = _x((37, 16), 1)
    ref = _ref_forward(jm, x)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **FWD)


@pytest.mark.parametrize("dispatch", expert.DISPATCHES)
def test_gradients_match_reference(dispatch):
    jm, pm = _pair(16, 32, 4, 11, k=2, capacity_factor=0.75,
                   aux_loss_weight=0.1, dispatch=dispatch)
    x, cot = _x((29, 16), 2), _x((29, 16), 3)
    want = _ref_grads(jm, x, cot)
    _, _, got = _port_grads(pm, x, cot)
    assert sorted(got) == sorted(want)
    for n in want:
        np.testing.assert_allclose(got[n].numpy(), want[n], **GRAD,
                                   err_msg=n)


def test_three_dispatches_are_bit_equal():
    """sort = scatter = einsum: forward, the input's and every parameter's
    gradient, at a capacity factor that drops picks, aux loss included."""
    _, base = _pair(16, 32, 4, 13, k=2, capacity_factor=0.75,
                    aux_loss_weight=0.1)
    x, cot = _x((29, 16), 4), _x((29, 16), 5)
    runs = {}
    for dispatch in expert.DISPATCHES:
        import copy
        m = copy.deepcopy(base)
        m.dispatch = dispatch
        runs[dispatch] = _port_grads(m, x, cot)
    y0, dx0, g0 = runs["sort"]
    for dispatch in ("scatter", "einsum"):
        y, dx, g = runs[dispatch]
        assert torch.equal(y, y0), dispatch
        assert torch.equal(dx, dx0), dispatch
        for n in g0:
            assert torch.equal(g[n], g0[n]), (dispatch, n)


@pytest.mark.parametrize("dispatch", ["sort", "scatter"])
def test_capacity_drops_at_a_realistic_token_count(dispatch):
    t, d, e = 8192, 32, 8
    jm, pm = _pair(d, d, e, 17, k=2, capacity_factor=0.25, dispatch=dispatch)
    x = _x((t, d), 6)
    ref = _ref_forward(jm, x)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x)).numpy()
        probs_p = torch.softmax(torch.from_numpy(x) @ pm.gate_weight,
                                -1).numpy()
    probs_j = np.asarray(jax.nn.softmax(jnp.asarray(x) @ jm.gate_weight, -1))
    routes_p, routes_j = _routes(probs_p, 2), _routes(probs_j, 2)
    flips = np.argwhere(routes_p != routes_j)
    gaps = [float(abs(np.sort(probs_j[tok])[-1 - j]
                      - np.sort(probs_j[tok])[-2 - j])) for j, tok in flips]
    assert not len(flips), f"routing flips at (round, token) {flips[:4]}, " \
        f"the reference's top-two probability gaps {gaps[:4]}"
    zero_p = np.abs(got).max(-1) < 1e-9
    zero_j = np.abs(ref).max(-1) < 1e-9
    assert 0 < zero_j.sum() < t
    np.testing.assert_array_equal(zero_p, zero_j)
    np.testing.assert_allclose(got, ref, **FWD)


def test_inject_loss_gives_aux_cotangent_one():
    y = torch.from_numpy(_x((3, 4), 7)).requires_grad_()
    aux = torch.tensor(2.5, requires_grad=True)
    out = inject_loss(y, aux)
    assert torch.equal(out, y)
    (out * 0.0).sum().backward()
    assert aux.grad.item() == 1.0
    assert torch.equal(y.grad, torch.zeros_like(y))
    ref = jax.grad(lambda a: jnp.sum(jinject_loss(jnp.ones((3, 4)), a)
                                     * 0.0))(jnp.asarray(0.0))
    assert float(ref) == aux.grad.item()


def test_aux_loss_alone_reaches_the_gate():
    jm, pm = _pair(8, 8, 4, 19, k=1, aux_loss_weight=0.1)
    x = _x((32, 8), 8)
    zero = np.zeros((32, 8), np.float32)
    want = _ref_grads(jm, x, zero)
    _, _, got = _port_grads(pm, x, zero)
    assert float(np.abs(want["gate_weight"]).max()) > 0
    np.testing.assert_allclose(got["gate_weight"].numpy(),
                               want["gate_weight"], **GRAD)
    for n in ("w1", "b1", "w2", "b2"):
        assert not got[n].any(), n
    # eval mode adds no aux loss
    pm.eval()
    y = pm(torch.from_numpy(x))
    assert y.grad_fn is None or "Inject" not in type(y.grad_fn).__name__


def test_dispatch_counter_counts_paths():
    from bigdl_tpu_torch.telemetry import get_registry, instruments
    fam = instruments(get_registry()).moe_dispatch_total
    for dispatch in expert.DISPATCHES:
        before = fam.labels(path=dispatch).value
        with torch.no_grad():
            MoE(8, 8, n_experts=2, k=1, dispatch=dispatch).eval()(
                torch.zeros(4, 8))
        assert fam.labels(path=dispatch).value == before + 1


def test_unknown_dispatch_and_swiglu_refuse():
    from bigdl_tpu import nn as jnn
    from bigdl_tpu_torch import nn
    with pytest.raises(ValueError, match="dispatch must be"):
        MoE(8, 8, 2, dispatch="dense")
    for lib in (jnn, nn):
        with pytest.raises(ValueError, match="swiglu FFN does not compose"):
            lib.TransformerEncoderLayer(8, 2, 16, activation="swiglu",
                                        moe_experts=4)


# --------------------------------------------------------- the MoE LM
V = 97
LM = dict(embed_dim=16, num_heads=2, ffn_dim=32, num_layers=2, max_len=64,
          moe_experts=4)
_LM = {}


def _lm_pair():
    if not _LM:
        from bigdl_tpu.models import transformer as jtr
        from bigdl_tpu.utils.rng import manual_seed
        from bigdl_tpu_torch.models.transformer import build_lm
        manual_seed(23)
        jm = jtr.build_lm(V, **LM)
        tm = build_lm(V, **LM, device="cpu", seed=0)
        import_tree_state(tm, flatten_tree(jm.parameter_tree()),
                          flatten_tree(jm.buffer_tree()))
        _LM["pair"] = (jm, tm)
    return _LM["pair"]


def _ids(b, s, seed):
    return np.random.default_rng(seed).integers(1, V + 1, (b, s))


def test_moe_lm_names_logprobs_and_gradients():
    jm, tm = _lm_pair()
    assert sorted(n for n, _ in tm.named_parameters()) == \
        sorted(flatten_tree(jm.parameter_tree()))
    ids = _ids(2, 12, 1)
    tm.eval()
    ref = _ref_forward(jm, ids.astype(np.float32))
    with torch.no_grad():
        got = tm(torch.as_tensor(ids)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    cot = _x(ref.shape, 9)
    want = _ref_grads(jm, ids.astype(np.float32), cot)
    tm.train()
    tm.zero_grad()
    (tm(torch.as_tensor(ids)) * torch.from_numpy(cot)).sum().backward()
    for n, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[n], **GRAD,
                                   err_msg=n)
    tm.eval()


def test_moe_lm_greedy_tokens_match():
    from bigdl_tpu.models.generation import generate as jgenerate
    from bigdl_tpu_torch.models.generation import generate
    jm, tm = _lm_pair()
    jm.evaluate_mode()
    prompt = _ids(2, 6, 2)
    ref = np.asarray(jgenerate(jm, jnp.asarray(prompt, jnp.float32), 8,
                               greedy=True)).astype(np.int64)
    got = generate(tm.eval(), prompt, 8, greedy=True, device="cpu").numpy()
    np.testing.assert_array_equal(got, ref)


def test_moe_lm_specs_and_state_dict_refusal():
    from bigdl_tpu.interop.state_dict import export_lm_state_dict as jexport
    from bigdl_tpu.parallel.tensor_parallel import infer_param_specs as jspecs
    from bigdl_tpu_torch.parallel import tensor_parallel as tp
    jm, tm = _lm_pair()
    with pytest.raises(ValueError, match="no torch-convention mapping"):
        jexport(jm)
    with pytest.raises(ValueError, match="no torch-convention mapping"):
        export_lm_state_dict(tm)
    axes = {"tensor": 2, "expert": 2}
    want = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                want[prefix + k] = tuple(v)
    walk(jspecs(jm, axis_size=axes), "")
    got = tp.flat_specs(tp.infer_param_specs(tm, axis_size=axes))
    assert got == want
    assert got["2.layer0.moe.w1"] == ("expert", None, None)


def test_build_lm_with_experts_raises_without_card():
    from bigdl_tpu_torch.models.transformer import build_lm
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_lm(V, **LM)
