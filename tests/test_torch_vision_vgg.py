"""VGG-CIFAR in the port against the JAX package's, on the CPU, at B=2
with the reference's weights (``flatten_tree`` -> ``import_tree_state``)
and dropout set to 0 in both (the packages draw masks from different
generators).

The reference's weights come from its process-wide
``RandomGenerator.RNG()``, so ``_reference_at`` sets that generator to
REF_SEED (then draws that many nets before the one it keeps) and restores
its state afterwards: the weights no longer depend on which test files
ran before on the same worker.

At init this net turns f32 rounding into gradient differences of about
1e-3 between f32 paths (13 conv+BN layers over a batch of 2), and the
reference cannot run it in f64 (its batch norm keeps f32 statistics). So
what is well conditioned (eval log-probabilities, the train loss, the
updated running statistics) is held within 1e-4 of the reference, and the
train gradients and the input gradient are held to the port's own f64 run
on the same carried weights (``double()``): per tensor, the port's f32
distance from f64 must be within GRAD_TRUTH_FACTOR times the reference's
f32 distance from the f64 run, or within GRAD_FLOOR, whichever is larger
(distances are relative L2 over the larger of the tensor's f64 norm and
GRAD_FLOOR of the largest f64 gradient norm: a conv bias before a batch
norm has an exact gradient of 0).

One thing is not rounding but a branch: at some weights a ReLU input lies
within rounding of 0, and the f32 forward takes the other side of it than
the f64 one, which moves every gradient below it by far more than any
rounding does. So the f64 run the port is held to takes the port's own
ReLU decisions (the input times the f32 run's mask), and every decision
that differs from the f64 sign must be a tie: the f64 input within
TIE_RTOL of its layer's largest. The reference is held to the plain f64
run (its decisions are not visible; a reference branch only widens its
distance).

With ``BIGDL_TPU_FUSED_3X3`` the fused model is held the same way (the
same function; the names differ, so tensors are matched by conv+BN unit),
and in f64 (the CPU takes K6's plain version, in f64 for f64 input) its
gradients lie within 1e-4 of the unfused port model's on the same
weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.models import vgg
from bigdl_tpu_torch.nn import BatchNormalization, FusedConv3x3BN, ReLU
from test_torch_vision_models import (_carry, _images, _labels, _rel_l2,
                                      _train_grads_port, _train_grads_ref)

RTOL = 1e-4
GRAD_TRUTH_FACTOR = 2
GRAD_FLOOR = 1e-3
TIE_RTOL = 1e-4
REF_SEED = 1
B = 2


@pytest.fixture(autouse=True)
def one_thread(monkeypatch):
    for g in ("BIGDL_TPU_FUSED_1X1", "BIGDL_TPU_FUSED_3X3"):
        monkeypatch.delenv(g, raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _no_dropout(*models):
    for model in models:
        for m in model.modules():
            if type(m).__name__ == "Dropout":
                m.set_p(0.0)


def _reference_at(draws: int):
    """The reference's unfused VGG-CIFAR built after ``draws`` others from
    REF_SEED, its eval log-probabilities, one training step's (loss,
    grads, buffers, dx) on the test batch, and the same step in the port
    in f64 on the carried weights (the plain truth)."""
    rng = JaxRNG.RNG()
    saved = (rng._seed, rng._np, rng._key)
    rng.set_seed(REF_SEED)
    try:
        for _ in range(draws):
            jvgg.build(10)
        jm = jvgg.build(10)
    finally:
        rng._seed, rng._np, rng._key = saved
    _no_dropout(jm)
    x, y = _images((B, 32, 32, 3)), _labels(B, 10)
    jm.evaluate_mode()
    out = np.asarray(jm.forward(jnp.asarray(x)))
    jm.training_mode()
    truth, _ = _f64_run(jm, x, y)
    return jm, x, y, out, _train_grads_ref(jm, x, y), truth


@pytest.fixture(scope="module")
def reference():
    return _reference_at(0)


def _relu_inputs(model, masks=None):
    """Hooks on ``model``'s ReLUs, in forward order: each input is kept in
    the returned list, and with ``masks`` the output is the input times
    the ReLU's mask; returns (list, hook handles)."""
    seen, handles = [], []
    for m in model.modules():
        if isinstance(m, ReLU):
            def hook(mod, args, out, k=len(handles)):
                seen.append(args[0].detach())
                if masks is not None:
                    return args[0] * masks[k].to(args[0].dtype)
            handles.append(m.register_forward_hook(hook))
    return seen, handles


def _f64_run(jm, x, y, masks=None):
    """One f64 training step of the port on the carried weights, with the
    ReLU decisions ``masks`` if given: (loss, grads, buffers, dx) and the
    ReLU inputs."""
    t64 = _carry(jm, vgg.build(10, device="cpu", seed=3)).double()
    _no_dropout(t64)
    seen, handles = _relu_inputs(t64, masks)
    try:
        return _train_grads_port(t64, x.astype(np.float64), y), seen
    finally:
        for h in handles:
            h.remove()


def _dist(got, truth, floor):
    return np.linalg.norm(got - truth) / max(np.linalg.norm(truth), floor)


def _held_to_truth(got, ref, truth, plain):
    """Every port f32 gradient (and dx) within GRAD_TRUTH_FACTOR times the
    reference's distance from the ``plain`` f64 run, or GRAD_FLOOR, with
    the port's distance taken from ``truth`` (the f64 run on the port's
    ReLU decisions); returns the worst ratio to its limit."""
    floor = GRAD_FLOOR * max(np.linalg.norm(g) for g in plain[1].values())
    pairs = [(name, g, ref[1][name], truth[1][name], plain[1][name])
             for name, g in got[1].items()]
    pairs.append(("dx", got[3], ref[3], truth[3], plain[3]))
    worst = 0.0
    for name, g, r, t, p in pairs:
        d_port, d_ref = _dist(g, t, floor), _dist(r, p, floor)
        limit = max(GRAD_TRUTH_FACTOR * d_ref, GRAD_FLOOR)
        assert d_port <= limit, (name, d_port, d_ref)
        worst = max(worst, d_port / limit)
    return worst


def _unit_names(model):
    """{parameter name: unit key}, alike whether or not conv+BN pairs are
    fused: a ``FusedConv3x3BN``, or a module followed by a
    ``BatchNormalization``, is one unit of weight, bias, gamma and beta;
    any other module with parameters is a unit of its own (forward order
    is registration order in the VGG builder)."""
    leaves = [(n, m) for n, m in model.named_modules()
              if not m._modules and m._parameters]
    out, i, unit = {}, 0, 0
    while i < len(leaves):
        name, m = leaves[i]
        nxt = leaves[i + 1] if i + 1 < len(leaves) else (None, None)
        if isinstance(m, FusedConv3x3BN):
            for f in ("weight", "bias", "gamma", "beta"):
                out[f"{name}.{f}"] = f"{unit}.{f}"
            i += 1
        elif (not isinstance(m, BatchNormalization)
              and isinstance(nxt[1], BatchNormalization)):
            out[f"{name}.weight"], out[f"{name}.bias"] = (f"{unit}.weight",
                                                          f"{unit}.bias")
            out[f"{nxt[0]}.weight"] = f"{unit}.gamma"
            out[f"{nxt[0]}.bias"] = f"{unit}.beta"
            i += 2
        else:
            for f in m._parameters:
                out[f"{name}.{f}"] = f"{unit}.{f}"
            i += 1
        unit += 1
    return out


def _hold(reference, tm, name_of=lambda n: n):
    """``tm`` against the reference's numbers and the f64 truth on its own
    ReLU decisions; ``name_of`` maps a port parameter name to the
    reference's. Returns the f32 step and the number of ties."""
    jm, x, y, ref_out, ref, plain = reference
    with torch.no_grad():
        got_out = tm.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got_out - ref_out).max() <= RTOL * np.abs(ref_out).max()
    seen, handles = _relu_inputs(tm)
    try:
        got = _train_grads_port(tm, x, y)
    finally:
        for h in handles:
            h.remove()
    assert abs(got[0] - ref[0]) <= RTOL * abs(ref[0])
    assert abs(got[0] - plain[0]) <= RTOL * abs(plain[0])
    masks = [a > 0 for a in seen]
    truth, pre64 = _f64_run(jm, x, y, masks)
    ties = 0
    for mask, a in zip(masks, pre64):
        differ = mask != (a > 0)
        scale = a.abs().max().item()
        assert (a[differ].abs() <= TIE_RTOL * scale).all(), (
            a[differ], scale)
        ties += int(differ.sum())
    renamed = (got[0], {name_of(n): g for n, g in got[1].items()}, got[2],
               got[3])
    _held_to_truth(renamed, ref, truth, plain)
    return got, ties


def test_vgg_cifar_matches_the_reference(reference):
    jm = reference[0]
    tm = _carry(jm, vgg.build(10, device="cpu", seed=3))
    _no_dropout(tm)
    got, _ = _hold(reference, tm)
    ref = reference[4]
    for name in ref[2]:   # the updated running statistics
        assert _rel_l2(got[2][name], ref[2][name]) <= RTOL, name


def test_vgg_cifar_fused_3x3(reference, monkeypatch):
    jm, x, y = reference[:3]
    unfused = _carry(jm, vgg.build(10, device="cpu", seed=4))
    monkeypatch.setenv("BIGDL_TPU_FUSED_3X3", "1")
    fused = vgg.build(10, device="cpu", seed=3)
    monkeypatch.delenv("BIGDL_TPU_FUSED_3X3")   # the f64 truth is unfused
    assert sum(isinstance(m, FusedConv3x3BN) for m in fused.modules()) == 13
    _no_dropout(fused, unfused)
    units_u, units_f = _unit_names(unfused), _unit_names(fused)
    assert sorted(units_u.values()) == sorted(units_f.values())
    name_u = {unit: n for n, unit in units_u.items()}
    by_unit = {units_u[n]: p.detach() for n, p in unfused.named_parameters()}
    with torch.no_grad():
        for n, p in fused.named_parameters():
            p.copy_(by_unit[units_f[n]])
    _hold(reference, fused, lambda n: name_u[units_f[n]])
    fused.double()
    unfused.double()
    got = _train_grads_port(fused, x.astype(np.float64), y)
    want = _train_grads_port(unfused, x.astype(np.float64), y)
    want_g = {units_u[n]: g for n, g in want[1].items()}
    assert abs(got[0] - want[0]) <= 1e-10 * abs(want[0])
    floor = 1e-3 * max(np.linalg.norm(g) for g in want_g.values())
    for name, g in got[1].items():
        key = units_f[name]
        err = (np.linalg.norm(g - want_g[key])
               / max(np.linalg.norm(want_g[key]), floor))
        assert err <= RTOL, (name, err)
    assert _rel_l2(got[3], want[3]) <= RTOL


@pytest.mark.parametrize("draws", [6, 12])
def test_vgg_cifar_at_other_generator_positions(draws):
    """The unfused net held the same way at other weights: after 6 draws
    the f32 forward takes one ReLU input that lies within rounding of 0 to
    the other side; after 12 the one-pass batch-norm statistics once put
    the port 23x past this limit (ROADMAP C.6)."""
    reference = _reference_at(draws)
    tm = _carry(reference[0], vgg.build(10, device="cpu", seed=3))
    _no_dropout(tm)
    _hold(reference, tm)
