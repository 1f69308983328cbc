"""VGG-CIFAR in the port against the JAX package's, on the CPU, at B=2
with the reference's weights (``flatten_tree`` -> ``import_tree_state``)
and dropout set to 0 in both (the packages draw masks from different
generators).

At init this net turns f32 rounding into gradient differences of 1e-3 to
3e-2 between any two f32 paths (13 conv+BN layers, then batch norm over
the batch; measured at B = 2, 4, 8 and 16, each package's f32 gradients
against an f64 copy, with neither package the nearer at every batch; at
this seed the largest port-to-reference distance is 2.2e-3), and the
reference cannot run it in f64 (its batch norm keeps f32 statistics). So:
what is well conditioned (eval log-probabilities, the train loss, the
updated running statistics) is held within 1e-4, the train gradients and
the input gradient within VGG_GRAD_RTOL relative L2 (over the larger of
the tensor's norm and 1e-3 of the largest gradient norm: a bias before a
batch norm has an exact gradient of 0). With ``BIGDL_TPU_FUSED_3X3`` the
fused model is held the same way to the reference's unfused model (the
same function; the names differ, so tensors are matched by conv+BN unit),
and in f64 (the CPU takes K6's plain version, in f64 for f64 input) its
gradients lie within 1e-4 of the unfused port model's on the same weights.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import vgg as jvgg
from bigdl_tpu_torch.models import vgg
from bigdl_tpu_torch.nn import BatchNormalization, FusedConv3x3BN
from test_torch_vision_models import (_carry, _images, _labels, _rel_l2,
                                      _train_grads_port, _train_grads_ref)

RTOL = 1e-4
VGG_GRAD_RTOL = 1e-2
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


@pytest.fixture(scope="module")
def reference():
    """The reference's unfused VGG-CIFAR, its eval log-probabilities and
    one training step's (loss, grads, buffers, dx) on the test batch."""
    jm = jvgg.build(10)
    _no_dropout(jm)
    x, y = _images((B, 32, 32, 3)), _labels(B, 10)
    jm.evaluate_mode()
    out = np.asarray(jm.forward(jnp.asarray(x)))
    jm.training_mode()
    return jm, x, y, out, _train_grads_ref(jm, x, y)


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
    """``tm`` against the reference's numbers; ``name_of`` maps a port
    parameter name to the reference's."""
    _, x, y, ref_out, ref = reference
    with torch.no_grad():
        got_out = tm.eval()(torch.from_numpy(x)).numpy()
    assert np.abs(got_out - ref_out).max() <= RTOL * np.abs(ref_out).max()
    got = _train_grads_port(tm, x, y)
    assert abs(got[0] - ref[0]) <= RTOL * abs(ref[0])
    floor = 1e-3 * max(np.linalg.norm(g) for g in ref[1].values())
    for name, g in got[1].items():
        want = ref[1][name_of(name)]
        err = np.linalg.norm(g - want) / max(np.linalg.norm(want), floor)
        assert err <= VGG_GRAD_RTOL, (name, err)
    assert _rel_l2(got[3], ref[3]) <= VGG_GRAD_RTOL
    return got


def test_vgg_cifar_matches_the_reference(reference):
    jm = reference[0]
    tm = _carry(jm, vgg.build(10, device="cpu", seed=3))
    _no_dropout(tm)
    got = _hold(reference, tm)
    ref = reference[4]
    for name in ref[2]:   # the updated running statistics
        assert _rel_l2(got[2][name], ref[2][name]) <= RTOL, name


def test_vgg_cifar_fused_3x3(reference, monkeypatch):
    jm, x, y, _, _ = reference
    unfused = _carry(jm, vgg.build(10, device="cpu", seed=4))
    monkeypatch.setenv("BIGDL_TPU_FUSED_3X3", "1")
    fused = vgg.build(10, device="cpu", seed=3)
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
