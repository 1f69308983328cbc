"""The port's ResNet builders and weight interop against the JAX package's,
on the CPU.

``build(1000, 50)`` with and without the fusion gates (module counts:
36 fused 1x1, 13 fused 3x3 and 4 plain pairs; parameter and buffer names
and shapes equal to the reference's trees), the tree-state round trip in
both directions (port -> port, port -> reference through ``nest_tree``)
with its name and shape checks, ``chip_smoke.transfer_state`` between
fused and unfused models (train and eval outputs within 1e-5), and the
builders' argument checks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import resnet as jax_resnet
from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                flatten_tree,
                                                import_tree_state)
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.nn import (FusedConv1x1BN, FusedConv3x3BN,
                                SpaceToDepthConv7, SpatialBatchNormalization,
                                SpatialConvolution)
from chip_smoke import transfer_state

torch.set_num_threads(1)


def nest_tree(flat):
    """``{dotted name: array}`` as the nested dict that the reference's
    ``load_parameter_tree`` and ``load_buffer_tree`` take."""
    tree = {}
    for key, value in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


CLASSES = 10
GATES = ("BIGDL_TPU_FUSED_1X1", "BIGDL_TPU_FUSED_3X3")


@pytest.fixture
def gates_on(monkeypatch):
    for g in GATES:
        monkeypatch.setenv(g, "1")


def _images(seed=0, b=4):
    return np.random.default_rng(seed).normal(
        0, 1, (b, 32, 32, 3)).astype(np.float32)


def _count(model, cls):
    return sum(isinstance(m, cls) for m in model.modules())


@pytest.mark.parametrize("gated", [True, False])
def test_resnet50_matches_reference_tree(gated, monkeypatch):
    for g in GATES:
        if gated:
            monkeypatch.setenv(g, "1")
        else:
            monkeypatch.delenv(g, raising=False)
    tm = resnet.build(1000, 50, device="cpu", seed=0)
    jm = jax_resnet.build(1000, 50)
    convs = _count(tm, (SpatialConvolution, SpaceToDepthConv7))
    if gated:
        assert (_count(tm, FusedConv1x1BN), _count(tm, FusedConv3x3BN),
                convs, _count(tm, SpatialBatchNormalization)) == (36, 13, 4, 4)
    else:
        assert (_count(tm, FusedConv1x1BN), _count(tm, FusedConv3x3BN),
                convs, _count(tm, SpatialBatchNormalization)) == (0, 0, 53, 53)
    params, bufs = export_tree_state(tm)
    for got, ref in ((params, flatten_tree(jm.parameter_tree())),
                     (bufs, flatten_tree(jm.buffer_tree()))):
        assert sorted(got) == sorted(ref)
        assert all(got[k].shape == ref[k].shape for k in ref)
    assert sum(v.size for v in params.values()) == 25_557_032


def test_tree_state_round_trip_and_checks(gates_on):
    a = resnet.build_cifar(CLASSES, depth=8, shortcut_type="B",
                           device="cpu", seed=0)
    b = resnet.build_cifar(CLASSES, depth=8, shortcut_type="B",
                           device="cpu", seed=1)
    with torch.no_grad():
        for buf in a.buffers():
            buf.add_(0.5)
    params, bufs = export_tree_state(a)
    import_tree_state(b, params, bufs)
    for (n, p), (_, q) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(p, q), n
    # and into the reference: its trees and its eval forward agree
    jm = jax_resnet.build_cifar(CLASSES, depth=8, shortcut_type="B")
    jm.load_parameter_tree(nest_tree({k: jnp.asarray(v)
                                      for k, v in params.items()}))
    jm.load_buffer_tree(nest_tree({k: jnp.asarray(v)
                                   for k, v in bufs.items()}))
    for got, ref in ((flatten_tree(jm.parameter_tree()), params),
                     (flatten_tree(jm.buffer_tree()), bufs)):
        assert got.keys() == ref.keys()
        assert all(np.array_equal(got[k], ref[k]) for k in ref)
    before = export_tree_state(b)[0]
    with pytest.raises(KeyError, match="missing"):
        import_tree_state(b, {k: v for k, v in params.items()
                              if k != "0.weight"}, bufs)
    with pytest.raises(KeyError, match="unexpected"):
        import_tree_state(b, {**params, "extra": np.zeros(1)}, bufs)
    bad = dict(params)
    bad["0.gamma"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        import_tree_state(b, bad, bufs)
    after = export_tree_state(b)[0]
    assert all(np.array_equal(before[k], after[k]) for k in before)


def test_transfer_state_between_fused_and_unfused_models(monkeypatch):
    x = torch.from_numpy(_images(3))
    for g in GATES:
        monkeypatch.setenv(g, "1")
    fused = resnet.build_cifar(CLASSES, depth=8, shortcut_type="B",
                               device="cpu", seed=0)
    for g in GATES:
        monkeypatch.delenv(g)
    plain = resnet.build_cifar(CLASSES, depth=8, shortcut_type="B",
                               device="cpu", seed=1)
    transfer_state(fused, plain)
    out_f, out_p = fused(x), plain(x)
    torch.testing.assert_close(out_f, out_p, rtol=1e-5, atol=1e-5)
    stats_f = [m.running_var for m in fused.modules()
               if hasattr(m, "running_var")]
    stats_p = [m.running_var for m in plain.modules()
               if hasattr(m, "running_var")]
    for a, b in zip(stats_f, stats_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    back = resnet.build_cifar(CLASSES, depth=8, shortcut_type="B",
                              device="cpu", seed=2)
    with pytest.raises(ValueError, match="differ"):
        transfer_state(fused, resnet.build(10, 18, device="cpu"))
    transfer_state(plain, back)
    fused.eval()
    back.eval()
    with torch.no_grad():
        torch.testing.assert_close(fused(x), back(x), rtol=1e-5, atol=1e-5)


def test_build_rejects_unknown_depths():
    with pytest.raises(ValueError, match="depth"):
        resnet.build(1000, 42, device="cpu")
    with pytest.raises(ValueError, match="6n"):
        resnet.build_cifar(10, 9, device="cpu")
