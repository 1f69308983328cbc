"""Sharded checkpoints (``bigdl_tpu_torch/utils/sharded_checkpoint.py``)
against the reference's ``bigdl_tpu/utils/sharded_checkpoint.py`` on the
CPU: the library's round trip, stale and missing shards, format 1, files
that either package writes and the other reads (numpy leaves), bf16 leaves
bit for bit (the reference cannot read its own back: ROADMAP C), the
optimizer's sharded resume (bit-equal within the port, within 1e-5 of the
reference's uninterrupted ``LocalOptimizer`` on carried weights), and the
coordinator and CLI on sharded pairs.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.base import AbstractDataSet as JaxAbstractDataSet
from bigdl_tpu.dataset.base import MiniBatch as JaxMiniBatch
from bigdl_tpu.optim import Optimizer as JaxOptimizer
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import Trigger as JaxTrigger
from bigdl_tpu.utils import sharded_checkpoint as ref_sc
from bigdl_tpu.utils.rng import manual_seed
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.base import AbstractDataSet, MiniBatch
from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                flatten_tree,
                                                import_tree_state)
from bigdl_tpu_torch.optim import SGD, AdamW, Optimizer, Trigger
from bigdl_tpu_torch.resilience import coordinator, corrupt_snapshot
from bigdl_tpu_torch.utils import sharded_checkpoint as sc

ROOT = Path(__file__).resolve().parent.parent
WEIGHT_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"params": {"w": rng.standard_normal((3, 4)).astype(np.float32),
                       "b": [rng.integers(0, 9, 5).astype(np.int32),
                             (np.float64(2.5), np.arange(3) > 1)]},
            "step": np.int64(7)}


def _targets(tree):
    if isinstance(tree, dict):
        return {k: _targets(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_targets(v) for v in tree)
    return None


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        np.asarray(x).dtype == np.asarray(y).dtype
        and np.array_equal(np.asarray(x), np.asarray(y))
        for x, y in zip(la, lb))


def test_round_trip_manifest_and_names(tmp_path):
    d = str(tmp_path / "s")
    tree = _tree()
    sc.save_sharded(d, tree)
    assert sc.is_sharded_checkpoint(d)
    leaves, shards = sc.read_manifest(d)
    assert shards == [sc.shard_filename(0)] == ["shard-00000.npz"]
    assert sorted(leaves) == sorted([
        "['params']['b'][0]", "['params']['b'][1][0]",
        "['params']['b'][1][1]", "['params']['w']", "['step']"])
    assert leaves["['params']['w']"] == {"shape": [3, 4],
                                         "dtype": "float32"}
    with np.load(os.path.join(d, shards[0])) as z:
        assert "['params']['w']||0,0||3,4" in z.files
    assert _equal(sc.load_sharded(d, _targets(tree)), tree)
    assert coordinator.manifest_leaf_keys(d) == list(leaves)
    assert sorted(os.listdir(d)) == ["manifest.json", "shard-00000.npz"]


def test_targets_place_tensors_and_manifest_builds_the_tree(tmp_path):
    d = str(tmp_path / "s")
    sc.save_sharded(d, {"a": torch.arange(6.0).reshape(2, 3),
                        "b": [torch.ones(2, dtype=torch.int64)]})
    got = sc.load_sharded(d, {"a": torch.device("cpu"), "b": ["cpu"]})
    assert torch.is_tensor(got["a"]) and got["a"].dtype == torch.float32
    assert torch.equal(got["a"], torch.arange(6.0).reshape(2, 3))
    assert torch.equal(got["b"][0], torch.ones(2, dtype=torch.int64))
    assert sc.manifest_targets(d) == {"a": None, "b": [None]}
    with pytest.raises(KeyError, match="not in checkpoint manifest"):
        sc.load_sharded(d, {"c": None})


def test_stale_shards_missing_shard_and_format_1(tmp_path):
    d = tmp_path / "s"
    d.mkdir()
    np.savez(d / "shard-00003.npz", x=np.zeros(1))   # a wider earlier save
    sc.save_sharded(str(d), _tree())
    assert not (d / "shard-00003.npz").exists()
    leaves, _ = sc.read_manifest(str(d))
    # format 1: a bare leaves dict, the shard files found by name
    (d / "manifest.json").write_text(json.dumps(leaves))
    assert sc.read_manifest(str(d)) == (leaves, None)
    assert _equal(sc.load_sharded(str(d), _targets(_tree())), _tree())
    assert coordinator.sharded_snapshot_complete(str(d))
    (d / "manifest.json").write_text(json.dumps(
        {"format": 2, "shards": ["shard-00000.npz", "shard-00001.npz"],
         "leaves": leaves}))
    assert not coordinator.sharded_snapshot_complete(str(d))
    with pytest.raises(NotImplementedError, match="A.4"):
        sc.load_sharded(str(d), _targets(_tree()))
    (d / "manifest.json").write_text(json.dumps(
        {"format": 2, "shards": ["shard-00000.npz"], "leaves": leaves}))
    (d / "shard-00000.npz").unlink()
    assert not coordinator.sharded_snapshot_complete(str(d))
    with pytest.raises(ValueError, match="incomplete"):
        sc.load_sharded(str(d), _targets(_tree()))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_numpy_trees_cross_packages(tmp_path, writer):
    d = str(tmp_path / writer)
    tree = _tree(seed=3)
    if writer == "port":
        sc.save_sharded(d, tree)
        got = ref_sc.load_sharded(d, _targets(tree))
    else:
        ref_sc.save_sharded(d, tree)
        got = sc.load_sharded(d, _targets(tree))
    assert _equal(got, tree)
    assert sc.read_manifest(d) == ref_sc.read_manifest(d)


def test_bf16_leaves_round_trip_bit_for_bit(tmp_path):
    d = str(tmp_path / "bf")
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(7, 5, generator=gen).to(torch.bfloat16)
    sc.save_sharded(d, {"m": x, "f": x.float()})
    leaves, _ = sc.read_manifest(d)
    assert leaves["['m']"] == {"shape": [7, 5], "dtype": "bfloat16"}
    with np.load(os.path.join(d, "shard-00000.npz")) as z:
        assert z["['m']||0,0||7,5"].dtype == np.dtype("V2")
    got = sc.load_sharded(d, {"m": None, "f": None})
    assert got["m"].dtype == torch.bfloat16
    assert torch.equal(got["m"].view(torch.int16), x.view(torch.int16))
    # the reference writes the same bytes for its bf16 leaf, and cannot
    # read them back (ROADMAP C, known differences); the port can
    r = str(tmp_path / "ref")
    ref_sc.save_sharded(r, {"m": jnp.asarray(x.float().numpy(),
                                             jnp.bfloat16)})
    assert sc.read_manifest(r)[0]["['m']"]["dtype"] == "bfloat16"
    assert torch.equal(sc.load_sharded(r, {"m": None})["m"], x)
    with pytest.raises(ValueError):
        ref_sc.load_sharded(r, {"m": None})


# ------------------------------------------------------------- optimizer
def _batches(n=4, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.randn(16, 6).astype(np.float32),
             rng.randint(1, 4, 16).astype(np.float32)) for _ in range(n)]


class _Fixed(AbstractDataSet):
    def __init__(self, mini=MiniBatch):
        self.mini = mini

    def data(self, train):
        for x, y in _batches():
            yield self.mini(x, y)

    def size(self):
        return 64

    def shuffle(self):
        pass


class _JaxFixed(JaxAbstractDataSet):
    def data(self, train):
        for x, y in _batches():
            yield JaxMiniBatch(x, y)

    def size(self):
        return 64

    def shuffle(self):
        pass


def _reference_run():
    """The reference's uninterrupted ``LocalOptimizer`` run; returns its
    initial and final weights in the port's names and layouts."""
    manual_seed(3)
    jm = (jnn.Sequential().add(jnn.Linear(6, 8)).add(jnn.Tanh())
          .add(jnn.Linear(8, 3)).add(jnn.LogSoftMax()))
    init = flatten_tree(jm.parameter_tree())
    opt = JaxOptimizer(jm, _JaxFixed(), jnn.ClassNLLCriterion())
    opt.set_optim_method(JaxSGD(learningrate=0.1, momentum=0.9))
    opt.set_end_when(JaxTrigger.max_epoch(3))
    trained = opt.optimize()
    return init, flatten_tree(trained.parameter_tree())


def _port(init, ckpt=None, method=None):
    model = (nn.Sequential().add(nn.Linear(6, 8)).add(nn.Tanh())
             .add(nn.Linear(8, 3)).add(nn.LogSoftMax()))
    import_tree_state(model, init, {})
    opt = Optimizer(model, _Fixed(), nn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(method or SGD(learningrate=0.1, momentum=0.9))
    opt.set_end_when(Trigger.max_epoch(3))
    if ckpt is not None:
        opt.set_checkpoint(str(ckpt), Trigger.several_iteration(6),
                           sharded=True)
    return opt


def test_optimizer_sharded_resume_matches_reference(tmp_path):
    init, ref_final = _reference_run()
    whole = _port(init, tmp_path)
    whole.optimize()
    want = export_tree_state(whole.model)[0]
    assert sorted(os.listdir(tmp_path)) == ["model.12", "model.6",
                                            "state.12", "state.6"]
    state = tmp_path / "state.6"
    assert sorted(os.listdir(state)) == ["driver.json", "manifest.json",
                                         "resume.json", "shard-00000.npz"]
    assert json.loads((state / "driver.json").read_text())["neval"] == 6
    other = {k: np.zeros_like(v) for k, v in init.items()}
    resumed = _port(other, tmp_path)
    resumed.resume(str(tmp_path / "model.6"), str(state))
    resumed.optimize()
    assert [h["neval"] for h in resumed.history] == list(range(6, 13))
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in whole.history][5:]
    got = export_tree_state(resumed.model)[0]
    for name, w in want.items():
        np.testing.assert_array_equal(got[name], w, err_msg=name)
        np.testing.assert_allclose(got[name], ref_final[name],
                                   rtol=WEIGHT_RTOL, atol=WEIGHT_RTOL,
                                   err_msg=name)


def test_optimizer_sharded_bf16_moments_auto_resume(tmp_path):
    init, _ = _reference_run()
    adamw = lambda: AdamW(learningrate=1e-2, weightdecay=0.01,
                          state_dtype="bfloat16")
    whole = _port(init, tmp_path / "a", adamw())
    whole.optimize()
    leaves, _ = sc.read_manifest(str(tmp_path / "a" / "state.6"))
    assert any(v["dtype"] == "bfloat16" for v in leaves.values())
    # auto_resume takes the newest complete pair: only 6 is left there
    os.makedirs(tmp_path / "b")
    for kind in ("model", "state"):
        os.rename(tmp_path / "a" / f"{kind}.6", tmp_path / "b" / f"{kind}.6")
    resumed = _port(init, tmp_path / "b", adamw()).auto_resume()
    resumed.optimize()
    assert [h["loss"] for h in resumed.history] == \
        [h["loss"] for h in whole.history][5:]
    for (n, p), q in zip(resumed.model.named_parameters(),
                         whole.model.parameters()):
        assert torch.equal(p, q), n


def test_coordinator_and_host_load_on_a_sharded_pair(tmp_path):
    init, _ = _reference_run()
    _port(init, tmp_path).optimize()
    model, state = str(tmp_path / "model.12"), str(tmp_path / "state.12")
    assert coordinator.validate_pair(model, state)
    point = coordinator.latest_resume_point(str(tmp_path))
    assert point.sharded and point.neval == 12 and point.marker["files"]
    params, optim, driver = coordinator.load_snapshot_host(model, state)
    assert sorted(params) == sorted(init) and driver["neval"] == 12
    assert optim["evalCounter"] == 11 and sorted(optim["velocity"]) == \
        sorted(init)
    info = corrupt_snapshot(model, seed=3)      # flip bytes of shard 0
    assert info["file"].endswith("shard-00000.npz")
    assert not coordinator.validate_pair(model, state)
    assert coordinator.latest_resume_point(str(tmp_path)).neval == 6
    with pytest.raises(ValueError, match="out of range"):
        corrupt_snapshot(state, shard=1)


def test_cli_on_sharded_pairs(tmp_path):
    init, _ = _reference_run()
    _port(init, tmp_path).optimize()
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}

    def cli(*args):
        return subprocess.run([sys.executable, "-m",
                               "bigdl_tpu_torch.resilience", *map(str, args)],
                              capture_output=True, text=True, timeout=120,
                              cwd=ROOT, env=env)
    r = cli("validate", tmp_path)
    assert r.returncode == 0
    assert [line.split()[0] for line in r.stdout.splitlines()] == [
        "complete", "complete"]
    assert all("sharded" in line for line in r.stdout.splitlines())
    r = cli("chaos", "corrupt", tmp_path / "state.12", "--shard", "0",
            "--mode", "truncate")
    assert r.returncode == 0 and "shard-00000.npz" in r.stdout
    r = cli("latest", tmp_path)
    assert r.stdout.splitlines() == [str(tmp_path / "model.6"),
                                     str(tmp_path / "state.6")]
