"""The rest of the port's data-parallel plane on the CPU: the FSDP layout
and the bf16 codec against the reference's, the mesh's and the Engine's
refusals, the facade's routing, and (two gloo ranks, then four) each
rank's records, the merged validation, the agreed preemption step and a
sharded snapshot saved by two ranks and restored by four and by one."""

import json

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
from bigdl_tpu_torch.parallel import (CompressedTensor, DistriOptimizer,
                                      MeshTopology, SerializerInstance,
                                      fsdp_param_specs, shard_fraction)
from bigdl_tpu_torch.parallel.mesh import MODEL_PARALLEL
from bigdl_tpu_torch.utils.engine import Engine


# ------------------------------------------------------- in this process
def _ref_specs(tree, n):
    from bigdl_tpu.parallel.fsdp import fsdp_param_specs as ref
    from bigdl_tpu_torch.interop.state_dict import flatten_tree
    specs = ref(tree, n)
    flat = {}

    def walk(t, s, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, s[k], f"{prefix}{k}.")
            else:
                flat[prefix + k] = tuple(s[k])
    walk(tree, specs, "")
    assert set(flat) == set(flatten_tree(tree))
    return flat


def _models():
    from bigdl_tpu.models import lenet as jlenet
    from bigdl_tpu.models import resnet as jresnet
    from bigdl_tpu.models import transformer as jtr
    from bigdl_tpu_torch.models import lenet, resnet, transformer
    # the 134m recipe of chip_smoke.py at 2 layers
    lm = dict(embed_dim=768, num_heads=12, num_kv_heads=4, ffn_dim=3072,
              num_layers=2, max_len=512, rope=True, activation="swiglu",
              norm="rms", bias=False, tie_embeddings=True)
    return [("lenet", jlenet.build(10), lenet.build(10, device="cpu")),
            ("resnet_cifar", jresnet.build_cifar(depth=8, class_num=10),
             resnet.build_cifar(depth=8, class_num=10, device="cpu")),
            ("lm_134m_2_layers", jtr.build_lm(32000, **lm),
             transformer.build_lm(32000, **lm, device="cpu"))]


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_specs_and_fraction_equal_the_references(models, n):
    from bigdl_tpu.parallel.fsdp import shard_fraction as ref_fraction
    for name, ref, port in models:
        tree = ref.parameter_tree()
        params = dict(port.named_parameters())
        want = _ref_specs(tree, n)
        assert fsdp_param_specs(params, n) == want, name
        assert shard_fraction(params, n) == pytest.approx(
            ref_fraction(tree, n), abs=1e-12), name
        # per-rank bytes: each sharded leaf's 1/n, the rest whole
        full = sum(p.numel() * 4 for p in params.values())
        per_rank = sum(p.numel() * 4 // (n if want[k] else 1)
                       for k, p in params.items())
        frac = shard_fraction(params, n)
        assert per_rank == pytest.approx(full * (1 - frac + frac / n))
    with pytest.raises(NotImplementedError, match="model-parallel axes"):
        fsdp_param_specs({"w": torch.zeros(4, 4)}, 2, base_specs={})


def test_compressed_tensor_bytes_equal_the_references():
    from bigdl_tpu.parallel import compression as ref
    rng = np.random.default_rng(1)
    a = rng.normal(0, 3, 1000).astype(np.float32)
    b = rng.normal(0, 3, 1000).astype(np.float32)
    for ours, theirs in ((CompressedTensor.from_array(a),
                          ref.CompressedTensor.from_array(a)),):
        assert ours.bytes() == theirs.bytes()
        ours.add(CompressedTensor.from_array(b), 10, 500)
        theirs.add(ref.CompressedTensor.from_array(b), 10, 500)
        assert ours.bytes() == theirs.bytes()
        np.testing.assert_array_equal(ours.decompress(), theirs.decompress())
        da, db = a.copy(), a.copy()
        ours.accumulate_into(da, 0)
        theirs.accumulate_into(db, 0)
        np.testing.assert_array_equal(da, db)
        assert CompressedTensor.from_bytes(ours.bytes()).bytes() == \
            ours.bytes()
    assert SerializerInstance.create(4, "fp16").length == 4
    with pytest.raises(ValueError, match="unsupported"):
        SerializerInstance.create(4, "int8")


def test_mesh_and_engine_refusals():
    for axis in ("tensor", "pipeline", "sequence", "expert"):
        with pytest.raises(NotImplementedError, match=MODEL_PARALLEL.replace(
                "(", r"\(").replace(")", r"\)")):
            MeshTopology(**{axis: 2}).build(device="cpu")
    with pytest.raises(ValueError, match="no process group"):
        MeshTopology(data=2).build(device="cpu")
    topo = MeshTopology(data=1)
    assert (topo.total(), topo.axis_names(), repr(topo)) == (
        1, ("data",), "MeshTopology(data=1)")
    mesh = topo.build(device="cpu")
    assert (mesh.size, mesh.rank, mesh.shape) == (1, 0, {"data": 1})
    assert repr(MeshTopology(data=4)) == "MeshTopology(data=4)"
    with pytest.raises(ValueError, match="backend='gloo'"):
        Engine.init_distributed("127.0.0.1:1", world_size=2 +
                                torch.cuda.device_count(), rank=0,
                                device="cuda:0", backend="nccl")
    with pytest.raises(ValueError, match="gloo"):
        Engine.init_distributed("127.0.0.1:1", 1, 0, device="cpu",
                                backend="nccl")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Engine.init_distributed("127.0.0.1:1", 1, 0)
    assert not torch.distributed.is_initialized()


def test_optimizer_routes_a_distributed_dataset():
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.optim import Optimizer, SGD, Trigger
    samples = worker.lenet_samples(8)
    model = lenet.build(10, device="cpu")
    opt = Optimizer(model, DataSet.array(samples, distributed=True)
                    >> SampleToBatch(4), nn.ClassNLLCriterion(),
                    device="cpu", sync_mode="sharded")
    assert isinstance(opt, DistriOptimizer) and opt.mesh.size == 1
    assert opt._telemetry_mode() == "mesh-sharded"
    opt.set_optim_method(SGD(learningrate=0.1)).set_end_when(
        Trigger.max_iteration(2))
    opt.optimize()
    assert len(opt.history) == 2
    with pytest.raises(NotImplementedError, match="model-parallel"):
        Optimizer(model, DataSet.array(samples, distributed=True),
                  nn.ClassNLLCriterion(), device="cpu",
                  topology=MeshTopology(data=1, tensor=2))


def test_single_process_shards_keep_the_local_optimizer(tmp_path):
    """Shards dealt by rank are distributed, but one process without a
    group trains them through ``LocalOptimizer`` (k-step windows kept)
    unless the caller asks for a sync mode."""
    from bigdl_tpu_torch.dataset.shards import ShardFolder, ShardWriter
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.optim import LocalOptimizer, Optimizer
    with ShardWriter(str(tmp_path / "part"), records_per_shard=2) as w:
        for i in range(4):
            w.write(float(i + 1), bytes([i]))
    ds = ShardFolder.stream(str(tmp_path))
    assert ds.is_distributed() and not torch.distributed.is_initialized()
    model = lenet.build(10, device="cpu")
    opt = Optimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
    assert type(opt) is LocalOptimizer and opt.supports_multi_dispatch
    opt = Optimizer(model, ds, nn.ClassNLLCriterion(), device="cpu",
                    sync_mode="allreduce")
    assert isinstance(opt, DistriOptimizer) and opt.mesh.size == 1


# ------------------------------------------------------- gloo ranks
@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    from bigdl_tpu_torch.dataset.shards import ShardWriter
    out = tmp_path_factory.mktemp("plane")
    (out / "shards").mkdir()
    with ShardWriter(str(out / "shards" / "part"),
                     records_per_shard=2) as w:
        for i in range(10):
            w.write(float(i + 1), bytes([i]))
    procs = worker.spawn(out, 2, ["data", "validation", "preempt",
                                  "broadcast", "ckpt_save"])
    done = []

    def result():
        if not done:
            worker.wait(procs, out)
            done.append(True)
        return out
    yield result
    for p in procs:
        p.kill()


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_each_rank_holds_its_records(world2):
    out = world2()
    got = [_json(out / f"data.{r}.json") for r in range(2)]
    assert [g["array"] for g in got] == [[0, 2, 4, 6, 8], [1, 3, 5, 7, 9]]
    names = [f"part-{i:05d}.bigdl-shard" for i in range(5)]
    assert [g["shard_files"] for g in got] == [names[0::2], names[1::2]]
    assert [g["stream_labels"] for g in got] == [[1, 2, 5, 6, 9, 10],
                                                 [3, 4, 7, 8]]
    assert all(g["stream_distributed"] for g in got)
    for r, g in enumerate(got):
        mine = [float(i) for i in range(r, 16, 2)]
        # a global batch of 8: 4 rows a rank, a permutation of its records
        assert [len(b) for b in g["cache"]] == [4, 4]
        assert sorted(sum(g["cache"], [])) == mine
        assert g["cache_eval"] == [mine[:4], mine[4:]]
    assert got[0]["cache"] != [got[0]["cache_eval"]]


def test_validation_merges_the_ranks(world2):
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.optim.evaluator import Evaluator
    from bigdl_tpu_torch.optim.validation import Loss, Top1Accuracy
    out = world2()
    got = [_json(out / f"validation.{r}.json") for r in range(2)]
    assert got[0] == got[1] and got[0]["records"] == 20
    model = lenet.build(10, device="cpu", seed=3)
    want = Evaluator(model, 20, device="cpu").test(
        DataSet.array(worker.lenet_samples(24)[:20]) >> SampleToBatch(20),
        [Top1Accuracy(), Loss(nn.ClassNLLCriterion())])
    acc, loss = (r.state() for r, _ in want)
    assert got[0]["results"]["Top1Accuracy"] == list(acc)
    assert got[0]["results"]["Loss"][1] == loss[1]
    assert got[0]["results"]["Loss"][0] == pytest.approx(loss[0], rel=1e-5)


def test_model_broadcast_predicts_with_rank_0s_weights(world2):
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.optim.evaluator import Predictor
    out = world2()
    got = [np.load(out / f"broadcast.{r}.npz")["out"] for r in range(2)]
    want = Predictor(lenet.build(10, device="cpu", seed=0), 8,
                     device="cpu").predict(
        DataSet.array(worker.lenet_samples(8)) >> SampleToBatch(8))[0]
    np.testing.assert_array_equal(got[0], got[1])
    np.testing.assert_allclose(got[0], want.numpy(), rtol=1e-6, atol=1e-6)


def test_preemption_is_agreed(world2):
    out = world2()
    got = [_json(out / f"preempt.{r}.json") for r in range(2)]
    # the notice came after step 3 on rank 1; the ranks agree every 2
    assert [g["stopped_after"] for g in got] == [4, 4]
    assert [g["local_notice"] for g in got] == [False, True]
    # one snapshot, tagged with the next neval as every snapshot is
    assert [p.name for p in (out / "preempt_ckpt").iterdir()
            if p.name.startswith("model")] == ["model.5"]


@pytest.fixture(scope="module")
def restored(world2):
    out = world2()
    procs = worker.spawn(out, 4, ["ckpt_restore"])
    worker.wait(procs, out)
    return out


def test_sharded_snapshot_restores_at_another_world(restored):
    from bigdl_tpu_torch.resilience import coordinator
    from bigdl_tpu_torch.telemetry import get_registry, instruments
    out = restored
    full = dict(np.load(out / "ckpt_full.0.npz"))
    point = coordinator.latest_resume_point(str(out / "fsdp_ckpt"))
    assert point.neval == 2 and point.sharded
    assert point.marker["mesh"] == {
        "process_count": 2, "device_count": 2, "mesh_shape": {"data": 2},
        "sync_mode": "fsdp"}
    assert sorted(p.name for p in (out / "fsdp_ckpt" / "model.2").iterdir()
                  if p.suffix == ".npz") == ["shard-00000.npz",
                                             "shard-00001.npz"]
    counter = instruments(get_registry()).resilience_resumes_total.labels(
        elastic="true")
    before = counter.value
    w1 = worker.ckpt_run(str(out), 1, steps=4, resume=True)
    assert counter.value == before + 1
    w4 = dict(np.load(out / "ckpt_restore_w4.0.npz"))
    for k, v in full.items():
        np.testing.assert_allclose(w4[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
        np.testing.assert_allclose(w1[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
