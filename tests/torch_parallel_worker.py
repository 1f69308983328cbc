"""One rank of the port's data-parallel tests (not a pytest file).

Usage: python torch_parallel_worker.py <outdir> <job> [<job> ...]

The rank joins a gloo process group on the CPU from the reference's
environment (``BIGDL_COORDINATOR_ADDRESS``, ``BIGDL_NUM_PROCESSES``,
``BIGDL_PROCESS_ID``) and runs each job in turn; a job's results go to
``<outdir>`` as ``<job>.<rank>.npz`` / ``.json`` for the parent test to
hold against the reference. Imports no JAX.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bigdl_tpu_torch import nn  # noqa: E402
from bigdl_tpu_torch.dataset.base import (DataSet, Sample,  # noqa: E402
                                          SampleToBatch)
from bigdl_tpu_torch.dataset.device_cache import DeviceCachedDataSet  # noqa
from bigdl_tpu_torch.interop.state_dict import (export_tree_state,  # noqa
                                                import_tree_state)
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger  # noqa: E402
from bigdl_tpu_torch.parallel import mesh as mesh_mod  # noqa: E402
from bigdl_tpu_torch.utils.engine import Engine  # noqa: E402
from bigdl_tpu_torch.utils.rng import RandomGenerator  # noqa: E402

#: the LeNet runs: (name, sync_mode, dataset kind, compress_gradients)
LENET_RUNS = (("allreduce", "allreduce", "host", False),
              ("sharded", "sharded", "host", False),
              ("fsdp", "fsdp", "host", False),
              ("cached", "allreduce", "cached", False))
LENET_BF16_RUNS = (("allreduce_bf16", "allreduce", "host", True),
                   ("sharded_bf16", "sharded", "host", True),
                   ("fsdp_bf16", "fsdp", "host", True))


def lenet_samples(n=32):
    rng = np.random.default_rng(0)
    return [Sample(rng.normal(0, 1, (28, 28, 1)).astype("float32"),
                   float(rng.integers(1, 11))) for _ in range(n)]


def load_init(outdir, name):
    with np.load(os.path.join(outdir, name)) as z:
        params = {k[2:]: z[k] for k in z.files if k.startswith("p:")}
        buffers = {k[2:]: z[k] for k in z.files if k.startswith("b:")}
    return params, buffers


def save(outdir, name, rank, arrays):
    np.savez(os.path.join(outdir, f"{name}.{rank}.npz"), **arrays)


def job_lenet(outdir, rank, world, runs=LENET_RUNS):
    from bigdl_tpu_torch.models import lenet
    params, _ = load_init(outdir, "lenet_init.npz")
    for name, mode, kind, compress in runs:
        RandomGenerator.RNG().set_seed(42)
        model = lenet.build(10, device="cpu")
        import_tree_state(model, params, {})
        if kind == "cached":
            ds = DeviceCachedDataSet(DataSet.array(lenet_samples(),
                                                   distributed=True),
                                     32, device="cpu")
        else:
            ds = (DataSet.array(lenet_samples(), distributed=True)
                  >> SampleToBatch(32 // world))
        opt = Optimizer(model, ds, nn.ClassNLLCriterion(), device="cpu",
                        sync_mode=mode, compress_gradients=compress)
        opt.set_optim_method(SGD(learningrate=0.05, momentum=0.9))
        opt.set_end_when(Trigger.max_iteration(3))
        opt.optimize()
        save(outdir, f"lenet_{name}", rank, export_tree_state(model)[0])


def bn_net(fused: bool):
    """conv3x3+BN, ReLU, conv1x1+BN, ReLU, mean pool, Linear: the fused
    modules (K6/K5 on a card) or the plain ones."""
    from bigdl_tpu_torch.nn import fused as fz
    from bigdl_tpu_torch.nn.containers import Sequential
    gen = torch.Generator().manual_seed(0)
    if fused:
        a = fz.FusedConv3x3BN(4, 8, generator=gen)
        b = fz.FusedConv1x1BN(8, 8, generator=gen)
    else:
        a = Sequential().add(nn.SpatialConvolution(4, 8, 3, 3, 1, 1, 1, 1,
                                                   with_bias=False,
                                                   generator=gen)) \
            .add(nn.SpatialBatchNormalization(8))
        b = Sequential().add(nn.SpatialConvolution(8, 8, 1, 1,
                                                   with_bias=False,
                                                   generator=gen)) \
            .add(nn.SpatialBatchNormalization(8))
    return (Sequential().add(a).add(nn.ReLU()).add(b).add(nn.ReLU())
            .add(nn.Mean(2)).add(nn.Mean(2))
            .add(nn.Linear(8, 3, generator=gen))
            .add(nn.LogSoftMax()))


def bn_samples(n=16):
    rng = np.random.default_rng(5)
    # channel offsets make the per-rank and global statistics differ
    return [Sample((rng.normal(0, 1, (6, 6, 4)) + (i % 2) * 2.0)
                   .astype("float32"), float(i % 3 + 1)) for i in range(n)]


def job_bn(outdir, rank, world, fused):
    tag = "fused" if fused else "plain"
    params, buffers = load_init(outdir, f"bn_init_{tag}.npz")
    for mode in ("allreduce", "sharded"):
        model = bn_net(fused)
        import_tree_state(model, params, buffers)
        # rank r's records are r, r + world, ...: the reference's
        # global batch of 16 in one step each iteration
        ds = (DataSet.array(bn_samples(), distributed=True)
              >> SampleToBatch(16 // world))
        opt = Optimizer(model, ds, nn.ClassNLLCriterion(), device="cpu",
                        sync_mode=mode)
        opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
        opt.set_end_when(Trigger.max_iteration(3))
        opt.optimize()
        p, b = export_tree_state(model)
        save(outdir, f"bn_{tag}_{mode}", rank,
             {**{"p:" + k: v for k, v in p.items()},
              **{"b:" + k: v for k, v in b.items()},
              "loss": np.array([h["loss"] for h in opt.history])})


def clip_samples():
    rng = np.random.default_rng(9)
    return [Sample(rng.normal(0, 3, (6,)).astype("float32"),
                   float(i % 5 + 1)) for i in range(16)]


def job_clip(outdir, rank, world):
    """L2 clipping in sharded mode over 6x3 + 3 + 3x5 + 5 = 41 parameters,
    padded to a multiple of the world (and in allreduce mode)."""
    params, _ = load_init(outdir, "clip_init.npz")
    for mode in ("sharded", "allreduce"):
        from bigdl_tpu_torch.nn.containers import Sequential
        model = (Sequential().add(nn.Linear(6, 3)).add(nn.Tanh())
                 .add(nn.Linear(3, 5)).add(nn.LogSoftMax()))
        import_tree_state(model, params, {})
        samples = clip_samples()
        ds = DataSet.array(samples, distributed=True) >> SampleToBatch(
            16 // world)
        opt = Optimizer(model, ds, nn.ClassNLLCriterion(), device="cpu",
                        sync_mode=mode)
        opt.set_optim_method(SGD(learningrate=0.5))
        opt.set_gradient_clipping_by_l2_norm(0.05)
        opt.set_end_when(Trigger.max_iteration(3))
        opt.optimize()
        save(outdir, f"clip_{mode}", rank, export_tree_state(model)[0])


def job_data(outdir, rank, world):
    """Each rank's records from DataSet.array, a shard set and the cache."""
    from bigdl_tpu_torch.dataset import shards
    got = {"array": [float(s.feature[0]) for s in DataSet.array(
        [Sample(np.array([float(i)], np.float32), 1.0) for i in range(10)],
        distributed=True).data(train=False)]}
    folder = os.path.join(outdir, "shards")
    got["shard_files"] = [os.path.basename(f)
                          for f in shards.ShardFolder.paths(folder)]
    stream = shards.ShardFolder.stream(folder)
    got["stream_labels"] = [float(r.label) for r in stream.data(train=False)]
    got["stream_distributed"] = stream.is_distributed()
    from bigdl_tpu_torch.parallel.mesh import MeshTopology
    mesh = MeshTopology(data=world).build()
    cache = DeviceCachedDataSet(DataSet.array(
        [Sample(np.array([float(i)], np.float32), 1.0) for i in range(16)],
        distributed=True), 8, device="cpu")
    cache.set_mesh(mesh)
    RandomGenerator.RNG().set_seed(3)
    got["cache"] = [b.data.numpy().ravel().tolist()
                    for b in cache.data(train=True)]
    got["cache_eval"] = [b.data.numpy().ravel().tolist()
                         for b in cache.data(train=False)]
    with open(os.path.join(outdir, f"data.{rank}.json"), "w") as f:
        json.dump(got, f)


def job_validation(outdir, rank, world):
    """Validation of a distributed set merged over the ranks."""
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.optim.validation import Loss, Top1Accuracy
    model = lenet.build(10, device="cpu", seed=3)
    samples = lenet_samples(24)
    ds = DataSet.array(samples, distributed=True) >> SampleToBatch(
        16 // world)
    val = DataSet.array(samples[:20], distributed=True) >> SampleToBatch(
        4, drop_remainder=False)
    opt = Optimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(SGD(learningrate=0.0))
    opt.set_validation(Trigger.every_epoch(), val,
                       [Top1Accuracy(), Loss(nn.ClassNLLCriterion())])
    opt.set_end_when(Trigger.max_iteration(1))
    opt.optimize()
    res = opt.validation_history[-1]
    out = {"records": res["records"],
           "results": {k: list(v.state()) for k, v in res["results"].items()}}
    with open(os.path.join(outdir, f"validation.{rank}.json"), "w") as f:
        json.dump(out, f)


def job_preempt(outdir, rank, world):
    """A preemption notice on rank 1 only: every rank stops at the agreed
    step (every 2 steps) with one snapshot."""
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.resilience.preemption import (PreemptionHandler,
                                                       TrainingPreempted)
    os.environ["BIGDL_PREEMPT_SYNC_EVERY"] = "2"
    model = lenet.build(10, device="cpu", seed=3)
    ds = DataSet.array(lenet_samples(64), distributed=True) >> SampleToBatch(
        8 // world)
    handler = PreemptionHandler(signals=())

    class Notice:   # a notice after step 3, on rank 1 alone
        def on_step(self, neval):
            if neval == 3 and rank == 1:
                handler.trigger("test notice")

    ckpt = os.path.join(outdir, "preempt_ckpt")
    opt = Optimizer(model, ds, nn.ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(SGD(learningrate=0.01))
    opt.set_checkpoint(ckpt, Trigger.max_iteration(10 ** 6))
    opt.set_preemption_handler(handler).set_chaos([Notice()])
    opt.set_end_when(Trigger.max_iteration(10))
    stopped = None
    try:
        opt.optimize()
    except TrainingPreempted:
        stopped = len(opt.history)
    with open(os.path.join(outdir, f"preempt.{rank}.json"), "w") as f:
        json.dump({"stopped_after": stopped,
                   "local_notice": handler.should_snapshot()}, f)


def job_broadcast(outdir, rank, world):
    """Each rank builds LeNet from its own seed; the broadcast weights
    (rank 0's) predict on every rank."""
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.parallel import ModelBroadcast
    from bigdl_tpu_torch.parallel.mesh import MeshTopology
    model = lenet.build(10, device="cpu", seed=rank)
    mine = export_tree_state(model)[0]
    bc = ModelBroadcast(model, MeshTopology(data=world).build())
    assert bc.value()[0] is model
    out = bc.predictor(8).predict(DataSet.array(lenet_samples(8))
                                  >> SampleToBatch(8))
    # the caller's module keeps its own weights
    assert all(np.array_equal(v, mine[k])
               for k, v in export_tree_state(model)[0].items())
    save(outdir, "broadcast", rank, {"out": out[0].numpy()})


def ckpt_run(outdir, world, steps, save=False, resume=False):
    """LeNet in fsdp mode, SGD with momentum, one global batch of all 32
    records a step (so any world size trains the same steps); ``save``: a
    sharded snapshot at step 2; ``resume``: from the newest snapshot.
    Returns the final parameters."""
    from bigdl_tpu_torch.models import lenet
    from bigdl_tpu_torch.resilience import coordinator
    model = lenet.build(10, device="cpu", seed=3)
    ds = (DataSet.array(lenet_samples(), distributed=True, seed=0)
          >> SampleToBatch(32 // world))
    opt = Optimizer(model, ds, nn.ClassNLLCriterion(), device="cpu",
                    sync_mode="fsdp")
    opt.set_optim_method(SGD(learningrate=0.05, momentum=0.9))
    ckpt = os.path.join(outdir, "fsdp_ckpt")
    if save:
        opt.set_checkpoint(ckpt, Trigger.several_iteration(2), sharded=True)
    if resume:
        point = coordinator.latest_resume_point(ckpt)
        opt.resume(point.model_path, point.state_path)
    opt.set_end_when(Trigger.max_iteration(steps))
    opt.optimize()
    return export_tree_state(model)[0]


def job_ckpt_save(outdir, rank, world):
    """A sharded snapshot at step 2, then the uninterrupted 4 steps."""
    ckpt_run(outdir, world, steps=2, save=True)
    save(outdir, "ckpt_full", rank, ckpt_run(outdir, world, steps=4))


def job_ckpt_restore(outdir, rank, world):
    save(outdir, f"ckpt_restore_w{world}", rank,
         ckpt_run(outdir, world, steps=4, resume=True))


def job_uneven(outdir, rank, world):
    """C.8: 5 records over the ranks (3 and 2 at world 2), a batch of one,
    two epochs: every rank ends, at the agreed iteration count."""
    rng = np.random.default_rng(11)
    samples = [Sample(rng.normal(0, 1, (4,)).astype("float32"),
                      np.float32(rng.normal())) for _ in range(5)]
    torch.manual_seed(0)
    model = nn.Linear(4, 1)
    ds = DataSet.array(samples, distributed=True) >> SampleToBatch(1)
    opt = Optimizer(model, ds, nn.MSECriterion(), device="cpu",
                    sync_mode="allreduce")
    opt.set_optim_method(SGD(learningrate=0.1))
    opt.set_end_when(Trigger.max_epoch(2))
    opt.optimize()
    save(outdir, "uneven", rank, {
        **export_tree_state(model)[0],
        "iterations": np.array([len(opt.history)]),
        "epochs": np.array([h["epoch"] for h in opt.history])})


def _grads(module):
    return {n: (p.grad if p.grad is not None else torch.zeros_like(p))
            for n, p in module.named_parameters()}


def job_tp(outdir, rank, world):
    """Over MeshTopology(data=2, tensor=2): (1) the TransformerEncoderLayer
    of ``tp_layer.npz`` sharded over the tensor axis, without and with
    sequence-parallel regions: forward, input and (reassembled) weight
    gradients, and the collectives of one forward and backward; (2) the
    MLP of ``tp_mlp.npz`` trained 4 SGD-momentum steps at dp=2 x tp=2."""
    from bigdl_tpu_torch.nn.containers import Sequential
    from bigdl_tpu_torch.parallel import tensor_parallel as tp
    from bigdl_tpu_torch.parallel.mesh import COLLECTIVES, MeshTopology
    mesh = MeshTopology(data=2, tensor=2).build()
    z = np.load(os.path.join(outdir, "tp_layer.npz"))
    params = {k[2:]: z[k] for k in z.files if k.startswith("p:")}
    out = {}
    for sp in (False, True):
        layer = nn.TransformerEncoderLayer(
            16, 4, 32, activation="swiglu", rope=True, num_kv_heads=2,
            causal=True)
        import_tree_state(layer, params, {})
        tp.shard_parameters(layer, mesh)
        if sp:
            assert tp.enable_sequence_parallel(layer, mesh) == 1
        x = torch.from_numpy(z["x"]).requires_grad_()
        COLLECTIVES.reset()
        y = layer(x)
        (y * torch.from_numpy(z["cot"])).sum().backward()
        counts = dict(COLLECTIVES.by_axis)
        grads = _grads(layer)
        partial = tp.sp_partial_params(layer)
        for n in partial:
            mesh.all_reduce(grads[n], axis="tensor")
        grads = tp.gather_full(layer, grads)
        tag = "sp" if sp else "tp"
        out[f"{tag}:y"] = y.detach().numpy()
        out[f"{tag}:dx"] = x.grad.numpy()
        out.update({f"{tag}:g:{n}": g.numpy() for n, g in grads.items()})
        out[f"{tag}:partial"] = np.array(sorted(partial))
        with open(os.path.join(outdir, f"tp_counts_{tag}.{rank}.json"),
                  "w") as f:
            json.dump(counts, f)
        # the full leaves, reassembled bit for bit
        full = export_tree_state(layer)[0]
        out[f"{tag}:roundtrip"] = np.array(
            all(np.array_equal(full[k], params[k]) for k in params))
        out[f"{tag}:in_proj_local"] = layer.self_attn.in_proj_weight \
            .detach().numpy()
        # the full arrays carried into the sharded layer: this rank's slices
        local = {n: p.detach().clone() for n, p in layer.named_parameters()}
        import_tree_state(layer, params, {})
        out[f"{tag}:import_local"] = np.array(all(
            torch.equal(p, local[n]) for n, p in layer.named_parameters()))
    # (1b) a lone column Linear (its output gathered) and a lone row one
    # (its input split) against the same layers whole
    for mode in (tp.COLUMN, tp.ROW):
        gen = torch.Generator().manual_seed(4)
        lone = nn.Linear(12, 16, generator=gen)
        lone.tp_mode = mode
        whole = nn.Linear(12, 16)
        whole.load_state_dict(lone.state_dict())
        tp.shard_parameters(lone, mesh)
        x = torch.randn(3, 12, generator=gen)
        xs, xw = x.clone().requires_grad_(), x.clone().requires_grad_()
        ys, yw = lone(xs), whole(xw)
        ys.square().sum().backward()
        yw.square().sum().backward()
        grads = tp.gather_full(lone, _grads(lone))
        out[f"lone_{mode}:err"] = np.array(max(
            (ys - yw).abs().max().item(), (xs.grad - xw.grad).abs().max()
            .item(), *((grads[n] - p.grad).abs().max().item()
                       for n, p in whole.named_parameters())))
    # (2) dp x tp training
    zm = np.load(os.path.join(outdir, "tp_mlp.npz"))
    mlp = (Sequential().add(nn.Linear(12, 16)).add(nn.ReLU())
           .add(nn.Linear(16, 5)).add(nn.LogSoftMax()))
    import_tree_state(mlp, {k[2:]: zm[k] for k in zm.files
                            if k.startswith("p:")}, {})
    samples = [Sample(f, float(l)) for f, l in zip(zm["x"], zm["y"])]
    ds = DataSet.array(samples, distributed=True) >> SampleToBatch(8)
    opt = Optimizer(mlp, ds, nn.ClassNLLCriterion(), device="cpu",
                    topology=MeshTopology(data=2, tensor=2))
    opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
    ckpt = os.path.join(outdir, "tp_ckpt")
    opt.set_checkpoint(ckpt, Trigger.several_iteration(2))
    opt.set_end_when(Trigger.max_iteration(4))
    opt.optimize()
    out.update({"mlp:" + k: v for k, v in export_tree_state(mlp)[0].items()})
    if rank == 0:
        # the tp=2 snapshot after iteration 1 (``model.2``: the next is 2;
        # full leaves) resumed by one process without a group, to 4
        one = (Sequential().add(nn.Linear(12, 16)).add(nn.ReLU())
               .add(nn.Linear(16, 5)).add(nn.LogSoftMax()))
        again = Optimizer(one, DataSet.array(samples) >> SampleToBatch(16),
                          nn.ClassNLLCriterion(), device="cpu")
        again.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
        again.resume(os.path.join(ckpt, "model.2"),
                     os.path.join(ckpt, "state.2"))
        again.set_end_when(Trigger.max_iteration(4))
        again.optimize()
        out.update({"mlp_tp1:" + k: v
                    for k, v in export_tree_state(one)[0].items()})
        out["mlp_tp1:iterations"] = np.array(len(again.history))
    out["mlp:local_weight_shape"] = np.array(
        list(mlp._modules.values())[0].weight.shape)
    save(outdir, "tp", rank, out)


def job_cli(outdir, rank, world):
    """``apps.transformer train`` at this world: ``--tensorParallel 2``
    (data = world / 2, sequence-parallel regions) and ``--contextParallel
    ring --ringLayout zigzag``; each run's losses."""
    from bigdl_tpu_torch.apps import transformer as app
    tiny = ["--device", "cpu", "--backend", "gloo", "-e", "1",
            "--synthetic-size", "8", "--vocab", "16", "--embedDim", "16",
            "--numHeads", "4", "--numLayers", "1", "--llamaBlock"]
    runs = {}
    opt, _ = app.optimizer(tiny + ["-b", "4", "--seqLen", "8",
                                   "--tensorParallel", "2"])
    opt.optimize()
    runs["tp"] = [h["loss"] for h in opt.history]
    run, _ = app.optimizer(tiny + ["-b", "4", "--seqLen", "16",
                                   "--contextParallel", "ring",
                                   "--ringLayout", "zigzag"])
    run.optimize()
    runs["cp"] = [h["loss"] for h in run.history]
    with open(os.path.join(outdir, f"cli.{rank}.json"), "w") as f:
        json.dump(runs, f)


#: ring_self_attention's cases: (mode, layout, use_kernel, causal)
CP_CASES = [("ring", layout, kernel, causal)
            for layout in ("contiguous", "zigzag")
            for kernel in (False, True) for causal in (False, True)] + [
    ("ulysses", "contiguous", None, causal) for causal in (False, True)]
#: the tiny Llama-recipe LM of the context-parallel and decode jobs
TINY_LM = dict(embed_dim=16, num_heads=4, num_kv_heads=2, ffn_dim=32,
               num_layers=2, max_len=64, rope=True, activation="swiglu",
               norm="rms", bias=False, tie_embeddings=True)
CP_LM_CASES = (("ring", "contiguous"), ("ring", "zigzag"),
               ("ulysses", "contiguous"))


def cp_case_name(case):
    mode, layout, kernel, causal = case
    return (f"{mode}_{layout}_{'kernel' if kernel else 'partial'}"
            f"_{'causal' if causal else 'full'}")


def job_cp(outdir, rank, world):
    """Context parallelism over MeshTopology(sequence=world): (1) the
    attention of ``cp.npz`` through ``ring_self_attention`` in each of
    CP_CASES, its output and input gradients and collectives; (2) the tiny
    LM of ``cp_lm.npz`` built with ``seq_axis`` in each of CP_LM_CASES
    through ``ContextParallelLM``: its gathered log-probs, and its first
    step's gradients (the ranks' sum) beside the whole model's."""
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.parallel.context import (ContextParallelLM,
                                                  ring_self_attention)
    from bigdl_tpu_torch.parallel.mesh import COLLECTIVES, MeshTopology
    mesh = MeshTopology(sequence=world).build()
    z = np.load(os.path.join(outdir, "cp.npz"))
    out, counts = {}, {}
    for case in CP_CASES:
        mode, layout, kernel, causal = case
        name = cp_case_name(case)
        q, k, v = (torch.from_numpy(z[a]).requires_grad_()
                   for a in ("q", "k", "v"))
        COLLECTIVES.reset()
        o = ring_self_attention(q, k, v, mesh, "seq", causal=causal,
                                mode=mode, use_kernel=kernel, layout=layout)
        (o * torch.from_numpy(z["cot"])).sum().backward()
        counts[name] = dict(COLLECTIVES.by_axis)
        out[f"{name}:o"] = o.detach().numpy()
        for a, t in (("q", q), ("k", k), ("v", v)):
            out[f"{name}:d{a}"] = t.grad.numpy()
    zl = np.load(os.path.join(outdir, "cp_lm.npz"))
    params = {k[2:]: zl[k] for k in zl.files if k.startswith("p:")}
    tokens = torch.from_numpy(zl["tokens"])
    targets = torch.from_numpy(zl["targets"])
    crit = nn.FusedLMHeadCriterion()
    whole = build_lm(64, **TINY_LM, device="cpu")
    import_tree_state(whole, params, {})
    whole.train()
    crit.forward(whole(tokens), targets).backward()
    for n, g in _grads(whole).items():
        out[f"whole:g:{n}"] = g.numpy()
    for mode, layout in CP_LM_CASES:
        tag = f"lm_{mode}_{layout}"
        model = build_lm(64, **TINY_LM, device="cpu", seq_axis="seq",
                         seq_mode=mode, seq_layout=layout)
        import_tree_state(model, params, {})
        lm = ContextParallelLM(model, mesh, layout=layout)
        model.eval()
        with torch.no_grad():
            out[f"{tag}:logp"] = lm.unshard(lm(tokens)).numpy()
        model.train()
        loss = crit.forward(lm(tokens), lm.shard(targets)) / world
        loss.backward()
        for n, g in _grads(model).items():
            mesh.all_reduce(g, axis="seq")
            out[f"{tag}:g:{n}"] = g.numpy()
    save(outdir, "cp", rank, out)
    with open(os.path.join(outdir, f"cp_counts.{rank}.json"), "w") as f:
        json.dump(counts, f)


def job_decode(outdir, rank, world):
    """generate(mesh=...) of the tiny LM of ``decode.npz``: dp-decode over
    MeshTopology(data=world) and tp-decode over MeshTopology(tensor=world),
    greedy, and the model whole again after the tp call."""
    from bigdl_tpu_torch.models.generation import generate
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.parallel.mesh import COLLECTIVES, MeshTopology
    z = np.load(os.path.join(outdir, "decode.npz"))
    params = {k[2:]: z[k] for k in z.files if k.startswith("p:")}
    model = build_lm(64, **TINY_LM, device="cpu")
    import_tree_state(model, params, {})
    prompt = torch.from_numpy(z["prompt"])
    out = {}
    COLLECTIVES.reset()
    out["dp"] = generate(model, prompt, 6, greedy=True, device="cpu",
                         mesh=MeshTopology(data=world).build()).numpy()
    out["dp_collectives"] = np.array(COLLECTIVES.by_axis.get(
        "all_gather/data", 0))
    tmesh = MeshTopology(tensor=world).build()
    out["tp"] = generate(model, prompt, 6, greedy=True, device="cpu",
                         mesh=tmesh, tensor_axis="tensor").numpy()
    out["tp_then_whole"] = np.array(all(
        np.array_equal(v, params[k])
        for k, v in export_tree_state(model)[0].items()))
    with pytest_raises(ValueError, "not a multiple"):
        generate(model, prompt[:3], 2, greedy=True, device="cpu",
                 mesh=MeshTopology(data=world).build())
    with pytest_raises(ValueError, "no 'data' axis"):
        generate(model, prompt, 2, greedy=True, device="cpu", mesh=tmesh)
    with pytest_raises(ValueError, "is not a mesh axis"):
        generate(model, prompt, 2, greedy=True, device="cpu", mesh=tmesh,
                 tensor_axis="model")
    save(outdir, "decode", rank, out)


# ------------------------------------------------ expert and pipeline axes
def _np_grads(module):
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()}


def _moe_from(z, prefix="m:"):
    from bigdl_tpu_torch.parallel.expert import MoE
    cfg = json.loads(str(z[prefix + "cfg"]))
    m = MoE(cfg["d"], cfg["h"], cfg["e"], k=cfg["k"],
            capacity_factor=cfg["cf"], aux_loss_weight=cfg["aux"])
    import_tree_state(m, {k[len(prefix) + 2:]: z[k] for k in z.files
                          if k.startswith(prefix + "p:")}, {})
    return m


def job_ep(outdir, rank, world):
    """The expert axis and global routing: at world 4 over
    MeshTopology(expert=4) and MeshTopology(data=2, expert=2), at world 2
    over MeshTopology(expert=2) and MeshTopology(data=2): the MoE of
    ``ep.npz``'s forward (eval), its routing, and the gradients of
    ``sum(y * cot)`` in training mode (aux loss in); then a DistriOptimizer
    run of ``ep_mlp.npz`` (SGD-momentum, L2 clip, 4 iterations of its one
    global batch, dealt rank-major by data coordinate) over data x expert,
    and the refused sync modes."""
    from bigdl_tpu_torch.dataset.base import DistributedDataSet, MiniBatch
    from bigdl_tpu_torch.parallel import expert
    from bigdl_tpu_torch.parallel.mesh import MeshTopology
    z = np.load(os.path.join(outdir, "ep.npz"))
    x_all, cot_all = z["x"], z["cot"]
    topos = ({"e4": dict(expert=4), "d2e2": dict(data=2, expert=2)}
             if world == 4 else {"e2": dict(expert=2), "d2": dict(data=2)})
    out = {}
    for tag, axes in topos.items():
        mesh = MeshTopology(**axes).build()
        n_data, r = mesh.axis_size("data"), mesh.axis_index("data")
        per = x_all.shape[0] // n_data
        x = x_all[r * per:(r + 1) * per]
        cot = cot_all[r * per:(r + 1) * per]
        m = _moe_from(z)
        if axes.get("expert", 1) > 1:
            expert.shard_experts(m, mesh)
        m.record_routing = True
        with torch.no_grad(), expert.global_routing(m, mesh):
            y = m.eval()(torch.from_numpy(x))
        out[f"{tag}:y"] = y.numpy()
        out[f"{tag}:keep"] = m.routing["keep"].numpy()
        out[f"{tag}:picks"] = m.routing["picks"].numpy()
        m.train()
        xt = torch.from_numpy(x).requires_grad_()
        with expert.global_routing(m, mesh):
            (m(xt) * torch.from_numpy(cot)).sum().backward()
        grads = _np_grads(m)
        # the data ranks' mean gradient is the global one
        for n in grads:
            mesh.all_reduce(grads[n], op="avg")
        if getattr(m, "_ep_mesh", None) is not None:
            out[f"{tag}:gate_local"] = grads["gate_weight"].numpy()
            grads = expert.gather_experts(m, grads)
        out.update({f"{tag}:g:{n}": g.numpy() for n, g in grads.items()})
        out[f"{tag}:dx"] = xt.grad.numpy()
        out[f"{tag}:w1_rows"] = np.array(m.w1.shape[0])
    # DistriOptimizer over data x expert on the global batches, rank-major
    topo = (dict(data=2, expert=2) if world == 4 else dict(expert=2))
    model, opt = _ep_mlp_optimizer(outdir, rank, world, topo)
    opt.optimize()
    out.update({"opt:" + k: v for k, v in export_tree_state(model)[0].items()})
    out["opt:loss"] = np.array([h["loss"] for h in opt.history])
    for mode in ("sharded", "fsdp"):
        with pytest_raises(ValueError, "does not compose with this topology"):
            Optimizer(nn.Linear(4, 4), DistributedDataSet(
                [MiniBatch(torch.zeros(2, 4), torch.ones(2))],
                shard_by_process=False), nn.MSECriterion(), device="cpu",
                topology=MeshTopology(**topo), sync_mode=mode)
    save(outdir, "ep", rank, out)


def _ep_mlp_optimizer(outdir, rank, world, topo):
    """``ep_mlp.npz``'s model (Linear, ReLU, MoE, Linear, LogSoftMax) and
    a DistriOptimizer over ``topo`` (SGD-momentum, L2 clip, 4 iterations
    of its one global batch, dealt rank-major by data coordinate)."""
    from bigdl_tpu_torch.dataset.base import DistributedDataSet, MiniBatch
    from bigdl_tpu_torch.nn.containers import Sequential
    from bigdl_tpu_torch.parallel.mesh import MeshTopology
    zm = np.load(os.path.join(outdir, "ep_mlp.npz"))
    n_data = topo.get("data", 1)
    model = (Sequential().add(nn.Linear(12, 16)).add(nn.ReLU())
             .add(_moe_from(zm)).add(nn.Linear(16, 5)).add(nn.LogSoftMax()))
    import_tree_state(model, {k[2:]: zm[k] for k in zm.files
                              if k.startswith("p:")}, {})
    coord = rank // (world // n_data)
    per = zm["x"].shape[1] // n_data
    batches = [MiniBatch(torch.from_numpy(bx[coord * per:(coord + 1) * per]),
                         torch.from_numpy(by[coord * per:(coord + 1) * per]))
               for bx, by in zip(zm["x"], zm["y"])]
    opt = Optimizer(model, DistributedDataSet(batches, shard_by_process=False),
                    nn.ClassNLLCriterion(), device="cpu",
                    topology=MeshTopology(**topo))
    opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
    opt.set_gradient_clipping_by_l2_norm(0.5)
    opt.set_end_when(Trigger.max_iteration(4))
    return model, opt


def job_ep_eval(outdir, rank, world):
    """Global routing stays inside the training step: ``ep_mlp.npz``'s
    model trained over MeshTopology(data=2) with its validation batches
    (``vx``, ``vy``) set twice, as a plain set (every rank scores all of
    it) and as a distributed set dealt unevenly (3 batches: 2 and 1);
    then a forward of the first validation batch on rank 0 alone."""
    from bigdl_tpu_torch.dataset.base import DistributedDataSet, MiniBatch
    from bigdl_tpu_torch.optim.validation import Loss, Top1Accuracy
    zm = np.load(os.path.join(outdir, "ep_mlp.npz"))
    val = [MiniBatch(torch.from_numpy(bx), torch.from_numpy(by))
           for bx, by in zip(zm["vx"], zm["vy"])]
    out = {}
    for tag, ds in (("plain", DataSet.array(val)),
                    ("uneven", DistributedDataSet(val))):
        model, opt = _ep_mlp_optimizer(outdir, rank, world, dict(data=2))
        opt.set_validation(Trigger.every_epoch(), ds,
                           [Top1Accuracy(), Loss(nn.ClassNLLCriterion())])
        opt.optimize()
        res = opt.validation_history[-1]
        out[f"{tag}:records"] = np.array(res["records"])
        for name, r in res["results"].items():
            out[f"{tag}:{name}"] = np.array(r.state(), np.float64)
        out.update({f"{tag}:p:{k}": v
                    for k, v in export_tree_state(model)[0].items()})
    if rank == 0:   # nothing runs on rank 1: this forward must not wait
        with torch.no_grad():
            out["solo_y"] = model.eval()(val[0].data).numpy()
    save(outdir, "ep_eval", rank, out)


def job_fsdp_tp(outdir, rank, world):
    """fsdp over a tensor axis: the tiny LM of ``fsdp_tp.npz`` trained 3
    SGD-momentum steps (L2 clip) over MeshTopology(data=2, tensor=2),
    sync_mode fsdp, on its one global batch dealt rank-major by data
    coordinate."""
    from bigdl_tpu_torch.dataset.base import DistributedDataSet, MiniBatch
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.parallel.mesh import MeshTopology
    z = np.load(os.path.join(outdir, "fsdp_tp.npz"))
    cfg = json.loads(str(z["cfg"]))
    model = build_lm(cfg.pop("vocab"), **cfg, device="cpu", seed=0)
    import_tree_state(model, {k[2:]: z[k] for k in z.files
                              if k.startswith("p:")},
                      {n: b.numpy() for n, b in model.named_buffers()})
    coord, per = rank // 2, z["x"].shape[1] // 2
    batches = [MiniBatch(torch.from_numpy(bx[coord * per:(coord + 1) * per]),
                         torch.from_numpy(by[coord * per:(coord + 1) * per]))
               for bx, by in zip(z["x"], z["y"])]
    opt = Optimizer(model, DistributedDataSet(batches, shard_by_process=False),
                    nn.TimeDistributedCriterion(nn.ClassNLLCriterion()),
                    device="cpu", topology=MeshTopology(data=2, tensor=2),
                    sync_mode="fsdp")
    opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
    opt.set_gradient_clipping_by_l2_norm(1.0)
    opt.set_end_when(Trigger.max_iteration(3))
    opt.optimize()
    out = {"p:" + k: v for k, v in export_tree_state(model)[0].items()}
    out["loss"] = np.array([h["loss"] for h in opt.history])
    out["resident"] = np.array(opt.resident_mib()["params"])
    out["slabs"] = np.array(sorted(opt._full))
    save(outdir, "fsdp_tp", rank, out)


def _pp_block():
    return nn.TransformerEncoderLayer(16, 2, 32, pre_norm=True)


def _pp_bn_block():
    return (nn.Sequential()
            .add(nn.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1,
                                       with_bias=False))
            .add(nn.SpatialBatchNormalization(8))
            .add(nn.ReLU()))


def _stack_from(z, prefix, factory, depth):
    from bigdl_tpu_torch.parallel.pipeline import PipelineStack
    stack = PipelineStack(factory, depth, device="cpu")
    import_tree_state(
        stack, {k[len(prefix) + 2:]: z[k] for k in z.files
                if k.startswith(prefix + "p:")},
        {k[len(prefix) + 2:]: z[k] for k in z.files
         if k.startswith(prefix + "b:")})
    return stack


def _pp_grads(stack, loss_fn, x, y, params=None):
    """(loss, {name: this rank's gradient of each whole stacked leaf}):
    its stage's rows, zeros elsewhere."""
    leaves = {n: p.detach().clone().requires_grad_()
              for n, p in (params or stack.parameter_tree()).items()}
    loss = loss_fn(leaves, None, torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    return float(loss.detach()), {n: t.grad for n, t in leaves.items()}


def job_pp(outdir, rank, world):
    """Pipelines at world 4: GPipe over MeshTopology(pipeline=4) at n_micro
    4, 8 and 16 (losses; gradients at 4 with and without remat), a
    batch-norm stack's loss and buffers, the circular schedule V=2 at
    M=8 and M=P=4 (loss, gradients), dp x pp over MeshTopology(data=2,
    pipeline=2), and the heterogeneous LM's StagePipeline at 4 stages and
    at 2 (under dp=2): losses and the stacked gradients."""
    from bigdl_tpu_torch.parallel import mesh as pmesh
    from bigdl_tpu_torch.parallel.pipeline import (StagePipeline,
                                                   circular_permutation,
                                                   gpipe_loss_fn,
                                                   stage_pipeline_loss_fn)
    z = np.load(os.path.join(outdir, "pp.npz"))
    out = {}
    mesh = MeshTopology_build(pipeline=4)
    dp_mesh = MeshTopology_build(data=2, pipeline=2)
    crit = nn.MSECriterion()
    stack8 = _stack_from(z, "s8:", _pp_block, 8)
    for m in (4, 8, 16):
        loss, _ = _pp_grads(stack8, gpipe_loss_fn(stack8, crit, mesh, m),
                            z["x16"], z["y16"])
        out[f"gpipe_m{m}:loss"] = np.array(loss)
    stack4 = _stack_from(z, "s4:", _pp_block, 4)
    for remat in (False, True):
        pmesh.COLLECTIVES.reset()
        loss, g = _pp_grads(stack4, gpipe_loss_fn(stack4, crit, mesh, 4,
                                                  remat=remat),
                            z["x8"], z["y8"])
        tag = "gpipe_remat" if remat else "gpipe"
        out[f"{tag}:loss"] = np.array(loss)
        out[f"{tag}:shifts"] = np.array(pmesh.COLLECTIVES.by_axis.get(
            "shift/pipe", 0))
        for n, t in g.items():
            mesh.all_reduce(t, axis="pipe")
            out[f"{tag}:g:{n}"] = t.numpy()
    # the batch-norm stack: loss and the stage's new buffers
    bn = _stack_from(z, "bn:", _pp_bn_block, 4)
    fn = gpipe_loss_fn(bn, crit, mesh, 4)
    loss, bufs = fn(bn.parameter_tree(), bn.buffer_tree(), None,
                    torch.from_numpy(z["xbn"]), torch.from_numpy(z["ybn"]))
    out["bn:loss"] = np.array(float(loss))
    for n, b in bufs.items():
        out[f"bn:b:{n}"] = mesh.all_gather(b.contiguous(), "pipe",
                                           dim=0).numpy()
    # circular, V = 2, on the permuted layers
    perm = circular_permutation(8, 4, 2)
    for m in (8, 4):
        params = {n: p.detach()[torch.from_numpy(perm).long()]
                  for n, p in stack8.parameter_tree().items()}
        loss, g = _pp_grads(stack8, gpipe_loss_fn(stack8, crit, mesh, m,
                                                  interleave=2),
                            z["x16"], z["y16"], params)
        out[f"circ_m{m}:loss"] = np.array(loss)
        inv = torch.from_numpy(np.argsort(perm)).long()
        for n, t in g.items():
            mesh.all_reduce(t, axis="pipe")
            out[f"circ_m{m}:g:{n}"] = t[inv].numpy()
    # dp x pp: this data rank's half of the batch
    d = dp_mesh.axis_index("data")
    xs, ys = z["x8"][4 * d:4 * d + 4], z["y8"][4 * d:4 * d + 4]
    loss, g = _pp_grads(stack4, gpipe_loss_fn(stack4, crit, dp_mesh, 4,
                                              data_axis="data"), xs, ys)
    out["dpp:loss"] = np.array(loss)
    for n, t in g.items():
        dp_mesh.all_reduce(t, axis="pipe")
        out[f"dpp:g:{n}"] = t.numpy()
    # StagePipeline: the LM in 4 stages, and in 2 under dp=2
    ids, tgt = z["ids"], z["tgt"]
    lm_crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    for tag, stages, m_ in (("stage4", _lm_stages(z, 4), mesh),
                            ("stage2", _lm_stages(z, 2), dp_mesh)):
        data_axis = "data" if tag == "stage2" else None
        rows = ids if data_axis is None else ids[4 * d:4 * d + 4]
        labels = tgt if data_axis is None else tgt[4 * d:4 * d + 4]
        pipe = StagePipeline(stages, rows[:1].astype(np.float32),
                             device="cpu")
        stacked = torch.from_numpy(pipe.parameter_tree().copy())
        row = stacked[m_.axis_index("pipe")].clone().requires_grad_()
        pmesh.COLLECTIVES.reset()
        loss = stage_pipeline_loss_fn(pipe, lm_crit, m_, len(rows),
                                      data_axis=data_axis)(
            row, torch.from_numpy(rows.astype(np.float32)),
            torch.from_numpy(labels.astype(np.float32)))
        loss.backward()
        out[f"{tag}:loss"] = np.array(float(loss.detach()))
        out[f"{tag}:shifts"] = np.array(pmesh.COLLECTIVES.by_axis.get(
            "shift/pipe", 0))
        out[f"{tag}:shift_bytes"] = np.array(pmesh.COLLECTIVES.bytes.get(
            "shift", 0))
        out[f"{tag}:in_shapes"] = np.array(
            [int(np.prod(s)) for s in pipe._in_shapes])
        out[f"{tag}:g"] = m_.all_gather(row.grad.contiguous(), "pipe",
                                        dim=0).view(stacked.shape).numpy()
        out[f"{tag}:stacked"] = pipe.parameter_tree()
    save(outdir, "pp", rank, out)


#: the comm-model job's tiny LM (the 134m recipe's block at narrow widths)
COMM_LM = dict(embed_dim=32, num_heads=4, num_kv_heads=2, ffn_dim=64,
               num_layers=2, max_len=32, rope=True, activation="swiglu",
               norm="rms", bias=False, tie_embeddings=True)
COMM_MOE = dict(embed_dim=32, num_heads=4, ffn_dim=64, max_len=32,
                num_layers=2)
COMM_V, COMM_B, COMM_S, COMM_STEPS = 64, 4, 16, 3


def _comm_batches(n_data, coord):
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    from bigdl_tpu_torch.dataset.base import MiniBatch
    samples = synthetic_corpus(COMM_B * COMM_STEPS, COMM_S, COMM_V, seed=17)
    per = COMM_B // n_data
    return [MiniBatch(b.data[coord * per:(coord + 1) * per],
                      b.labels[coord * per:(coord + 1) * per])
            for b in SampleToBatch(COMM_B)(iter(samples))]


def _comm_optimizer(model, n_data, coord, **kw):
    from bigdl_tpu_torch.dataset.base import DistributedDataSet
    from bigdl_tpu_torch.optim import AdamW
    opt = Optimizer(model, DistributedDataSet(
        _comm_batches(n_data, coord), shard_by_process=False, seed=0),
        nn.FusedLMHeadCriterion(), device="cpu", **kw)
    (opt.set_precision("bf16")
        .set_optim_method(AdamW(learningrate=3e-3, weightdecay=0.01))
        .set_gradient_clipping_by_l2_norm(1.0)
        .set_end_when(Trigger.max_iteration(COMM_STEPS)))
    return opt


def job_comm(outdir, rank, world):
    """The collective byte model's runs at world 2 (bf16, AdamW, L2 clip
    1.0, COMM_STEPS steps): DistriOptimizer's allreduce, sharded and fsdp
    modes; tensor=2 without and with sequence-parallel regions; an MoE LM
    over data=2 (global routing) and expert=2; ContextParallelLM's ring
    at sequence=2; GPipe and StagePipeline at pipeline=2. Each run's
    COLLECTIVES snapshot and its model symbols (read off the live
    objects) go to ``comm.<rank>.json``."""
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.parallel import comm_symbols as cs
    from bigdl_tpu_torch.parallel import tensor_parallel as tp
    from bigdl_tpu_torch.parallel.mesh import COLLECTIVES, MeshTopology
    runs = {}

    def record(name, mode, symbols, steps=COMM_STEPS):
        runs[name] = {"mode": mode, "steps": steps, "symbols": symbols,
                      "snapshot": COLLECTIVES.snapshot()}

    for sync in ("allreduce", "sharded", "fsdp"):
        model = build_lm(COMM_V, **COMM_LM, device="cpu", seed=7)
        opt = _comm_optimizer(model, world, rank, sync_mode=sync)
        COLLECTIVES.reset()
        opt.optimize()
        record(sync, {"allreduce": "dp-allreduce", "sharded": "dp-sharded",
                      "fsdp": "fsdp"}[sync], cs.dp_symbols(opt))
    for sp in (False, True):
        model = build_lm(COMM_V, **COMM_LM, device="cpu", seed=7)
        opt = _comm_optimizer(model, 1, 0,
                              topology=MeshTopology(tensor=world))
        if sp:
            tp.enable_sequence_parallel(model, opt.mesh)
        COLLECTIVES.reset()
        opt.optimize()
        record("tp_sp" if sp else "tp", "tp-sp" if sp else "tp-megatron",
               cs.tp_symbols(model, opt.mesh, COMM_B, COMM_S, 2, True))
    for axis in ("data", "expert"):
        model = build_lm(COMM_V, **COMM_MOE, fused_head=True, moe_experts=4,
                         device="cpu", seed=7)
        n_data = world if axis == "data" else 1
        opt = _comm_optimizer(model, n_data, rank % n_data,
                              topology=MeshTopology(**{axis: world}))
        COLLECTIVES.reset()
        opt.optimize()
        sym = cs.moe_symbols(model, COMM_B // n_data * COMM_S, 2, n_data,
                             True)
        sym.update(P=cs.nbytes(model.parameters()), S_expert=world)
        record("ep_" + axis, "dp x ep" if axis == "data" else "ep", sym)
    # the ring: ContextParallelLM.train_step on the whole batch
    from bigdl_tpu_torch.ops.precision import DtypePolicy
    from bigdl_tpu_torch.optim import AdamW
    from bigdl_tpu_torch.parallel.context import ContextParallelLM
    model = build_lm(COMM_V, **COMM_LM, device="cpu", seed=7)
    for m in model.modules():
        if isinstance(m, nn.MultiHeadAttention):
            m.seq_axis, m.seq_mode, m.seq_layout = "seq", "ring", "contiguous"
    mesh = MeshTopology(sequence=world).build()
    lm = ContextParallelLM(model, mesh)
    batch = _comm_batches(1, 0)[0]
    params = dict(model.named_parameters())
    method = AdamW(learningrate=3e-3, weightdecay=0.01)
    state = method.init_state(params)
    COLLECTIVES.reset()
    for _ in range(COMM_STEPS):
        lm.train_step(torch.as_tensor(batch.data),
                      torch.as_tensor(batch.labels), nn.FusedLMHeadCriterion(),
                      method, state, params, precision=DtypePolicy.bf16(),
                      clip_norm=1.0)
    record("cp_ring", "sp-ring",
           cs.ring_symbols(model, mesh, COMM_B, COMM_S, 2))
    # GPipe: one loss and backward of a 4-block stack in 2 microbatches
    from bigdl_tpu_torch.parallel.pipeline import (PipelineStack,
                                                   StagePipeline,
                                                   gpipe_loss_fn,
                                                   stage_pipeline_loss_fn)
    torch.manual_seed(7)
    stack = PipelineStack(lambda: nn.TransformerEncoderLayer(
        32, 4, 64, causal=True), 4, device="cpu").to(torch.bfloat16)
    gen = torch.Generator().manual_seed(29)
    x = torch.randn(COMM_B, COMM_S, 32, generator=gen).to(torch.bfloat16)
    y = torch.randn(x.shape, generator=gen)
    leaves = {n: p.detach().clone().requires_grad_()
              for n, p in stack.parameter_tree().items()}
    pmesh = MeshTopology(pipeline=world).build()
    fn = gpipe_loss_fn(stack, nn.MSECriterion(), pmesh, 2,
                       head=lambda _, f: f.float())
    COLLECTIVES.reset()
    fn(leaves, None, x, y).backward()
    record("gpipe", "pp-gpipe", cs.gpipe_symbols(x, 2, pmesh), steps=1)
    # StagePipeline: the tiny LM as two stages, f32
    lm_whole = build_lm(COMM_V, **dict(COMM_LM, tie_embeddings=False),
                        device="cpu", seed=7)
    parts = list(lm_whole._modules.values())
    at = next(i for i, m in enumerate(parts)
              if isinstance(m, nn.TransformerEncoder))
    enc = parts[at]
    s0, s1 = nn.Sequential(), nn.Sequential()
    for part in parts[:at]:
        s0.add(part)
    s0.add(enc._modules["layer0"])
    s1.add(enc._modules["layer1"]).add(enc.final_norm)
    for part in parts[at + 1:]:
        s1.add(part)
    ids = torch.as_tensor(batch.data)
    pipe = StagePipeline([s0, s1], ids[:COMM_B // 2].numpy(), device="cpu")
    row = torch.from_numpy(pipe.parameter_tree())[rank].clone() \
        .requires_grad_()
    crit = nn.TimeDistributedCriterion(nn.ClassNLLCriterion())
    COLLECTIVES.reset()
    stage_pipeline_loss_fn(pipe, crit, pmesh, 2)(
        row, ids, torch.as_tensor(batch.labels)).backward()
    record("stage", "pp-stage", cs.stage_symbols(pipe, 2, pmesh), steps=1)
    with open(os.path.join(outdir, f"comm.{rank}.json"), "w") as f:
        json.dump(runs, f)


def MeshTopology_build(**axes):
    from bigdl_tpu_torch.parallel.mesh import MeshTopology
    return MeshTopology(**axes).build()


def _lm_stages(z, n):
    """The heterogeneous LM (embedding + position + block | blocks | norm
    + head) in ``n`` stages, with ``pp.npz``'s weights."""
    from bigdl_tpu_torch.nn.containers import Sequential
    e, v = 16, 24
    emb = (Sequential().add(nn.LookupTable(v, e))
           .add(nn.PositionalEncoding(e, 32))
           .add(nn.TransformerEncoderLayer(e, 2, 32, causal=True)))
    mids = [Sequential().add(nn.TransformerEncoderLayer(e, 2, 32,
                                                        causal=True))
            for _ in range(2)]
    head = (Sequential().add(nn.LayerNorm(e))
            .add(nn.TimeDistributed(nn.Linear(e, v))).add(nn.LogSoftMax()))
    parts = [emb, *mids, head]
    for i, part in enumerate(parts):
        import_tree_state(part, {k[len(f"lm{i}:p:"):]: z[k] for k in z.files
                                 if k.startswith(f"lm{i}:p:")},
                          {n: b.numpy() for n, b in part.named_buffers()})
    if n == 4:
        return parts
    first = Sequential().add(parts[0]).add(parts[1])
    last = Sequential().add(parts[2]).add(parts[3])
    return [first, last]


class pytest_raises:
    """``pytest.raises`` for the rank processes (which import no pytest)."""

    def __init__(self, exc, match):
        self.exc, self.match = exc, match

    def __enter__(self):
        return self

    def __exit__(self, kind, value, tb):
        if kind is None or not issubclass(kind, self.exc) \
                or self.match not in str(value):
            raise AssertionError(f"expected {self.exc.__name__} "
                                 f"({self.match!r}), got {kind}: {value}")
        return True


JOBS = {"bn_plain": lambda o, r, w: job_bn(o, r, w, False),
        "bn_fused": lambda o, r, w: job_bn(o, r, w, True),
        "broadcast": job_broadcast, "clip": job_clip, "data": job_data,
        "lenet": job_lenet,
        "lenet_bf16": lambda o, r, w: job_lenet(o, r, w, LENET_BF16_RUNS),
        "validation": job_validation, "preempt": job_preempt,
        "ckpt_save": job_ckpt_save, "ckpt_restore": job_ckpt_restore,
        "uneven": job_uneven, "tp": job_tp, "cp": job_cp,
        "decode": job_decode, "cli": job_cli, "ep": job_ep,
        "ep_eval": job_ep_eval, "fsdp_tp": job_fsdp_tp, "pp": job_pp,
        "comm": job_comm}


def spawn(outdir, world, jobs):
    """Start ``world`` ranks of this script running ``jobs``; each rank's
    output goes to ``<outdir>/rank<r>.log``. Returns the processes."""
    import socket
    import subprocess
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    procs = []
    for r in range(world):
        env = {**os.environ, "BIGDL_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
               "BIGDL_NUM_PROCESSES": str(world), "BIGDL_PROCESS_ID": str(r),
               "OMP_NUM_THREADS": "1"}
        env.pop("XLA_FLAGS", None)
        log = open(os.path.join(outdir, f"rank{r}.log"), "wb")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(outdir), *jobs],
            env=env, stdout=log, stderr=subprocess.STDOUT))
        log.close()
    return procs


def wait(procs, outdir, timeout=120):
    """Wait for ``spawn``'s ranks; raises with a failed rank's log."""
    import subprocess
    try:
        for p in procs:
            p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(outdir, f"rank{r}.log"), "rb") as f:
                log = f.read().decode(errors="replace")
            raise AssertionError(f"rank {r} exited {p.returncode}:\n"
                                 f"{log[-4000:]}")


def main():
    outdir, jobs = sys.argv[1], sys.argv[2:]
    torch.set_num_threads(1)
    Engine.init_distributed(device="cpu", backend="gloo")
    rank, world = Engine.process_index(), Engine.process_count()
    counts = {}
    for job in jobs:
        mesh_mod.COLLECTIVES.reset()
        JOBS[job](outdir, rank, world)
        counts[job] = mesh_mod.COLLECTIVES.snapshot()
    with open(os.path.join(outdir, f"collectives.{rank}.json"), "w") as f:
        json.dump(counts, f)
    Engine.shutdown_distributed()


if __name__ == "__main__":
    main()
