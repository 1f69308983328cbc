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


JOBS = {"bn_plain": lambda o, r, w: job_bn(o, r, w, False),
        "bn_fused": lambda o, r, w: job_bn(o, r, w, True),
        "broadcast": job_broadcast, "clip": job_clip, "data": job_data,
        "lenet": job_lenet,
        "lenet_bf16": lambda o, r, w: job_lenet(o, r, w, LENET_BF16_RUNS),
        "validation": job_validation, "preempt": job_preempt,
        "ckpt_save": job_ckpt_save, "ckpt_restore": job_ckpt_restore}


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
