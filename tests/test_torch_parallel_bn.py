"""Synchronized batch norm and sharded clipping of the port's
``DistriOptimizer`` (two gloo ranks on the CPU) against the reference's
mesh of two virtual devices.

A conv3x3+BN, conv1x1+BN net, plain (``SpatialBatchNormalization``) here
and fused (the K6/K5 ops' Functions) in ``test_torch_parallel_bn_fused.py``,
three SGD steps on a global batch of 16
whose two halves differ by a channel offset of 2: in ``allreduce`` mode
the reference's XLA takes the statistics of the global batch and the port
must synchronize them; in ``sharded`` mode both take each replica's and
average the running statistics. Parameters, running statistics and losses
are held at ``rtol=1e-4, atol=1e-5``, and the test checks that the two
kinds of statistics differ far beyond that, so a port without the
synchronization fails. Then L2 clipping (0.05) of 41 parameters, padded
to an even count in ``sharded`` mode, and in ``allreduce`` mode.
"""

import numpy as np
import pytest

import jax

import torch_parallel_worker as worker

RTOL, ATOL = 1e-4, 1e-5


def _ref_bn_net(fused):
    from bigdl_tpu import nn
    from bigdl_tpu.nn.fused import FusedConv1x1BN, FusedConv3x3BN
    if fused:
        a, b = FusedConv3x3BN(4, 8), FusedConv1x1BN(8, 8)
    else:
        a = nn.Sequential().add(nn.SpatialConvolution(
            4, 8, 3, 3, 1, 1, 1, 1, with_bias=False)) \
            .add(nn.SpatialBatchNormalization(8))
        b = nn.Sequential().add(nn.SpatialConvolution(
            8, 8, 1, 1, with_bias=False)) \
            .add(nn.SpatialBatchNormalization(8))
    return (nn.Sequential().add(a).add(nn.ReLU()).add(b).add(nn.ReLU())
            .add(nn.Mean(2)).add(nn.Mean(2)).add(nn.Linear(8, 3))
            .add(nn.LogSoftMax()))


def _ref_train(model, samples, sync_mode, batch, lr, momentum=0.0,
               clip=None, iters=3):
    """The reference's DistriOptimizer over a mesh of 2, batches in the
    samples' order: device d trains on the d-th half of each batch."""
    from bigdl_tpu import nn
    from bigdl_tpu.dataset.base import DataSet, Sample, SampleToBatch
    from bigdl_tpu.optim import Optimizer, SGD, Trigger
    from bigdl_tpu.parallel.mesh import MeshTopology
    ds = DataSet.array([Sample(s.feature, float(s.label)) for s in samples],
                       distributed=True) >> SampleToBatch(batch)
    opt = Optimizer(model, ds, nn.ClassNLLCriterion(),
                    topology=MeshTopology(data=2, devices=jax.devices()[:2]))
    opt.sync_mode = sync_mode
    opt.set_optim_method(SGD(learningrate=lr, momentum=momentum))
    if clip is not None:
        opt.set_gradient_clipping_by_l2_norm(clip)
    opt.set_end_when(Trigger.max_iteration(iters))
    trained = opt.optimize()
    return trained, opt


def _rank_order(samples, world=2):
    """The reference's batch order whose d-th block holds rank d's
    records (``data[d::world]``)."""
    return [s for d in range(world) for s in samples[d::world]]


def spawn_bn(tmp_path_factory, fused: bool, jobs):
    """Two ranks running ``jobs`` from the reference's initial weights;
    returns (a waiter for their folder, the processes)."""
    from bigdl_tpu.utils.rng import manual_seed
    from bigdl_tpu.nn import Linear, LogSoftMax, Sequential, Tanh
    from bigdl_tpu_torch.interop.state_dict import flatten_tree
    tag = "fused" if fused else "plain"
    out = tmp_path_factory.mktemp(f"bn_{tag}")
    manual_seed(3)
    m = _ref_bn_net(fused)
    p, b = flatten_tree(m.parameter_tree()), flatten_tree(m.buffer_tree())
    np.savez(out / f"bn_init_{tag}.npz",
             **{"p:" + k: v for k, v in p.items()},
             **{"b:" + k: v for k, v in b.items()})
    manual_seed(4)
    clip_model = (Sequential().add(Linear(6, 3)).add(Tanh())
                  .add(Linear(3, 5)).add(LogSoftMax()))
    np.savez(out / "clip_init.npz", **{
        "p:" + k: v
        for k, v in flatten_tree(clip_model.parameter_tree()).items()})
    procs = worker.spawn(out, 2, jobs)
    done = []

    def result():
        if not done:
            worker.wait(procs, out)
            done.append(True)
        return out
    return result, procs


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    result, procs = spawn_bn(tmp_path_factory, False, ["bn_plain", "clip"])
    yield result
    for p in procs:
        p.kill()


@pytest.fixture
def unshuffled(monkeypatch):
    from bigdl_tpu.dataset.base import LocalDataSet
    monkeypatch.setattr(LocalDataSet, "shuffle", lambda self: None)


def _ref_bn(fused, mode):
    from bigdl_tpu.utils.rng import manual_seed
    from bigdl_tpu_torch.interop.state_dict import flatten_tree
    manual_seed(3)   # the fixture's initial weights
    model = _ref_bn_net(fused)
    trained, opt = _ref_train(model, _rank_order(worker.bn_samples()), mode,
                              16, 0.1, momentum=0.9)
    return (flatten_tree(trained.parameter_tree()),
            flatten_tree(trained.buffer_tree()))


def check_bn(result, fused: bool):
    """Both modes' parameters, running statistics and losses against the
    reference's, and the two kinds of statistics apart."""
    want = {mode: _ref_bn(fused, mode)
            for mode in ("allreduce", "sharded")}
    out = result()
    tag = "fused" if fused else "plain"
    for mode, (wp, wb) in want.items():
        got = [dict(np.load(out / f"bn_{tag}_{mode}.{r}.npz"))
               for r in range(2)]
        for kind, ref in (("p:", wp), ("b:", wb)):
            for k, v in ref.items():
                np.testing.assert_allclose(got[0][kind + k], v, rtol=RTOL,
                                           atol=ATOL,
                                           err_msg=f"{tag} {mode} {k}")
                np.testing.assert_array_equal(got[1][kind + k],
                                              got[0][kind + k])
    # global and per-replica statistics part far beyond the tolerance:
    # leaving the synchronization out would fail the allreduce case
    (gp, gb), (sp, sb) = want["allreduce"], want["sharded"]
    gap = max(np.abs(gb[k] - sb[k]).max() for k in gb)
    assert gap > 1000 * ATOL, gap


@pytest.mark.parametrize("fused", [False], ids=["plain"])
def test_batch_norm_statistics_match_the_reference(ranks, unshuffled,
                                                   fused):
    check_bn(ranks, fused)


@pytest.mark.parametrize("mode", ["sharded", "allreduce"])
def test_l2_clipping_matches_the_reference(ranks, mode):
    from bigdl_tpu.nn import Linear, LogSoftMax, Sequential, Tanh
    from bigdl_tpu.utils.rng import manual_seed
    from bigdl_tpu_torch.interop.state_dict import flatten_tree
    out = ranks()
    init, _ = worker.load_init(out, "clip_init.npz")
    manual_seed(4)   # the fixture's initial weights
    model = (Sequential().add(Linear(6, 3)).add(Tanh())
             .add(Linear(3, 5)).add(LogSoftMax()))
    trained, _ = _ref_train(model, worker.clip_samples(), mode, 16, 0.5,
                            clip=0.05)
    want = flatten_tree(trained.parameter_tree())
    assert sum(v.size for v in want.values()) % 2 == 1   # needs a pad lane
    got = dict(np.load(out / f"clip_{mode}.0.npz"))
    moved = max(np.abs(want[k] - init[k]).max() for k in want)
    assert 0 < moved <= 3 * 0.5 * 0.05 + 1e-6   # the clip held each step
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
