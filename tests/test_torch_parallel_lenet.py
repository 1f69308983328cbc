"""The port's ``DistriOptimizer`` against the reference's on LeNet: ranks
of gloo processes on the CPU against ``bigdl_tpu``'s single-process mesh
of as many virtual devices (the counterpart of ``tests/test_multihost.py``).

Three SGD iterations (0.05, momentum 0.9) over 32 records, one global
batch of 32 a step (each of N ranks holds its 16 or 8 records), at world
2 here (world 4: ``_w4.py``), in modes ``allreduce``, ``sharded``,
``fsdp`` and ``cached`` (allreduce over the ``DeviceCachedDataSet``),
and the first three with ``compress_gradients`` (``_bf16.py``,
``_w4_bf16.py``); held at the reference's own ``rtol=2e-4, atol=2e-5``.
One spawn a file runs its modes in sequence (``torch_parallel_worker.py``)
while the reference trains here.
"""

import numpy as np
import pytest

import jax

import torch_parallel_worker as worker

RTOL, ATOL = 2e-4, 2e-5


def _reference(world, name, sync_mode, kind, compress):
    from bigdl_tpu import nn
    from bigdl_tpu.dataset.base import DataSet, Sample, SampleToBatch
    from bigdl_tpu.models import lenet
    from bigdl_tpu.optim import Optimizer, SGD, Trigger
    from bigdl_tpu.parallel.mesh import MeshTopology
    from bigdl_tpu.utils.rng import manual_seed

    manual_seed(42)
    samples = [Sample(s.feature, float(s.label))
               for s in worker.lenet_samples()]
    if kind == "cached":
        from bigdl_tpu.dataset import DeviceCachedDataSet
        ds = DeviceCachedDataSet(DataSet.array(samples, distributed=True),
                                 batch_size=32)
    else:
        ds = DataSet.array(samples, distributed=True) >> SampleToBatch(32)
    model = lenet.build(10)
    opt = Optimizer(model, ds, nn.ClassNLLCriterion(),
                    topology=MeshTopology(data=world,
                                          devices=jax.devices()[:world]))
    opt.sync_mode = sync_mode
    opt.compress_gradients = compress
    opt.set_optim_method(SGD(learningrate=0.05, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(3))
    trained = opt.optimize()
    from bigdl_tpu_torch.interop.state_dict import flatten_tree
    return flatten_tree(trained.parameter_tree())


def spawn_lenet(tmp_path_factory, world, job="lenet"):
    """``world`` ranks running ``job``'s LeNet modes, started with the
    reference's initial weights (``manual_seed(42)``, as ``_reference``
    builds them); returns (their output folder, a waiter)."""
    from bigdl_tpu.models import lenet
    from bigdl_tpu.utils.rng import manual_seed
    from bigdl_tpu_torch.interop.state_dict import flatten_tree
    manual_seed(42)
    init = flatten_tree(lenet.build(10).parameter_tree())
    out = tmp_path_factory.mktemp(f"{job}_w{world}")
    np.savez(out / "lenet_init.npz", **{"p:" + k: v for k, v in init.items()})
    procs = worker.spawn(out, world, [job])
    done = []

    def result():
        if not done:
            worker.wait(procs, out)
            done.append(True)
        return out
    return result, procs


def check_lenet(result, world, run):
    name = run[0]
    want = _reference(world, *run)
    out = result()
    got = [dict(np.load(out / f"lenet_{name}.{r}.npz"))
           for r in range(world)]
    assert sorted(got[0]) == sorted(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[0][k], v, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{name} {k}")
        for r in range(1, world):   # every rank holds the same weights
            np.testing.assert_array_equal(got[r][k], got[0][k])


@pytest.fixture(scope="module")
def ranks_w2(tmp_path_factory):
    result, procs = spawn_lenet(tmp_path_factory, 2)
    yield result
    for p in procs:
        p.kill()


@pytest.mark.parametrize("run", worker.LENET_RUNS, ids=lambda r: r[0])
def test_lenet_matches_the_reference_mesh(ranks_w2, run):
    check_lenet(ranks_w2, 2, run)
