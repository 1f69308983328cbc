"""``test_torch_parallel_lenet.py`` at world 4 with ``compress_gradients``:
four gloo ranks against the reference's mesh of four, allreduce, sharded
and fsdp rounding to bf16, at the reference's ``rtol=2e-4, atol=2e-5``."""

import pytest

import torch_parallel_worker as worker
from test_torch_parallel_lenet import check_lenet, spawn_lenet


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    result, procs = spawn_lenet(tmp_path_factory, 4, "lenet_bf16")
    yield result
    for p in procs:
        p.kill()


@pytest.mark.parametrize("run", worker.LENET_BF16_RUNS, ids=lambda r: r[0])
def test_lenet_matches_the_reference_mesh_w4_bf16(ranks, run):
    check_lenet(ranks, 4, run)
