"""``test_torch_parallel_lenet.py`` at world 4: four gloo ranks on the CPU
against the reference's mesh of four virtual devices, the modes without
compression, at the reference's ``rtol=2e-4, atol=2e-5``."""

import pytest

import torch_parallel_worker as worker
from test_torch_parallel_lenet import check_lenet, spawn_lenet


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    result, procs = spawn_lenet(tmp_path_factory, 4, "lenet")
    yield result
    for p in procs:
        p.kill()


@pytest.mark.parametrize("run", worker.LENET_RUNS, ids=lambda r: r[0])
def test_lenet_matches_the_reference_mesh_w4(ranks, run):
    check_lenet(ranks, 4, run)
