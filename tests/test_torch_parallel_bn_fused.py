"""``test_torch_parallel_bn.py`` for the fused modules: ``FusedConv3x3BN``
and ``FusedConv1x1BN`` (the K6/K5 ops' ``Function``s, their plain versions
on the CPU) on two gloo ranks against the reference's mesh of two, in
``allreduce`` mode (synchronized statistics from the ops' sums) and
``sharded`` mode (each replica's), at ``rtol=1e-4, atol=1e-5``."""

import pytest

from test_torch_parallel_bn import check_bn, spawn_bn, unshuffled  # noqa


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    result, procs = spawn_bn(tmp_path_factory, True, ["bn_fused"])
    yield result
    for p in procs:
        p.kill()


@pytest.mark.parametrize("fused", [True], ids=["fused"])
def test_batch_norm_statistics_match_the_reference_fused(ranks, unshuffled,
                                                         fused):
    check_bn(ranks, fused)
