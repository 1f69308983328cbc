"""Fault C.8, pinned: ranks with unequal shares of a distributed dataset
stay in step.

``DataSet.array(5 samples, distributed=True) >> SampleToBatch(1)`` over two
gloo ranks gives rank 0 three records and rank 1 two (the reference's
``data[p::n]``); ``Linear(4, 1)``, ``MSECriterion``, ``SGD``, ``allreduce``,
two epochs. ``DistriOptimizer`` agrees each epoch's iteration count (the
ranks' least) before the epoch starts, so both ranks end, with equal
iteration counts and bit-equal parameters (before the repair rank 0's
third iteration met rank 1's first of epoch 2 and rank 0 died in
``Mesh.all_reduce``). A dataset that cannot count its batches is refused
before the first step, naming C.8.
"""

import numpy as np
import pytest
import torch

import torch_parallel_worker as worker


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("uneven")
    procs = worker.spawn(out, 2, ["uneven"])
    worker.wait(procs, out)
    return [np.load(out / f"uneven.{r}.npz") for r in range(2)]


def test_both_ranks_end_in_step(ranks):
    a, b = ranks
    # 2 agreed iterations an epoch (rank 1's two records), two epochs
    assert int(a["iterations"]) == int(b["iterations"]) == 4
    np.testing.assert_array_equal(a["epochs"], [1, 1, 2, 2])
    np.testing.assert_array_equal(a["epochs"], b["epochs"])


def test_both_ranks_hold_bit_equal_parameters(ranks):
    a, b = ranks
    for name in ("weight", "bias"):
        assert np.array_equal(a[name], b[name]), name


def test_an_uncountable_dataset_is_refused_before_the_first_step():
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.dataset.base import (AbstractDataSet,
                                              epoch_batches)
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.parallel import DistriOptimizer
    from bigdl_tpu_torch.parallel.mesh import Mesh

    class Stream(AbstractDataSet):
        def data(self, train):
            raise AssertionError("a batch was read")

        def size(self):
            return 4

        def shuffle(self):
            pass

        def is_distributed(self):
            return True

    assert epoch_batches(Stream()) is None
    opt = Optimizer(nn.Linear(4, 1), Stream(), nn.MSECriterion(),
                    device="cpu", sync_mode="allreduce")
    assert isinstance(opt, DistriOptimizer)
    # a data axis of two, no group: the count is asked before any batch
    opt.mesh = Mesh(2, 0, "cpu", None)
    opt.set_optim_method(SGD()).set_end_when(Trigger.max_iteration(1))
    with pytest.raises(ValueError, match="C.8"):
        opt.optimize()
