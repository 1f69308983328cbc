"""Trigger-bounded windows of ``Optimizer.set_steps_per_dispatch(k)``
against the JAX package's, on the CPU (the set-up, data and helpers of
``test_torch_steps_per_dispatch.py``): window lengths, read from both
packages' ``train.dispatch`` spans, are equal when a ``several_iteration``
bound ends a window, and when a loss trigger (``min_loss``) or a custom
``Trigger(fn)`` forces windows of 1. The custom trigger is never probed, so
it sees the same states in the same order in both packages.
"""

import pytest
import torch

from test_torch_steps_per_dispatch import run_both


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_several_iteration_bounds_a_window():
    # fires at nevals divisible by 5 from epoch 2 on: epoch 1 is one window
    # of 3; in epoch 2 the probe at neval 5 fires, so its first window
    # holds neval 4 alone, and the run ends there
    res = run_both(4, lambda T: T.and_(T.several_iteration(5), T.max_epoch(1)))
    assert res["ref"]["windows"] == res["port"]["windows"] == [3, 1]


def test_loss_trigger_forces_windows_of_one():
    res = run_both(4, lambda T: T.or_(T.min_loss(-1.0), T.max_iteration(4)))
    assert res["ref"]["windows"] == res["port"]["windows"] == [1] * 4


def test_custom_trigger_forces_windows_of_one_and_sees_the_same_states():
    seen = {"ref": [], "port": []}

    def custom(side):
        def build(T):
            def fn(state):
                seen[side].append((int(state["epoch"]), int(state["neval"])))
                return int(state["neval"]) > 5
            return T(fn)
        return build

    res = run_both(4, custom("ref"), port_end=custom("port"))
    assert res["ref"]["windows"] == res["port"]["windows"] == [1] * 5
    assert seen["ref"] == seen["port"] and len(seen["port"]) >= 6
