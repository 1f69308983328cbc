"""The port's ResNet slice against the JAX package's, on the CPU.

The slice as a whole: ``build_cifar(10, depth=8, shortcut_type="B")`` with
both fusion gates set (5 fused 3x3 pairs, 2 strided fused 1x1
projections) at B=4, 32x32, built in the reference and carried into the
port (``flatten_tree`` -> ``import_tree_state``). The loss, every
parameter's gradient and every updated running statistic of one training
forward and backward, then one ``Optimizer`` step of SGD with momentum,
against the reference on the same numpy batch; and a bf16 training run
through ``Optimizer``. The builders' structure and the weight interop are
in ``test_torch_resnet_build.py``.

Tolerances: the loss within 1e-5 (relative); each gradient, running
statistic and updated weight within 1e-4 relative L2 of the reference's
tensor (f32 sums in other orders through eight layers of BN, whose
backward subtracts sums of order N*H*W).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.base import DataSet as JaxDataSet
from bigdl_tpu.dataset.base import Sample as JaxSample
from bigdl_tpu.dataset.base import SampleToBatch as JaxSampleToBatch
from bigdl_tpu.models import resnet as jax_resnet
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import Optimizer as JaxOptimizer
from bigdl_tpu.optim import Trigger as JaxTrigger
from bigdl_tpu_torch.dataset.base import DataSet, Sample, SampleToBatch
from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                flatten_tree,
                                                import_tree_state)
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.nn import (ClassNLLCriterion, FusedConv1x1BN,
                                FusedConv3x3BN)
from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger

torch.set_num_threads(1)

B, CLASSES = 4, 10
LOSS_RTOL = 1e-5
RTOL = 1e-4
GATES = ("BIGDL_TPU_FUSED_1X1", "BIGDL_TPU_FUSED_3X3")


@pytest.fixture
def gates_on(monkeypatch):
    for g in GATES:
        monkeypatch.setenv(g, "1")


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, 32, 32, 3)).astype(np.float32)
    y = rng.integers(1, CLASSES + 1, (B,)).astype(np.float32)
    return x, y


def _rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    return np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)


def _cifar_pair():
    """The reference's depth-8 CIFAR ResNet and the port's, same weights."""
    jm = jax_resnet.build_cifar(CLASSES, depth=8, shortcut_type="B")
    tm = resnet.build_cifar(CLASSES, depth=8, shortcut_type="B",
                            device="cpu", seed=3)
    import_tree_state(tm, flatten_tree(jm.parameter_tree()),
                      flatten_tree(jm.buffer_tree()))
    return jm, tm


def _count(model, cls):
    return sum(isinstance(m, cls) for m in model.modules())


def test_cifar_slice_gradients_and_running_stats_match(gates_on):
    jm, tm = _cifar_pair()
    assert _count(tm, FusedConv3x3BN) == 5
    assert [m.stride for m in tm.modules()
            if isinstance(m, FusedConv1x1BN)] == [2, 2]
    x, y = _batch()
    crit = jnn.ClassNLLCriterion()

    def loss_fn(params):
        out, bufs = functional_apply(jm, params, jm.buffer_tree(),
                                     jnp.asarray(x), training=True)
        return crit.apply(out, jnp.asarray(y)), bufs

    (ref_loss, ref_bufs), ref_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jm.parameter_tree())
    tm.train()
    loss = ClassNLLCriterion()(tm(torch.from_numpy(x)), torch.from_numpy(y))
    loss.backward()
    assert abs(loss.item() - float(ref_loss)) <= LOSS_RTOL * abs(float(ref_loss))
    ref_grads, ref_bufs = flatten_tree(ref_grads), flatten_tree(ref_bufs)
    names = [n for n, _ in tm.named_parameters()]
    assert sorted(names) == sorted(ref_grads)
    for name, p in tm.named_parameters():
        assert _rel_l2(p.grad.numpy(), ref_grads[name]) <= RTOL, name
    assert sorted(n for n, _ in tm.named_buffers()) == sorted(ref_bufs)
    for name, buf in tm.named_buffers():
        assert _rel_l2(buf.numpy(), ref_bufs[name]) <= RTOL, name


def test_cifar_slice_one_sgd_momentum_step_matches(gates_on):
    jm, tm = _cifar_pair()
    x, y = _batch(1)
    sgd = dict(learningrate=0.1, momentum=0.9)
    jds = JaxDataSet.array([JaxSample(f, l) for f, l in zip(x, y)]) \
        >> JaxSampleToBatch(B)
    (JaxOptimizer(jm, jds, jnn.ClassNLLCriterion())
     .set_optim_method(JaxSGD(**sgd))
     .set_end_when(JaxTrigger.max_iteration(1)).optimize())
    ds = DataSet.array([Sample(f, l) for f, l in zip(x, y)], seed=0) \
        >> SampleToBatch(B)
    opt = (Optimizer(tm, ds, ClassNLLCriterion(), device="cpu")
           .set_optim_method(SGD(**sgd))
           .set_end_when(Trigger.max_iteration(1)))
    opt.optimize()
    assert len(opt.history) == 1 and np.isfinite(opt.history[0]["loss"])
    params, bufs = export_tree_state(tm)
    ref_params = flatten_tree(jm.parameter_tree())
    ref_bufs = flatten_tree(jm.buffer_tree())
    for name in ref_params:
        assert _rel_l2(params[name], ref_params[name]) <= RTOL, name
    for name in ref_bufs:
        assert _rel_l2(bufs[name], ref_bufs[name]) <= RTOL, name


def test_bf16_training_through_optimizer_runs_the_fused_path(gates_on):
    tm = resnet.build_cifar(CLASSES, depth=8, shortcut_type="B",
                            device="cpu", seed=0)
    x, y = _batch(2)
    ds = DataSet.array([Sample(f, l) for f, l in zip(x, y)], seed=0) \
        >> SampleToBatch(B)
    opt = (Optimizer(tm, ds, ClassNLLCriterion(), device="cpu")
           .set_precision("bf16")
           .set_optim_method(SGD(learningrate=0.1, momentum=0.9))
           .set_end_when(Trigger.max_iteration(3)))
    opt.optimize()
    losses = [h["loss"] for h in opt.history]
    assert len(losses) == 3 and np.isfinite(losses).all()
    for name, buf in tm.named_buffers():
        assert buf.dtype == torch.float32 and torch.isfinite(buf).all(), name
    moved = [m.running_mean.abs().sum().item() for m in tm.modules()
             if isinstance(m, (FusedConv1x1BN, FusedConv3x3BN))]
    assert all(v > 0 for v in moved)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
