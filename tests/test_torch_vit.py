"""ViT (``models/vit.py``) in the port against the JAX package's, on the CPU.

At the reference's own small shape (``tests/test_models.py``: 32x32
images, patch 8, width 32, 4 heads, FFN 64, 2 layers) the two models get
the same weights (``flatten_tree`` -> ``import_tree_state``, names
checked) and seeded numpy images: log-probs and every parameter gradient
of the ``ClassNLLCriterion`` loss agree within 1e-5 absolute + 1e-4
relative (elementwise, f32). ViT-S/16's parameter count equals the
reference's, and a bf16-policy forward keeps the probabilities within the
LM slice's bf16 bound (0.1) of the reference's bf16 forward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import vit as jvit
from bigdl_tpu.nn.criterion import ClassNLLCriterion as JaxNLL
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.ops.precision import DtypePolicy as JaxPolicy
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                flatten_tree,
                                                import_tree_state)
from bigdl_tpu_torch.models import vit
from bigdl_tpu_torch.nn import ClassNLLCriterion, Mean, TransformerEncoder
from bigdl_tpu_torch.ops.precision import DtypePolicy

ATOL, RTOL = 1e-5, 1e-4
SMALL = dict(image_size=32, patch_size=8, embed_dim=32, num_heads=4,
             ffn_dim=64, num_layers=2)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=0):
    JaxRNG.RNG().set_seed(seed)
    jm = jvit.build(10, **SMALL)
    tm = vit.build(10, **SMALL, device="cpu", seed=seed)
    params = flatten_tree(jm.parameter_tree())
    got, _ = export_tree_state(tm)
    assert sorted(got) == sorted(params)
    import_tree_state(tm, params, flatten_tree(jm.buffer_tree()))
    return jm, tm


def _batch(b=3, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 32, 32, 3)).astype(np.float32)
    y = rng.integers(1, 11, (b,)).astype(np.float32)
    return x, y


def test_structure_is_the_reference_recipe():
    tm = vit.build(10, **SMALL, device="cpu")
    kinds = [type(m).__name__ for m in tm.children()]
    assert kinds == ["SpatialConvolution", "Reshape", "CAdd",
                     "TransformerEncoder", "Mean", "Linear", "LogSoftMax"]
    enc = next(m for m in tm.modules() if isinstance(m, TransformerEncoder))
    assert not enc.layer0.self_attn.causal
    assert next(m for m in tm.modules() if isinstance(m, Mean)).dimension == 2
    with pytest.raises(ValueError, match="multiple"):
        vit.build(10, image_size=30, patch_size=8, device="cpu")


def test_log_probs_and_gradients_match_reference():
    jm, tm = _pair()
    x, y = _batch()

    def loss_fn(p):
        out, _ = functional_apply(jm, p, jm.buffer_tree(), jnp.asarray(x),
                                  training=True)
        return JaxNLL().apply(out, jnp.asarray(y)), out

    (ref_loss, ref_out), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(jm.parameter_tree())
    tm.train()
    out = tm(torch.from_numpy(x))
    loss = ClassNLLCriterion()(out, torch.from_numpy(y))
    loss.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=RTOL)
    ref_grads = flatten_tree(grads)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), ref_grads[name],
                                   atol=ATOL, rtol=RTOL, err_msg=name)


def test_vit_s16_parameter_count_equals_reference(monkeypatch):
    # the reference's draws replaced by zeros: the count does not depend
    # on them, and its 22M-parameter build stays cheap
    monkeypatch.setattr(JaxRNG, "uniform",
                        lambda self, lo=0.0, hi=1.0, size=None: np.zeros(size))
    monkeypatch.setattr(JaxRNG, "normal",
                        lambda self, m=0.0, s=1.0, size=None: np.zeros(size))
    want = jvit.build(1000).n_parameters()
    got = sum(p.numel() for p in vit.build(1000, device="cpu").parameters())
    assert got == want
    assert abs(got - 22.0e6) < 0.5e6


def test_bf16_policy_forward_within_bf16_bound():
    jm, tm = _pair(seed=3)
    x, _ = _batch(b=2, seed=4)
    policy = JaxPolicy.bf16()
    ref, _ = jax.jit(lambda p, xin: functional_apply(
        jm, policy.cast_params_for_compute(p), jm.buffer_tree(), xin,
        training=False))(jm.parameter_tree(), jnp.asarray(x))
    params = dict(tm.named_parameters())
    tm.eval()
    with torch.no_grad():
        got = torch.func.functional_call(
            tm, DtypePolicy.bf16().cast_params_for_compute(params),
            (torch.from_numpy(x),))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.isfinite(got).all()
    ref = np.asarray(ref, np.float32)
    assert np.abs(np.exp(got) - np.exp(ref)).max() < 0.1


def test_small_vit_trains_through_the_cache_as_the_reference():
    """The slice as a whole: the small ViT, 3 SGD iterations through
    ``DeviceCachedDataSet`` in both packages, from the same weights and
    the same seeded data and shuffle seed: every iteration's loss and
    the final parameters within 1e-5 relative."""
    from bigdl_tpu.dataset import DeviceCachedDataSet as JaxCache
    from bigdl_tpu.dataset.base import DataSet as JaxDataSet
    from bigdl_tpu.dataset.base import Sample as JaxSample
    from bigdl_tpu.optim import SGD as JaxSGD
    from bigdl_tpu.optim import Optimizer as JaxOptimizer
    from bigdl_tpu.optim import Trigger as JaxTrigger
    from bigdl_tpu_torch.dataset import DeviceCachedDataSet
    from bigdl_tpu_torch.dataset.base import DataSet, Sample
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    from bigdl_tpu_torch.utils.rng import RandomGenerator

    jm, tm = _pair(seed=5)
    x, y = _batch(b=8, seed=6)
    JaxRNG.RNG().set_seed(9)
    ref_opt = JaxOptimizer(jm, JaxCache(JaxDataSet.array(
        [JaxSample(a, b) for a, b in zip(x, y)]), batch_size=4), JaxNLL())
    ref_opt.set_optim_method(JaxSGD(learningrate=0.05)) \
        .set_end_when(JaxTrigger.max_iteration(3))
    ref_losses = []

    class LossSink:
        def add_scalar(self, tag, value, step):
            if tag == "Loss":
                ref_losses.append(value)

    ref_opt.set_train_summary(LossSink())
    trained = ref_opt.optimize()
    RandomGenerator.RNG().set_seed(9)
    opt = Optimizer(tm, DeviceCachedDataSet(DataSet.array(
        [Sample(a, b) for a, b in zip(x, y)]), 4, device="cpu"),
        ClassNLLCriterion(), device="cpu")
    opt.set_optim_method(SGD(learningrate=0.05)) \
       .set_end_when(Trigger.max_iteration(3))
    opt.optimize()
    losses = [h["loss"] for h in opt.history]
    assert len(losses) == len(ref_losses) == 3
    np.testing.assert_allclose(losses, ref_losses, rtol=1e-5)
    ref_params = flatten_tree(trained.parameter_tree())
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref_params[name],
                                   rtol=1e-5, atol=1e-6, err_msg=name)
