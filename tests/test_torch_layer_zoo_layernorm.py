"""Fault C.1 of the port against the JAX package, on the CPU: ``LayerNorm``
normalises over the last ``len(normalized_shape)`` axes and takes
``elementwise_affine`` third; ``LayerNorm((2, 3))`` on
``arange(6).reshape(1, 2, 3)`` gives the reference's six values within
1e-5, forward and input gradients agree over two- and three-axis shapes
with and without the affine parameters, and the last-axis case is
unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.base import Sample as JSample
from bigdl_tpu.dataset.base import SampleToBatch as JSampleToBatch
from bigdl_tpu.models import lenet as jlenet
from bigdl_tpu.nn.quantized import quantize_model as jquantize
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.utils.rng import RandomGenerator as PortRNG
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.base import Sample, SampleToBatch
from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                flatten_tree,
                                                import_tree_state)
from bigdl_tpu_torch.models import lenet
from bigdl_tpu_torch.nn.quantized import (QuantizedSpatialConvolution,
                                          quantize_model)


@pytest.fixture(autouse=True)
def one_thread():
    """One thread; and the global generators the test draws from (both
    packages' ``RandomGenerator`` and PyTorch's) left as it found them, so
    that no later test in the process sees other draws."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    gens = [JaxRNG.RNG(), PortRNG.RNG()]
    saved = [(g._seed, g._np.bit_generator.state, getattr(g, "_key", None))
             for g in gens]
    torch_state = torch.get_rng_state()
    yield
    for g, (seed, state, key) in zip(gens, saved):
        g._seed, g._np.bit_generator.state = seed, state
        if key is not None:
            g._key = key
    torch.set_rng_state(torch_state)
    torch.set_num_threads(n)


def _names(tree_or_module):
    if isinstance(tree_or_module, dict):
        return sorted(flatten_tree(tree_or_module))
    return sorted(export_tree_state(tree_or_module)[0])


# ------------------------------------------------------------------- C.1
def test_layer_norm_over_two_axes():
    x = np.arange(6, dtype=np.float32).reshape(1, 2, 3)
    jm, tm = jnn.LayerNorm((2, 3)), nn.LayerNorm((2, 3))
    ref = np.asarray(jm.forward(jnp.asarray(x)))
    np.testing.assert_allclose(
        ref.reshape(-1), [-1.4638, -0.8783, -0.2928, 0.2928, 0.8783, 1.4638],
        atol=1e-4)
    assert tm.weight.shape == (2, 3)
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("shape,norm", [((4, 2, 3), (2, 3)),
                                        ((2, 3, 4, 5), (3, 4, 5)),
                                        ((3, 7), 7), ((2, 3, 7), (7,))])
@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_reference(shape, norm, affine):
    jm = jnn.LayerNorm(norm, 1e-5, affine)
    tm = nn.LayerNorm(norm, 1e-5, affine)
    rng = np.random.default_rng(0)
    if affine:
        for k in ("weight", "bias"):
            setattr(jm, k, jnp.asarray(rng.normal(0, 1, jm.weight.shape)
                                       .astype(np.float32)))
        import_tree_state(tm, flatten_tree(jm.parameter_tree()), {})
    else:
        assert list(tm.parameters()) == []
    x = rng.normal(0, 2, shape).astype(np.float32)
    import jax
    ref, vjp = jax.vjp(lambda a: jm.forward(a), jnp.asarray(x))
    g = rng.normal(0, 1, shape).astype(np.float32)
    (ref_dx,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_()
    out = tm(xt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=1e-5, rtol=0)
    np.testing.assert_allclose(xt.grad.numpy(), ref_dx, atol=1e-5, rtol=0)


def test_layer_norm_positional_eps_and_affine():
    tm = nn.LayerNorm(3, 1e-5, False)
    assert tm.eps == 1e-5 and not tm.elementwise_affine
    assert list(tm.parameters()) == []
    assert nn.LayerNorm(5, 1e-3).eps == 1e-3
