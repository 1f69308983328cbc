"""Faults C.2 and C.4 of the port against the JAX package, on the CPU
(C.1, ``LayerNorm``: ``test_torch_layer_zoo_layernorm.py``; C.3,
``perf --memStats`` on stderr: ``tests/test_torch_perf_app.py``).

- C.2: ``Dropout``, ``MultiHeadAttention``, ``TransformerEncoderLayer``,
  ``TransformerEncoder``, ``SampleToBatch`` and ``SpatialConvolution``
  take their positional arguments in the reference's order: each is built
  positionally in both packages and the parameter names and attributes
  compared. The reference's blockwise, context-parallel and MoE arguments
  are placeholders that refuse any value but their default, and
  ``SampleToBatch``'s padding options refuse theirs citing ROADMAP A.6.
- C.4: ``quantize_model`` of LeNet-5 gives ``QuantizedSpatialConvolution``
  children in both packages, and the two int8 twins' log-probs agree
  within the int8 twin's known difference (ROADMAP C: 1e-2 absolute);
  the conv twin holds an int8 HWIO kernel with per-output-channel f32
  scales and refuses ``reset``.
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


# ------------------------------------------------------------------- C.2
@pytest.mark.parametrize("args", [(0.5, False), (0.3, True, False),
                                  (0.2, False, True)])
def test_dropout_positional(args):
    jm, tm = jnn.Dropout(*args), nn.Dropout(*args)
    assert (tm.p, tm.scale) == (jm.p, jm.scale)


@pytest.mark.parametrize("args", [(8, 2, 0.0), (8, 2, 0.1),
                                  (8, 2, 0.0, False, True),
                                  (8, 2, 0.0, True, True, 0, None, "ring",
                                   "contiguous", True, 1)])
def test_multi_head_attention_positional(args):
    jm, tm = jnn.MultiHeadAttention(*args), nn.MultiHeadAttention(*args)
    assert _names(tm) == _names(jm.parameter_tree())
    assert tm.attn_drop.p == jm.dropout_p
    assert (tm.with_bias, tm.causal, tm.rope, tm.num_kv_heads) == (
        jm.with_bias, jm.causal, jm.rope, jm.num_kv_heads)


@pytest.mark.parametrize("args", [(8, 2, 16, 0.1), (8, 2, 16, 0.0, "relu"),
                                  (8, 2, 16, 0.2, "gelu", False, True)])
def test_encoder_layer_positional(args):
    if "relu" in args:
        with pytest.raises(ValueError, match="activation"):
            nn.TransformerEncoderLayer(*args)
        return
    jm = jnn.TransformerEncoderLayer(*args)
    tm = nn.TransformerEncoderLayer(*args)
    assert _names(tm) == _names(jm.parameter_tree())
    assert (tm.activation, tm.pre_norm, tm.self_attn.causal) == (
        jm.activation, jm.pre_norm, jm.self_attn.causal)
    assert tm.drop.p == args[3] == tm.self_attn.attn_drop.p


@pytest.mark.parametrize("args", [(1, 8, 2, 16, 0.1),
                                  (2, 8, 2, 16, 0.0, "gelu", False, True)])
def test_encoder_positional(args):
    jm, tm = jnn.TransformerEncoder(*args), nn.TransformerEncoder(*args)
    assert _names(tm) == _names(jm.parameter_tree())
    assert tm.num_layers == jm.num_layers
    assert (tm.final_norm is None) == (not args[6] if len(args) > 6
                                       else False)


@pytest.mark.parametrize("cls,kw", [
    ("MultiHeadAttention", {"block_size": 16}),
    ("MultiHeadAttention", {"seq_axis": "sp"}),
    ("MultiHeadAttention", {"seq_mode": "all_gather"}),
    ("TransformerEncoderLayer", {"seq_layout": "zigzag"}),
    ("TransformerEncoderLayer", {"moe_experts": 4}),
    ("TransformerEncoder", {"moe_k": 1})])
def test_unported_arguments_refuse_other_values(cls, kw):
    args = {"MultiHeadAttention": (8, 2),
            "TransformerEncoderLayer": (8, 2, 16),
            "TransformerEncoder": (1, 8, 2, 16)}[cls]
    with pytest.raises(NotImplementedError, match="ROADMAP A.4"):
        getattr(nn, cls)(*args, **kw)


def test_sample_to_batch_positional():
    samples = [Sample(np.full(3, i, np.float32), np.float32(i))
               for i in range(5)]
    jsamples = [JSample(np.full(3, i, np.float32), np.float32(i))
                for i in range(5)]
    got = list(SampleToBatch(2, None, None, None, False)(iter(samples)))
    ref = list(JSampleToBatch(2, None, None, None, False)(iter(jsamples)))
    assert [b.size() for b in got] == [b.size() for b in ref] == [2, 2, 1]
    for value, name in ((0.0, "feature_padding"), (-1.0, "label_padding")):
        with pytest.raises(NotImplementedError,
                           match=r"A\.6 \(SampleToBatch padding\)"):
            SampleToBatch(2, **{name: value})
    with pytest.raises(NotImplementedError, match="fixed_length"):
        SampleToBatch(2, None, None, 10)


def test_spatial_convolution_twelfth_argument_is_the_weight_regularizer():
    args = (3, 4, 3, 3, 1, 1, 1, 1, 1, True, True)
    jm = jnn.SpatialConvolution(*args, jnn.L2Regularizer(0.1),
                                jnn.L1Regularizer(0.2), "kaiming")
    tm = nn.SpatialConvolution(*args, nn.L2Regularizer(0.1),
                               nn.L1Regularizer(0.2), "kaiming")
    assert _names(tm) == _names(jm.parameter_tree())
    assert tm.init_method == jm.init_method == "kaiming"
    for k in ("weight", "bias"):
        assert (type(tm.regularizer_tree()[k]).__name__
                == type(jm.regularizer_tree()[k]).__name__)


# ------------------------------------------------------------------- C.4
def test_quantize_lenet_quantizes_the_convolutions():
    jm = jlenet.build(10)
    tm = lenet.build(10, device="cpu")
    import_tree_state(tm, flatten_tree(jm.parameter_tree()), {})
    jq, tq = jquantize(jm), quantize_model(tm, device="cpu")
    assert ([type(m).__name__ for m in jq._modules.values()]
            == [type(m).__name__ for m in tq._modules.values()])
    convs = [m for m in tq.modules()
             if isinstance(m, QuantizedSpatialConvolution)]
    assert len(convs) == 2
    for m in convs:
        assert m.weight_q.dtype == torch.int8
        assert m.weight_scale.shape == (1, 1, 1, m.n_output_plane)
        with pytest.raises(RuntimeError, match="inference-only"):
            m.reset()
    assert list(tq.parameters()) == []
    x = np.random.default_rng(0).normal(0, 1, (4, 28, 28, 1)).astype(
        np.float32)
    ref = np.asarray(jq.forward(jnp.asarray(x)), np.float32)
    got = tq(torch.from_numpy(x)).float().detach().numpy()
    assert np.abs(got - ref).max() <= 1e-2
    # and the twins stay near their f32 model
    f32 = tm.eval()(torch.from_numpy(x)).detach().numpy()
    assert np.abs(got - f32).max() < 0.1


def test_quantized_conv_buffers_match_the_reference():
    jm = jnn.Sequential().add(jnn.SpatialConvolution(3, 5, 3, 3))
    tm = nn.Sequential().add(nn.SpatialConvolution(3, 5, 3, 3))
    import_tree_state(tm, flatten_tree(jm.parameter_tree()), {})
    jq, tq = jquantize(jm), quantize_model(tm, device="cpu")
    want = flatten_tree(jq.buffer_tree())
    got = export_tree_state(tq)[1]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
