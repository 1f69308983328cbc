"""The rest of the reference's public methods that a class-by-class
comparison found missing, on the CPU against the JAX package:
``MultiHeadAttention.set_mask`` (and the ``(query, key, value[, mask])``
input), ``Table.insert`` / ``get_or_else`` / ``clone``, ``DataSet.sort``,
``OptimMethod.get_hyper_parameter`` over the nine methods,
``ResumePoint.saved_mesh``, the quantized twins' dequantized weight
views, and the package root's names. Attention outputs agree within 1e-5
of max|ref|; the rest is equal. Also: ``output`` is recorded for the
user's own calls, on any thread, and never by the port's own loops.
"""

import subprocess
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bigdl_tpu
import bigdl_tpu_torch
from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.base import DataSet as JDataSet
from bigdl_tpu.dataset.base import Sample as JSample
from bigdl_tpu.optim import methods as jmethods
from bigdl_tpu.resilience.coordinator import ResumePoint as JResumePoint
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu.utils.table import T as JT
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.base import DataSet, Sample
from bigdl_tpu_torch.optim import methods
from bigdl_tpu_torch.resilience.coordinator import ResumePoint
from bigdl_tpu_torch.utils.rng import RandomGenerator as PortRNG
from bigdl_tpu_torch.utils.table import T, Table

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5


@pytest.fixture(autouse=True)
def one_thread():
    """One thread; and the global generators the test draws from (both
    packages' ``RandomGenerator`` and PyTorch's) left as it found them."""
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


def _x(shape, seed=0):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def _close(got, ref, tol=RTOL):
    got = np.asarray(got.detach(), np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


def _mha_pair(**kw):
    jm = jnn.MultiHeadAttention(8, 2, **kw)
    tm = nn.MultiHeadAttention(8, 2, **kw)
    tm.load_parameter_tree(jax.tree_util.tree_map(np.asarray,
                                                  jm.parameter_tree()))
    for m in (jm, tm):
        m.evaluate_mode()
    return jm, tm


def _mask(s, seed):
    rng = np.random.default_rng(seed)
    m = rng.random((1, 1, s, s)) < 0.7
    m[..., 0] = True          # every row attends somewhere
    return m


@pytest.mark.parametrize("causal", [False, True])
def test_set_mask_matches_the_reference(causal):
    jm, tm = _mha_pair(causal=causal)
    x = _x((2, 6, 8), seed=1)
    mask = _mask(6, seed=2)
    assert tm.attn_mask is None
    assert tm.set_mask(torch.from_numpy(mask)) is tm
    jm.set_mask(jnp.asarray(mask))
    _close(tm(torch.from_numpy(x)), jm.forward(jnp.asarray(x)))
    # the 4th input element overrides the set mask
    other = _mask(6, seed=3)
    xt = torch.from_numpy(x)
    got = tm((xt, xt, xt, torch.from_numpy(other)))
    want = jm.forward((jnp.asarray(x),) * 3 + (jnp.asarray(other),))
    _close(got, want)
    assert not np.allclose(got.detach().numpy(),
                           tm(xt).detach().numpy())
    # unset: the unmasked forward again
    tm.set_mask(None)
    jm.set_mask(None)
    _close(tm(xt), jm.forward(jnp.asarray(x)))


def test_cross_attention_inputs_match_the_reference():
    jm, tm = _mha_pair()
    q, k, v = _x((2, 3, 8), seed=4), _x((2, 5, 8), seed=5), \
        _x((2, 5, 8), seed=6)
    got = tm(T(*(torch.from_numpy(a) for a in (q, k, v))))
    want = jm.forward(JT(*(jnp.asarray(a) for a in (q, k, v))))
    _close(got, want)
    rope = nn.MultiHeadAttention(8, 2, rope=True)
    with pytest.raises(ValueError, match="rope"):
        rope((torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)))


def test_table_methods_match_the_reference():
    t, j = T(1.0, "a"), JT(1.0, "a")
    assert t.insert(3) is t and j.insert(3) is j
    assert dict(t) == dict(j) == {1: 1.0, 2: "a", 3: 3}
    assert t.get_or_else(9, "d") == j.get_or_else(9, "d") == "d"
    assert t.get_or_else(2, "d") == "a"
    c = t.clone()
    assert isinstance(c, Table) and c == t and c is not t
    c.insert(4)
    assert t.length() == 3 and c.length() == 4


def test_dataset_sort_orders_by_length():
    rng = np.random.default_rng(7)
    lengths = rng.integers(1, 9, 12)
    feats = [rng.normal(size=(int(n), 2)).astype(np.float32)
             for n in lengths]
    labels = [float(i % 3 + 1) for i in range(12)]
    port = DataSet.sort([Sample(f, y) for f, y in zip(feats, labels)])
    ref = JDataSet.sort([JSample(f, y) for f, y in zip(feats, labels)])
    got = [(s.feature.shape[0], float(s.label)) for s in port.data(
        train=False)]
    want = [(s.feature.shape[0], float(np.asarray(s.label)))
            for s in ref.data(train=False)]
    assert got == want
    assert [n for n, _ in got] == sorted(lengths.tolist())
    by_label = DataSet.sort([Sample(f, y) for f, y in zip(feats, labels)],
                            key=lambda s: -float(s.label))
    assert [float(s.label) for s in by_label.data(train=False)][:4] == \
        [3.0] * 4


_OPTIM = [
    ("OptimMethod", dict(learningrate=0.3, weightdecay=0.01)),
    ("SGD", dict(learningrate=0.1, weightdecay=1e-4, momentum=0.9)),
    ("Adagrad", dict(learningrate=0.05, weightdecay=0.002)),
    ("Adam", dict(learningrate=1e-3, weightdecay=0.03)),
    ("AdamW", dict(learningrate=2e-4, weightdecay=0.1)),
    ("Adamax", dict(learningrate=0.002)),
    ("Adadelta", dict(decayrate=0.8)),
    ("RMSprop", dict(learningrate=0.01)),
    ("LBFGS", dict(max_iter=5)),
]


@pytest.mark.parametrize("name,kw", _OPTIM, ids=[n for n, _ in _OPTIM])
def test_get_hyper_parameter_matches_the_reference(name, kw):
    got = getattr(methods, name)(**kw).get_hyper_parameter()
    want = getattr(jmethods, name)(**kw).get_hyper_parameter()
    assert isinstance(got, Table)
    assert dict(got) == dict(want)


def test_resume_point_saved_mesh():
    mesh = {"data": 2, "tensor": 1}
    args = ("m", "s", 3, False)
    assert ResumePoint(*args, marker={"mesh": mesh}).saved_mesh() == \
        JResumePoint(*args, marker={"mesh": mesh}).saved_mesh() == mesh
    assert ResumePoint(*args).saved_mesh() is None
    assert ResumePoint(*args, marker={"step": 1}).saved_mesh() is None


def test_quantized_twins_show_their_dequantized_weights():
    from bigdl_tpu_torch.nn.quantized import quantize_model
    model = nn.Sequential().add(nn.Linear(16, 8)) \
        .add(nn.MultiHeadAttention(8, 2))
    q = quantize_model(model, device="cpu")
    lin, mha = q.get_submodule("0"), q.get_submodule("1")
    assert torch.equal(lin.weight, lin._dequant("weight"))
    assert lin.weight.dtype == torch.bfloat16
    w = model.get_submodule("0").weight.detach()
    assert (lin.weight.float() - w).abs().max() <= w.abs().max() / 100
    assert mha.in_proj_weight.shape == (24, 8)
    assert mha.out_proj_weight.shape == (8, 8)


def test_the_package_root_serves_the_reference_names():
    assert set(bigdl_tpu.__all__) <= set(bigdl_tpu_torch.__all__)
    for name in bigdl_tpu.__all__:
        assert getattr(bigdl_tpu_torch, name) is not None, name
    bt = bigdl_tpu_torch
    assert isinstance(bt.nn.Sequential().add(bt.nn.Linear(2, 2)),
                      bt.nn.Sequential)
    assert bt.T(1, 2) == bt.Table({1: 1, 2: 2})
    assert bt.optim.SGD is methods.SGD
    with pytest.raises(AttributeError):
        bt.no_such_name
    code = ("import sys, bigdl_tpu_torch\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _mlp():
    torch.manual_seed(0)
    return (nn.Sequential().add(nn.Linear(4, 8)).add(nn.ReLU())
            .add(nn.Linear(8, 3)).add(nn.LogSoftMax()))


def _outputs(model):
    return [m.output for m in model.modules() if m.output is not None]


def _on_a_thread(fn):
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join(timeout=120)
    assert out, "the thread did not finish"
    return out[0]


def test_a_users_calls_record_their_output_on_any_thread():
    model = _mlp()
    x = torch.from_numpy(_x((5, 4)))
    y = model(x)
    assert model.output is y and len(_outputs(model)) == 5
    model = _mlp()
    y = _on_a_thread(lambda: model(x))
    assert model.output is y and len(_outputs(model)) == 5
    model = _mlp()
    with bigdl_tpu_torch.nn.module.record_outputs(False):
        model(x)
    assert not _outputs(model)


def _lm():
    from bigdl_tpu_torch.models.transformer import build_lm
    return build_lm(50, embed_dim=16, num_heads=2, ffn_dim=32, num_layers=2,
                    max_len=32, rope=True, device="cpu", seed=1).eval()


def _classifier_loops():
    from bigdl_tpu_torch.ml.classifier import DLClassifier
    from bigdl_tpu_torch.optim import Top1Accuracy
    x, y = _x((12, 4)), np.arange(12) % 3 + 1.0
    model = _mlp()
    fitted = DLClassifier(model, batch_size=4, max_epoch=1,
                          device="cpu").fit(x, y)
    yield model
    fitted.transform(x)
    yield model
    model.evaluate(DataSet.array([Sample(x[i], y[i]) for i in range(12)]),
                   [Top1Accuracy()])
    yield model


def _lm_loops():
    from bigdl_tpu_torch.models.generation import generate
    from bigdl_tpu_torch.models.serving import ContinuousLMServer
    model = _lm()
    generate(model, [[3, 4, 5]], 3, greedy=True, device="cpu")
    yield model
    srv = ContinuousLMServer(model, slots=1, max_len=32, greedy=True,
                             prefill_chunk=4, prefill_mode="bucketed",
                             device="cpu")
    try:
        # on a client thread, as the router calls it
        _on_a_thread(lambda: srv.prefill_handoff([3, 4, 5, 6, 7]))
        yield model
        srv.submit([3, 4, 5], 3, timeout=60)
        yield model
    finally:
        srv.close()


@pytest.mark.parametrize("loops", [_classifier_loops, _lm_loops],
                         ids=["fit-transform-evaluate",
                              "generate-handoff-serve"])
def test_the_ports_loops_record_no_output(loops):
    for model in loops():
        assert not _outputs(model)
