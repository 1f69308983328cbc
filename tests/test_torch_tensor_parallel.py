"""The port's tensor (Megatron) parallelism against the reference's, on the
CPU.

In this process: ``infer_param_specs``, ``opt_state_specs`` and the
auto-tagging against the reference's on the same models (the cases of the
reference's ``tests/test_tensor_parallel.py``: the indivisible fallback, a
lone Linear, the MLP pair, the causal-LM head, swiglu), fsdp over a tensor
axis (``base_specs``), and the head-aligned shard of the fused q;k;v rows
round-tripped bit for bit. In four gloo ranks (one spawn,
``MeshTopology(data=2, tensor=2)``, ``torch_parallel_worker.py``'s ``tp``
job): a ``TransformerEncoderLayer`` (E=16, 4 heads, 2 kv heads, swiglu,
RoPE) sharded at tp=2, without and with sequence-parallel regions, its
forward and input and weight gradients within 1e-5 of the reference's
single-device layer and its collectives held to the Megatron structure;
an MLP trained 4 SGD-momentum steps at dp=2 x tp=2 within the
reference's own ``test_tp_matches_dp`` bound (2e-3 absolute) of the
reference's single-device training, its snapshot after the first
iteration resumed by one process to the same end; and the ``apps.transformer train``
CLI with ``--tensorParallel 2`` and ``--contextParallel ring`` (the
``cli`` job) at world 4.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from bigdl_tpu_torch.interop.state_dict import flatten_tree
from bigdl_tpu_torch.parallel import tensor_parallel as tp

LAYER_TOL = 1e-5
MLP_ATOL = 2e-3


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat_ref(specs):
    """A reference spec tree by dotted name, each spec a tuple."""
    from jax.sharding import PartitionSpec as P
    out = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                assert isinstance(v, P)
                out[prefix + k] = tuple(v)
    walk(specs, "")
    return out


def _pairs():
    """(name, reference model, port model, axis_size) of the reference
    test's cases, built alike."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.models import transformer as jtr
    from bigdl_tpu.parallel.tensor_parallel import COLUMN as JCOL
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.models import transformer
    cases = []
    lin_j, lin_p = jnn.Linear(7, 10), nn.Linear(7, 10)
    lin_j.tp_mode, lin_p.tp_mode = JCOL, tp.COLUMN
    cases += [("indivisible", lin_j, lin_p, 4)]
    lin_j2, lin_p2 = jnn.Linear(7, 10), nn.Linear(7, 10)
    lin_j2.tp_mode, lin_p2.tp_mode = JCOL, tp.COLUMN
    cases += [("divisible", lin_j2, lin_p2, 2)]
    cases += [("lone_linear", jnn.Sequential().add(jnn.Linear(16, 16))
               .add(jnn.ReLU()), nn.Sequential().add(nn.Linear(16, 16))
               .add(nn.ReLU()), 2)]
    cases += [("mlp_pair",
               jnn.Sequential().add(jnn.Linear(784, 64)).add(jnn.ReLU())
               .add(jnn.Linear(64, 10)).add(jnn.LogSoftMax()),
               nn.Sequential().add(nn.Linear(784, 64)).add(nn.ReLU())
               .add(nn.Linear(64, 10)).add(nn.LogSoftMax()), 2)]
    lm = dict(embed_dim=16, num_heads=2, ffn_dim=32, num_layers=1,
              max_len=32)
    cases += [("causal_lm_head", jtr.build_lm(1000, **lm),
               transformer.build_lm(1000, **lm, device="cpu"), 2)]
    sw = dict(embed_dim=16, num_heads=4, num_kv_heads=2, ffn_dim=32,
              num_layers=2, max_len=32, rope=True, activation="swiglu",
              norm="rms", bias=False, tie_embeddings=True)
    cases += [("swiglu_tied", jtr.build_lm(64, **sw),
               transformer.build_lm(64, **sw, device="cpu"), 2)]
    return cases


@pytest.mark.parametrize("case", [c[0] for c in _pairs()] + ["no_size"])
def test_specs_and_tags_equal_the_references(case):
    from bigdl_tpu.parallel.tensor_parallel import (
        infer_param_specs as ref_specs)
    if case == "no_size":
        name, jm, pm, _ = _pairs()[3]
        size = None
    else:
        name, jm, pm, size = next(c for c in _pairs() if c[0] == case)
    want = _flat_ref(ref_specs(jm, axis_size=size))
    got = tp.flat_specs(tp.infer_param_specs(pm, axis_size=size))
    assert got == want
    # the tags the walk left: the same modules, the same modes
    assert _tags(pm) == _tags(jm)
    if case == "causal_lm_head":
        assert got["3.inner.weight"] == ("tensor", None)
        assert got["0.weight"] == (None, "tensor")


def _tags(m, prefix=""):
    """{module path: tp_mode} of the tagged modules."""
    out = {}
    if getattr(m, "tp_mode", None) is not None:
        out[prefix] = m.tp_mode
    for name, child in m._modules.items():
        if child is not None:
            out.update(_tags(child, f"{prefix}{name}."))
    return out


def test_opt_state_and_fsdp_specs_equal_the_references():
    from bigdl_tpu.optim import SGD as JSGD
    from bigdl_tpu.parallel.fsdp import fsdp_param_specs as ref_fsdp
    from bigdl_tpu.parallel.tensor_parallel import (
        infer_param_specs as ref_specs, opt_state_specs as ref_state)
    from bigdl_tpu_torch.optim import SGD
    from bigdl_tpu_torch.parallel import fsdp_param_specs
    _, jm, pm, size = _pairs()[5]
    jp = jm.parameter_tree()
    jspecs = ref_specs(jm, axis_size=size)
    jstate = ref_state(jax.eval_shape(JSGD(momentum=0.9).init_state, jp),
                       jp, jspecs)
    params = dict(pm.named_parameters())
    pspecs = tp.flat_specs(tp.infer_param_specs(pm, axis_size=size))
    pstate = tp.opt_state_specs(SGD(momentum=0.9).init_state(params),
                                params, pspecs)
    assert set(pstate) == set(jstate)
    for key in jstate:
        if isinstance(jstate[key], dict):
            assert pstate[key] == _flat_ref(jstate[key]), key
        else:
            assert pstate[key] == tuple(jstate[key]), key
    # fsdp x tp: the tensor entries kept, the data axis on a free dim
    want = _flat_ref(ref_fsdp(jp, 2, base_specs=jspecs))
    assert fsdp_param_specs(params, 2, base_specs=pspecs) == want


def test_in_proj_head_aligned_shard_round_trips():
    from bigdl_tpu_torch import nn
    gen = torch.Generator().manual_seed(0)
    mha = nn.MultiHeadAttention(768, 12, num_kv_heads=4, with_bias=True)
    with torch.no_grad():
        mha.in_proj_weight.copy_(torch.randn(mha.in_proj_weight.shape,
                                             generator=gen))
        mha.in_proj_bias.copy_(torch.randn(mha.in_proj_bias.shape,
                                           generator=gen))
    for name in ("in_proj_weight", "in_proj_bias"):
        full = getattr(mha, name).detach()
        spec = ("tensor", None) if full.dim() == 2 else ("tensor",)
        pieces = [tp.shard_leaf(mha, name, full, spec, 2, r) for r in (0, 1)]
        # rank 0: q heads 0-5, k heads 0-1, v heads 0-1
        assert torch.equal(pieces[0][:384], full[:384])
        assert torch.equal(pieces[0][384:512], full[768:896])
        assert torch.equal(pieces[1][512:], full[1152:])
        assert torch.equal(tp.unshard_leaf(mha, name, pieces, spec), full)


# ------------------------------------------------------- four gloo ranks
@pytest.fixture(scope="module", autouse=True)
def world4(tmp_path_factory):
    """The ranks start with the file, so they run beside the in-process
    tests."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.utils.rng import manual_seed
    out = tmp_path_factory.mktemp("tp")
    manual_seed(5)
    layer = jnn.TransformerEncoderLayer(16, 4, 32, activation="swiglu",
                                        rope=True, num_kv_heads=2,
                                        causal=True)
    rng = np.random.default_rng(3)
    x = rng.normal(0, 1, (2, 8, 16)).astype(np.float32)
    cot = rng.normal(0, 1, (2, 8, 16)).astype(np.float32)
    lp = flatten_tree(layer.parameter_tree())
    np.savez(out / "tp_layer.npz", x=x, cot=cot,
             **{"p:" + k: v for k, v in lp.items()})
    mlp = (jnn.Sequential().add(jnn.Linear(12, 16)).add(jnn.ReLU())
           .add(jnn.Linear(16, 5)).add(jnn.LogSoftMax()))
    mx = rng.normal(0, 1, (16, 12)).astype(np.float32)
    my = rng.integers(1, 6, 16).astype(np.float32)
    mp = flatten_tree(mlp.parameter_tree())
    np.savez(out / "tp_mlp.npz", x=mx, y=my,
             **{"p:" + k: v for k, v in mp.items()})
    procs = worker.spawn(out, 4, ["tp", "cli"])
    done = []

    def result():
        if not done:
            worker.wait(procs, out)
            done.append(True)
        return out
    yield {"result": result, "layer": layer, "x": x, "cot": cot,
           "mlp": mlp, "mx": mx, "my": my}
    for p in procs:
        p.kill()


def _layer_reference(layer, x, cot):
    from bigdl_tpu.nn.module import functional_apply
    params = layer.parameter_tree()

    def f(p, xx):
        out, _ = functional_apply(layer, p, {}, xx, training=False)
        return out

    @jax.jit
    def run(p, xx, c):
        y, vjp = jax.vjp(f, p, xx)
        gp, gx = vjp(c)
        return y, gx, gp
    y, gx, gp = run(params, jnp.asarray(x), jnp.asarray(cot))
    return np.asarray(y), np.asarray(gx), flatten_tree(gp)


@pytest.mark.parametrize("tag", ["tp", "sp"])
def test_layer_matches_the_single_device_reference(world4, tag):
    y, gx, gp = _layer_reference(world4["layer"], world4["x"],
                                 world4["cot"])
    out = world4["result"]()
    for rank in range(4):
        z = np.load(out / f"tp.{rank}.npz")
        np.testing.assert_allclose(z[f"{tag}:y"], y, rtol=0, atol=LAYER_TOL)
        np.testing.assert_allclose(z[f"{tag}:dx"], gx, rtol=0,
                                   atol=LAYER_TOL)
        for name, g in gp.items():
            np.testing.assert_allclose(z[f"{tag}:g:{name}"], g, rtol=0,
                                       atol=LAYER_TOL, err_msg=name)
        assert bool(z[f"{tag}:roundtrip"])
        assert bool(z[f"{tag}:import_local"])
        # (16 q rows + 2 x 8 kv rows) / 2
        assert z[f"{tag}:in_proj_local"].shape == (16, 16)
    if tag == "sp":
        assert sorted(z["sp:partial"]) == [
            "linear2.bias", "norm1.bias", "norm1.weight", "norm2.bias",
            "norm2.weight", "self_attn.out_proj_bias"]


@pytest.mark.parametrize("mode", ["column", "row"])
def test_a_lone_linear_matches_its_whole_self(world4, mode):
    """A column Linear with no row partner gathers its output; a row one
    with no column partner splits its input."""
    out = world4["result"]()
    for rank in range(4):
        z = np.load(out / f"tp.{rank}.npz")
        assert float(z[f"lone_{mode}:err"]) <= LAYER_TOL


@pytest.mark.parametrize("tag", ["tp", "sp"])
def test_layer_collectives_follow_the_megatron_structure(world4, tag):
    out = world4["result"]()
    want = ({"all_reduce/tensor": 4} if tag == "tp" else
            # regions: 2 gathers + 2 reduce-scatters forward, their
            # transposes backward; the stream's split (backward: a gather)
            # and the exit gather (forward)
            {"all_gather/tensor": 6, "reduce_scatter/tensor": 4})
    for rank in range(4):
        with open(out / f"tp_counts_{tag}.{rank}.json") as f:
            assert json.load(f) == want


def _mlp_reference(mlp, x, y):
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.dataset.base import DataSet, Sample, SampleToBatch
    from bigdl_tpu.optim import Optimizer, SGD, Trigger
    ds = DataSet.array([Sample(f, float(l)) for f, l in zip(x, y)]) \
        >> SampleToBatch(16)
    opt = Optimizer(mlp, ds, jnn.ClassNLLCriterion())
    opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
    opt.set_end_when(Trigger.max_iteration(4))
    return flatten_tree(opt.optimize().parameter_tree())


def test_dp_by_tp_training_matches_the_single_device_reference(world4):
    want = _mlp_reference(world4["mlp"], world4["mx"], world4["my"])
    out = world4["result"]()
    for rank in range(4):
        z = np.load(out / f"tp.{rank}.npz")
        for name, w in want.items():
            np.testing.assert_allclose(z["mlp:" + name], w, rtol=0,
                                       atol=MLP_ATOL, err_msg=name)
        # each rank held half of the column layer's rows
        assert tuple(z["mlp:local_weight_shape"]) == (8, 12)
    # the snapshot before iteration 2 (full leaves) resumed at tp=1
    z = np.load(out / "tp.0.npz")
    assert int(z["mlp_tp1:iterations"]) == 3
    for name, w in want.items():
        np.testing.assert_allclose(z["mlp_tp1:" + name], w, rtol=0,
                                   atol=MLP_ATOL, err_msg=name)


def test_the_cli_trains_tensor_and_context_parallel(world4):
    out = world4["result"]()
    runs = []
    for rank in range(4):
        with open(out / f"cli.{rank}.json") as f:
            runs.append(json.load(f))
    for mode, iters in (("tp", 2), ("cp", 2)):
        losses = runs[0][mode]
        assert len(losses) == iters and np.isfinite(losses).all(), mode
        # the logged loss is the ranks' mean: one value on every rank
        assert all(r[mode] == losses for r in runs), mode
