"""The port's pipeline schedules (``parallel/pipeline.py``) against the
reference's sequential answers, on the CPU.

One spawn of four gloo ranks starts with the file
(``torch_parallel_worker.py``'s ``pp`` job) while this process computes the
reference's answers. Over ``MeshTopology(pipeline=4)``: GPipe of a
``PipelineStack`` of pre-norm ``TransformerEncoderLayer``s (E=16, depth
8, a batch of 16) at n_micro 4, 8 and 16 (loss within 1e-5 of the
reference stack's sequential loss), a depth-4 stack's gradients (a batch
of 8, n_micro 4) within 1e-4 of the
reference's ``jax.grad`` through ``scan_apply``, the ``remat=True``
gradients identical to the plain ones, and a shift count of 2 x the
schedule length a step (forward and backward); a batch-norm stack's loss and
buffers against the reference's microbatch-sequential oracle (1e-4); the
circular schedule (V=2, the depth-8 stack) at M=8 and M=P=4, loss and
un-permuted
gradients; dp x pp over ``MeshTopology(data=2, pipeline=2)`` (each data
rank its half of the batch) against the full batch's loss and gradients;
and ``StagePipeline`` of a heterogeneous LM (embedding + position + block
| block | block | norm + head) at 4 stages, and at 2 under dp=2: the
loss (1e-5) and the (P, L) stacked gradients (the reference's own
2e-4 relative, 1e-6 absolute). In this process: the scan against the
reference's, the raveled (P, L) array bit-equal to the reference's
``StagePipeline.parameter_tree()``, the boundaries' bytes (each at its
own shape, in f32; the reference pads them to one conduit), the refusals
(a stage that mutates
its buffers, a single stage), and the entry points' refusal without a
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from bigdl_tpu_torch.interop.state_dict import flatten_tree

LOSS_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
STAGE_GRAD_TOL = dict(rtol=2e-4, atol=1e-6)
_REF = {}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _block():
    from bigdl_tpu import nn as jnn
    return jnn.TransformerEncoderLayer(16, 2, 32, pre_norm=True)


def _bn_block():
    from bigdl_tpu import nn as jnn
    return (jnn.Sequential()
            .add(jnn.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1,
                                        with_bias=False))
            .add(jnn.SpatialBatchNormalization(8))
            .add(jnn.ReLU()))


def _ref_stack(factory, depth, seed):
    from bigdl_tpu.parallel.pipeline import PipelineStack
    from bigdl_tpu.utils.rng import manual_seed
    manual_seed(seed)
    return PipelineStack(factory, depth)


def _lm_parts(seed=5):
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.utils.rng import manual_seed
    manual_seed(seed)
    e, v = 16, 24
    emb = (jnn.Sequential().add(jnn.LookupTable(v, e))
           .add(jnn.PositionalEncoding(e, 32))
           .add(jnn.TransformerEncoderLayer(e, 2, 32, causal=True)))
    mids = [jnn.Sequential().add(jnn.TransformerEncoderLayer(e, 2, 32,
                                                             causal=True))
            for _ in range(2)]
    head = (jnn.Sequential().add(jnn.LayerNorm(e))
            .add(jnn.TimeDistributed(jnn.Linear(e, v))).add(jnn.LogSoftMax()))
    return [emb, *mids, head]


def _ref_stages(n):
    from bigdl_tpu import nn as jnn
    parts = _lm_parts()
    if n == 4:
        return parts
    return [jnn.Sequential().add(parts[0]).add(parts[1]),
            jnn.Sequential().add(parts[2]).add(parts[3])]


def _seq_loss_and_grads(stack, x, y):
    from bigdl_tpu import nn as jnn
    crit = jnn.MSECriterion()

    def loss(p, x, y):
        return crit.apply(stack.scan_apply(p, x), y)
    val, g = jax.jit(jax.value_and_grad(loss))(
        stack.parameter_tree(), jnp.asarray(x), jnp.asarray(y))
    return float(val), flatten_tree(g)


def _reference_answers(z):
    """Every answer the ranks are held to."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.parallel.pipeline import StagePipeline
    # one batch a stack: each answer compiles once
    s8 = _ref_stack(_block, 8, 3)
    s4 = _ref_stack(_block, 4, 4)
    deep = _seq_loss_and_grads(s8, z["x16"], z["y16"])
    for m in (4, 8, 16):
        _REF[f"gpipe_m{m}"] = deep[0]
    for m in (8, 4):
        _REF[f"circ_m{m}"] = deep
    _REF["gpipe"] = _REF["dpp"] = _seq_loss_and_grads(s4, z["x8"], z["y8"])
    bn = _ref_stack(_bn_block, 4, 6)
    crit = jnn.MSECriterion()
    params, bufs = bn.parameter_tree(), bn.buffer_tree()
    mbs = z["xbn"].reshape(4, 2, 6, 6, 8)
    ybs = z["ybn"].reshape(4, 2, 6, 6, 8)
    step = jax.jit(lambda p, x, b: bn.scan_apply(p, x, training=True,
                                                 buffers=b))
    total = 0.0
    for i in range(4):
        out, bufs = step(params, jnp.asarray(mbs[i]), bufs)
        total += float(crit.apply(out, jnp.asarray(ybs[i])))
    _REF["bn"] = (total / 4, flatten_tree(bufs))
    lm_crit = jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion())
    ids = jnp.asarray(z["ids"], jnp.float32)
    tgt = jnp.asarray(z["tgt"], jnp.float32)
    for n in (4, 2):
        pipe = StagePipeline(_ref_stages(n), sample_microbatch=z["ids"][:1])

        def loss(p):
            return lm_crit.apply(pipe.sequential_apply(p, ids), tgt) \
                .astype(jnp.float32)
        val, g = jax.jit(jax.value_and_grad(loss))(pipe.parameter_tree())
        _REF[f"stage{n}"] = (float(val), np.asarray(g),
                             np.asarray(pipe.parameter_tree()))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp")
    rng = np.random.default_rng(21)

    def r(*shape):
        return rng.normal(0, 1, shape).astype(np.float32)
    arrays = dict(x8=r(8, 6, 16), y8=r(8, 6, 16), x16=r(16, 4, 16),
                  y16=r(16, 4, 16), xbn=r(8, 6, 6, 8), ybn=r(8, 6, 6, 8),
                  ids=rng.integers(1, 25, (8, 8)),
                  tgt=rng.integers(1, 25, (8, 8)))
    for tag, (factory, depth, seed) in (("s8", (_block, 8, 3)),
                                        ("s4", (_block, 4, 4)),
                                        ("bn", (_bn_block, 4, 6))):
        st = _ref_stack(factory, depth, seed)
        arrays.update({f"{tag}:p:{k}": v for k, v in
                       flatten_tree(st.parameter_tree()).items()})
        arrays.update({f"{tag}:b:{k}": v for k, v in
                       flatten_tree(st.buffer_tree()).items()})
    for i, part in enumerate(_lm_parts()):
        arrays.update({f"lm{i}:p:{k}": v for k, v in
                       flatten_tree(part.parameter_tree()).items()})
    np.savez(out / "pp.npz", **arrays)
    procs = worker.spawn(out, 4, ["pp"])
    _reference_answers(np.load(out / "pp.npz"))
    worker.wait(procs, out, timeout=240)
    return [np.load(out / f"pp.{r}.npz") for r in range(4)]


@pytest.mark.parametrize("n_micro", [4, 8, 16])
def test_gpipe_loss_matches_sequential(ranks, n_micro):
    for r in ranks:
        np.testing.assert_allclose(float(r[f"gpipe_m{n_micro}:loss"]),
                                   _REF[f"gpipe_m{n_micro}"], **LOSS_TOL)


def test_gpipe_grads_match_and_remat_is_identical(ranks):
    from bigdl_tpu_torch.parallel.pipeline import schedule_length
    loss, grads = _REF["gpipe"]
    for r in ranks:
        np.testing.assert_allclose(float(r["gpipe:loss"]), loss, **LOSS_TOL)
        assert float(r["gpipe_remat:loss"]) == float(r["gpipe:loss"])
        for n, want in grads.items():
            np.testing.assert_allclose(r[f"gpipe:g:{n}"], want, **GRAD_TOL,
                                       err_msg=n)
            np.testing.assert_array_equal(r[f"gpipe_remat:g:{n}"],
                                          r[f"gpipe:g:{n}"], err_msg=n)
        # each step's shift, forward and backward
        assert int(r["gpipe:shifts"]) == 2 * schedule_length(4, 4)


def test_batch_norm_stack_buffers_match_microbatch_sequential(ranks):
    loss, bufs = _REF["bn"]
    for r in ranks:
        np.testing.assert_allclose(float(r["bn:loss"]), loss, **GRAD_TOL)
        for n, want in bufs.items():
            np.testing.assert_allclose(r[f"bn:b:{n}"], want, **GRAD_TOL,
                                       err_msg=n)


@pytest.mark.parametrize("n_micro", [8, 4])
def test_circular_schedule_matches_sequential(ranks, n_micro):
    loss, grads = _REF[f"circ_m{n_micro}"]
    for r in ranks:
        np.testing.assert_allclose(float(r[f"circ_m{n_micro}:loss"]), loss,
                                   **LOSS_TOL)
        for n, want in grads.items():
            np.testing.assert_allclose(r[f"circ_m{n_micro}:g:{n}"], want,
                                       **GRAD_TOL, err_msg=n)


def test_dp_x_pp_matches_the_full_batch(ranks):
    loss, grads = _REF["dpp"]
    for r in ranks:
        np.testing.assert_allclose(float(r["dpp:loss"]), loss, **LOSS_TOL)
        for n, want in grads.items():
            np.testing.assert_allclose(r[f"dpp:g:{n}"], want, **GRAD_TOL,
                                       err_msg=n)


@pytest.mark.parametrize("stages", [4, 2])
def test_stage_pipeline_matches_sequential(ranks, stages):
    from bigdl_tpu_torch.parallel.pipeline import schedule_length
    loss, grads, stacked = _REF[f"stage{stages}"]
    n_micro = 8 if stages == 4 else 4
    for r in ranks:
        np.testing.assert_array_equal(r[f"stage{stages}:stacked"], stacked)
        np.testing.assert_allclose(float(r[f"stage{stages}:loss"]), loss,
                                   **LOSS_TOL)
        np.testing.assert_allclose(r[f"stage{stages}:g"], grads,
                                   **STAGE_GRAD_TOL)
        assert int(r[f"stage{stages}:shifts"]) == \
            2 * schedule_length(n_micro, stages)
    # each boundary goes at its own shape in f32 (not the reference's
    # conduit padded to the largest), the wrap-around as one element:
    # rank i sends its output forward and its input's gradient back
    sizes = [int(n) for n in ranks[0][f"stage{stages}:in_shapes"]]
    steps = schedule_length(n_micro, stages)
    for i, r in enumerate(ranks):
        idx = i % stages
        send = sizes[idx + 1] if idx < stages - 1 else 1
        recv = sizes[idx] if idx > 0 else 1
        assert int(r[f"stage{stages}:shift_bytes"]) == \
            4 * steps * (send + recv)


def test_scan_and_specs_match_the_reference():
    from bigdl_tpu.parallel.pipeline import (
        circular_permutation as jperm, pipeline_spec_tree as jspecs)
    from bigdl_tpu_torch.interop.state_dict import import_tree_state
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel.pipeline import (PipelineStack,
                                                   circular_permutation,
                                                   pipeline_spec_tree)
    jst = _ref_stack(_block, 4, 8)
    st = PipelineStack(lambda: nn.TransformerEncoderLayer(16, 2, 32,
                                                          pre_norm=True),
                       4, device="cpu")
    import_tree_state(st, flatten_tree(jst.parameter_tree()), {})
    x = np.random.default_rng(2).normal(0, 1, (2, 6, 16)).astype(np.float32)
    ref = np.asarray(jax.jit(jst.scan_apply)(jst.parameter_tree(),
                                             jnp.asarray(x)))
    with torch.no_grad():
        got = st.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, **LOSS_TOL)
    specs = pipeline_spec_tree(st)
    ref_specs = {}

    def walk(t, prefix):
        for k, v in t.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                ref_specs[prefix + k] = tuple(v)
    walk(jspecs(jst), "")
    assert specs == ref_specs
    for args in ((8, 4, 2), (16, 4, 2), (8, 2, 1)):
        np.testing.assert_array_equal(circular_permutation(*args),
                                      jperm(*args))


def test_stage_pipeline_refusals():
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel.pipeline import StagePipeline
    s0 = nn.Sequential().add(nn.SpatialConvolution(1, 4, 3, 3)) \
        .add(nn.SpatialBatchNormalization(4))
    s1 = nn.Sequential().add(nn.Linear(4, 2))
    before = s0._modules["1"].running_mean.clone()
    with pytest.raises(ValueError, match="buffer"):
        StagePipeline([s0, s1], np.zeros((1, 8, 8, 1), np.float32),
                      device="cpu")
    assert torch.equal(s0._modules["1"].running_mean, before)
    with pytest.raises(ValueError, match="2 stages"):
        StagePipeline([s1], np.zeros((1, 4), np.float32), device="cpu")


def test_pipeline_entry_points_raise_without_card():
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.parallel.pipeline import PipelineStack, StagePipeline
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PipelineStack(lambda: nn.Linear(4, 4), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StagePipeline([nn.Linear(4, 4), nn.Linear(4, 4)],
                      np.zeros((1, 4), np.float32))


@pytest.mark.parametrize("training", [False, True])
def test_scan_without_buffers_runs_on_the_template_block(training):
    """A buffered stack's ``scan_apply`` without ``buffers`` runs every
    layer on the template block's own buffers, as the reference's (its
    stacked buffers moved by a training forward first)."""
    from bigdl_tpu.parallel.pipeline import PipelineStack as JStack
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.interop.state_dict import import_tree_state
    from bigdl_tpu_torch.parallel.pipeline import PipelineStack

    def block():
        return (nn.Sequential()
                .add(nn.SpatialConvolution(8, 8, 3, 3, 1, 1, 1, 1,
                                           with_bias=False))
                .add(nn.SpatialBatchNormalization(8)).add(nn.ReLU()))
    from bigdl_tpu.utils.rng import manual_seed
    manual_seed(12)
    js = JStack(_bn_block, 3)
    ps = PipelineStack(block, 3, device="cpu")
    import_tree_state(ps, flatten_tree(js.parameter_tree()),
                      flatten_tree(js.buffer_tree()))
    x = np.random.default_rng(4).normal(0, 1, (2, 5, 5, 8)).astype(
        np.float32)
    js.training_mode()
    js.forward(jnp.asarray(x))
    ps.train()
    ps(torch.from_numpy(x))
    ref = np.asarray(js.scan_apply(js.parameter_tree(), jnp.asarray(x),
                                   training=training))
    with torch.no_grad():
        got = ps.scan_apply(ps.parameter_tree(), torch.from_numpy(x),
                            training=training).numpy()
    np.testing.assert_allclose(got, ref, **GRAD_TOL)
