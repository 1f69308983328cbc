"""The port's blockwise attention core and context parallelism against the
reference's, on the CPU.

In this process: ``attention_partial``, ``online_softmax_combine``,
``finalize_partial`` and ``blockwise_attention`` (causal and masked)
within 1e-5 of the reference's, and ``zigzag_permutation`` /
``zigzag_inverse`` equal to the reference's. In two gloo ranks (one spawn,
``torch_parallel_worker.py``'s ``cp`` job): ring attention (contiguous
and zigzag, the partial path and the plain version of the kernel hops)
and Ulysses, causal and not, within 2e-5 (forward) and 1e-4 (gradients)
of the reference's ``dot_product_attention`` (the reference's own
tolerances, ``tests/test_context_parallel.py``), with the ring's shifts
and Ulysses' all-to-alls held to the structure; and the tiny Llama-recipe
``build_lm(seq_axis=..., rope=True)`` in each mode, its log-probs within
1e-5 of the reference's single-device ``build_lm`` and its first-step
gradients (the ranks' sum) within 1e-5 of the port's whole model's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from bigdl_tpu_torch.interop.state_dict import flatten_tree
from bigdl_tpu_torch.ops import attention_core as core
from bigdl_tpu_torch.parallel import context

TOL = 1e-5
FWD_TOL, GRAD_TOL = 2e-5, 1e-4


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def world2(tmp_path_factory):
    """Two ranks, started with the file."""
    from bigdl_tpu.models import transformer as jtr
    from bigdl_tpu.utils.rng import manual_seed
    out = tmp_path_factory.mktemp("cp")
    rng = np.random.default_rng(7)
    qkv = {a: rng.normal(0, 1, (2, 16, 4, 8)).astype(np.float32)
           for a in ("q", "k", "v", "cot")}
    np.savez(out / "cp.npz", **qkv)
    manual_seed(11)
    lm = jtr.build_lm(64, **worker.TINY_LM)
    tokens = rng.integers(1, 65, (2, 16)).astype(np.float32)
    targets = rng.integers(1, 65, (2, 16)).astype(np.float32)
    params = flatten_tree(lm.parameter_tree())
    np.savez(out / "cp_lm.npz", tokens=tokens, targets=targets,
             **{"p:" + k: v for k, v in params.items()})
    procs = worker.spawn(out, 2, ["cp"])
    done = []

    def result():
        if not done:
            worker.wait(procs, out)
            done.append(True)
        return out
    yield {"result": result, "qkv": qkv, "lm": lm, "tokens": tokens}
    for p in procs:
        p.kill()


# ------------------------------------------------------- in this process
def _qkv(seed, sq=12, sk=20):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (2, s, 3, 8)).astype(np.float32)
            for s in (sq, sk, sk)]


def _close(got, want, tol=TOL, what=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("causal", [False, True])
def test_partials_and_combine_equal_the_references(causal):
    from bigdl_tpu.ops import attention_core as ref
    q, k, v = _qkv(1, sq=8, sk=16)
    scale = 8 ** -0.5
    qp = np.arange(8, 16)
    parts = []
    for lo in (0, 8):
        kp = np.arange(lo, lo + 8)
        want = jax.jit(lambda a, b, c, qq, kk: ref.attention_partial(
            a, b, c, scale, 0, 0, causal, q_pos=qq, k_pos=kk))(
            jnp.asarray(q), jnp.asarray(k[:, lo:lo + 8]),
            jnp.asarray(v[:, lo:lo + 8]), jnp.asarray(qp), jnp.asarray(kp))
        got = core.attention_partial(
            torch.from_numpy(q), torch.from_numpy(k[:, lo:lo + 8]),
            torch.from_numpy(v[:, lo:lo + 8]), scale, 0, 0, causal,
            q_pos=torch.from_numpy(qp), k_pos=torch.from_numpy(kp))
        for g, w, what in zip(got, want, ("acc", "sum", "max")):
            _close(g, w, what=what)
        parts.append((got, want))
    got = core.online_softmax_combine(*parts[0][0], *parts[1][0])
    want = ref.online_softmax_combine(*parts[0][1], *parts[1][1])
    for g, w in zip(got, want):
        _close(g, w)
    _close(core.finalize_partial(got[0], got[1]),
           ref.finalize_partial(want[0], want[1]))
    # a fully masked chunk: the finite sentinel, zero output
    acc, rsum, rmax = core.attention_partial(
        torch.from_numpy(q), torch.from_numpy(k[:, :8]),
        torch.from_numpy(v[:, :8]), scale, 100, 0, True)
    assert float(rsum.abs().max()) == 0.0
    assert float(rmax.max()) == float(np.finfo(np.float32).min)


@pytest.mark.parametrize("case", ["plain", "causal", "masked", "block3"])
def test_blockwise_attention_equals_the_references(case):
    from bigdl_tpu.ops import attention_core as ref
    q, k, v = _qkv(2, sq=20, sk=20)
    mask = None
    if case == "masked":
        mask = np.random.default_rng(3).random((2, 1, 20, 20)) > 0.3
        mask[0, 0, 4] = False   # a fully masked row
    kw = dict(causal=case == "causal",
              block_size=3 if case == "block3" else 8)
    want = jax.jit(lambda a, b, c, m: ref.blockwise_attention(
        a, b, c, mask=m, **kw))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        None if mask is None else jnp.asarray(mask))
    got = core.blockwise_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        mask=None if mask is None else torch.from_numpy(mask), **kw)
    _close(got, want)


@pytest.mark.parametrize("s,p", [(8, 2), (16, 2), (24, 3), (32, 4)])
def test_zigzag_layout_equals_the_references(s, p):
    from bigdl_tpu.parallel import context as ref
    np.testing.assert_array_equal(context.zigzag_permutation(s, p),
                                  ref.zigzag_permutation(s, p))
    np.testing.assert_array_equal(context.zigzag_inverse(s, p),
                                  ref.zigzag_inverse(s, p))
    for dev in range(p):
        np.testing.assert_array_equal(
            context.zigzag_positions(dev, s // p, p).numpy(),
            np.asarray(ref._zigzag_positions(dev, s // p, p)))
    with pytest.raises(ValueError, match="zigzag needs"):
        context.zigzag_permutation(s + 1, p)


def test_mha_block_size_takes_the_blockwise_core():
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.nn.module import functional_apply
    from bigdl_tpu.utils.rng import manual_seed
    from bigdl_tpu_torch import nn
    from bigdl_tpu_torch.interop.state_dict import import_tree_state
    manual_seed(4)
    jm = jnn.MultiHeadAttention(16, 4, causal=True, block_size=4)
    pm = nn.MultiHeadAttention(16, 4, causal=True, block_size=4)
    import_tree_state(pm, flatten_tree(jm.parameter_tree()), {})
    x = np.random.default_rng(5).normal(0, 1, (2, 10, 16)).astype(
        np.float32)
    want = jax.jit(lambda p, xx: functional_apply(
        jm, p, {}, xx, training=False)[0])(jm.parameter_tree(),
                                           jnp.asarray(x))
    _close(pm(torch.from_numpy(x)), want)


# ------------------------------------------------------- two gloo ranks
def _attention_reference(q, k, v, cot, causal):
    from bigdl_tpu.ops.attention_core import dot_product_attention

    @jax.jit
    def run(q, k, v, c):
        o, vjp = jax.vjp(lambda a, b, d: dot_product_attention(
            a, b, d, causal=causal), q, k, v)
        return (o, *vjp(c))
    return [np.asarray(t) for t in run(*map(jnp.asarray, (q, k, v, cot)))]


@pytest.mark.parametrize("case", worker.CP_CASES,
                         ids=[worker.cp_case_name(c) for c in worker.CP_CASES])
def test_ring_and_ulysses_match_full_attention(world2, case):
    qkv = world2["qkv"]
    o, dq, dk, dv = _attention_reference(qkv["q"], qkv["k"], qkv["v"],
                                         qkv["cot"], case[3])
    out = world2["result"]()
    name = worker.cp_case_name(case)
    for rank in range(2):
        z = np.load(out / f"cp.{rank}.npz")
        _close(z[f"{name}:o"], o, FWD_TOL, "o")
        for a, want in (("q", dq), ("k", dk), ("v", dv)):
            _close(z[f"{name}:d{a}"], want, GRAD_TOL, f"d{a}")
        with open(out / f"cp_counts.{rank}.json") as f:
            counts = json.load(f)[name]
        # the whole-array wrapper: q, k, v split (backward: 3 gathers),
        # the answer gathered (forward); the ring: k and v shifted P-1 = 1
        # times forward and back; Ulysses: 4 all-to-alls each way
        core_ops = ({"shift/seq": 4} if case[0] == "ring"
                    else {"all_to_all/seq": 8})
        assert counts == {"all_gather/seq": 4, **core_ops}, counts


_LM_REF = {}


def _lm_reference(lm, tokens):
    from bigdl_tpu.nn.module import functional_apply
    if "logp" not in _LM_REF:
        _LM_REF["logp"] = np.asarray(jax.jit(lambda p, t: functional_apply(
            lm, p, {}, t, training=False)[0])(lm.parameter_tree(),
                                              jnp.asarray(tokens)))
    return _LM_REF["logp"]


@pytest.mark.parametrize("mode,layout", worker.CP_LM_CASES)
def test_lm_with_seq_axis_matches_the_reference(world2, mode, layout):
    lm = world2["lm"]
    want = _lm_reference(lm, world2["tokens"])
    out = world2["result"]()
    tag = f"lm_{mode}_{layout}"
    for rank in range(2):
        z = np.load(out / f"cp.{rank}.npz")
        _close(z[f"{tag}:logp"], want, TOL, "log-probs")
        names = [k[len("whole:g:"):] for k in z.files
                 if k.startswith("whole:g:")]
        assert names
        for n in names:
            _close(z[f"{tag}:g:{n}"], z[f"whole:g:{n}"], TOL, n)
