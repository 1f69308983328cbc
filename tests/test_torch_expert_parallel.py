"""The port's expert axis, global routing and fsdp over a tensor axis
against the reference on its CPU mesh.

Two spawns start with the file (``torch_parallel_worker.py``'s ``ep`` and
``fsdp_tp`` jobs, gloo): world 4 over ``MeshTopology(expert=4)`` and
``MeshTopology(data=2, expert=2)``, and world 2 over
``MeshTopology(expert=2)`` and ``MeshTopology(data=2)``. The MoE (d=16,
h=32, 8 experts, k=2, capacity factor 0.5, so experts overflow) routes a
global batch of 24 tokens, each data rank its contiguous half (the
reference's multi-process order: data-rank-major). Held against the
reference's MoE: the outputs within 2e-5, the dropped picks equal to
the reference's routing (iterative top-k, slots counted over the global
batch, round-major), the gradients of ``sum(y * cot)`` plus the aux loss
within 1e-4 (the data ranks' mean, experts reassembled) of the
reference's single-device answer, and the
replicated gate's gradient equal on every expert rank. A
``DistriOptimizer`` run (Linear, MoE, Linear; SGD momentum, L2 clip, 4
iterations) at data x expert ends within 1e-4 of the reference's
``DistriOptimizer`` on the same topology; ``sharded``, and ``fsdp`` with
an expert axis, raise the reference's ``ValueError``. Global routing
stays inside the training step: at data=2 (the ``ep_eval`` job) a plain
validation set, an unevenly dealt distributed one and a forward on rank 0
alone after ``optimize()`` score and answer as the reference's model with
the same weights does on each batch whole. fsdp x tensor: a
tiny LM trained 3 steps at data=2 x tensor=2 ends within 1e-4 of the
reference's ``DistriOptimizer(sync_mode="fsdp")`` on the same mesh.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_worker as worker
from bigdl_tpu_torch.interop.state_dict import flatten_tree

OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
RUN_TOL = 1e-4
MOE = dict(d=16, h=32, e=8, k=2, cf=0.5, aux=0.05)
T, B, ITERS = 24, 8, 4
VAL_BATCHES = 3
MLP_TOPOS = {4: dict(data=2, expert=2), 2: dict(expert=2)}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ref_moe():
    from bigdl_tpu.parallel.expert import MoE
    from bigdl_tpu.utils.rng import manual_seed
    manual_seed(31)
    return MoE(MOE["d"], MOE["h"], MOE["e"], k=MOE["k"],
               capacity_factor=MOE["cf"], aux_loss_weight=MOE["aux"])


def _moe_arrays(m, prefix=""):
    return {f"{prefix}cfg": np.array(json.dumps(MOE)),
            **{f"{prefix}p:{k}": v
               for k, v in flatten_tree(m.parameter_tree()).items()}}


def _ref_mlp():
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.parallel.expert import MoE
    from bigdl_tpu.utils.rng import manual_seed
    manual_seed(37)
    return (jnn.Sequential().add(jnn.Linear(12, 16)).add(jnn.ReLU())
            .add(MoE(MOE["d"], MOE["h"], MOE["e"] // 2, k=MOE["k"],
                     capacity_factor=MOE["cf"],
                     aux_loss_weight=MOE["aux"]))
            .add(jnn.Linear(16, 5)).add(jnn.LogSoftMax()))


FSDP_LM = dict(vocab=64, embed_dim=16, num_heads=4, ffn_dim=32, num_layers=1,
               max_len=16)


def _ref_lm():
    from bigdl_tpu.models import transformer as jtr
    from bigdl_tpu.utils.rng import manual_seed
    manual_seed(41)
    cfg = dict(FSDP_LM)
    return jtr.build_lm(cfg.pop("vocab"), **cfg)


_REF = {}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The two spawns, started with the file; their folders."""
    rng = np.random.default_rng(13)
    x = rng.normal(0, 1, (T, MOE["d"])).astype(np.float32)
    cot = rng.normal(0, 1, (T, MOE["d"])).astype(np.float32)
    mlp = _ref_mlp()
    mx = rng.normal(0, 1, (1, B, 12)).astype(np.float32)
    my = rng.integers(1, 6, (1, B)).astype(np.float32)
    vx = rng.normal(0, 1, (VAL_BATCHES, B, 12)).astype(np.float32)
    vy = rng.integers(1, 6, (VAL_BATCHES, B)).astype(np.float32)
    mlp_arrays = {"x": mx, "y": my, "vx": vx, "vy": vy,
                  **{"p:" + k: v for k, v in
                     flatten_tree(mlp.parameter_tree()).items()}}
    mlp_moe = {**{"cfg": np.array(json.dumps(dict(MOE, e=MOE["e"] // 2)))},
               **{"p:" + k[2:]: v for k, v in
                  flatten_tree(mlp.parameter_tree()).items()
                  if k.startswith("2.")}}
    lm = _ref_lm()
    lx = rng.integers(1, 65, (1, B, 8)).astype(np.float32)
    ly = rng.integers(1, 65, (1, B, 8)).astype(np.float32)
    dirs, procs = {}, {}
    for world, jobs in ((4, ["ep", "fsdp_tp"]), (2, ["ep", "ep_eval"])):
        out = tmp_path_factory.mktemp(f"ep{world}")
        np.savez(out / "ep.npz", x=x, cot=cot, **_moe_arrays(_ref_moe(),
                                                              "m:"))
        np.savez(out / "ep_mlp.npz", **mlp_arrays,
                 **{"m:cfg": mlp_moe["cfg"]},
                 **{"m:p:" + k[2:]: v for k, v in mlp_moe.items()
                    if k.startswith("p:")})
        cfg = dict(FSDP_LM)
        np.savez(out / "fsdp_tp.npz", x=lx, y=ly, cfg=np.array(
            json.dumps(cfg)), **{"p:" + k: v for k, v in
                                 flatten_tree(lm.parameter_tree()).items()})
        dirs[world] = out
        procs[world] = worker.spawn(out, world, jobs)
    # the reference's answers while the ranks run
    _ref_single(x, cot)
    for world in (4, 2):
        _ref_mlp_run(dirs[world], f"mlp{world}", MLP_TOPOS[world])
    _ref_mlp_run(dirs[2], "mlp_d2", dict(data=2))
    _ref_fsdp_run(dirs[4])
    for world in (4, 2):
        worker.wait(procs[world], dirs[world], timeout=240)
    return dirs


def _ranks(out, world, name="ep"):
    return [np.load(out / f"{name}.{r}.npz") for r in range(world)]


def _ref_single(x, cot):
    """The reference MoE on one device: (eval forward, a function of the
    data axis's size giving the gradients of ``sum(y * cot) / n_data`` plus
    the aux loss and dx), compiled once."""
    from bigdl_tpu.nn.module import functional_apply
    if "moe" not in _REF:
        m = _ref_moe()
        params, bufs = m.parameter_tree(), m.buffer_tree()
        fwd = jax.jit(lambda p, x: functional_apply(m, p, bufs, x,
                                                    training=False)[0])

        def loss(p, x, c):
            y, _ = functional_apply(m, p, bufs, x, training=True)
            return jnp.sum(y * c)
        grad = jax.jit(jax.grad(loss, argnums=(0, 1)))

        def grads(n_data):
            gp, gx = grad(params, jnp.asarray(x), jnp.asarray(cot / n_data))
            return {k: np.asarray(v) for k, v in gp.items()}, np.asarray(gx)
        _REF["moe"] = (np.asarray(fwd(params, jnp.asarray(x))), grads)
    return _REF["moe"]


def _ref_keep(x):
    """The reference's routing of the global batch: (k, T) kept picks."""
    m = _ref_moe()
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ m.gate_weight, -1))
    k, e = MOE["k"], MOE["e"]
    cap = min(max(1, int(np.ceil(len(x) / e * MOE["cf"] * k))), len(x))
    masked, fill, keep = probs.copy(), np.zeros(e, int), []
    for _ in range(k):
        pick = masked.argmax(-1)
        round_keep = np.zeros(len(x), bool)
        for t, p in enumerate(pick):
            round_keep[t] = fill[p] < cap
            fill[p] += 1
        keep.append(round_keep)
        masked[np.arange(len(x)), pick] = 0.0
    return np.stack(keep)


CASES = {4: {"e4": dict(expert=4), "d2e2": dict(data=2, expert=2)},
         2: {"e2": dict(expert=2), "d2": dict(data=2)}}


@pytest.mark.parametrize("world,tag", [(w, t) for w in (4, 2)
                                       for t in CASES[w]])
def test_routing_outputs_and_gradients_match_the_reference(ranks, world,
                                                           tag):
    z0 = np.load(ranks[world] / "ep.npz")
    x, cot = z0["x"], z0["cot"]
    axes = CASES[world][tag]
    runs = _ranks(ranks[world], world)
    n_data = axes.get("data", 1)
    n_exp = axes.get("expert", 1)
    # one rank of each data coordinate, in data order
    heads = [runs[d * n_exp] for d in range(n_data)]
    y = np.concatenate([r[f"{tag}:y"] for r in heads])
    keep = np.concatenate([r[f"{tag}:keep"] for r in heads], axis=1)
    ref_y, grads = _ref_single(x, cot)
    ref_g, ref_dx = grads(n_data)
    want_keep = _ref_keep(x)
    assert 0 < (~want_keep).sum(), "the case must drop picks"
    np.testing.assert_array_equal(keep, want_keep)
    np.testing.assert_allclose(y, ref_y, **OUT_TOL)
    dx = np.concatenate([r[f"{tag}:dx"] for r in heads]) / n_data
    np.testing.assert_allclose(dx, ref_dx, **GRAD_TOL)
    for r in runs:
        for n, want in ref_g.items():
            np.testing.assert_allclose(r[f"{tag}:g:{n}"], want, **GRAD_TOL,
                                       err_msg=f"{tag} {n}")
        assert int(r[f"{tag}:w1_rows"]) == MOE["e"] // n_exp
    if n_exp > 1:   # the replicated gate: equal on every expert rank
        for d in range(n_data):
            group = runs[d * n_exp:(d + 1) * n_exp]
            for r in group[1:]:
                np.testing.assert_array_equal(r[f"{tag}:gate_local"],
                                              group[0][f"{tag}:gate_local"])


def _ref_mlp_run(out, key, topo):
    """The reference's DistriOptimizer on ``ep_mlp.npz``'s global batch
    over ``MeshTopology(**topo)``: its parameters after ITERS iterations,
    kept as ``_REF[key]``."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.dataset.base import DataSet, MiniBatch
    from bigdl_tpu.optim import SGD, Trigger
    from bigdl_tpu.parallel.distri_optimizer import DistriOptimizer
    from bigdl_tpu.parallel.mesh import MeshTopology
    z = np.load(out / "ep_mlp.npz")
    model = _ref_mlp()
    ds = DataSet.array([MiniBatch(z["x"][0], z["y"][0])])
    opt = DistriOptimizer(model, ds, jnn.ClassNLLCriterion(),
                          topology=MeshTopology(**topo))
    opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
    opt.set_gradient_clipping_by_l2_norm(0.5)
    opt.set_end_when(Trigger.max_iteration(ITERS))
    opt.optimize()
    _REF[key] = flatten_tree(model.parameter_tree())


def _ref_fsdp_run(out):
    """The reference's dp x tp fsdp run of ``fsdp_tp.npz``."""
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.dataset.base import DataSet, MiniBatch
    from bigdl_tpu.optim import SGD, Trigger
    from bigdl_tpu.parallel.distri_optimizer import DistriOptimizer
    from bigdl_tpu.parallel.mesh import MeshTopology
    z = np.load(out / "fsdp_tp.npz")
    model = _ref_lm()
    ds = DataSet.array([MiniBatch(z["x"][0], z["y"][0])])
    opt = DistriOptimizer(model, ds,
                          jnn.TimeDistributedCriterion(jnn.ClassNLLCriterion()),
                          topology=MeshTopology(data=2, tensor=2),
                          sync_mode="fsdp")
    opt.set_optim_method(SGD(learningrate=0.1, momentum=0.9))
    opt.set_gradient_clipping_by_l2_norm(1.0)
    opt.set_end_when(Trigger.max_iteration(3))
    opt.optimize()
    _REF["fsdp"] = flatten_tree(model.parameter_tree())


@pytest.mark.parametrize("world", [4, 2])
def test_distri_optimizer_over_data_x_expert_matches_the_reference(ranks,
                                                                   world):
    want = _REF[f"mlp{world}"]
    for r in _ranks(ranks[world], world):
        assert len(r["opt:loss"]) == ITERS
        for n, v in want.items():
            np.testing.assert_allclose(r["opt:" + n], v, rtol=RUN_TOL,
                                       atol=RUN_TOL, err_msg=n)


def test_fsdp_over_a_tensor_axis_matches_the_reference(ranks):
    want = _REF["fsdp"]
    full = sum(v.size for v in want.values()) * 4 / 2 ** 20
    for r in _ranks(ranks[4], 4, "fsdp_tp"):
        assert len(r["loss"]) == 3
        # at rest: tensor slices cut again over the data axis
        assert float(r["resident"]) < 0.4 * full
        assert len(r["slabs"]) > 0
        for n, v in want.items():
            np.testing.assert_allclose(r["p:" + n], v, rtol=RUN_TOL,
                                       atol=RUN_TOL, err_msg=n)


def _nest(flat):
    """Dotted names back into the reference's nested parameter tree."""
    tree = {}
    for name, value in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value)
    return tree


def test_validation_and_inference_route_each_ranks_own_tokens(ranks):
    from bigdl_tpu import nn as jnn
    from bigdl_tpu.dataset.base import DataSet, MiniBatch
    from bigdl_tpu.nn.module import functional_apply
    from bigdl_tpu.optim import Loss, Top1Accuracy
    z = np.load(ranks[2] / "ep_mlp.npz")
    runs = _ranks(ranks[2], 2, "ep_eval")
    want = _REF["mlp_d2"]
    val = DataSet.array([MiniBatch(bx, by) for bx, by in zip(z["vx"],
                                                                z["vy"])])
    for tag in ("plain", "uneven"):
        weights = {n: runs[0][f"{tag}:p:{n}"] for n in want}
        for n, v in want.items():   # training routed the global batch
            np.testing.assert_allclose(weights[n], v, rtol=RUN_TOL,
                                       atol=RUN_TOL, err_msg=n)
        ref = _ref_mlp()
        ref.load_parameter_tree(_nest(weights))
        acc, loss = (r.state() for r, _ in ref.evaluate(
            val, [Top1Accuracy(), Loss(jnn.ClassNLLCriterion())]))
        for r in runs:
            assert int(r[f"{tag}:records"]) == VAL_BATCHES * B
            np.testing.assert_array_equal(r[f"{tag}:Top1Accuracy"],
                                          np.asarray(acc, np.float64))
            assert r[f"{tag}:Loss"][1] == loss[1]
            assert r[f"{tag}:Loss"][0] == pytest.approx(loss[0], rel=1e-5)
    ref = _ref_mlp()
    ref.load_parameter_tree(_nest({n: runs[0][f"uneven:p:{n}"]
                                   for n in want}))
    solo, _ = functional_apply(ref, ref.parameter_tree(), ref.buffer_tree(),
                               jnp.asarray(z["vx"][0]), training=False)
    assert "solo_y" not in runs[1].files
    np.testing.assert_allclose(runs[0]["solo_y"], np.asarray(solo),
                               **OUT_TOL)
