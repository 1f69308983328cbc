"""How far ResNet-50's f32 gradients at init lie from exact, in both
packages, on the CPU (slow tier: ``python -m pytest -m slow -s
tests/test_torch_resnet50_f64.py``, about a minute a seed).

``resnet.build(1000, 50)`` (unfused) at B=2, 224x224, seeds 11, 21 and 31:
the reference's weights are carried into the port (``flatten_tree`` ->
``import_tree_state``); one training forward and backward of
``ClassNLLCriterion`` runs in the reference at f32 and under
``jax.enable_x64`` with f64 weights and images, and in the port at f32
and in f64. The port's f64 model is the truth: its batch norm computes in
the input's dtype, where the reference's keeps f32 statistics even under
x64 (``bigdl_tpu/ops/batch_norm.py``), so the reference's x64 run is
itself f32-limited. Per seed the test prints, over every parameter
gradient, the median and largest relative L2 distance from the truth of:
the port's f32, the reference's f32 and the reference's x64 run; and two
readings that do not lean on the port's f64 model: the reference's f32
against its own x64 run (how far the reference moves when only its
precision changes) and the port's f32 against the reference's f32.

It answers ROADMAP C's question (is the port's 1.7-2.6e-2, measured on the
card against a CPU f64 copy, the network's or the port's). Seeds 11, 21
and 31 read medians of: port f32 2.27e-2, 2.43e-2, 1.91e-2; reference f32
3.66e-2, 4.14e-2, 4.46e-2; reference x64 3.59e-2, 4.27e-2, 4.12e-2;
reference f32 vs its x64 2.06e-2, 2.25e-2, 2.33e-2; port f32 vs reference
f32 3.68e-2, 4.50e-2, 4.61e-2. The reference alone, with no code of the
port, moves by 2.1-2.3e-2 between f32 and x64: ResNet-50 at init
amplifies f32 rounding that far. The test holds the port's f32 within
twice that spread of its f64 model, the port's f32 median within twice
the reference's f32 median from the truth (or 1e-3), and the two
packages' f32 gradients within three times the spread of each other (two
f32 paths, each within about one spread (port) or two (the reference,
whose x64 is f32-limited) of exact, by the triangle inequality).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import resnet as jresnet
from bigdl_tpu.nn.criterion import ClassNLLCriterion as JaxNLL
from bigdl_tpu.nn.module import functional_apply
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.interop.state_dict import flatten_tree, import_tree_state
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.nn import ClassNLLCriterion

pytestmark = pytest.mark.slow

B = 2


@pytest.fixture(autouse=True)
def unfused(monkeypatch):
    for g in ("BIGDL_TPU_FUSED_1X1", "BIGDL_TPU_FUSED_3X3"):
        monkeypatch.delenv(g, raising=False)


def _ref_grads(jm, params, x, y):
    def fn(p):
        out, _ = functional_apply(jm, p, jm.buffer_tree(), jnp.asarray(x),
                                  training=True)
        return JaxNLL().apply(out, jnp.asarray(y))
    loss, grads = jax.jit(jax.value_and_grad(fn))(params)
    return float(loss), {k: np.asarray(v, np.float64)
                         for k, v in flatten_tree(grads).items()}


def _port_grads(tm, x, y):
    tm.train()
    tm.zero_grad(set_to_none=True)
    p = next(tm.parameters())
    loss = ClassNLLCriterion()(tm(torch.from_numpy(x).to(p.dtype)),
                               torch.from_numpy(y))
    loss.backward()
    return loss.item(), {n: q.grad.double().numpy()
                         for n, q in tm.named_parameters()}


def _dist(got, truth):
    scale = 1e-3 * max(np.linalg.norm(v) for v in truth.values())
    d = [np.linalg.norm(got[k] - v) / max(np.linalg.norm(v), scale)
         for k, v in truth.items()]
    return float(np.median(d)), float(max(d))


@pytest.mark.parametrize("seed", [11, 21, 31])
def test_resnet50_f32_gradients_against_f64(seed):
    JaxRNG.RNG().set_seed(seed)
    jm = jresnet.build(1000, 50)
    rng = np.random.default_rng(seed + 4)
    x = rng.normal(0, 1, (B, 224, 224, 3)).astype(np.float32)
    y = rng.integers(1, 1001, (B,)).astype(np.float32)
    params = jm.parameter_tree()
    ref_loss, ref = _ref_grads(jm, params, x, y)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     params)
        x64_loss, ref_x64 = _ref_grads(jm, p64, x.astype(np.float64), y)
    tm = resnet.build(1000, 50, device="cpu", seed=seed)
    import_tree_state(tm, flatten_tree(params), flatten_tree(jm.buffer_tree()))
    port_loss, port = _port_grads(tm, x, y)
    truth_loss, truth = _port_grads(tm.double(), x.astype(np.float64), y)
    readings = {"seed": seed, "losses_port_ref_refx64_truth":
                [port_loss, ref_loss, x64_loss, truth_loss],
                "port_f32": _dist(port, truth), "ref_f32": _dist(ref, truth),
                "ref_x64": _dist(ref_x64, truth),
                "port_f32_vs_ref_f32": _dist(port, ref),
                "ref_f32_vs_ref_x64": _dist(ref, ref_x64)}
    print(readings)
    assert abs(port_loss - truth_loss) <= 1e-5 * abs(truth_loss)
    assert readings["port_f32"][0] <= max(1e-3, 2 * readings["ref_f32"][0])
    spread = readings["ref_f32_vs_ref_x64"][0]
    assert readings["port_f32"][0] <= max(1e-3, 2 * spread)
    assert readings["port_f32_vs_ref_f32"][0] <= max(1e-3, 3 * spread)
