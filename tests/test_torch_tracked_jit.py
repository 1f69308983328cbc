"""The compile flight recorder, MFU and the training families of the port
(``telemetry/profiling.py``, ``optim/optimizer.py``) on the CPU, against
the reference's ``bigdl_tpu/telemetry/profiling.py`` and
``bigdl_tpu/optim/optimizer.py``:

- ``tracked_jit`` records once per signature and again after an
  eviction; its cost fields are present or ``None``; the FLOPs of a
  ``Linear`` (forward, and forward plus backward) equal the formula, and
  each kernel's per-launch count (K1-K6, what the wrappers add on the card)
  equals its analytic formula;
- ``bigdl_train_mfu`` is set under ``BIGDL_TPU_PEAK_FLOPS``; the training
  families' sample counts after N steps equal the reference's;
- ``bigdl_int8_fallbacks_total`` counts each call with K off the quantum;
- ``set_profiling`` writes a Chrome trace of exactly its window, the
  modules' forwards named in it; the generation and evaluation sites
  compile once.
"""

import json

import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.dataset.base import AbstractDataSet as JaxAbstractDataSet
from bigdl_tpu.dataset.base import MiniBatch as JaxMiniBatch
from bigdl_tpu.optim import Optimizer as JaxOptimizer
from bigdl_tpu.optim import SGD as JaxSGD
from bigdl_tpu.optim import Trigger as JaxTrigger
from bigdl_tpu.telemetry import MetricsRegistry as JaxRegistry
from bigdl_tpu.telemetry import get_registry as jax_get_registry
from bigdl_tpu.telemetry import instruments as jax_instruments
from bigdl_tpu.telemetry import set_registry as jax_set_registry
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.dataset.base import AbstractDataSet, MiniBatch
from bigdl_tpu_torch.models.generation import generate
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.ops import (_build, conv3x3_bn, flash_attention,
                                 int8_matmul, matmul_bn)
from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger
from bigdl_tpu_torch.optim.evaluator import Evaluator
from bigdl_tpu_torch.telemetry import (MetricsRegistry, get_registry,
                                       instruments, profiling, set_registry)
from bigdl_tpu_torch.telemetry.profiling import tracked_jit

STEPS = 5


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def registry():
    prev = get_registry()
    reg = MetricsRegistry()
    set_registry(reg)
    yield reg
    set_registry(prev)


def _compiles(reg, site):
    return instruments(reg).compiles_total.labels(site=site).value


def test_once_per_signature_and_again_after_eviction():
    reg = MetricsRegistry()
    lin = torch.nn.Linear(16, 8)
    f = tracked_jit(lambda x, scale: lin(x) * scale, site="t", registry=reg,
                    cache_size=2)
    x = lambda *s: torch.ones(*s)
    for shape in [(4, 16), (4, 16), (3, 16), (3, 16)]:
        f(x(*shape), 2.0)
    assert f.compiles == 2 and _compiles(reg, "t") == 2
    f(x(4, 16), 3.0)        # a Python scalar is keyed by its type
    f(x(4, 16).double().float().requires_grad_(), 2.0)
    assert f.compiles == 3  # requires_grad splits the signature
    f(x(3, 16), 1.0)        # evicted by the last one (oldest first)
    assert f.compiles == 4
    ev = instruments(reg).compile_cache_evictions_total.labels(site="t")
    assert ev.value == 2
    assert instruments(reg).compile_seconds.labels(site="t").snapshot()[
        "count"] == 4


def test_cost_fields_present_or_none_and_linear_flops():
    reg = MetricsRegistry()
    lin = torch.nn.Linear(16, 8)
    fwd = tracked_jit(lin, site="fwd", registry=reg, count_flops=True)
    fwd(torch.ones(4, 16))
    ev = fwd.last_event.as_dict()
    assert ev["flops"] == 2 * 4 * 16 * 8
    assert ev["output_bytes"] == 4 * 8 * 4
    assert ev["temp_bytes"] is None            # no allocator on the CPU
    assert ev["bytes_accessed"] is None and ev["argument_bytes"] is None
    assert ev["seconds"] > 0 and ev["site"] == "fwd"
    assert instruments(reg).program_flops.labels(site="fwd").value == \
        2 * 4 * 16 * 8

    def step(x):
        y = lin(x).sum()
        y.backward()
        return y.detach()
    x = torch.ones(4, 16, requires_grad=True)
    train = tracked_jit(step, site="train", registry=reg, count_flops=True)
    train(x)
    # forward, the weight gradient and the input gradient
    assert train.last_flops == 3 * 2 * 4 * 16 * 8
    # a site that counts none (serving, generation, evaluation)
    plain = tracked_jit(lin, site="plain", registry=reg)
    plain(torch.ones(4, 16))
    assert plain.last_event.flops is None and plain.compiles == 1
    assert plain.last_event.output_bytes == 4 * 8 * 4


def test_kernel_launches_and_uncounted_blocks():
    reg = MetricsRegistry()
    a = torch.ones(8, 8)

    def fn(x):
        _build.KERNEL_FLOPS.add(1000)   # what a kernel wrapper adds
        y = x @ a
        with profiling.uncounted():     # a capture repeating the work
            x @ a
        return y
    f = tracked_jit(fn, site="k", registry=reg, count_flops=True)
    f(torch.ones(2, 8))
    assert f.last_flops == 1000 + 2 * 2 * 8 * 8


@pytest.mark.parametrize("b, n, sq, sk, d, causal", [
    (2, 3, 16, 16, 64, True), (2, 3, 16, 16, 64, False),
    (1, 12, 7, 40, 128, True), (1, 2, 40, 7, 64, True)])
def test_flash_launch_flops_equal_the_formula(b, n, sq, sk, d, causal):
    mask = np.tril(np.ones((sq, sk), bool)) if causal else \
        np.ones((sq, sk), bool)
    pairs = b * n * int(mask.sum())
    assert flash_attention.attention_pairs(b, n, sq, sk, causal) == pairs
    for kernel, per in (("flash_fwd", 4), ("flash_bwd_dq", 6),
                        ("flash_bwd_dkv", 8)):
        assert flash_attention.launch_flops(kernel, b, n, sq, sk, d,
                                            causal) == per * d * pairs


@pytest.mark.parametrize("m, k, n", [(1, 768, 768), (256, 3072, 768),
                                     (802816, 64, 256)])
def test_gemm_launch_flops_equal_the_formula(m, k, n):
    assert int8_matmul.launch_flops(m, k, n) == 2 * m * k * n
    assert matmul_bn.launch_flops(m, k, n) == 2 * m * k * n


def test_conv_launch_flops_equal_the_formula():
    for n, h, w, ci, co in ((256, 56, 56, 64, 64), (256, 7, 7, 512, 512),
                            (2, 5, 3, 8, 16)):
        assert conv3x3_bn.launch_flops(n, h, w, ci, co) == \
            2 * n * h * w * 9 * ci * co
        # the plain conv's count, by torch's own formulas, agrees
        x = torch.zeros(min(n, 2), h, w, ci)
        wt = torch.zeros(3, 3, ci, co)
        f = tracked_jit(conv3x3_bn.conv3x3_with_stats_plain, site="c",
                        registry=MetricsRegistry(), count_flops=True)
        f(x, wt)
        assert f.last_flops == conv3x3_bn.launch_flops(min(n, 2), h, w, ci,
                                                       co)


def test_peak_flops_and_mfu(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_PEAK_FLOPS", "2e12")
    assert profiling.peak_flops() == 2e12
    assert profiling.mfu(1e12, 1.0) == 0.5
    assert profiling.mfu(None, 1.0) is None
    monkeypatch.delenv("BIGDL_TPU_PEAK_FLOPS")
    if not torch.cuda.is_available():
        assert profiling.peak_flops() is None       # no card, no roof


# --------------------------------------------------------------- training
def _batches():
    rng = np.random.RandomState(0)
    return [(rng.randn(8, 6).astype(np.float32),
             rng.randint(1, 4, 8).astype(np.float32)) for _ in range(3)]


class _Fixed(AbstractDataSet):
    def data(self, train):
        for x, y in _batches():
            yield MiniBatch(x, y)

    def size(self):
        return 24

    def shuffle(self):
        pass


class _JaxFixed(JaxAbstractDataSet):
    def data(self, train):
        for x, y in _batches():
            yield JaxMiniBatch(x, y)

    def size(self):
        return 24

    def shuffle(self):
        pass


def _port_opt(steps=STEPS):
    torch.manual_seed(0)
    model = (nn.Sequential().add(nn.Linear(6, 5)).add(nn.ReLU())
             .add(nn.Linear(5, 3)).add(nn.LogSoftMax()))
    return (Optimizer(model, _Fixed(), nn.ClassNLLCriterion(), device="cpu")
            .set_optim_method(SGD(learningrate=0.1))
            .set_end_when(Trigger.max_iteration(steps)))


FAMILIES = {"step": "train_step_seconds", "data_wait":
            "train_data_wait_seconds", "dispatch": "train_dispatch_seconds",
            "sync": "train_sync_seconds"}


def _samples(tm):
    out = {k: getattr(tm, name).labels(mode="local").snapshot()["count"]
           for k, name in FAMILIES.items()}
    out.update(steps=tm.train_steps_total.labels(mode="local").value,
               records=tm.train_records_total.labels(mode="local").value,
               compiles=tm.train_compiles_total.labels(mode="local").value)
    return out


def test_training_families_match_the_reference(registry):
    prev = jax_get_registry()
    jreg = JaxRegistry()
    jax_set_registry(jreg)
    try:
        jm = (jnn.Sequential().add(jnn.Linear(6, 5)).add(jnn.ReLU())
              .add(jnn.Linear(5, 3)).add(jnn.LogSoftMax()))
        (JaxOptimizer(jm, _JaxFixed(), jnn.ClassNLLCriterion())
         .set_optim_method(JaxSGD(learningrate=0.1))
         .set_end_when(JaxTrigger.max_iteration(STEPS))).optimize()
    finally:
        jax_set_registry(prev)
    _port_opt().optimize()
    want = _samples(jax_instruments(jreg))
    got = _samples(instruments(registry))
    assert got == want
    assert got["steps"] == STEPS and got["records"] == 8 * STEPS
    tm = instruments(registry)
    assert tm.train_records_per_second.labels(mode="local").value > 0
    assert _compiles(registry, "train.step") == 1


def test_train_mfu_is_set_with_a_peak(registry, monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_PEAK_FLOPS", "1e9")
    opt = _port_opt()
    opt.optimize()
    tm = instruments(registry)
    flops = tm.program_flops.labels(site="train.step").value
    # forward and backward of the two Linears (the first's input needs no
    # gradient)
    assert flops == 2 * 8 * (6 * 5 + 5 * 3) + 2 * 8 * (6 * 5 + 2 * 5 * 3)
    mfu = tm.train_mfu.labels(mode="local").value
    assert mfu == pytest.approx(flops / opt.history[-1]["seconds"] / 1e9,
                                rel=1e-9)


def test_windows_are_the_multi_step_site(registry):
    opt = _port_opt(steps=6).set_steps_per_dispatch(3)
    opt.optimize()
    assert _compiles(registry, "train.multi_step") == 1
    assert _compiles(registry, "train.step") == 0


def test_int8_fallbacks_count_each_call(registry):
    x = torch.ones(2, 17)
    w_q = torch.ones(4, 17, dtype=torch.int8)
    scale = torch.ones(4)
    fallbacks = instruments(registry).int8_fallbacks_total
    with pytest.warns(RuntimeWarning, match="multiple of 16"):
        int8_matmul.int8_matmul(x, w_q, scale)
    int8_matmul.int8_matmul(x, w_q, scale)      # warned once, counted again
    assert fallbacks.value == 2
    int8_matmul.int8_matmul(torch.ones(2, 16),
                            torch.ones(4, 16, dtype=torch.int8), scale)
    assert fallbacks.value == 2


def test_set_profiling_traces_exactly_the_window(tmp_path, registry):
    opt = _port_opt(steps=6)
    opt.model[0].set_name("first_linear")
    opt.set_profiling(str(tmp_path), start_iteration=2, n_iterations=3)
    opt.optimize()
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert sorted(n for n in names if str(n).startswith("iteration")) == [
        "iteration 2", "iteration 3", "iteration 4"]
    assert {"first_linear", "Linear", "LogSoftMax"} <= names
    # the hooks are gone once the window closes
    assert not opt.model[0]._forward_pre_hooks


def test_generation_and_evaluation_sites_compile_once(registry):
    model = build_lm(40, embed_dim=16, num_heads=2, ffn_dim=32,
                     num_layers=1, max_len=16, device="cpu", seed=1)
    for _ in range(2):
        generate(model, np.ones((1, 3)), 3, greedy=True, device="cpu")
    assert _compiles(registry, "generation.decode") == 1
    net = (nn.Sequential().add(nn.Linear(6, 3)).add(nn.LogSoftMax()))
    ev = Evaluator(net, device="cpu")
    methods = [Top1Accuracy()]      # kept: the scorer is cached by them
    for _ in range(2):
        ev.test(_Fixed(), methods)
    assert _compiles(registry, "eval.scorer") == 1
    assert _compiles(registry, "eval.forward") == 1
