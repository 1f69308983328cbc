"""The port stands alone: no JAX, nothing of bigdl_tpu, no silent CPU.

``bigdl_tpu_torch`` and ``chip_smoke.py`` import neither ``jax`` nor any
module of ``bigdl_tpu``, and every entry point runs on the card unless the
caller asks for the CPU.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.apps import transformer as transformer_app
from bigdl_tpu_torch.models.generation import generate, generate_speculative
from bigdl_tpu_torch.resilience.serving_drill import run_kill_drill
from bigdl_tpu_torch.models import resnet
from bigdl_tpu_torch.models.lm_server import LMServer
from bigdl_tpu_torch.models.serving import ContinuousLMServer
from bigdl_tpu_torch.apps.transformer import synthetic_corpus
from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
from bigdl_tpu_torch.optim.optimizer import Optimizer
from bigdl_tpu_torch.optim.triggers import Trigger
from bigdl_tpu_torch.scripts import roofline_hbm
from bigdl_tpu_torch.utils.device import resolve_device

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "bigdl_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import bigdl_tpu_torch
names = [m.name for m in pkgutil.walk_packages(bigdl_tpu_torch.__path__,
                                               "bigdl_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.") or m == "bigdl_tpu"
             or m.startswith("bigdl_tpu."))
print(len(names), bad)
"""

_BAD_IMPORT = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+bigdl_tpu\b(?!_torch)"
    r"|from\s+bigdl_tpu\b(?!_torch))", re.MULTILINE)


def _tiny(device="cpu", **kw):
    return build_lm(50, embed_dim=64, num_heads=2, ffn_dim=64, num_layers=1,
                    max_len=16, tie_embeddings=True, device=device, **kw)


def test_importing_every_module_pulls_in_no_jax_or_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 25 and bad == "[]"


def test_new_subpackages_are_part_of_the_port():
    """The serving plane's subpackages ship inside the package and stand
    alone like the rest (the import check above walks them)."""
    for sub in ("telemetry", "resilience", "apps"):
        assert (PKG / sub / "__init__.py").is_file(), sub
    for mod in ("models/router.py", "nn/recurrent.py", "apps/common.py",
                "resilience/serving_drill.py", "resilience/__main__.py",
                "telemetry/registry.py", "telemetry/exposition.py",
                "telemetry/tracing.py", "telemetry/catalogue.py",
                "telemetry/profiling.py", "utils/cuda_graph.py"):
        text = (PKG / mod).read_text()
        assert "bigdl_tpu/" in text.split('"""')[1], mod  # names its mirror


def test_sources_import_no_jax_or_reference():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if _BAD_IMPORT.search(f.read_text())]
    assert offenders == []


def test_scan_pattern_catches_reference_imports():
    for line in ("import jax", "from jax import numpy", "import bigdl_tpu",
                 "from bigdl_tpu.nn import Linear", "  import jax.numpy as jnp"):
        assert _BAD_IMPORT.search(line), line
    for line in ("import bigdl_tpu_torch", "from bigdl_tpu_torch.nn import x"):
        assert not _BAD_IMPORT.search(line), line


def test_kernel_sources_exist_and_name_what_they_replace():
    fa = "bigdl_tpu/ops/flash_attention.py"
    for name, refs in (("flash_fwd", (fa, "_fwd_kernel")),
                       ("flash_bwd", (fa, "_bwd_dq_kernel", "_bwd_dkv_kernel")),
                       ("int8_matmul", ("bigdl_tpu/ops/int8_matmul.py",)),
                       ("matmul_bn", ("bigdl_tpu/ops/matmul_bn.py",
                                      "matmul_with_stats")),
                       ("conv3x3_bn", ("bigdl_tpu/ops/conv3x3_bn.py",
                                       "conv3x3_with_stats")),
                       ("hbm_roof", ("scripts/roofline_pallas.py",
                                     "bench_auto", "bench_manual",
                                     "bench_hbm_dma"))):
        text = (PKG / "csrc" / f"{name}.cu").read_text()
        assert all(ref in text for ref in refs) and "sm_90a" in text


def _require_no_card():
    # decided inside the test: the entry points must refuse only when there
    # is no card to run on
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    _require_no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()


def test_build_lm_raises_without_card():
    _require_no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _tiny(device="cuda")
    with pytest.raises(RuntimeError):
        build_lm(50, embed_dim=64, num_heads=2, ffn_dim=64, num_layers=1,
                 tie_embeddings=True)


@pytest.mark.parametrize("entry", ["generate", "LMServer",
                                   "ContinuousLMServer", "quantize_model",
                                   "cast_model", "Optimizer", "resnet.build",
                                   "resnet.build_cifar", "roofline_hbm.main",
                                   "generate_speculative", "run_kill_drill",
                                   "transformer.main",
                                   "Optimizer.set_steps_per_dispatch"])
def test_entry_points_raise_without_card(entry):
    _require_no_card()
    model = _tiny().evaluate_mode()
    calls = {
        "generate": lambda: generate(model, np.ones((1, 3)), 2, greedy=True),
        "LMServer": lambda: LMServer(model, greedy=True),
        "ContinuousLMServer": lambda: ContinuousLMServer(
            _tiny(rope=True).evaluate_mode(), greedy=True),
        "quantize_model": lambda: quantize_model(model),
        "cast_model": lambda: cast_model(model),
        "Optimizer": lambda: Optimizer(
            model, DataSet.array(synthetic_corpus(2, 4, 50)) >> SampleToBatch(2),
            FusedLMHeadCriterion()),
        "resnet.build": lambda: resnet.build(10, 18),
        "resnet.build_cifar": lambda: resnet.build_cifar(10, 8),
        "roofline_hbm.main": lambda: roofline_hbm.main(["--gib", "1"]),
        "generate_speculative": lambda: generate_speculative(
            model, _tiny().evaluate_mode(), np.ones((1, 3)), 2),
        "run_kill_drill": lambda: run_kill_drill(requests=2),
        # the CLI's --device default: every subcommand goes to the card
        "transformer.main": lambda: transformer_app.main(
            ["generate", "--maxNewTokens", "2"]),
        # k > 1 windows: CUDA graphs of k steps on the card
        "Optimizer.set_steps_per_dispatch": lambda: Optimizer(
            model, DataSet.array(synthetic_corpus(2, 4, 50)) >> SampleToBatch(2),
            FusedLMHeadCriterion()).set_steps_per_dispatch(4).optimize(),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_entry_points_run_when_cpu_is_asked_for():
    model = _tiny().evaluate_mode()
    out = generate(model, np.ones((1, 3)), 2, greedy=True, device="cpu")
    assert out.shape == (1, 5)
    assert quantize_model(model, device="cpu") is not model
    assert cast_model(model, device="cpu") is not model
    server = ContinuousLMServer(_tiny(rope=True).evaluate_mode(), slots=1,
                                max_len=8, greedy=True, device="cpu")
    try:
        assert len(server.submit([1, 2], 2, timeout=60)) == 2
    finally:
        server.close()
    opt = Optimizer(_tiny(), DataSet.array(synthetic_corpus(4, 4, 50))
                    >> SampleToBatch(2), FusedLMHeadCriterion(), device="cpu")
    opt.set_steps_per_dispatch(2).set_end_when(Trigger.max_iteration(4))
    opt.optimize()
    assert [h["neval"] for h in opt.history] == [1, 2, 3, 4]
    net = resnet.build_cifar(10, 8, device="cpu").evaluate_mode()
    assert net(torch.zeros(1, 32, 32, 3)).shape == (1, 10)
    assert next(resnet.build(10, 18, device="cpu").parameters()).device.type \
        == "cpu"


def test_chip_smoke_refuses_to_run_without_card():
    _require_no_card()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
