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

from bigdl_tpu_torch.models.generation import generate
from bigdl_tpu_torch.models.lm_server import LMServer
from bigdl_tpu_torch.models.transformer import build_lm
from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
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


def _tiny(device="cpu"):
    return build_lm(50, embed_dim=64, num_heads=2, ffn_dim=64, num_layers=1,
                    max_len=16, tie_embeddings=True, device=device)


def test_importing_every_module_pulls_in_no_jax_or_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 15 and bad == "[]"


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
    for name, ref in (("flash_fwd", "bigdl_tpu/ops/flash_attention.py"),
                      ("int8_matmul", "bigdl_tpu/ops/int8_matmul.py")):
        text = (PKG / "csrc" / f"{name}.cu").read_text()
        assert ref in text and "sm_90a" in text


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


@pytest.mark.parametrize("entry", ["generate", "LMServer", "quantize_model",
                                   "cast_model"])
def test_entry_points_raise_without_card(entry):
    _require_no_card()
    model = _tiny().evaluate_mode()
    calls = {
        "generate": lambda: generate(model, np.ones((1, 3)), 2, greedy=True),
        "LMServer": lambda: LMServer(model, greedy=True),
        "quantize_model": lambda: quantize_model(model),
        "cast_model": lambda: cast_model(model),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_entry_points_run_when_cpu_is_asked_for():
    model = _tiny().evaluate_mode()
    out = generate(model, np.ones((1, 3)), 2, greedy=True, device="cpu")
    assert out.shape == (1, 5)
    assert quantize_model(model, device="cpu") is not model
    assert cast_model(model, device="cpu") is not model


def test_chip_smoke_refuses_to_run_without_card():
    _require_no_card()
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
