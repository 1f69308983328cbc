"""The port's graftlint gate: ``python -m bigdl_tpu_torch.analysis``
keeps ``bigdl_tpu_torch/`` (its ``scripts/`` included) and
``chip_smoke.py`` at zero unsuppressed findings, every suppression with
its reason (the counterpart of ``tests/test_graftlint.py::TestSelfLint``).

The analyser stands alone: it imports neither ``torch`` nor ``jax`` nor
anything of the reference. No wall-clock budget is asserted (``chip_smoke``
phase 3r reports the cold and warm seconds).
"""

import collections
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bigdl_tpu_torch.analysis import core, lint_paths, render_json
from bigdl_tpu_torch.analysis.__main__ import default_paths

REPO = Path(__file__).resolve().parents[1]


def test_default_paths_are_the_port_and_chip_smoke():
    paths = default_paths()
    assert paths == [str(REPO / "bigdl_tpu_torch"),
                     str(REPO / "chip_smoke.py")]


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """One cold whole-tree pass, stored in a cache of this module's own
    (the warm checks below are hits on it)."""
    cache_dir = str(tmp_path_factory.mktemp("graftlint_cache"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("GRAFTLINT_CACHE", cache_dir)
        results = lint_paths(default_paths(), use_cache=True)
    return cache_dir, results


def test_zero_unsuppressed_findings(gate):
    _, results = gate
    findings = [f for r in results for f in r.findings]
    assert not findings, (
        "graftlint found unsuppressed hazards (fix them or add "
        "'# graftlint: ignore[JG0xx] -- reason'):\n"
        + "\n".join(f.render() for f in findings))
    assert len(results) > 150
    assert any(r.path.endswith("chip_smoke.py") for r in results)
    # the suppressions' inventory: each is reasoned (JG000 otherwise) and
    # bounded by design (CHANGES.md lists them)
    by_code = collections.Counter(f.code for r in results
                                  for f in r.suppressed)
    assert set(by_code) <= {"JG004", "JG013", "JG014", "JG019"}, by_code


def test_warm_full_tree_pass_is_a_cache_hit(gate, monkeypatch):
    cache_dir, cold = gate
    monkeypatch.setenv("GRAFTLINT_CACHE", cache_dir)

    def refuse(*a, **k):
        raise AssertionError("a warm pass parsed a file")
    monkeypatch.setattr(core.FileContext, "parse", refuse)
    warm = lint_paths(default_paths())
    assert render_json(warm) == render_json(cold)


def test_cli_gate_exits_zero(gate):
    env = dict(os.environ, GRAFTLINT_CACHE=gate[0])
    out = subprocess.run([sys.executable, "-m", "bigdl_tpu_torch.analysis"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1].startswith(
        "graftlint: 0 finding(s)")


_IMPORTS = """
import importlib, pkgutil, sys
import bigdl_tpu_torch.analysis as a
names = [m.name for m in pkgutil.walk_packages(
    a.__path__, "bigdl_tpu_torch.analysis.")]
for name in names:
    importlib.import_module(name)
a.all_rules()
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "bigdl_tpu", "numpy"))
print(len(names), bad)
"""


def test_the_analyser_imports_no_torch_jax_or_reference():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _IMPORTS], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    n, bad = out.stdout.strip().split(" ", 1)
    assert int(n) >= 20 and bad == "[]"

