"""bigdl_tpu_torch.analysis — graftlint for the port (counterpart of
``bigdl_tpu/analysis/``), an AST linter for CUDA-graph, generator,
compile-family, collective and thread hazards.

It walks every module's AST (never importing it: no ``torch``, nothing of
the reference), works out which functions run under a CUDA-graph capture
(``GraphedProgram`` bodies, ``torch.cuda.graph`` blocks,
``make_graphed_callables`` and ``torch.compile`` targets) and which build
a compile family (``tracked_jit``), and flags what only shows up as a slow
or wrong run on the card: host reads and Python side effects in a captured
body, draws from a generator the graph does not replay, programs built per
iteration or cached under traffic-dependent keys, a held graph output that
the next replay overwrote, an input rebound under a graph, spec and
collective axes the mesh lacks, autograd regions whose backward returns
the wrong number of gradients, and races and blocking device reads under
locks. The rule table, how to add a rule and how to suppress one are in
``bigdl_tpu_torch/analysis/README.md``.

CLI::

    python -m bigdl_tpu_torch.analysis                 # the port tree
    python -m bigdl_tpu_torch.analysis --list-rules    # rule table
    python -m bigdl_tpu_torch.analysis --select JG001,JG003 --format json paths...
    python -m bigdl_tpu_torch.analysis --comm-model bigdl_tpu_torch/analysis/comm_model.json

Suppression (the reason is mandatory)::

    x = float(loss)  # graftlint: ignore[JG001] -- eager-only debug path

The gate (``tests/test_torch_graftlint_gate.py``) keeps
``bigdl_tpu_torch/`` and ``chip_smoke.py`` at zero unsuppressed findings.
"""

from bigdl_tpu_torch.analysis.core import (Finding, FileResult, Rule, RULES,
                                           all_rules, lint_file, lint_paths,
                                           lint_source, register, render_json,
                                           render_text, select_rules)
from bigdl_tpu_torch.analysis.program import ProgramIndex
from bigdl_tpu_torch.analysis.sarif import render_sarif, sarif_report

__all__ = [
    "Finding", "FileResult", "ProgramIndex", "Rule", "RULES", "all_rules",
    "lint_file", "lint_paths", "lint_source", "register", "render_json",
    "render_sarif", "render_text", "sarif_report", "select_rules",
]
