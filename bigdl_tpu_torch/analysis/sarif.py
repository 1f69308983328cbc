"""SARIF 2.1.0 emitter for the port's graftlint (counterpart of
``bigdl_tpu/analysis/sarif.py``) — the interchange format CI annotators
(GitHub code scanning, VS Code SARIF viewers, Gerrit checks) consume
natively.

One ``run`` per invocation: the tool.driver carries the full rule
catalogue (id, summary, rationale), every unsuppressed finding becomes a
``result`` with a physical location, and source-suppressed findings are
included with ``suppressions: [{kind: "inSource"}]`` so dashboards can
audit the suppression inventory rather than lose it.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence

from bigdl_tpu_torch.analysis.core import (FileResult, Finding, Rule,
                                           all_rules)

SARIF_VERSION = "2.1.0"
SARIF_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
                "master/Schemata/sarif-schema-2.1.0.json")


def _artifact_uri(path: str) -> str:
    """Relative forward-slash URI when under the CWD, else absolute."""
    ap = os.path.abspath(path)
    cwd = os.getcwd()
    if ap.startswith(cwd + os.sep):
        return os.path.relpath(ap, cwd).replace(os.sep, "/")
    return "file://" + ap.replace(os.sep, "/")


def _result(f: Finding, rule_index: dict, suppressed: bool) -> dict:
    out = {
        "ruleId": f.code,
        "level": "warning",
        "message": {"text": f.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {"uri": _artifact_uri(f.path)},
                "region": {
                    "startLine": max(1, f.line),
                    "startColumn": f.col + 1,
                    "endLine": max(1, f.end_line or f.line),
                },
            },
        }],
    }
    if f.code in rule_index:
        out["ruleIndex"] = rule_index[f.code]
    if suppressed:
        out["suppressions"] = [{"kind": "inSource"}]
    return out


def sarif_report(results: Sequence[FileResult],
                 rules: Optional[Sequence[Rule]] = None) -> dict:
    """The report as a plain dict (``render_sarif`` serializes it)."""
    rules = list(rules) if rules is not None else all_rules()
    rule_index = {r.code: i for i, r in enumerate(rules)}
    driver_rules = [{
        "id": r.code,
        "name": type(r).__name__,
        "shortDescription": {"text": r.summary},
        "fullDescription": {"text": " ".join((r.__doc__ or "").split())},
        "defaultConfiguration": {"level": "warning"},
    } for r in rules]
    sarif_results: List[dict] = []
    for res in results:
        for f in res.findings:
            sarif_results.append(_result(f, rule_index, suppressed=False))
        for f in res.suppressed:
            sarif_results.append(_result(f, rule_index, suppressed=True))
    return {
        "$schema": SARIF_SCHEMA,
        "version": SARIF_VERSION,
        "runs": [{
            "tool": {"driver": {
                "name": "graftlint",
                "informationUri":
                    "https://github.com/bigdl-tpu/bigdl-tpu"
                    "/blob/main/bigdl_tpu_torch/analysis/README.md",
                "rules": driver_rules,
            }},
            "results": sarif_results,
        }],
    }


def render_sarif(results: Sequence[FileResult],
                 rules: Optional[Sequence[Rule]] = None) -> str:
    """SARIF 2.1.0 JSON text for ``--format sarif`` / ``--sarif PATH``."""
    return json.dumps(sarif_report(results, rules), indent=2)
