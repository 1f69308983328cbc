"""graftlint CLI for the port (counterpart of
``bigdl_tpu/analysis/__main__.py``):
``python -m bigdl_tpu_torch.analysis [paths...]``.

Exit status 0 when every finding is suppressed (with a reason), 1 when
unsuppressed findings remain, 2 on usage errors — so the command slots
straight into CI. ``--changed REF``
narrows the pass to files changed vs a git ref (fast local gating);
``--sarif PATH`` writes a SARIF 2.1.0 report alongside the stdout
format.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from typing import List, Optional

from bigdl_tpu_torch.analysis.core import (all_rules, iter_python_files,
                                     lint_paths, render_json, render_text)
from bigdl_tpu_torch.analysis.sarif import render_sarif


def _csv(value: str) -> List[str]:
    return [v for v in value.split(",") if v.strip()]


def default_paths() -> List[str]:
    """The gate's tree, resolved from the package location (not the
    CWD): bigdl_tpu_torch/ (its scripts/ included) plus chip_smoke.py when
    it sits at the package's parent."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = [pkg]
    smoke = os.path.join(os.path.dirname(pkg), "chip_smoke.py")
    if os.path.isfile(smoke):
        out.append(smoke)
    return out


def rule_table() -> str:
    lines = ["code   summary", "-----  " + "-" * 66]
    for rule in all_rules():
        lines.append(f"{rule.code}  {rule.summary}")
    return "\n".join(lines)


def changed_files(ref: str, paths: List[str]) -> List[str]:
    """``.py`` files under ``paths`` that differ from git ``ref``
    (deleted files excluded), PLUS untracked files — a brand-new module
    is the one most likely to hold fresh findings, and ``git diff``
    alone never lists it. Raises ValueError when git can't answer — the
    caller turns that into a usage error, never a silent pass."""
    probe = paths[0] if paths else os.getcwd()
    probe_dir = probe if os.path.isdir(probe) else os.path.dirname(probe)
    try:
        top = subprocess.run(
            ["git", "-C", probe_dir or ".", "rev-parse", "--show-toplevel"],
            capture_output=True, text=True, check=True).stdout.strip()
        out = subprocess.run(
            ["git", "-C", top, "diff", "--name-only", "--diff-filter=d",
             ref, "--", "*.py"],
            capture_output=True, text=True, check=True).stdout
        untracked = subprocess.run(
            ["git", "-C", top, "ls-files", "--others",
             "--exclude-standard", "--", "*.py"],
            capture_output=True, text=True, check=True).stdout
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        detail = getattr(e, "stderr", "") or str(e)
        raise ValueError(f"--changed {ref}: {detail.strip()}")
    changed = {os.path.abspath(os.path.join(top, line))
               for line in (out.splitlines() + untracked.splitlines())
               if line.strip()}
    lint_set = {os.path.abspath(p) for p in iter_python_files(paths)}
    return sorted(changed & lint_set)


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.analysis",
        description="graftlint: AST-based CUDA-graph, generator and "
                    "collective hazard linter for bigdl_tpu_torch")
    parser.add_argument("paths", nargs="*", default=[],
                        help="files or directories to lint (default: the "
                             "installed bigdl_tpu_torch/ tree + sibling "
                             "chip_smoke.py)")
    parser.add_argument("--select", type=_csv, default=None, metavar="CODES",
                        help="comma-separated rule codes to run (only)")
    parser.add_argument("--ignore", type=_csv, default=None, metavar="CODES",
                        help="comma-separated rule codes to skip")
    parser.add_argument("--format", choices=("text", "json", "sarif"),
                        default="text",
                        help="report format (default: text)")
    parser.add_argument("--sarif", metavar="PATH", default=None,
                        help="also write a SARIF 2.1.0 report to PATH")
    parser.add_argument("--changed", metavar="REF", default=None,
                        help="lint only files changed vs this git ref "
                             "(whole-program facts come from the changed "
                             "set only — run the full gate before merging)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule table and exit")
    parser.add_argument("--no-cache", action="store_true",
                        help="bypass the content-hash result cache "
                             "(GRAFTLINT_NO_CACHE=1 equivalent)")
    parser.add_argument("--comm-model", metavar="PATH", default=None,
                        help="write the static collective byte model "
                             "(bigdl_tpu_torch/analysis/comm_model.json; "
                             "'-' for stdout) and exit")
    args = parser.parse_args(argv)

    if args.list_rules:
        print(rule_table())
        return 0
    if args.comm_model is not None:
        from bigdl_tpu_torch.analysis import commcost
        if args.comm_model == "-":
            print(json.dumps(commcost.build_model(), indent=2,
                             sort_keys=True))
        else:
            commcost.write_model(args.comm_model)
            print(f"graftlint: collective byte model written to "
                  f"{args.comm_model}", file=sys.stderr)
        return 0
    paths = args.paths or default_paths()
    missing = [p for p in paths if not os.path.exists(p)]
    if missing:
        # a typo'd path must not silently lint zero files and pass
        print(f"graftlint: no such path(s): {', '.join(missing)}",
              file=sys.stderr)
        return 2
    files = None
    try:
        if args.changed is not None:
            files = changed_files(args.changed, paths)
            if not files:
                # stderr: stdout must stay a clean json/sarif document
                print(f"graftlint: no linted files changed vs "
                      f"{args.changed}", file=sys.stderr)
        # lint_paths validates --select/--ignore codes via select_rules
        results = lint_paths(paths, select=args.select, ignore=args.ignore,
                             files=files,
                             use_cache=False if args.no_cache else None)
    except ValueError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 2
    except OSError as e:
        print(f"graftlint: {e}", file=sys.stderr)
        return 2
    if args.format == "json":
        out = render_json(results)
    elif args.format == "sarif":
        out = render_sarif(results)
    else:
        out = render_text(results)
    print(out)
    if args.sarif:
        with open(args.sarif, "w", encoding="utf-8") as f:
            f.write(render_sarif(results))
        print(f"graftlint: SARIF report written to {args.sarif}",
              file=sys.stderr)
    return 1 if any(res.findings for res in results) else 0


if __name__ == "__main__":
    sys.exit(main())
