"""JG006 — Python branching on a tensor inside a captured body
(counterpart of ``bigdl_tpu/analysis/rules/tracer_branch.py``)."""

from __future__ import annotations

from typing import Iterator

from bigdl_tpu_torch.analysis.core import (FileContext, Finding, Rule,
                                           iter_trace_events, register)


@register
class TracerBranchRule(Rule):
    """``if``/``while``/``assert`` (or a conditional expression, or a
    comprehension's ``if``) on a tensor inside a body captured into a CUDA
    graph reads the tensor on the host at capture — which the capture
    refuses — and, where it does not raise, freezes the branch taken at
    capture for every replay. Branch on the card instead
    (``torch.where``, masks) or decide outside the captured body. Python
    branches on static values (config, ``.shape``/``.dtype``/``.size()``,
    ``len()``) are fine and not flagged.
    """

    code = "JG006"
    summary = ("Python if/while/assert on a tensor inside a CUDA-graph "
               "captured body (use torch.where / masks)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for ev in iter_trace_events(ctx):
            if ev.kind == "tracer_branch":
                yield self.finding(
                    ctx, ev.node,
                    f"Python branch on a tensor ('{ev.detail}') inside "
                    f"captured body '{ev.qualname}': a host read at "
                    f"capture, and a branch frozen for every replay; use "
                    f"torch.where / a mask, or decide outside the body")
