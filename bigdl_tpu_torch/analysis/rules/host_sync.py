"""JG001 — host read of a tensor inside a captured body (counterpart of
``bigdl_tpu/analysis/rules/host_sync.py``)."""

from __future__ import annotations

from typing import Iterator

from bigdl_tpu_torch.analysis.core import (FileContext, Finding, Rule,
                                           iter_trace_events, register)


@register
class HostSyncRule(Rule):
    """``float()``/``int()``/``bool()``/``np.asarray()``/``.item()``/
    ``.tolist()``/``.cpu()``/``.numpy()`` on a tensor, or a device-wide
    wait (``torch.cuda.synchronize()``, ``Event/Stream.synchronize()``),
    inside a body captured into a CUDA graph (a ``GraphedProgram`` body, a
    ``with torch.cuda.graph(...)`` block, a ``make_graphed_callables`` or
    ``torch.compile`` target, or a helper they call, across modules). A
    capture cannot record a copy to the host or a wait: it raises at
    capture, and in code that sometimes runs eagerly the same line
    silently serializes the stream. Keep the value on the card and read
    it outside the captured body.
    """

    code = "JG001"
    summary = ("host read (float/int/bool/.item/.tolist/.cpu/synchronize) "
               "of a tensor inside a CUDA-graph captured body")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for ev in iter_trace_events(ctx):
            if ev.kind == "host_sync":
                yield self.finding(
                    ctx, ev.node,
                    f"{ev.detail} reads a tensor on the host inside "
                    f"captured body '{ev.qualname}'; a CUDA graph cannot "
                    f"capture it — keep the value on the card and read it "
                    f"outside the captured body")
