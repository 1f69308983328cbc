"""JG002 — Python side effects inside a captured body (counterpart of
``bigdl_tpu/analysis/rules/side_effects.py``)."""

from __future__ import annotations

import ast
from typing import Iterator

from bigdl_tpu_torch.analysis.core import (_FUNC_TYPES, FileContext, Finding,
                                           Rule, dotted_name,
                                           iter_own_statements, register)

_LOGGER_NAMES = {"logging", "logger", "log", "LOG", "LOGGER", "_log",
                 "_logger"}
_LOG_METHODS = {"debug", "info", "warning", "warn", "error", "critical",
                "exception", "log"}
# telemetry instruments: each call is one host-side increment
_METRIC_METHODS = {"inc", "observe"}


def _captured_units(ctx: FileContext):
    """(node, qualname) for every captured function and capture block."""
    idx = ctx.capture_index
    for fn in idx.functions:
        if idx.is_captured(fn):
            yield fn, idx.qualname(fn), iter_own_statements(fn)
    for lam in idx.captured:
        if isinstance(lam, ast.Lambda):
            yield lam, idx.qualname(lam), iter_own_statements(lam)
    for block in idx.capture_blocks:
        owner = idx.parent.get(block)
        while owner is not None and not isinstance(owner, _FUNC_TYPES):
            owner = idx.parent.get(owner)
        if owner is not None and idx.is_captured(owner):
            continue   # already walked as a captured function
        qual = (idx.qualname(owner) if owner is not None else "<module>") \
            + ".<cuda graph>"
        yield block, qual, _block_statements(block)


def _block_statements(block: ast.With):
    wrapper = ast.Module(body=block.body, type_ignores=[])
    return iter_own_statements(wrapper)


@register
class TraceSideEffectRule(Rule):
    """``print``/``logging``/``warnings.warn``, a metric's ``inc``/
    ``observe``, a ``+= <number>`` counter on an attribute or an item, or
    ``global``/``nonlocal`` mutation inside a body captured into a CUDA
    graph runs once, at capture, and never at replay: the log line, the
    count or the global then describe one step out of thousands. (The
    port's ``LaunchCounter.add`` is the exception the graph itself
    replays.) Count and log outside the captured body, from the replay's
    caller.
    """

    code = "JG002"
    summary = ("print/logging/counter/global mutation inside a CUDA-graph "
               "captured body runs at capture, not at each replay")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for unit, qual, nodes in _captured_units(ctx):
            for node in nodes:
                if isinstance(node, (ast.Global, ast.Nonlocal)):
                    kind = "global" if isinstance(node, ast.Global) \
                        else "nonlocal"
                    yield self.finding(
                        ctx, node,
                        f"'{kind} {', '.join(node.names)}' inside captured "
                        f"body '{qual}': the mutation happens once at "
                        f"capture and never at replay")
                    continue
                if isinstance(node, ast.AugAssign) \
                        and isinstance(node.target, (ast.Attribute,
                                                     ast.Subscript)) \
                        and isinstance(node.value, ast.Constant) \
                        and isinstance(node.value.value, (int, float)):
                    yield self.finding(
                        ctx, node,
                        f"a Python counter is bumped inside captured body "
                        f"'{qual}': it counts the capture only, never a "
                        f"replay; count from the replay's caller")
                    continue
                if not isinstance(node, ast.Call):
                    continue
                name = dotted_name(node.func)
                effect = None
                if name == "print":
                    effect = "print()"
                elif name == "warnings.warn":
                    effect = "warnings.warn()"
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _LOG_METHODS \
                        and isinstance(node.func.value, ast.Name) \
                        and node.func.value.id in _LOGGER_NAMES:
                    effect = f"{node.func.value.id}.{node.func.attr}()"
                elif isinstance(node.func, ast.Attribute) \
                        and node.func.attr in _METRIC_METHODS:
                    effect = f".{node.func.attr}()"
                if effect is not None:
                    yield self.finding(
                        ctx, node,
                        f"{effect} inside captured body '{qual}' fires at "
                        f"capture only, never at a replay; move it to the "
                        f"replay's caller")
