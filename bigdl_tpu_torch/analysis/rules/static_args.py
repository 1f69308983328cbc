"""JG005 — a program declaration naming what the wrapped callable lacks
(counterpart of ``bigdl_tpu/analysis/rules/static_args.py``)."""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional

from bigdl_tpu_torch.analysis.core import (CAPTURE_WRAPPERS, FAMILY_WRAPPERS,
                                           FileContext, Finding, Rule,
                                           _positional_params, dotted_name,
                                           register)


def _literal_ints(node: ast.expr) -> Optional[List[object]]:
    """Constant(s) out of an int/tuple/list literal, else None."""
    if isinstance(node, ast.Constant):
        return [node.value]
    if isinstance(node, (ast.Tuple, ast.List)):
        out: List[object] = []
        for elt in node.elts:
            if not isinstance(elt, ast.Constant):
                return None
            out.append(elt.value)
        return out
    return None


def _kw(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _wrapped(ctx: FileContext, call: ast.Call):
    """The def or lambda a builder call wraps, when it resolves to one."""
    target = call.args[0] if call.args else None
    if isinstance(target, ast.Lambda):
        return target
    if isinstance(target, ast.Name):
        matches = ctx.capture_index.resolve_name(target.id, call)
        return matches[0] if len(matches) == 1 else None
    if isinstance(target, ast.Attribute) and isinstance(target.value,
                                                        ast.Name) \
            and target.value.id in ("self", "cls"):
        return ctx.capture_index.resolve_method(target.attr, call)
    return None


def _required_positional(fn: ast.AST, bound: int = 0) -> int:
    a = fn.args
    n = len(getattr(a, "posonlyargs", [])) + len(a.args)
    return max(0, n - len(a.defaults) - bound)


@register
class StaticArgsRule(Rule):
    """A program declaration that names what its callable lacks does
    nothing, or fails far from the declaration: a ``tracked_jit``
    ``donate_argnums`` index beyond the wrapped callable's positional
    parameters is dead (the reference's donation never happens), a
    literal ``cache_size`` below 1 evicts every program it records, and a
    ``GraphedProgram`` body with required parameters fails at its first
    call (a graph body is called with none: it reads its inputs from
    tensors at fixed addresses). Declarations must name what the callable
    has.
    """

    code = "JG005"
    summary = ("tracked_jit donate_argnums out of range / cache_size < 1, "
               "or a GraphedProgram body that needs arguments")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ctx.walk():
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if callee in FAMILY_WRAPPERS:
                yield from self._family(ctx, node)
            elif callee in CAPTURE_WRAPPERS:
                fn = _wrapped(ctx, node)
                if fn is None:
                    continue
                bound = 1 if isinstance(node.args[0], ast.Attribute) else 0
                need = _required_positional(fn, bound)
                if need or fn.args.kwonlyargs and any(
                        d is None for d in fn.args.kw_defaults):
                    yield self.finding(
                        ctx, node,
                        f"the GraphedProgram body "
                        f"'{getattr(fn, 'name', '<lambda>')}' needs "
                        f"{need or 'keyword'} argument(s), but a graph body "
                        f"is called with none — it raises at its first "
                        f"call; close over tensors at fixed addresses")

    def _family(self, ctx: FileContext, call: ast.Call
                ) -> Iterator[Finding]:
        size = _kw(call, "cache_size")
        if isinstance(size, ast.Constant) and type(size.value) is int \
                and size.value < 1:
            yield self.finding(
                ctx, size,
                f"tracked_jit cache_size={size.value} evicts every program "
                f"it records: each call is a 'compile'; use at least 1")
        donate = _kw(call, "donate_argnums")
        values = _literal_ints(donate) if donate is not None else None
        if not values:
            return
        fn = _wrapped(ctx, call)
        if fn is None:
            return
        bound = 1 if isinstance(call.args[0], ast.Attribute) else 0
        pos = _positional_params(fn)[bound:]
        for v in values:
            if not isinstance(v, int) or isinstance(v, bool):
                yield self.finding(ctx, donate,
                                   f"donate_argnums entry {v!r} is not an "
                                   f"int")
            elif (v >= len(pos) or v < 0) and fn.args.vararg is None:
                yield self.finding(
                    ctx, donate,
                    f"donate_argnums index {v} is out of range for "
                    f"'{getattr(fn, 'name', '<lambda>')}' ({len(pos)} "
                    f"positional parameter(s)) — the declaration is dead")
