"""JG004 — a program built inside a Python loop (counterpart of
``bigdl_tpu/analysis/rules/jit_in_loop.py``)."""

from __future__ import annotations

import ast
from typing import Iterator

from bigdl_tpu_torch.analysis.core import (_FUNC_TYPES, PROGRAM_BUILDERS,
                                           FileContext, Finding, Rule,
                                           _unwrap_partial, dotted_name,
                                           register)


_COMPREHENSIONS = (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)


def _loop_body_calls(loop: ast.AST) -> Iterator[ast.Call]:
    """Calls lexically inside a loop body (or a comprehension's element/
    condition expressions), not crossing a function boundary — a def
    inside the loop builds when *called*, not per iteration. A
    ``GraphedProgram(lambda: ...)`` call IS per-iteration, so the builder
    call itself is seen even though the lambda body is skipped."""
    if isinstance(loop, _COMPREHENSIONS):
        stack: list = ([loop.value, loop.key]
                       if isinstance(loop, ast.DictComp) else [loop.elt])
        for gen in loop.generators:
            stack.extend(gen.ifs)
    else:
        stack = list(loop.body) + list(getattr(loop, "orelse", []))
        if isinstance(loop, ast.While):
            stack.append(loop.test)  # evaluated per iteration too
    while stack:
        node = stack.pop()
        if isinstance(node, _FUNC_TYPES):
            continue
        if isinstance(node, ast.Lambda):
            continue  # body runs at call time, not per iteration
        if isinstance(node, ast.Call):
            yield node
        stack.extend(ast.iter_child_nodes(node))


@register
class JitInLoopRule(Rule):
    """``GraphedProgram(...)``, ``torch.cuda.CUDAGraph()``,
    ``make_graphed_callables(...)``, ``torch.compile(...)`` or
    ``tracked_jit(...)`` inside a ``for``/``while`` body builds a FRESH
    program every iteration: each graph captures again (and holds a
    memory pool of its own), each compiled callable compiles again, each
    flight recorder starts an empty family. Build it once outside the
    loop, or cache it by its static signature and bound the cache.
    """

    code = "JG004"
    summary = ("GraphedProgram/CUDAGraph/torch.compile/tracked_jit built "
               "inside a Python loop — a capture or compile per iteration")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        seen = set()  # a call in nested loops reports once, not per loop
        for node in ctx.walk():
            if not isinstance(node, (ast.For, ast.While, *_COMPREHENSIONS)):
                continue
            if isinstance(node, ast.While):
                kind = "while loop"
            elif isinstance(node, ast.For):
                kind = "for loop"
            else:
                kind = "comprehension"
            for call in _loop_body_calls(node):
                if id(call) in seen:
                    continue
                seen.add(id(call))
                callee = dotted_name(call.func) or _unwrap_partial(call)
                if callee in PROGRAM_BUILDERS:
                    yield self.finding(
                        ctx, call,
                        f"{callee}(...) inside a {kind} builds a fresh "
                        f"program every iteration (a capture or a compile "
                        f"each time); build it once outside the loop or "
                        f"cache it by its static signature")
