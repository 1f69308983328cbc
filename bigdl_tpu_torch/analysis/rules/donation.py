"""JG007 — a graph output read after the next replay of its program
(counterpart of ``bigdl_tpu/analysis/rules/donation.py``: where the
reference's donated buffer is deleted by the call, a ``GraphedProgram``'s
output is overwritten by the next replay)."""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Sequence, Set

from bigdl_tpu_torch.analysis.core import (_FUNC_TYPES, CAPTURE_WRAPPERS,
                                           FileContext, Finding, Rule,
                                           dotted_name, register)


def local_programs(fn: ast.AST) -> Set[str]:
    """Local names bound to a ``GraphedProgram(...)`` in ``fn``."""
    out: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and dotted_name(node.value.func) in CAPTURE_WRAPPERS:
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


class ReplayAliasWalker:
    """Order-sensitive walk tracking which names hold a program's static
    output: a call of program ``p`` (a name or dotted ``self.x`` in
    ``programs``) overwrites every output of ``p`` held so far, and a
    later read of one is reported through ``report(node)``. Branch arms
    merge, loop bodies run twice (a read in the next iteration)."""

    def __init__(self, programs: Set[str], report):
        self.programs = programs
        self.report = report

    def walk(self, stmts: Sequence[ast.stmt], held: Dict[str, str],
             dead: Set[str]) -> None:
        for stmt in stmts:
            self._stmt(stmt, held, dead)

    def _stmt(self, stmt: ast.stmt, held: Dict[str, str],
              dead: Set[str]) -> None:
        if isinstance(stmt, (*_FUNC_TYPES, ast.ClassDef)):
            return  # nested scopes analyzed on their own
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            if stmt.value is not None:
                self._expr(stmt.value, held, dead)
            if isinstance(stmt, ast.AugAssign) and \
                    isinstance(stmt.target, ast.Name) and \
                    stmt.target.id in dead:
                self._report(stmt.target, dead)
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            prog = self._program_of(stmt.value)
            for tgt in targets:
                self._rebind(tgt, held, dead)
                if prog is not None and isinstance(tgt, ast.Name):
                    held[tgt.id] = prog
            return
        if isinstance(stmt, ast.If):
            self._expr(stmt.test, held, dead)
            h1, h2 = dict(held), dict(held)
            d1, d2 = set(dead), set(dead)
            self.walk(stmt.body, h1, d1)
            self.walk(stmt.orelse, h2, d2)
            held.clear()
            held.update({**h1, **h2})
            dead.clear()
            dead.update(d1 | d2)
            return
        if isinstance(stmt, (ast.For, ast.While)):
            if isinstance(stmt, ast.For):
                self._expr(stmt.iter, held, dead)
                self._rebind(stmt.target, held, dead)
            else:
                self._expr(stmt.test, held, dead)
            for _ in range(2):  # second pass: reads across iterations
                h1, d1 = dict(held), set(dead)
                self.walk(stmt.body, h1, d1)
                held.update(h1)
                dead.update(d1)
            self.walk(stmt.orelse, held, dead)
            return
        if isinstance(stmt, ast.Try):
            self.walk(stmt.body, held, dead)
            for handler in stmt.handlers:
                self.walk(handler.body, held, dead)
            self.walk(stmt.orelse, held, dead)
            self.walk(stmt.finalbody, held, dead)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._expr(item.context_expr, held, dead)
            self.walk(stmt.body, held, dead)
            return
        for child in ast.iter_child_nodes(stmt):
            if isinstance(child, ast.expr):
                self._expr(child, held, dead)

    def _program_of(self, value) -> str:
        """``p()`` -> ``p`` when ``value`` is a bare call of a program."""
        if isinstance(value, ast.Call) and not value.args \
                and not value.keywords:
            name = dotted_name(value.func)
            if name in self.programs:
                return name
        return None

    def _rebind(self, target: ast.expr, held: Dict[str, str],
                dead: Set[str]) -> None:
        if isinstance(target, ast.Name):
            dead.discard(target.id)
            held.pop(target.id, None)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._rebind(elt, held, dead)
        elif isinstance(target, ast.Starred):
            self._rebind(target.value, held, dead)

    def _expr(self, node: ast.expr, held: Dict[str, str],
              dead: Set[str]) -> None:
        if isinstance(node, (ast.Lambda, *_FUNC_TYPES)):
            return
        if isinstance(node, ast.Call):
            for arg in node.args:
                self._expr(arg, held, dead)
            for kw in node.keywords:
                self._expr(kw.value, held, dead)
            name = dotted_name(node.func)
            if name in self.programs:
                # the replay overwrites every output of this program held
                for n in [n for n, p in held.items() if p == name]:
                    del held[n]
                    dead.add(n)
            else:
                self._expr(node.func, held, dead)
            return
        if isinstance(node, ast.Name) and isinstance(node.ctx, ast.Load) \
                and node.id in dead:
            self._report(node, dead)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                self._expr(child, held, dead)

    def _report(self, node: ast.Name, dead: Set[str]) -> None:
        dead.discard(node.id)  # one report per overwrite, not per read
        self.report(node)


@register
class DonatedBufferReuseRule(Rule):
    """A ``GraphedProgram`` returns its graph's STATIC outputs: every
    replay writes the same memory and returns the same tensors. An output
    held across the next replay of the same program (``a = prog();
    b = prog(); use(a)``) silently reads the newer replay's values — the
    program still "works", just with the wrong step's numbers. Read the
    output before the next replay, or ``.clone()`` it when it must
    outlive one (as ``_WindowGraph`` does with its losses).
    """

    code = "JG007"
    summary = ("a GraphedProgram output is read after the next replay of "
               "the same program overwrote it (clone it first)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        findings: List[Finding] = []

        def report(node: ast.Name) -> None:
            findings.append(self.finding(
                ctx, node,
                f"'{node.id}' holds a graph output that a later replay of "
                f"the same GraphedProgram has overwritten — read it before "
                f"the next replay or .clone() it"))

        if not ctx.mentions("GraphedProgram"):
            return
        for fn in ctx.capture_index.functions:
            programs = local_programs(fn)
            if programs:
                ReplayAliasWalker(programs, report).walk(fn.body, {}, set())
        yield from findings
