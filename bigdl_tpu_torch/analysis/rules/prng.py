"""JG003 — generator streams a CUDA graph replays wrongly, and streams
re-seeded into a repeat (counterpart of
``bigdl_tpu/analysis/rules/prng.py``: the reference's PRNG key reuse)."""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from bigdl_tpu_torch.analysis.core import (_FUNC_TYPES, CAPTURE_WRAPPERS,
                                           FileContext, Finding, Rule,
                                           dotted_name, register)
from bigdl_tpu_torch.analysis.program import GeneratorFacts, generator_names

# torch draws that take the global generator when given no generator=
_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
          "multinomial", "rand_like", "randn_like", "randint_like",
          "dropout", "poisson"}


def _generator_kw(call: ast.Call) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == "generator":
            return kw.value
    return None


def _body_of(ctx: FileContext, call: ast.Call) -> Optional[ast.AST]:
    body = call.args[0] if call.args else None
    idx = ctx.capture_index
    if isinstance(body, ast.Lambda):
        return body
    if isinstance(body, ast.Name):
        found = idx.resolve_name(body.id, call)
        return found[0] if len(found) == 1 else None
    if isinstance(body, ast.Attribute) and isinstance(body.value, ast.Name) \
            and body.value.id in ("self", "cls"):
        return idx.resolve_method(body.attr, call)
    return None


@register
class KeyReuseRule(Rule):
    """A CUDA graph replays the random draws it captured from the
    generators it knows: the device's default one, and each explicit
    ``torch.Generator`` registered with it (``GraphedProgram(...,
    generators=...)``, ``graph.register_generator_state``). A draw inside
    a captured body from an explicit generator the graph does not know of
    is not advanced per replay: every replay gives the same numbers (or
    the capture refuses it) — dropout masks and sampled tokens repeat, and
    the program still "works". Register the generator with the graph.
    A generator re-seeded with the same value before its second round of
    draws repeats the first round exactly; seed once, or derive a new
    value (the port's ``(seed, rank)`` streams are distinct values).
    """

    code = "JG003"
    summary = ("draw inside a CUDA-graph body from a generator not given to "
               "the graph, or a generator re-seeded into a repeat")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not ctx.mentions("Generator", "manual_seed", "generator"):
            return
        facts = ctx.program.generator_facts(ctx.module)
        for node in ctx.walk():
            if isinstance(node, ast.Call) \
                    and dotted_name(node.func) in CAPTURE_WRAPPERS:
                yield from self._program(ctx, facts, node)
            elif isinstance(node, ast.With) and \
                    node in ctx.capture_index.capture_blocks:
                yield from self._block(ctx, facts, node)
        if not ctx.mentions("manual_seed"):
            return
        for fn in ctx.capture_index.functions:
            if any(isinstance(n, ast.Attribute) and n.attr == "manual_seed"
                   for n in ast.walk(fn)):
                yield from self._reseeds(ctx, fn)

    # -- draws inside captured bodies ------------------------------------
    def _program(self, ctx: FileContext, facts: GeneratorFacts,
                 call: ast.Call) -> Iterator[Finding]:
        body = _body_of(ctx, call)
        if body is None:
            return
        registered: Set[str] = set()
        for kw in call.keywords:
            if kw.arg == "generators":
                registered = generator_names(kw.value)
                if not registered <= facts.generators:
                    return   # a computed list: not resolvable, skip
        yield from self._draws(ctx, facts, [body], registered,
                               "GraphedProgram")

    def _block(self, ctx: FileContext, facts: GeneratorFacts,
               block: ast.With) -> Iterator[Finding]:
        yield from self._draws(ctx, facts, block.body, facts.registered,
                               "torch.cuda.graph block")

    def _draws(self, ctx: FileContext, facts: GeneratorFacts,
               roots: List[ast.AST], registered: Set[str],
               where: str) -> Iterator[Finding]:
        cls = None
        for root in roots:
            cls = ctx.capture_index.enclosing_class_name(root) or cls
        work = list(roots)
        seen: Set[int] = set()
        while work:
            node = work.pop()
            if id(node) in seen:
                continue
            seen.add(id(node))
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                if isinstance(sub.func, ast.Name):
                    # same-module helpers run under the capture too
                    work.extend(ctx.capture_index.resolve_name(sub.func.id,
                                                               sub))
                for gen, how in self._generators_drawn(ctx, sub, cls):
                    if gen in facts.generators and gen not in registered:
                        yield self.finding(
                            ctx, sub,
                            f"{how} draws from generator '{gen}' inside a "
                            f"{where} that was not given it: the graph "
                            f"does not advance it, so every replay draws "
                            f"the same numbers; register it "
                            f"(generators=...)")

    def _generators_drawn(self, ctx: FileContext, call: ast.Call,
                          cls: Optional[str]
                          ) -> Iterator[Tuple[str, str]]:
        callee = dotted_name(call.func) or "a call"
        g = _generator_kw(call)
        if g is not None:
            name = dotted_name(g)
            if name is not None:
                yield name, f"{callee}(generator=...)"
        if ctx.program is None or ctx.module is None:
            return
        args = [(j, None, a) for j, a in enumerate(call.args)]
        args += [(None, kw.arg, kw.value) for kw in call.keywords
                 if kw.arg != "generator"]
        for pos, kw_name, arg in args:
            name = dotted_name(arg)
            if name is None or (pos is None and kw_name is None):
                continue
            if ctx.program.call_draws_from(
                    ctx.module, dotted_name(call.func) or "",
                    pos if pos is not None else 0, kw_name, cls):
                yield name, f"{callee}() (which draws from its argument)"

    # -- re-seeding into a repeat ----------------------------------------
    def _reseeds(self, ctx: FileContext, fn: ast.AST) -> Iterator[Finding]:
        out: List[Finding] = []
        self._walk(ctx, fn.body, {}, {}, out)
        yield from out

    def _walk(self, ctx: FileContext, stmts, seeds: Dict[str, str],
              draws: Dict[str, int], out: List[Finding]) -> None:
        for stmt in stmts:
            if isinstance(stmt, (*_FUNC_TYPES, ast.ClassDef)):
                continue
            if isinstance(stmt, ast.If):
                s1, d1 = dict(seeds), dict(draws)
                s2, d2 = dict(seeds), dict(draws)
                self._walk(ctx, stmt.body, s1, d1, out)
                self._walk(ctx, stmt.orelse, s2, d2, out)
                seeds.clear()
                seeds.update({k: v for k, v in s1.items()
                              if s2.get(k) == v})
                for k in set(d1) | set(d2):
                    draws[k] = max(d1.get(k, 0), d2.get(k, 0))
                continue
            if isinstance(stmt, (ast.For, ast.While, ast.With, ast.Try)):
                for sub in ast.iter_child_nodes(stmt):
                    if isinstance(sub, ast.expr):
                        self._calls(ctx, sub, seeds, draws, out)
                bodies = [stmt.body, getattr(stmt, "orelse", [])]
                if isinstance(stmt, ast.Try):
                    bodies += [h.body for h in stmt.handlers]
                    bodies.append(stmt.finalbody)
                for _ in range(2 if isinstance(stmt, (ast.For, ast.While))
                               else 1):
                    for body in bodies:
                        self._walk(ctx, body, seeds, draws, out)
                continue
            self._calls(ctx, stmt, seeds, draws, out)

    def _calls(self, ctx: FileContext, node: ast.AST, seeds: Dict[str, str],
               draws: Dict[str, int], out: List[Finding]) -> None:
        calls = [n for n in ast.walk(node) if isinstance(n, ast.Call)
                 and not isinstance(n, ast.Lambda)]
        calls.sort(key=lambda c: (c.lineno, c.col_offset))
        for call in calls:
            if isinstance(call.func, ast.Attribute) \
                    and call.func.attr == "manual_seed" and call.args:
                base = call.func.value
                name = dotted_name(base)
                if isinstance(base, ast.Call) and dotted_name(
                        base.func) in ("torch.Generator", "Generator"):
                    continue   # a fresh generator: a new stream
                if name is None:
                    continue
                value = ast.dump(call.args[0])
                if seeds.get(name) == value and draws.get(name, 0) > 0:
                    out.append(self.finding(
                        ctx, call,
                        f"'{name}' is re-seeded with the same value after "
                        f"drawing from it: the draws that follow repeat "
                        f"the earlier ones exactly; seed once, or derive a "
                        f"distinct value"))
                seeds[name] = value
                draws[name] = 0
                continue
            callee = dotted_name(call.func) or ""
            g = _generator_kw(call)
            if g is not None and dotted_name(g) is not None:
                key = dotted_name(g)
                draws[key] = draws.get(key, 0) + 1
            elif callee.startswith("torch.") \
                    and callee.rsplit(".", 1)[-1] in _DRAWS:
                draws["torch"] = draws.get("torch", 0) + 1
