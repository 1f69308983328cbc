"""JG013–JG014 — program-cache hazards: programs cached under a
traffic-dependent key, and caches that grow without bound on a
loop-reachable path (counterpart of
``bigdl_tpu/analysis/rules/compile_cache.py``).

The reference's motivating fixture was the continuous server's prefill
compiled once per distinct prompt length. The port's programs are CUDA
graphs (``GraphedProgram``: one capture and one private memory pool
each), ``torch.compile`` callables and ``tracked_jit`` families; a dict
of them keyed by a request-derived value captures once per value and
keeps every pool. Both rules reason about *program values*: a direct
builder call, a local name bound to one, or a call to a function whose
whole-program summary says it returns a fresh program.
"""

from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from bigdl_tpu_torch.analysis.core import (_FUNC_TYPES, WRAPPER_BUILDERS,
                                           FileContext, Finding, Rule,
                                           dotted_name, iter_own_statements,
                                           register)
from bigdl_tpu_torch.analysis.shapes import DYN, RT, Scalar, shape_env

_LOOPS = (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
          ast.GeneratorExp)
_EVICTORS = {"pop", "popitem", "clear"}
_EMPTY_CTORS = {"dict", "OrderedDict", "collections.OrderedDict", "list"}


def program_builder(expr: ast.expr, ctx: FileContext,
                    cls: Optional[str]) -> Optional[str]:
    """The builder when ``expr`` is a call building a fresh program."""
    if not isinstance(expr, ast.Call):
        return None
    callee = dotted_name(expr.func) or ""
    if callee in WRAPPER_BUILDERS:
        return callee
    if ctx.program is not None and ctx.module is not None:
        resolved = ctx.program.summary_for_call(ctx.module, callee, cls)
        if resolved is not None and resolved[1].returns_program:
            return callee
    return None


def _is_program_value(expr: ast.expr, fn: ast.AST, ctx: FileContext,
                      cls: Optional[str]) -> bool:
    """``expr`` evaluates to a fresh program: directly, or a local name
    that is bound to one anywhere in ``fn``."""
    if program_builder(expr, ctx, cls) is not None:
        return True
    if isinstance(expr, ast.Name):
        for node in iter_own_statements(fn):
            if isinstance(node, ast.Assign) \
                    and program_builder(node.value, ctx, cls) is not None:
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name) and tgt.id == expr.id:
                        return True
    return False


def _container_of(store_target: ast.expr) -> Optional[Tuple[str, ast.expr]]:
    """For ``X[k] = ...`` return (dotted base of X, key expr)."""
    if isinstance(store_target, ast.Subscript):
        base = dotted_name(store_target.value)
        if base is not None:
            return base, store_target.slice
    return None


def _may_build(ctx: FileContext) -> bool:
    """Can this file build a program at all? (a builder's name, or a call
    of a function the program summary says returns one)."""
    def build() -> bool:
        names = {b.rsplit(".", 1)[-1] for b in WRAPPER_BUILDERS}
        if ctx.program is not None:
            names |= {q.rsplit(".", 1)[-1]
                      for key, s in ctx.program.summaries.items()
                      if s.returns_program for q in [key[1]]}
        return ctx.mentions(*names)
    return ctx.rule_cache("compile_cache.may_build", build)


def cache_inserts(fn: ast.AST, ctx: FileContext, cls: Optional[str]
                  ) -> List[Tuple[ast.AST, str, Optional[ast.expr]]]:
    """Program container inserts in ``fn``: ``(node, container dotted
    base, key expr or None)`` for ``X[k] = prog``, ``X.setdefault(k,
    prog)`` and ``X.append(prog)`` (chained ``p = X[k] = prog`` too);
    computed once per function."""
    if not _may_build(ctx):
        return []
    memo = ctx.rule_cache("compile_cache.inserts", dict)
    if id(fn) not in memo:
        memo[id(fn)] = list(_inserts(fn, ctx, cls))
    return memo[id(fn)]


def _inserts(fn: ast.AST, ctx: FileContext, cls: Optional[str]
             ) -> Iterator[Tuple[ast.AST, str, Optional[ast.expr]]]:
    for node in iter_own_statements(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                info = _container_of(tgt)
                if info and _is_program_value(node.value, fn, ctx, cls):
                    yield node, info[0], info[1]
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute):
            base = dotted_name(node.func.value)
            if base is None:
                continue
            if node.func.attr == "setdefault" and len(node.args) == 2 \
                    and _is_program_value(node.args[1], fn, ctx, cls):
                yield node, base, node.args[0]
            elif node.func.attr == "append" and len(node.args) == 1 \
                    and _is_program_value(node.args[0], fn, ctx, cls):
                yield node, base, None


def traffic_dependent(key: ast.expr, fn: ast.AST, ctx: FileContext) -> bool:
    """Is a cache key derived from runtime data? A constant, a literal
    int, and a value that went through a call (a bucketing function) are
    bounded; a parameter, ``self`` state, a loop variable or ``len()`` of
    runtime data (and arithmetic over it) are not."""
    if isinstance(key, ast.Constant):
        return False
    if isinstance(key, ast.Tuple):
        return any(traffic_dependent(e, fn, ctx) for e in key.elts)
    v = shape_env(ctx, fn).eval(key)
    return v is RT or (isinstance(v, Scalar) and v.value is DYN)


def _has_eviction(ctx: FileContext, base: str) -> bool:
    """Any ``<base>.pop/popitem/clear(...)``, ``del <base>[...]``, a
    rebinding of ``<base>`` to an empty container outside ``__init__``, or
    a ``.close()`` over its values in the module — the cache is bounded
    or released. (Evicted container names are indexed once per file.)"""

    def last(node: ast.AST) -> Optional[str]:
        b = dotted_name(node)
        return b.rsplit(".", 1)[-1] if b is not None else None

    def build() -> set:
        out = set()
        idx = ctx.capture_index
        for node in ctx.walk():
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute):
                if node.func.attr in _EVICTORS:
                    b = last(node.func.value)
                    if b is not None:
                        out.add(b)
            elif isinstance(node, ast.Delete):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Subscript):
                        b = last(tgt.value)
                        if b is not None:
                            out.add(b)
            elif isinstance(node, ast.Assign):
                owner = idx.parent.get(node)
                while owner is not None and not isinstance(owner,
                                                           _FUNC_TYPES):
                    owner = idx.parent.get(owner)
                if owner is None or owner.name == "__init__":
                    continue
                pairs = []
                for tgt in node.targets:
                    if isinstance(tgt, ast.Tuple) and isinstance(
                            node.value, ast.Tuple) and len(tgt.elts) == \
                            len(node.value.elts):
                        pairs += list(zip(tgt.elts, node.value.elts))
                    else:
                        pairs.append((tgt, node.value))
                for tgt, value in pairs:
                    empty = (isinstance(value, (ast.Dict, ast.List))
                             and not getattr(value, "keys", getattr(
                                 value, "elts", None))) or (
                        isinstance(value, ast.Call) and not value.args
                        and dotted_name(value.func) in _EMPTY_CTORS)
                    b = last(tgt)
                    if empty and b is not None:
                        out.add(b)
            elif isinstance(node, ast.For) and isinstance(node.iter,
                                                          ast.Call) \
                    and isinstance(node.iter.func, ast.Attribute) \
                    and node.iter.func.attr in ("values", "items"):
                closes = any(isinstance(n, ast.Call)
                             and isinstance(n.func, ast.Attribute)
                             and n.func.attr == "close"
                             for n in ast.walk(node))
                b = last(node.iter.func.value)
                if closes and b is not None:
                    out.add(b)
        return out

    evicted = ctx.rule_cache("compile_cache.evicted", build)
    return base.rsplit(".", 1)[-1] in evicted


def _in_loop(node: ast.AST, fn: ast.AST, ctx: FileContext) -> bool:
    cur = ctx.capture_index.parent.get(node)
    while cur is not None and cur is not fn:
        if isinstance(cur, _LOOPS):
            return True
        if isinstance(cur, (*_FUNC_TYPES, ast.Lambda)):
            return False
        cur = ctx.capture_index.parent.get(cur)
    return False


@register
class DynamicCompileKeyRule(Rule):
    """A program stored into a container under a traffic-dependent key —
    a parameter, ``self`` state, a loop variable, ``len(request)`` — is a
    family keyed by a runtime value: every distinct value captures a new
    CUDA graph (with a memory pool of its own), compiles a new
    ``torch.compile`` callable or opens a new ``tracked_jit`` family, so
    traffic chooses the count. Bucket the key to a bounded set (a
    bucketing call such as ``pow2_bucket(n)`` is taken as bounded), key
    by a constant, or document the bound with a suppression.
    """

    code = "JG013"
    summary = ("GraphedProgram/tracked_jit/compiled program cached under a "
               "traffic-dependent key — one capture or compile per value")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in ctx.capture_index.functions:
            cls = ctx.capture_index.enclosing_class_name(fn)
            for node, base, key in cache_inserts(fn, ctx, cls):
                if key is None or not traffic_dependent(key, fn, ctx):
                    continue
                yield self.finding(
                    ctx, node,
                    f"a program is stored in '{base}' under a "
                    f"traffic-dependent key — each distinct key value "
                    f"captures or compiles a new program; bucket the key "
                    f"to a bounded set (e.g. powers of two) or bound the "
                    f"family")


@register
class UnboundedJitCacheRule(Rule):
    """A container of programs that grows on a LOOP-REACHABLE path (the
    insert sits in a loop, or in a function the whole-program call graph
    reaches from one) with no eviction (``pop``/``popitem``/``clear``/
    ``del``, a rebinding to an empty container, or ``close()`` over its
    values) anywhere in the module keeps every program forever: each CUDA
    graph holds its private memory pool, each compiled callable its
    kernels. Bound it: evict at a cap, or close and drop the programs
    when their inputs change (as ``ContinuousLMServer._release_graphs``
    does).
    """

    code = "JG014"
    summary = ("program cache grows without eviction or close() on a "
               "loop-reachable path (every graph's memory pool retained)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for fn in ctx.capture_index.functions:
            cls = ctx.capture_index.enclosing_class_name(fn)
            for node, base, _key in cache_inserts(fn, ctx, cls):
                reachable = _in_loop(node, fn, ctx) or (
                    ctx.program is not None and ctx.module is not None
                    and ctx.program.called_from_loop(ctx.module, fn))
                if not reachable or _has_eviction(ctx, base):
                    continue
                yield self.finding(
                    ctx, node,
                    f"'{base}' accumulates programs on a loop-reachable "
                    f"path and nothing in this module evicts or closes "
                    f"them — every graph's memory pool stays resident; "
                    f"evict at a cap or key it to a bounded set")
