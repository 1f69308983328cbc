"""JG018–JG020 — shape-aware rules powered by the abstract interpreter
(counterpart of ``bigdl_tpu/analysis/rules/shapeaware.py``):

- **JG018** — a spec or a region sharding a statically known dim that the
  axis size cannot divide. ``tensor_parallel._divisible`` is the run-time
  twin: a leaf it refuses stays replicated, a region ``split`` raises.
- **JG019** — a runtime-derived length (``len()`` of request data and
  arithmetic over it) reaching a program's key: a ``tracked_jit``
  signature through a tensor's SHAPE (the recorder keys Python scalars by
  type, so only shapes split its family), or the key of a container of
  programs. Bucketing (an unmodeled call such as ``pow2_bucket``, or
  ``%`` by a constant) launders the value.
- **JG020** — JG007 across ``self`` and modules (a ``GraphedProgram``
  held on ``self`` or built by a helper anywhere in the program), and a
  tensor a program's ``inputs=`` names rebound rather than ``copy_``'d
  into, which ``GraphedProgram.replay``'s ``data_ptr`` check refuses at
  run time.

All three inherit the precision-over-recall stance: unresolvable
topologies, shapes and callees are skipped, never guessed.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from bigdl_tpu_torch.analysis.core import (_FUNC_TYPES, CAPTURE_WRAPPERS,
                                           FAMILY_WRAPPERS, FileContext,
                                           Finding, Rule, dotted_name,
                                           register)
from bigdl_tpu_torch.analysis.rules.compile_cache import cache_inserts
from bigdl_tpu_torch.analysis.rules.donation import (ReplayAliasWalker,
                                                     local_programs)
from bigdl_tpu_torch.analysis.rules.sharding import (MESH_COLLECTIVES,
                                                     axis_name_of,
                                                     collective_sites,
                                                     enclosing_fn,
                                                     resolver_for, spec_dims)
from bigdl_tpu_torch.analysis.shapes import DYN, Scalar, shape_env


def _in_loop(ctx: FileContext, node: ast.AST) -> bool:
    """Is ``node`` lexically inside a loop (stopping at the enclosing
    function boundary)?"""
    cur = ctx.capture_index.parent.get(node)
    while cur is not None and not isinstance(cur, _FUNC_TYPES):
        if isinstance(cur, (ast.For, ast.While)):
            return True
        cur = ctx.capture_index.parent.get(cur)
    return False


def _loop_reachable(ctx: FileContext, call: ast.AST) -> bool:
    if _in_loop(ctx, call):
        return True
    fn = enclosing_fn(ctx, call)
    if fn is None or ctx.program is None or ctx.module is None:
        return False
    return ctx.program.called_from_loop(ctx.module, fn)


def _int(node: Optional[ast.expr]) -> Optional[int]:
    if isinstance(node, ast.Constant) and type(node.value) is int:
        return node.value
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _int(node.operand)
        return -v if v is not None else None
    return None


# ---------------------------------------------------------------------------
# JG018 — sharded-dim divisibility
# ---------------------------------------------------------------------------

@register
class ShardDivisibilityRule(Rule):
    """A leaf or an activation sharded over an axis whose size does not
    divide the dim: ``shard_leaf`` under a spec cuts ``dim // n`` rows
    and silently drops the remainder, ``tensor_parallel._divisible``
    keeps such a leaf replicated (its axis never used), and a region
    ``split`` / ``scatter_sequence`` or a ``Mesh.reduce_scatter`` /
    ``all_to_all`` along it raises or mis-slices on the first step. When
    the dim and the axis size both resolve statically the check is a
    lint-time error instead. Dims derived from runtime data, and
    unresolvable topologies, are skipped.
    """

    code = "JG018"
    summary = ("spec or region shards a statically known dim the axis "
               "size cannot evenly divide")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        resolver = resolver_for(ctx)
        for call in ctx.walk():
            if not isinstance(call, ast.Call):
                continue
            last = (dotted_name(call.func) or "").rsplit(".", 1)[-1]
            if last == "shard_leaf" and len(call.args) >= 5:
                yield from self._shard_leaf(ctx, call)
        for call, op, mesh, axis_expr in collective_sites(ctx):
            dim = self._dim_of(call, op)
            if dim is None:
                continue
            axis = axis_name_of(axis_expr, ctx) if axis_expr is not None \
                else ("data" if op in MESH_COLLECTIVES else None)
            sizes = resolver.sizes_of(mesh, call)
            fn = enclosing_fn(ctx, call)
            if axis is None or sizes is None or fn is None:
                continue
            shape = shape_env(ctx, fn).shape_of(call.args[0])
            n = sizes.get(axis, 1)
            if shape is None or n <= 1 or not -len(shape) <= dim < len(
                    shape):
                continue
            d = shape[dim]
            if isinstance(d, int) and d % n:
                yield self.finding(
                    ctx, call,
                    f"{op} cuts dim {dim} ({d}) over axis '{axis}' of "
                    f"size {n}, which does not divide it")

    @staticmethod
    def _dim_of(call: ast.Call, op: str) -> Optional[int]:
        """The dim a collective or region cuts, when literal."""
        kws = {kw.arg: kw.value for kw in call.keywords}
        if op in ("split", "scatter_sequence"):
            return _int(call.args[3] if len(call.args) > 3
                        else kws.get("dim", ast.Constant(1)))
        if op == "reduce_scatter":
            return _int(call.args[2] if len(call.args) > 2
                        else kws.get("dim"))
        if op == "all_to_all":
            return _int(call.args[2] if len(call.args) > 2
                        else kws.get("split_dim"))
        return None

    def _shard_leaf(self, ctx: FileContext, call: ast.Call
                    ) -> Iterator[Finding]:
        dims = spec_dims(call.args[3], ctx)
        n = _int(call.args[4])
        fn = enclosing_fn(ctx, call)
        if dims is None or n is None or n <= 1 or fn is None:
            return
        shape = shape_env(ctx, fn).shape_of(call.args[2])
        if shape is None:
            return
        for d, axes in enumerate(dims):
            if not axes or d >= len(shape):
                continue
            size = shape[d]
            if isinstance(size, int) and size % n:
                yield self.finding(
                    ctx, call,
                    f"dim {d} of this leaf is {size}, which axis "
                    f"'{'x'.join(axes)}' of size {n} cannot evenly divide "
                    f"— the slice drops {size % n} row(s)")
            break   # shard_leaf cuts the first named dim only


# ---------------------------------------------------------------------------
# JG019 — runtime length reaching a program's key
# ---------------------------------------------------------------------------

def _family_callables(ctx: FileContext) -> Set[str]:
    """Dotted names bound to a ``tracked_jit(...)`` (``step =
    tracked_jit(...)``, ``self._fwd = tracked_jit(...)``)."""
    out: Set[str] = set()
    for node in ctx.walk():
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call) \
                and dotted_name(node.value.func) in FAMILY_WRAPPERS:
            for tgt in node.targets:
                name = dotted_name(tgt)
                if name is not None:
                    out.add(name)
    return out


@register
class DynamicJitKeyRule(Rule):
    """A program family is keyed by what its calls look like: a
    ``tracked_jit`` by its tensor arguments' SHAPES (it keys Python
    scalars by type), a dict of ``GraphedProgram``s by its key. A length
    derived from runtime data (``len()`` of a request, a queue, a prompt)
    reaching either one builds a new program per distinct value — one
    "compile" recorded, or one capture with its own memory pool. Only
    loop-reachable call sites fire (a one-shot call cannot storm);
    bucketing launders the value (``pow2_bucket(n)``, ``n % CHUNK``).
    """

    code = "JG019"
    summary = ("runtime-derived (len-of-data) length reaches a tracked_jit "
               "signature through a shape, or a capture key")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        families = ctx.rule_cache("shapeaware.families",
                                  lambda: _family_callables(ctx))
        for call in ctx.walk():
            if not isinstance(call, ast.Call):
                continue
            cname = dotted_name(call.func)
            if cname is None or cname not in families:
                continue
            fn = enclosing_fn(ctx, call)
            if fn is None or not _loop_reachable(ctx, call):
                continue
            env = shape_env(ctx, fn)
            for arg in list(call.args) + [kw.value for kw in call.keywords]:
                shape = env.shape_of(arg)
                if shape is not None and DYN in shape:
                    yield self.finding(
                        ctx, call,
                        f"a tensor whose shape carries a runtime-derived "
                        f"length reaches '{cname}' (tracked_jit) — its "
                        f"family is keyed by shapes, so every distinct "
                        f"length records a new program; pad to a bucket "
                        f"first")
                    break
        for fn in ctx.capture_index.functions:
            cls = ctx.capture_index.enclosing_class_name(fn)
            for node, base, key in cache_inserts(fn, ctx, cls):
                if key is None:
                    continue
                v = shape_env(ctx, fn).eval(key)
                if isinstance(v, Scalar) and v.value is DYN:
                    yield self.finding(
                        ctx, node,
                        f"a runtime-derived length keys the programs in "
                        f"'{base}' — one capture or compile per distinct "
                        f"length; bucket it first")


# ---------------------------------------------------------------------------
# JG020 — graph outputs across self and modules; rebound inputs
# ---------------------------------------------------------------------------

def _self_programs(ctx: FileContext, cls_node: ast.ClassDef) -> Set[str]:
    """``self.X`` attributes of ``cls_node`` holding a GraphedProgram:
    assigned a direct ``GraphedProgram(...)`` or the result of a
    (cross-module) builder whose summary returns one."""
    out: Set[str] = set()
    for node in ast.walk(cls_node):
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.value, ast.Call)):
            continue
        tname = dotted_name(node.targets[0])
        if tname is None or not tname.startswith("self."):
            continue
        callee = dotted_name(node.value.func) or ""
        if callee in CAPTURE_WRAPPERS:
            out.add(tname)
        elif ctx.program is not None and ctx.module is not None:
            resolved = ctx.program.summary_for_call(ctx.module, callee,
                                                    cls_node.name)
            if resolved is not None and resolved[1].returns_graph:
                out.add(tname)
    return out


def _builder_programs(ctx: FileContext, fn: ast.AST) -> Set[str]:
    """Local names in ``fn`` bound from calls of builders returning a
    GraphedProgram (the cross-module form JG007 cannot see)."""
    out: Set[str] = set()
    if ctx.program is None or ctx.module is None:
        return out
    cls = ctx.capture_index.enclosing_class_name(fn)
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Assign)
                and isinstance(node.value, ast.Call)):
            continue
        callee = dotted_name(node.value.func) or ""
        if callee in CAPTURE_WRAPPERS:
            continue
        resolved = ctx.program.summary_for_call(ctx.module, callee, cls)
        if resolved is None or not resolved[1].returns_graph:
            continue
        for tgt in node.targets:
            if isinstance(tgt, ast.Name):
                out.add(tgt.id)
    return out


def _input_refs(ctx: FileContext, call: ast.Call) -> Set[str]:
    """Dotted names of the tensors a ``GraphedProgram``'s ``inputs=``
    returns (a lambda's list, or a same-class method's returned list)."""
    expr = next((kw.value for kw in call.keywords if kw.arg == "inputs"),
                None)
    if expr is None:
        return set()
    bodies: List[ast.expr] = []
    if isinstance(expr, ast.Lambda):
        bodies.append(expr.body)
    elif isinstance(expr, ast.Attribute) and isinstance(expr.value,
                                                        ast.Name) \
            and expr.value.id == "self":
        method = ctx.capture_index.resolve_method(expr.attr, call)
        if method is not None:
            for node in ast.walk(method):
                if isinstance(node, ast.Return) and node.value is not None:
                    bodies.append(node.value)
    out: Set[str] = set()
    for body in bodies:
        elts = body.elts if isinstance(body, (ast.List, ast.Tuple)) \
            else [body]
        for e in elts:
            name = dotted_name(e)
            if name is not None:
                out.add(name)
    return out


@register
class InterprocDonationRule(Rule):
    """JG007 across ``self`` and modules: a ``GraphedProgram`` held on
    ``self`` (or returned by a builder anywhere in the program) returns
    its static outputs, which the next replay overwrites. And the tensors
    its ``inputs=`` names must stay at their addresses: rebinding one
    (``self.buf = torch.zeros(...)``, ``x = new``) rather than copying
    into it (``self.buf.copy_(new)``) leaves the graph reading the old
    memory — ``GraphedProgram.replay`` then raises its ``data_ptr``
    error. Copy into the captured tensor, or close and recapture.
    """

    code = "JG020"
    summary = ("a held/built GraphedProgram's output read after its next "
               "replay, or a tensor its inputs= names rebound")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        if not self._may_hold_graph(ctx):
            return
        findings: List[Finding] = []

        def report(node: ast.Name) -> None:
            findings.append(self.finding(
                ctx, node,
                f"'{node.id}' holds a graph output (of a GraphedProgram "
                f"held on self or built elsewhere) that a later replay "
                f"overwrote — read it first or .clone() it"))

        class_programs: Dict[ast.AST, Set[str]] = {}
        for node in ctx.walk():
            if isinstance(node, ast.ClassDef):
                progs = _self_programs(ctx, node)
                if progs:
                    class_programs[node] = progs
        for fn in ctx.capture_index.functions:
            progs = set(_builder_programs(ctx, fn)) - local_programs(fn)
            cur = ctx.capture_index.parent.get(fn)
            while cur is not None:
                if isinstance(cur, ast.ClassDef):
                    progs |= class_programs.get(cur, set())
                    break
                cur = ctx.capture_index.parent.get(cur)
            if progs:
                ReplayAliasWalker(progs, report).walk(fn.body, {}, set())
        yield from findings
        yield from self._rebound_inputs(ctx)

    @staticmethod
    def _may_hold_graph(ctx: FileContext) -> bool:
        names = {"GraphedProgram"}
        if ctx.program is not None:
            names |= {key[1].rsplit(".", 1)[-1]
                      for key, s in ctx.program.summaries.items()
                      if s.returns_graph}
        return ctx.mentions(*names)

    def _rebound_inputs(self, ctx: FileContext) -> Iterator[Finding]:
        idx = ctx.capture_index
        for call in ctx.walk():
            if not (isinstance(call, ast.Call)
                    and dotted_name(call.func) in CAPTURE_WRAPPERS):
                continue
            refs = _input_refs(ctx, call)
            if not refs:
                continue
            fn = enclosing_fn(ctx, call)
            cls = None
            cur = idx.parent.get(call)
            while cur is not None:
                if isinstance(cur, ast.ClassDef):
                    cls = cur
                    break
                cur = idx.parent.get(cur)
            scopes: List[Tuple[ast.AST, int]] = []
            if fn is not None:
                scopes.append((fn, call.lineno))
            if cls is not None:
                scopes += [(m, 0) for m in cls.body
                           if isinstance(m, _FUNC_TYPES) and m is not fn
                           and m.name != "__init__"]
            for scope, after in scopes:
                for node in ast.walk(scope):
                    if not isinstance(node, (ast.Assign, ast.AugAssign)) \
                            or node.lineno <= after:
                        continue
                    targets = node.targets if isinstance(node, ast.Assign) \
                        else [node.target]
                    for tgt in targets:
                        elts = tgt.elts if isinstance(tgt, ast.Tuple) \
                            else [tgt]
                        for e in elts:
                            name = dotted_name(e)
                            local = name is not None and "." not in name \
                                and scope is fn
                            if name in refs and (local or name.startswith(
                                    "self.")):
                                yield self.finding(
                                    ctx, node,
                                    f"'{name}' is read by a CUDA graph "
                                    f"(inputs= at line {call.lineno}) and "
                                    f"is rebound here: the graph keeps "
                                    f"reading the old memory and the next "
                                    f"replay raises its data_ptr error; "
                                    f"copy_ into it instead")
