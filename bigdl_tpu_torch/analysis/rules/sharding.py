"""JG010–JG012 — mesh contracts: spec tuples naming axes the mesh lacks,
autograd region Functions whose backward returns the wrong number of
gradients, and collectives naming axes the enclosing topology lacks
(counterpart of ``bigdl_tpu/analysis/rules/sharding.py``).

The port's specs are the reference's ``PartitionSpec``s as tuples of
mesh-axis names (``("tensor", None)``; ``parallel/tensor_parallel.py``),
its per-rank region boundaries are ``torch.autograd.Function``s, and its
collectives are ``parallel.mesh.Mesh`` methods. The axis checks compare
against the topology at the site when it resolves statically (a
``MeshTopology(...)`` with literal sizes, its ``.build()``, a name bound
to one), and otherwise against the axes ``parallel/mesh.py`` declares at
all — precision over recall, as in the rest of graftlint.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from bigdl_tpu_torch.analysis.core import (_FUNC_TYPES, FileContext, Finding,
                                           Rule, dotted_name, register)

# parallel/mesh.py's axes (DATA_AXIS ... EXPERT_AXIS)
KNOWN_AXES = ("data", "tensor", "pipe", "seq", "expert")
# a collective over every process of the group
WORLD_AXIS = "world"
# MeshTopology's keyword -> axis name, and mesh.py's canonical order
_TOPO_PARAMS = ("data", "tensor", "pipeline", "sequence", "expert")
_TOPO_AXIS = {"data": "data", "tensor": "tensor", "pipeline": "pipe",
              "sequence": "seq", "expert": "expert"}
_TOPO_CANON = ("data", "pipeline", "expert", "sequence", "tensor")
_AXIS_CONSTANTS = {"DATA_AXIS": "data", "TENSOR_AXIS": "tensor",
                   "PIPELINE_AXIS": "pipe", "SEQUENCE_AXIS": "seq",
                   "EXPERT_AXIS": "expert"}
# Mesh collective method -> index of its axis argument
MESH_COLLECTIVES = {"all_reduce": 2, "reduce_scatter": 1, "all_gather": 1,
                    "all_to_all": 1, "shift": 1}
# region functions (tensor_parallel.py) -> (mesh index, axis index)
REGION_FUNCTIONS = {"copy_to_region": (1, 2), "reduce_from_region": (1, 2),
                    "gather_sequence": (1, 2), "scatter_sequence": (1, 2),
                    "split": (1, 2), "gather": (1, 2)}
# spec consumers -> index of their spec argument
_SPEC_CONSUMERS = {"shard_leaf": 3, "unshard_leaf": 3, "_divisible": 0}
_SPEC_KWARGS = {"spec", "specs", "base", "base_specs", "param_spec",
                "param_specs"}


def _topology_sizes(call: ast.Call) -> Optional[Dict[str, int]]:
    """``MeshTopology(data=2, ...)`` with literal int sizes -> every
    axis's size (absent axes 1)."""
    sizes: Dict[str, int] = {k: 1 for k in _TOPO_PARAMS}
    for i, arg in enumerate(call.args):
        if i >= len(_TOPO_PARAMS) or not (
                isinstance(arg, ast.Constant)
                and type(arg.value) is int):
            return None
        sizes[_TOPO_PARAMS[i]] = arg.value
    for kw in call.keywords:
        if kw.arg not in sizes or not (
                isinstance(kw.value, ast.Constant)
                and type(kw.value.value) is int):
            return None
        sizes[kw.arg] = kw.value.value
    return {_TOPO_AXIS[k]: sizes[k] for k in _TOPO_CANON}


def wide_axes(sizes: Dict[str, int]) -> Tuple[str, ...]:
    """The axes above 1 (``Mesh.shape``'s; ``("data",)`` when none is)."""
    return tuple(a for a, n in sizes.items() if n > 1) or ("data",)


class MeshResolver:
    """Static topology resolution with lexical-scope-aware name lookup:
    ``MeshTopology(...)``, ``MeshTopology(...).build()``,
    ``MeshTopology.data_parallel(n)`` (data only) and names bound to
    them."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.idx = ctx.capture_index
        self.assigns: Dict[str, List[Tuple[ast.AST, ast.expr]]] = {}
        for node in ctx.walk():
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                name = dotted_name(node.targets[0])
                if name is not None:
                    self.assigns.setdefault(name, []).append(
                        (node, node.value))

    def _scope_of(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.idx.parent.get(node)
        while cur is not None and not isinstance(cur, _FUNC_TYPES):
            cur = self.idx.parent.get(cur)
        return cur

    def sizes_of(self, expr: ast.expr, at: ast.AST,
                 depth: int = 0) -> Optional[Dict[str, int]]:
        """Every axis's size of the topology or mesh ``expr`` evaluates
        to, or None."""
        if depth > 4 or expr is None:
            return None
        if isinstance(expr, ast.Call):
            if isinstance(expr.func, ast.Attribute) \
                    and expr.func.attr == "build":
                return self.sizes_of(expr.func.value, at, depth + 1)
            callee = dotted_name(expr.func) or ""
            last = callee.rsplit(".", 1)[-1]
            if last == "MeshTopology":
                return _topology_sizes(expr)
            if last == "data_parallel" and expr.args and isinstance(
                    expr.args[0], ast.Constant) \
                    and type(expr.args[0].value) is int:
                sizes = {a: 1 for a in KNOWN_AXES}
                sizes["data"] = expr.args[0].value
                return sizes
            return None
        name = dotted_name(expr)
        if name is None:
            return None
        cands = self.assigns.get(name, [])
        scope = self._scope_of(at)
        visible = [(n, v) for n, v in cands
                   if self._scope_of(n) is scope or self._scope_of(n) is None
                   or name.startswith("self.")]
        if not visible:
            return None
        resolved = []
        for node, value in visible:
            sizes = self.sizes_of(value, node, depth + 1)
            if sizes is None:
                return None
            resolved.append(sizes)
        return resolved[0] if all(r == resolved[0] for r in resolved) \
            else None

    def topology_in(self, fn: Optional[ast.AST]) -> Optional[Dict[str, int]]:
        """The one topology resolvable in ``fn`` (its assignments), or
        None when there is none or more than one."""
        if fn is None:
            return None
        found = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                sizes = self.sizes_of(node.value, node)
                if sizes is not None and sizes not in found:
                    found.append(sizes)
        return found[0] if len(found) == 1 else None


def resolver_for(ctx: FileContext) -> MeshResolver:
    """One shared resolver per file (JG010/JG012/JG018 consume it)."""
    return ctx.rule_cache("sharding.MeshResolver", lambda: MeshResolver(ctx))


def axis_name_of(node: Optional[ast.expr], ctx: FileContext) -> Optional[str]:
    """A single axis-name expression -> string, via literals and
    (cross-module) module-level string constants."""
    if node is None:
        return None
    if isinstance(node, ast.Constant):
        return node.value if isinstance(node.value, str) else None
    if isinstance(node, ast.Name):
        if ctx.program is not None and ctx.module is not None:
            v = ctx.program.resolve_str_constant(ctx.module, node.id)
            if v is not None:
                return v
        return _AXIS_CONSTANTS.get(node.id)
    if isinstance(node, ast.Attribute):
        return _AXIS_CONSTANTS.get(node.attr)
    return None


def spec_dims(expr: ast.expr, ctx: FileContext
              ) -> Optional[List[Tuple[str, ...]]]:
    """A spec literal (``("tensor", None)``, ``(None, ("data",
    "tensor"))``) -> each dim's axis names; None when ``expr`` is not a
    literal spec naming at least one axis."""
    if not isinstance(expr, ast.Tuple) or not expr.elts:
        return None
    dims: List[Tuple[str, ...]] = []
    named = False
    for elt in expr.elts:
        if isinstance(elt, ast.Constant) and elt.value is None:
            dims.append(())
            continue
        parts = elt.elts if isinstance(elt, ast.Tuple) else [elt]
        axes = []
        for p in parts:
            a = axis_name_of(p, ctx)
            if a is None:
                return None
            axes.append(a)
        named = True
        dims.append(tuple(axes))
    return dims if named else None


def enclosing_fn(ctx: FileContext, node: ast.AST) -> Optional[ast.AST]:
    cur = ctx.capture_index.parent.get(node)
    while cur is not None and not isinstance(cur, _FUNC_TYPES):
        cur = ctx.capture_index.parent.get(cur)
    return cur


def spec_sites(ctx: FileContext) -> Iterator[Tuple[ast.Tuple, ast.AST]]:
    """(spec literal, anchor) for every spec in a spec position: the spec
    argument of ``shard_leaf``/``unshard_leaf``/``_divisible``, a
    ``spec=``-style keyword, a store into a ``*spec*`` container, a
    ``*spec*`` dict literal's values, or a return of a ``*spec*``
    function."""
    for node in ctx.walk():
        cands: List[ast.expr] = []
        if isinstance(node, ast.Call):
            last = (dotted_name(node.func) or "").rsplit(".", 1)[-1]
            pos = _SPEC_CONSUMERS.get(last)
            if pos is not None and len(node.args) > pos:
                cands.append(node.args[pos])
            cands += [kw.value for kw in node.keywords
                      if kw.arg in _SPEC_KWARGS]
        elif isinstance(node, ast.Assign):
            for tgt in node.targets:
                base = dotted_name(tgt.value) if isinstance(
                    tgt, ast.Subscript) else dotted_name(tgt)
                if base is not None and "spec" in base.lower():
                    if isinstance(node.value, ast.Dict):
                        cands += list(node.value.values)
                    else:
                        cands.append(node.value)
        elif isinstance(node, ast.Return) and node.value is not None:
            fn = enclosing_fn(ctx, node)
            if fn is not None and "spec" in fn.name.lower():
                cands.append(node.value)
        for c in cands:
            if isinstance(c, ast.Tuple) and spec_dims(c, ctx) is not None:
                yield c, node


@register
class PspecMeshAxesRule(Rule):
    """A spec tuple naming an axis that is no axis of ``parallel/mesh.py``
    (a typo: ``("tensr", None)``) raises deep inside sharding, and one
    naming an axis the topology at the site does not have (size 1) is
    silently never sharded: every rank keeps the whole leaf. When the
    site's ``MeshTopology`` resolves statically the spec is held to it;
    otherwise to mesh.py's five axes.
    """

    code = "JG010"
    summary = ("spec tuple names an axis the MeshTopology at the site "
               "lacks, or no axis of parallel/mesh.py")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        resolver = resolver_for(ctx)
        seen: Set[int] = set()
        for spec, anchor in spec_sites(ctx):
            if id(spec) in seen:
                continue
            seen.add(id(spec))
            sizes = resolver.topology_in(enclosing_fn(ctx, anchor))
            for axes in spec_dims(spec, ctx):
                for axis in axes:
                    if axis not in KNOWN_AXES:
                        yield self.finding(
                            ctx, spec,
                            f"spec axis '{axis}' is no axis of "
                            f"parallel/mesh.py ({', '.join(KNOWN_AXES)})")
                    elif sizes is not None and sizes.get(axis, 1) <= 1:
                        yield self.finding(
                            ctx, spec,
                            f"spec axis '{axis}' is not an axis of the "
                            f"topology here (axes: "
                            f"{', '.join(wide_axes(sizes))}) — the leaf is "
                            f"never sharded over it")


def _is_autograd_function(cls: ast.ClassDef) -> bool:
    for base in cls.bases:
        name = dotted_name(base) or ""
        if name in ("torch.autograd.Function", "autograd.Function",
                    "Function"):
            return True
    return False


def _returns(fn: ast.AST) -> Iterator[ast.Return]:
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, (*_FUNC_TYPES, ast.Lambda, ast.ClassDef)):
            continue
        if isinstance(node, ast.Return):
            yield node
        stack.extend(ast.iter_child_nodes(node))


@register
class ShardMapAritySpecRule(Rule):
    """The port's per-rank region boundaries are
    ``torch.autograd.Function``s: ``backward`` must return one gradient
    (or ``None``) per input ``forward`` took. Fewer raises "returned an
    incorrect number of gradients" on the first backward — far from the
    definition, and only on the path that differentiates through the
    region; more is accepted only when the extras are ``None``. Checked
    when ``backward`` returns a literal tuple (or a single value), against
    each ``apply(...)`` call of the class in the module, and otherwise
    against ``forward``'s signature.
    """

    code = "JG011"
    summary = ("autograd region Function: backward returns a different "
               "number of gradients than forward takes inputs")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        applies: Dict[str, List[ast.Call]] = {}
        for node in ctx.walk():
            if isinstance(node, ast.Call) and isinstance(node.func,
                                                         ast.Attribute) \
                    and node.func.attr == "apply" \
                    and isinstance(node.func.value, ast.Name):
                applies.setdefault(node.func.value.id, []).append(node)
        for cls in ctx.walk():
            if not isinstance(cls, ast.ClassDef) \
                    or not _is_autograd_function(cls):
                continue
            methods = {m.name: m for m in cls.body
                       if isinstance(m, _FUNC_TYPES)}
            fwd, bwd = methods.get("forward"), methods.get("backward")
            if fwd is None or bwd is None or fwd.args.vararg is not None:
                continue
            params = len(getattr(fwd.args, "posonlyargs", [])) + \
                len(fwd.args.args) - 1          # minus ctx
            required = params - len(fwd.args.defaults)
            sites = [c for c in applies.get(cls.name, ())
                     if not any(isinstance(a, ast.Starred) for a in c.args)]
            for ret in _returns(bwd):
                got = self._count(ret)
                if got is None:
                    continue
                n_ret, extras_none = got
                if sites:
                    bad = [len(c.args) for c in sites
                           if self._wrong(n_ret, extras_none, len(c.args),
                                          len(c.args))]
                else:
                    bad = [params] if self._wrong(n_ret, extras_none,
                                                  required, params) else []
                if bad:
                    yield self.finding(
                        ctx, ret,
                        f"'{cls.name}.backward' returns {n_ret} "
                        f"gradient(s) but forward takes {bad[0]} input(s) "
                        f"— autograd raises on the first backward through "
                        f"this region")

    @staticmethod
    def _count(ret: ast.Return):
        v = ret.value
        if v is None:
            return 1, lambda n: False
        if isinstance(v, ast.Tuple):
            if any(isinstance(e, ast.Starred) for e in v.elts):
                return None
            elts = v.elts

            def extras_none(n, elts=elts):
                return all(isinstance(e, ast.Constant) and e.value is None
                           for e in elts[n:])
            return len(elts), extras_none
        return 1, lambda n: False

    @staticmethod
    def _wrong(n_ret: int, extras_none, low: int, high: int) -> bool:
        if n_ret < low:
            return True
        return n_ret > high and not extras_none(high)


def collective_sites(ctx: FileContext
                     ) -> Iterator[Tuple[ast.Call, str, Optional[ast.expr],
                                         Optional[ast.expr]]]:
    """(call, op, mesh expr, axis expr) for every ``Mesh`` collective
    (a receiver named ``*mesh``) and region-function call."""
    for node in ctx.walk():
        if not isinstance(node, ast.Call):
            continue
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in MESH_COLLECTIVES:
            recv = dotted_name(node.func.value) or ""
            if not recv.rsplit(".", 1)[-1].lower().endswith("mesh"):
                continue
            pos = MESH_COLLECTIVES[node.func.attr]
            axis = node.args[pos] if len(node.args) > pos else next(
                (kw.value for kw in node.keywords if kw.arg == "axis"),
                None)
            yield node, node.func.attr, node.func.value, axis
            continue
        last = (dotted_name(node.func) or "").rsplit(".", 1)[-1]
        if last in REGION_FUNCTIONS:
            mpos, apos = REGION_FUNCTIONS[last]
            mesh = node.args[mpos] if len(node.args) > mpos else next(
                (kw.value for kw in node.keywords if kw.arg == "mesh"), None)
            mname = dotted_name(mesh) if mesh is not None else None
            if mname is None or not mname.lower().endswith("mesh"):
                continue
            axis = node.args[apos] if len(node.args) > apos else next(
                (kw.value for kw in node.keywords if kw.arg == "axis"),
                None)
            yield node, last, mesh, axis


@register
class CollectiveAxisRule(Rule):
    """A ``Mesh`` collective (``all_reduce``, ``reduce_scatter``,
    ``all_gather``, ``all_to_all``, ``shift``) or a region function
    (``copy_to_region``, ``gather_sequence``, ...) naming an axis the
    enclosing topology does not have is silently the identity — the sum
    over the axis never happens and every rank trains on its own
    gradients — and one naming no axis of ``parallel/mesh.py`` raises a
    ``KeyError`` only when that path runs. Checked when the axis is a
    literal or a module-level constant (``TENSOR_AXIS``), against the
    topology when it resolves statically.
    """

    code = "JG012"
    summary = ("Mesh collective or region function names an axis absent "
               "from the enclosing topology (a silent no-op)")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        resolver = resolver_for(ctx)
        for call, op, mesh, axis_expr in collective_sites(ctx):
            axis = axis_name_of(axis_expr, ctx) if axis_expr is not None \
                else None
            if axis_expr is None and op in MESH_COLLECTIVES:
                axis = "data"                   # the methods' default
            if axis is None or axis == WORLD_AXIS:
                continue
            if axis not in KNOWN_AXES:
                yield self.finding(
                    ctx, call,
                    f"{op}(..., '{axis}') names no axis of "
                    f"parallel/mesh.py ({', '.join(KNOWN_AXES)}) — a "
                    f"KeyError when this path runs")
                continue
            sizes = resolver.sizes_of(mesh, call)
            if sizes is not None and sizes.get(axis, 1) <= 1:
                yield self.finding(
                    ctx, call,
                    f"{op}(..., '{axis}') names an axis the topology here "
                    f"does not have (axes: {', '.join(wide_axes(sizes))}) "
                    f"— the collective is silently the identity")
