"""graftlint core for the port (counterpart of
``bigdl_tpu/analysis/core.py``): rule registry, capture index, taint
engine, suppressions, the lint drivers and the reporters.

The reference's graftlint flags the JAX hazards that surface only as a
slow or wrong run. The port has the same families in PyTorch's form: a
CUDA graph captures one pass of an eager body and replays it, so a host
read inside the body cannot be captured, a Python side effect runs at
capture and never at replay, a generator the graph does not know of gives
the same numbers at every replay, and a rebound input is caught only at
run time. The analyser walks every module's AST and never imports what it
checks (pure ``ast`` + ``tokenize``; it imports neither ``torch`` nor
anything of the reference).

Three layers live here:

- **CaptureIndex** — which function defs run under a CUDA-graph capture.
  *Seeds* are the bodies a capture records: the first argument of
  ``GraphedProgram(...)`` (``utils/cuda_graph.py``), the callables given
  to ``torch.cuda.make_graphed_callables`` and ``torch.compile`` targets
  (decorator or call), resolved with lexical visibility (``self.m``
  resolves to a method of the enclosing class). The statements of a
  ``with torch.cuda.graph(...)`` block are a capture block. The
  *captured* set is the closure of the seeds under nesting and
  same-module ``Name`` calls (a helper called from a captured body runs
  under the capture too, but its parameters are not assumed tensors).
  The second set is the compile family: the callables handed to
  ``tracked_jit(...)`` (``telemetry/profiling.py``), closed the same way.
- **Taint engine** (``iter_trace_events``) — an order-sensitive walk that
  tracks which names hold tensors: ``torch.*`` / ``F.*`` results and
  tensor methods are tensors; ``.shape``/``.dtype``/``.device``,
  ``.size()``/``.numel()`` and ``len()`` are static values; host reads
  (``float/int/bool(t)``, ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``np.asarray(t)``) and device-wide waits
  (``torch.cuda.synchronize()``, ``Event/Stream.synchronize()``) are
  events. The enclosing functions of a captured body are walked too
  (silently), so a body closing over a tensor sees it as one. Rules
  consume the events raised inside captured code (host reads, branches
  on tensors).
- **Suppressions** — ``# graftlint: ignore[JG001] -- reason``. The
  reason is mandatory: a bare ignore does not suppress and is itself
  reported (JG000, unsuppressable); a suppression that matches nothing
  is reported too.

``lint_paths`` builds a :class:`~bigdl_tpu_torch.analysis.program.ProgramIndex`
over every linted file: captured reach, host-read summaries and
generator-stream facts propagate through helper calls across modules.
See ``bigdl_tpu_torch/analysis/README.md`` for the rule table.
"""

from __future__ import annotations

import ast
import io
import json
import os
import re
import tokenize
from dataclasses import dataclass, field
from typing import (Dict, Iterable, Iterator, List, Optional, Sequence, Set,
                    Tuple)

# --------------------------------------------------------------------------
# Findings and rules
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One diagnostic: ``path:line:col: CODE message``. ``end_line`` is
    the last physical line of the flagged construct — a suppression
    anywhere in [line, end_line] applies (flake8-noqa style trailing
    comments on multi-line statements)."""

    code: str
    message: str
    path: str
    line: int
    col: int = 0
    end_line: int = 0

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"


class Rule:
    """Base class for graftlint rules.

    Subclasses set ``code`` (``JG0xx``) and ``summary`` (one line, used
    in reports and the rule table) and implement ``check(ctx)`` yielding
    :class:`Finding`. The class docstring is the rule's rationale (the
    SARIF report's full description), so write it for users.
    """

    code: str = ""
    summary: str = ""

    def check(self, ctx: "FileContext") -> Iterator[Finding]:
        raise NotImplementedError

    def finding(self, ctx: "FileContext", node: ast.AST,
                message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(self.code, message, ctx.path, line,
                       getattr(node, "col_offset", 0),
                       getattr(node, "end_lineno", line) or line)


RULES: Dict[str, Rule] = {}


def register(cls):
    """Class decorator adding a rule instance to the global registry."""
    if not cls.code or not cls.code.startswith("JG"):
        raise ValueError(f"rule {cls.__name__} needs a JGxxx code")
    if cls.code in RULES:
        raise ValueError(f"duplicate rule code {cls.code}")
    RULES[cls.code] = cls()
    return cls


def all_rules() -> List[Rule]:
    """Registered rules, sorted by code (imports the rule package)."""
    import bigdl_tpu_torch.analysis.rules  # noqa: F401  (registration)
    return [RULES[c] for c in sorted(RULES)]


# --------------------------------------------------------------------------
# Suppressions
# --------------------------------------------------------------------------

SUPPRESS_RE = re.compile(
    r"#\s*graftlint:\s*ignore\[([A-Za-z0-9,\s]+)\]\s*(?:--\s*(\S.*))?")


@dataclass
class Suppression:
    line: int
    codes: Tuple[str, ...]
    reason: Optional[str]
    used: bool = False  # matched at least one finding this run


def _scan_suppressions(source: str) -> Tuple[Dict[int, List[Suppression]],
                                             Set[int]]:
    """Map line -> suppressions, plus the set of comment-only lines."""
    by_line: Dict[int, List[Suppression]] = {}
    comment_only: Set[int] = set()
    comment_lines: Set[int] = set()
    line_has_code: Dict[int, bool] = {}
    if "graftlint" not in source:
        return by_line, comment_only   # no suppression to find
    try:
        toks = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, SyntaxError, IndentationError):
        return by_line, comment_only
    for tok in toks:
        line = tok.start[0]
        if tok.type == tokenize.COMMENT:
            comment_lines.add(line)
            m = SUPPRESS_RE.search(tok.string)
            if m:
                codes = tuple(c.strip().upper() for c in m.group(1).split(",")
                              if c.strip())
                reason = m.group(2)
                by_line.setdefault(line, []).append(Suppression(
                    line, codes, reason.strip() if reason else None))
        elif tok.type not in (tokenize.NL, tokenize.NEWLINE, tokenize.INDENT,
                              tokenize.DEDENT, tokenize.ENCODING,
                              tokenize.ENDMARKER):
            for ln in range(tok.start[0], tok.end[0] + 1):
                line_has_code[ln] = True
    # EVERY comment-only line (suppression or not) is climbable, so an
    # ignore can sit above further explanatory comment lines
    for line in comment_lines:
        if not line_has_code.get(line):
            comment_only.add(line)
    return by_line, comment_only


# --------------------------------------------------------------------------
# Capture index
# --------------------------------------------------------------------------

# dotted callables whose first argument is a body captured into a CUDA
# graph and replayed (utils/cuda_graph.py); the body takes no arguments
CAPTURE_WRAPPERS = {
    "GraphedProgram", "cuda_graph.GraphedProgram",
    "bigdl_tpu_torch.utils.cuda_graph.GraphedProgram",
}
# callables whose callable arguments run captured with tensor parameters
GRAPHED_CALLABLES = {"torch.cuda.make_graphed_callables",
                     "cuda.make_graphed_callables",
                     "make_graphed_callables"}
COMPILE_WRAPPERS = {"torch.compile"}
# context managers whose block is recorded into a CUDA graph
GRAPH_CONTEXTS = {"torch.cuda.graph", "cuda.graph"}
# the compile flight recorder: a signature-keyed family of "compiles"
FAMILY_WRAPPERS = {"tracked_jit", "profiling.tracked_jit",
                   "bigdl_tpu_torch.telemetry.profiling.tracked_jit"}
# every call that builds a program (a capture, a compile or a family):
# one per loop iteration is a capture or a compile per iteration
PROGRAM_BUILDERS = (CAPTURE_WRAPPERS | GRAPHED_CALLABLES | COMPILE_WRAPPERS
                    | FAMILY_WRAPPERS | {"torch.cuda.CUDAGraph",
                                         "cuda.CUDAGraph", "CUDAGraph"})
# builders whose result is a callable program cached by the caller
WRAPPER_BUILDERS = CAPTURE_WRAPPERS | COMPILE_WRAPPERS | FAMILY_WRAPPERS


def dotted_name(node: ast.AST) -> Optional[str]:
    """``torch.cuda.graph`` for Name-rooted Attribute chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _unwrap_partial(call: ast.Call) -> Optional[str]:
    """``functools.partial(torch.compile, ...)`` -> ``"torch.compile"``."""
    fn = dotted_name(call.func)
    if fn in ("functools.partial", "partial") and call.args:
        return dotted_name(call.args[0])
    return None


_FUNC_TYPES = (ast.FunctionDef, ast.AsyncFunctionDef)
FuncNode = ast.FunctionDef

# shared mutable-default detection (JG008): a default built by a ctor call
# is created once and shared regardless of whether the call takes
# arguments — dict(momentum=0.9) is as shared as {}
MUTABLE_LITERALS = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp,
                    ast.SetComp)
MUTABLE_CTORS = {"list", "dict", "set", "bytearray", "defaultdict",
                 "OrderedDict", "collections.defaultdict",
                 "collections.OrderedDict", "collections.deque", "deque"}


def is_mutable_default(node: ast.AST) -> bool:
    """True when a parameter default expression is a shared mutable
    object (literal or ctor call)."""
    if isinstance(node, MUTABLE_LITERALS):
        return True
    if isinstance(node, ast.Call):
        return dotted_name(node.func) in MUTABLE_CTORS
    return False


def _positional_params(fn: ast.AST) -> List[str]:
    a = fn.args
    return [p.arg for p in list(getattr(a, "posonlyargs", [])) + list(a.args)]


def _all_params(fn: ast.AST) -> List[str]:
    a = fn.args
    names = [p.arg for p in list(getattr(a, "posonlyargs", []))
             + list(a.args) + list(a.kwonlyargs)]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def _is_graph_context(item: ast.withitem) -> bool:
    expr = item.context_expr
    return isinstance(expr, ast.Call) and dotted_name(expr.func) in \
        GRAPH_CONTEXTS


class CaptureIndex:
    """Which function defs in a module run under a CUDA-graph capture.

    ``seeds`` are capture entry points whose parameters are tensors
    (``make_graphed_callables`` and ``torch.compile`` targets; a
    ``GraphedProgram`` body takes none); ``captured`` additionally holds
    every function reachable from a seed by lexical nesting or
    same-module ``Name`` calls, and from a ``with torch.cuda.graph(...)``
    block (``capture_blocks``). ``families`` is the same closure from the
    callables handed to ``tracked_jit``.
    """

    def __init__(self, tree: ast.Module):
        self.tree = tree
        self.seeds: Set[ast.AST] = set()
        self.captured: Set[ast.AST] = set()
        self.families: Set[ast.AST] = set()
        self.capture_blocks: Set[ast.With] = set()
        self.parent: Dict[ast.AST, Optional[ast.AST]] = {}
        self.functions: List[FuncNode] = []
        self._by_name: Dict[str, List[FuncNode]] = {}
        self._index(tree)
        self._seed(tree)
        self._propagate(self.captured, extra_roots=self.capture_blocks)
        self._propagate(self.families)

    def add_extern_captured(self, fn_nodes: Iterable[ast.AST]) -> None:
        """Mark functions captured from ANOTHER module's body (whole-
        program propagation) and re-close the local captured set. Extern
        functions are never seeds: their parameters are not assumed
        tensors."""
        added = False
        for fn in fn_nodes:
            if fn not in self.captured:
                self.captured.add(fn)
                added = True
        if added:
            self._propagate(self.captured)

    # -- construction ------------------------------------------------------
    def _index(self, tree: ast.Module) -> None:
        for node in ast.walk(tree):
            for child in ast.iter_child_nodes(node):
                self.parent[child] = node
        for node in ast.walk(tree):
            if isinstance(node, _FUNC_TYPES):
                self.functions.append(node)
                self._by_name.setdefault(node.name, []).append(node)

    def _seed(self, tree: ast.Module) -> None:
        # decorator forms: @torch.compile, @torch.compile(...)
        for fn in self.functions:
            for dec in fn.decorator_list:
                name = dotted_name(dec)
                if isinstance(dec, ast.Call):
                    name = dotted_name(dec.func) or _unwrap_partial(dec)
                if name in COMPILE_WRAPPERS:
                    self._add_seed(fn)
        for node in ast.walk(tree):
            if isinstance(node, ast.With) and any(
                    _is_graph_context(i) for i in node.items):
                self.capture_blocks.add(node)
                continue
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if callee is None and isinstance(node.func, ast.Call):
                callee = _unwrap_partial(node.func)
            if callee in CAPTURE_WRAPPERS:
                body = node.args[0] if node.args else next(
                    (kw.value for kw in node.keywords if kw.arg == "body"),
                    None)
                if body is not None:
                    self._seed_func_arg(body, node, self.captured,
                                        seeds=False)
            elif callee in COMPILE_WRAPPERS:
                if node.args:
                    self._seed_func_arg(node.args[0], node, self.captured)
            elif callee in GRAPHED_CALLABLES:
                if node.args:
                    arg = node.args[0]
                    elts = arg.elts if isinstance(arg, (ast.Tuple, ast.List)) \
                        else [arg]
                    for elt in elts:
                        self._seed_func_arg(elt, node, self.captured)
            elif callee in FAMILY_WRAPPERS:
                fn_arg = node.args[0] if node.args else next(
                    (kw.value for kw in node.keywords if kw.arg == "fn"),
                    None)
                if fn_arg is not None:
                    self._seed_func_arg(fn_arg, node, self.families,
                                        seeds=False)

    def _add_seed(self, fn: ast.AST, into: Optional[Set[ast.AST]] = None,
                  seeds: bool = True) -> None:
        if seeds:
            self.seeds.add(fn)
        (self.captured if into is None else into).add(fn)

    def _seed_func_arg(self, arg: ast.AST, call: ast.Call,
                       into: Set[ast.AST], seeds: bool = True) -> None:
        if isinstance(arg, ast.Lambda):
            self._add_seed(arg, into, seeds)
        elif isinstance(arg, ast.Name):
            for fn in self.resolve_name(arg.id, call):
                self._add_seed(fn, into, seeds)
        elif isinstance(arg, ast.Attribute) and isinstance(arg.value,
                                                           ast.Name) \
                and arg.value.id in ("self", "cls"):
            method = self.resolve_method(arg.attr, call)
            if method is not None:
                self._add_seed(method, into, seeds)

    def resolve_method(self, name: str, at: ast.AST) -> Optional[FuncNode]:
        """``self.<name>`` from ``at``: the method of the enclosing class."""
        node = self.parent.get(at)
        while node is not None and not isinstance(node, ast.ClassDef):
            node = self.parent.get(node)
        if node is None:
            return None
        for sub in node.body:
            if isinstance(sub, _FUNC_TYPES) and sub.name == name:
                return sub
        return None

    def resolve_name(self, name: str, at: ast.AST) -> List[FuncNode]:
        """Defs named ``name`` lexically visible from ``at`` — innermost
        scope wins (several defs can share the innermost scope, e.g. one
        per branch of an ``if``)."""
        candidates = self._by_name.get(name, [])
        if not candidates:
            return []
        ancestors = []
        node: Optional[ast.AST] = at
        while node is not None:
            ancestors.append(node)
            node = self.parent.get(node)
        anc_set = {id(a) for a in ancestors}
        scored: List[Tuple[int, FuncNode]] = []
        for fn in candidates:
            scope = self._enclosing_scope(fn)
            if scope is None or id(scope) in anc_set:
                depth = self._depth(fn)
                scored.append((depth, fn))
        if not scored:
            return list(candidates)  # conservative: mark them all
        best = max(d for d, _ in scored)
        return [fn for d, fn in scored if d == best]

    def _enclosing_scope(self, fn: ast.AST) -> Optional[ast.AST]:
        node = self.parent.get(fn)
        while node is not None and not isinstance(node, _FUNC_TYPES):
            node = self.parent.get(node)
        return node

    def _depth(self, fn: ast.AST) -> int:
        d = 0
        node = self.parent.get(fn)
        while node is not None:
            d += 1
            node = self.parent.get(node)
        return d

    def _propagate(self, into: Set[ast.AST],
                   extra_roots: Iterable[ast.AST] = ()) -> None:
        """Close ``into`` under nesting and same-module ``Name`` calls
        (``extra_roots``: capture blocks, whose calls propagate too)."""
        work = list(into) + list(extra_roots)
        while work:
            fn = work.pop()
            for node in ast.walk(fn):
                found = []
                if isinstance(node, (*_FUNC_TYPES, ast.Lambda)) \
                        and node is not fn:
                    found.append(node)
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Name):
                    found += self.resolve_name(node.func.id, node)
                for callee in found:
                    if callee not in into:
                        into.add(callee)
                        work.append(callee)

    # -- queries -----------------------------------------------------------
    def is_captured(self, fn: ast.AST) -> bool:
        return fn in self.captured

    def seed_ancestor_or_self(self, fn: ast.AST) -> bool:
        node: Optional[ast.AST] = fn
        while node is not None:
            if node in self.seeds:
                return True
            node = self.parent.get(node)
        return False

    def outermost_function(self, node: ast.AST) -> Optional[ast.AST]:
        """The outermost def or lambda enclosing ``node`` (or ``node``)."""
        out = node if isinstance(node, (*_FUNC_TYPES, ast.Lambda)) else None
        cur = self.parent.get(node)
        while cur is not None:
            if isinstance(cur, (*_FUNC_TYPES, ast.Lambda)):
                out = cur
            cur = self.parent.get(cur)
        return out

    def taint_roots(self) -> List[ast.AST]:
        """The functions the taint engine walks: for every captured
        function and capture block, its outermost enclosing function (a
        body closing over tensors inherits their taint at its definition;
        the engine descends into nested defs itself)."""
        roots: Dict[int, ast.AST] = {}
        for node in list(self.captured) + list(self.capture_blocks):
            root = self.outermost_function(node)
            if root is not None:
                roots[id(root)] = root
        return sorted(roots.values(), key=lambda n: (n.lineno, n.col_offset))

    def qualname(self, fn: ast.AST) -> str:
        parts = [getattr(fn, "name", "<lambda>")]
        node = self.parent.get(fn)
        while node is not None:
            if isinstance(node, (*_FUNC_TYPES, ast.ClassDef)):
                parts.append(node.name)
            node = self.parent.get(node)
        return ".".join(reversed(parts))

    def enclosing_class_name(self, fn: ast.AST) -> Optional[str]:
        """Name of the nearest enclosing class (``self.m()`` resolution
        for cross-module summaries), or None."""
        node = self.parent.get(fn)
        while node is not None:
            if isinstance(node, ast.ClassDef):
                return node.name
            node = self.parent.get(node)
        return None


def iter_own_statements(fn: ast.AST) -> Iterator[ast.AST]:
    """Walk a function's nodes WITHOUT entering nested def/lambda bodies
    (nested functions are analyzed on their own). The nested def node
    itself IS yielded — only its body is private to it."""
    stack = [fn.body] if isinstance(fn, ast.Lambda) \
        else list(getattr(fn, "body", []))
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (*_FUNC_TYPES, ast.Lambda)):
            # the body is private to the nested function, but its
            # decorators and parameter defaults EXECUTE in the enclosing
            # scope — keep them visible to the walk
            stack.extend(getattr(node, "decorator_list", ()))
            args = node.args
            stack.extend(args.defaults)
            stack.extend(d for d in args.kw_defaults if d is not None)
            continue
        stack.extend(ast.iter_child_nodes(node))


# --------------------------------------------------------------------------
# Tensor-taint engine
# --------------------------------------------------------------------------

# results of these attribute reads are static Python metadata, never tensors
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "is_leaf", "itemsize", "nbytes"}
# tensor methods returning static Python values (not host reads)
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "element_size",
                   "data_ptr", "stride", "is_contiguous", "get_device",
                   "storage_offset", "is_floating_point", "is_complex",
                   "ndimension", "type"}
# builtins whose results are static regardless of argument taint
_STATIC_BUILTINS = {"len", "isinstance", "type", "id", "hasattr", "range",
                    "str", "repr", "callable", "issubclass", "format",
                    "getattr", "tuple", "list", "zip", "enumerate", "print"}
# host-converting calls: consume a tensor by copying it to the host
HOST_CONVERTERS = {"float", "int", "bool", "complex",
                   "np.asarray", "np.array", "numpy.asarray", "numpy.array",
                   "np.float32", "np.float64", "np.int32", "np.int64",
                   "np.uint8", "np.bool_"}
# tensor methods that read the tensor on the host
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
# device-wide waits: illegal inside a capture whatever they are handed
SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}
SYNC_METHODS = {"synchronize"}
# namespaces whose call results are tensors
_TENSOR_NAMESPACES = ("torch.", "F.", "nn.functional.")
# ...except these, which return Python values or objects
_STATIC_TORCH_PREFIXES = ("torch.cuda.", "torch.distributed.",
                          "torch.backends.", "torch.autograd.",
                          "torch.utils.", "torch.nn.init.")
_STATIC_TORCH_LASTS = {
    "device", "Size", "is_tensor", "is_floating_point", "is_complex",
    "finfo", "iinfo", "get_default_dtype", "promote_types", "result_type",
    "is_grad_enabled", "no_grad", "enable_grad", "inference_mode",
    "set_grad_enabled", "Generator", "manual_seed", "numel", "dtype",
    "is_inference_mode_enabled", "get_num_threads", "set_num_threads",
}


def is_tensor_call(callee: Optional[str]) -> bool:
    """``torch.zeros`` / ``F.relu``: a call whose result is a tensor."""
    if callee is None or not callee.startswith(_TENSOR_NAMESPACES):
        return False
    if callee.startswith(_STATIC_TORCH_PREFIXES):
        return False
    return callee.rsplit(".", 1)[-1] not in _STATIC_TORCH_LASTS


@dataclass
class TraceEvent:
    """One hazard candidate inside captured code."""

    kind: str          # "host_sync" | "tracer_branch"
    node: ast.AST      # anchor for line/col
    detail: str        # converter name / branch test source
    qualname: str      # captured function (or block) it occurred in


class _TaintWalker:
    """Order-sensitive walk of one function tree.

    Tracks the set of names bound to tensors. Seed parameters are tensors
    (minus ``self``/``cls``); closure variables inherit the enclosing
    walk's taint; ``torch.*`` results and tensor methods are tensors;
    static metadata and host reads are not. Events are raised only where
    the walk is inside captured code (a captured function, or a capture
    block). Branch arms are analyzed independently and union-merged; loop
    bodies run twice so second-iteration taint is seen.
    """

    def __init__(self, index: CaptureIndex, events: List[TraceEvent],
                 src: Optional[str] = None, program=None,
                 module: Optional[str] = None):
        self.index = index
        self.events = events
        self.src = src
        self.program = program       # ProgramIndex (cross-module reads)
        self.module = module
        self._emit = False
        self._block_name = ""

    # -- entry -------------------------------------------------------------
    def run(self, fn: ast.AST, inherited: Optional[Set[str]] = None,
            emit: bool = False) -> None:
        tainted: Set[str] = set(inherited or ())
        if self.index.seed_ancestor_or_self(fn):
            for name in _all_params(fn):
                if name in ("self", "cls"):
                    tainted.discard(name)
                else:
                    tainted.add(name)
        else:
            # an eager function or a propagated helper: parameters unknown
            # — assume they are not tensors, so Python config does not
            # false-positive; tensors still appear via torch.* results
            for name in _all_params(fn):
                tainted.discard(name)
        self._fn = fn
        self._emit = emit or self.index.is_captured(fn)
        if isinstance(fn, ast.Lambda):
            self._expr(fn.body, tainted)
        else:
            self._block(fn.body, tainted)

    def _event(self, kind: str, node: ast.AST, detail: str) -> None:
        if self._emit:
            self.events.append(TraceEvent(
                kind, node, detail,
                self.index.qualname(self._fn) + self._block_name))

    # -- statements --------------------------------------------------------
    def _block(self, stmts: Sequence[ast.stmt], tainted: Set[str]) -> None:
        for stmt in stmts:
            self._stmt(stmt, tainted)

    def _nested(self, fn: ast.AST, tainted: Set[str]) -> None:
        sub = _TaintWalker(self.index, self.events, self.src,
                           self.program, self.module)
        sub.run(fn, inherited=set(tainted), emit=self._emit)

    def _stmt(self, stmt: ast.stmt, tainted: Set[str]) -> None:
        if isinstance(stmt, _FUNC_TYPES):
            for dec in stmt.decorator_list:
                self._expr(dec, tainted)
            self._nested(stmt, tainted)
            return
        if isinstance(stmt, ast.ClassDef):
            return
        if isinstance(stmt, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = stmt.value
            is_tainted = self._expr(value, tainted) if value else False
            targets = (stmt.targets if isinstance(stmt, ast.Assign)
                       else [stmt.target])
            for tgt in targets:
                if isinstance(stmt, ast.AugAssign):
                    is_tainted = is_tainted or self._expr(tgt, tainted)
                self._bind(tgt, is_tainted, tainted)
            return
        if isinstance(stmt, ast.If):
            self._branch_test(stmt.test, tainted)
            t1, t2 = set(tainted), set(tainted)
            self._block(stmt.body, t1)
            self._block(stmt.orelse, t2)
            tainted |= t1 | t2
            return
        if isinstance(stmt, ast.While):
            self._branch_test(stmt.test, tainted)
            for _ in range(2):
                t1 = set(tainted)
                self._block(stmt.body, t1)
                tainted |= t1
            self._block(stmt.orelse, tainted)
            return
        if isinstance(stmt, ast.For):
            it_tainted = self._expr(stmt.iter, tainted)
            for _ in range(2):
                self._bind(stmt.target, it_tainted, tainted)
                t1 = set(tainted)
                self._block(stmt.body, t1)
                tainted |= t1
            self._block(stmt.orelse, tainted)
            return
        if isinstance(stmt, ast.Try):
            t1 = set(tainted)
            self._block(stmt.body, t1)
            tainted |= t1
            for handler in stmt.handlers:
                th = set(tainted)
                self._block(handler.body, th)
                tainted |= th
            self._block(stmt.orelse, tainted)
            self._block(stmt.finalbody, tainted)
            return
        if isinstance(stmt, ast.With):
            for item in stmt.items:
                self._expr(item.context_expr, tainted)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars, False, tainted)
            if stmt in self.index.capture_blocks and not self._emit:
                self._emit, self._block_name = True, ".<cuda graph>"
                try:
                    self._block(stmt.body, tainted)
                finally:
                    self._emit, self._block_name = False, ""
            else:
                self._block(stmt.body, tainted)
            return
        if isinstance(stmt, ast.Assert):
            self._branch_test(stmt.test, tainted)
            return
        if isinstance(stmt, (ast.Return, ast.Expr)) and \
                getattr(stmt, "value", None) is not None:
            self._expr(stmt.value, tainted)
            return
        # default (Raise, Delete, Import, ...): visit child expressions
        for node in ast.iter_child_nodes(stmt):
            if isinstance(node, ast.expr):
                self._expr(node, tainted)

    def _bind(self, target: ast.expr, is_tainted: bool,
              tainted: Set[str]) -> None:
        if isinstance(target, ast.Name):
            if is_tainted:
                tainted.add(target.id)
            else:
                tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt, is_tainted, tainted)
        elif isinstance(target, ast.Starred):
            self._bind(target.value, is_tainted, tainted)
        # Attribute/Subscript stores don't (re)bind local names

    def _branch_test(self, test: ast.expr, tainted: Set[str]) -> None:
        if self._expr(test, tainted):
            self._event("tracer_branch", test, self._src_of(test))

    def _src_of(self, node: ast.AST) -> str:
        if self.src is not None:
            try:
                seg = ast.get_source_segment(self.src, node)
                if seg:
                    return " ".join(seg.split())[:60]
            except Exception:  # pragma: no cover - malformed positions
                pass
        return type(node).__name__

    # -- expressions: return taint, emit events ----------------------------
    def _expr_list(self, exprs: Iterable[Optional[ast.expr]],
                   tainted: Set[str]) -> bool:
        hit = False
        for e in exprs:
            if e is not None:
                hit = self._expr(e, tainted) or hit
        return hit

    def _expr(self, node: ast.expr, tainted: Set[str]) -> bool:
        if isinstance(node, ast.Name):
            return node.id in tainted
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            base = self._expr(node.value, tainted)
            return False if node.attr in _STATIC_ATTRS else base
        if isinstance(node, ast.Subscript):
            base = self._expr(node.value, tainted)
            self._expr(node.slice, tainted)
            return base
        if isinstance(node, ast.Call):
            return self._call(node, tainted)
        if isinstance(node, ast.BinOp):
            l = self._expr(node.left, tainted)
            return self._expr(node.right, tainted) or l
        if isinstance(node, ast.UnaryOp):
            return self._expr(node.operand, tainted)
        if isinstance(node, ast.BoolOp):
            return self._expr_list(node.values, tainted)
        if isinstance(node, ast.Compare):
            hit = self._expr(node.left, tainted)
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                self._expr_list(node.comparators, tainted)
                return False   # identity: a Python bool, no device read
            return self._expr_list(node.comparators, tainted) or hit
        if isinstance(node, ast.IfExp):
            self._branch_test(node.test, tainted)
            body = self._expr(node.body, tainted)
            return self._expr(node.orelse, tainted) or body
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            return self._expr_list(node.elts, tainted)
        if isinstance(node, ast.Dict):
            hit = self._expr_list(node.keys, tainted)
            return self._expr_list(node.values, tainted) or hit
        if isinstance(node, ast.Starred):
            return self._expr(node.value, tainted)
        if isinstance(node, ast.Slice):
            return self._expr_list((node.lower, node.upper, node.step),
                                   tainted)
        if isinstance(node, ast.Lambda):
            self._nested(node, tainted)
            return False  # a callable, not a tensor
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            ct = set(tainted)
            hit = False
            for gen in node.generators:
                it = self._expr(gen.iter, ct)
                self._bind(gen.target, it, ct)
                hit = it or hit
                for cond in gen.ifs:
                    self._branch_test(cond, ct)
            if isinstance(node, ast.DictComp):
                hit = self._expr(node.key, ct) or hit
                hit = self._expr(node.value, ct) or hit
            else:
                hit = self._expr(node.elt, ct) or hit
            return hit
        if isinstance(node, ast.JoinedStr):
            for v in node.values:
                if isinstance(v, ast.FormattedValue):
                    if self._expr(v.value, tainted):
                        self._event("host_sync", v.value,
                                    "f-string formatting")
            return False
        # conservative default: visit children, propagate any taint
        hit = False
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.expr):
                hit = self._expr(child, tainted) or hit
        return hit

    def _call(self, node: ast.Call, tainted: Set[str]) -> bool:
        callee = dotted_name(node.func)
        recv_taint = False
        if isinstance(node.func, ast.Attribute):
            if callee is None:
                # computed receiver, e.g. ``(x + y).sum()`` — visit once
                recv_taint = self._expr(node.func.value, tainted)
            else:
                root = node.func
                while isinstance(root, ast.Attribute):
                    if root is not node.func and root.attr in _STATIC_ATTRS:
                        break
                    root = root.value
                recv_taint = (isinstance(root, ast.Name)
                              and root.id in tainted)
        arg_taints = [self._expr(a, tainted) for a in node.args]
        kw_taints = {kw.arg: self._expr(kw.value, tainted)
                     for kw in node.keywords}
        arg_taint = any(arg_taints)
        kw_taint = any(kw_taints.values())
        any_taint = arg_taint or kw_taint

        if callee in SYNC_CALLS or (isinstance(node.func, ast.Attribute)
                                    and node.func.attr in SYNC_METHODS
                                    and not node.args):
            self._event("host_sync", node, f"{callee or '.synchronize'}()")
            return False
        if callee in HOST_CONVERTERS and any_taint:
            self._event("host_sync", node, f"{callee}()")
            return False  # result lives on the host
        if isinstance(node.func, ast.Attribute):
            if node.func.attr in HOST_METHODS and recv_taint:
                self._event("host_sync", node, f".{node.func.attr}()")
                return False
            if node.func.attr in _STATIC_METHODS and recv_taint:
                return False
        if self._emit and self.program is not None and callee and any_taint:
            # whole-program: a tensor handed to a helper (possibly in
            # another module) whose summary says that parameter is read on
            # the host — the finding lands at the point of entry
            hit = self.program.call_syncs_tainted(
                self.module, callee, arg_taints, kw_taints,
                self.index.enclosing_class_name(self._fn))
            if hit is not None:
                self._event("host_sync", node,
                            f"{callee}() [{hit} reads this argument on "
                            f"the host]")
                return False
        if callee in _STATIC_BUILTINS:
            return False
        if callee is not None and callee.startswith(_TENSOR_NAMESPACES):
            return is_tensor_call(callee)
        return recv_taint or any_taint


def iter_trace_events(ctx: "FileContext") -> List[TraceEvent]:
    """All taint events for the file, computed once and cached on ctx."""
    if ctx._trace_events is None:
        events: List[TraceEvent] = []
        walker = _TaintWalker(ctx.capture_index, events, ctx.source,
                              ctx.program, ctx.module)
        for fn in ctx.capture_index.taint_roots():
            walker.run(fn)
        ctx._trace_events = events
    return ctx._trace_events


# --------------------------------------------------------------------------
# File context and driver
# --------------------------------------------------------------------------


@dataclass
class FileContext:
    """Everything a rule needs about one source file. ``module`` and
    ``program`` are set when the file is linted as part of a whole-
    program pass (``lint_paths``) — rules degrade to per-file behaviour
    when ``program`` is None."""

    path: str
    source: str
    tree: ast.Module
    capture_index: CaptureIndex
    suppressions: Dict[int, List[Suppression]]
    comment_only_lines: Set[int]
    module: Optional[str] = None
    program: Optional[object] = field(default=None, repr=False)
    _trace_events: Optional[List[TraceEvent]] = field(default=None,
                                                      repr=False)
    _all_nodes: Optional[List[ast.AST]] = field(default=None, repr=False)
    _rule_caches: Dict[str, object] = field(default_factory=dict,
                                            repr=False)

    def walk(self) -> List[ast.AST]:
        """Every node of the tree, walked once and cached."""
        if self._all_nodes is None:
            self._all_nodes = list(ast.walk(self.tree))
        return self._all_nodes

    def rule_cache(self, key: str, build):
        """Get-or-build a per-file helper shared between rules (lock
        index, mesh resolver, ...)."""
        cached = self._rule_caches.get(key)
        if cached is None:
            cached = self._rule_caches[key] = build()
        return cached

    @classmethod
    def parse(cls, path: str, source: Optional[str] = None) -> "FileContext":
        if source is None:
            with open(path, encoding="utf-8") as f:
                source = f.read()
        tree = ast.parse(source, filename=path)
        by_line, comment_only = _scan_suppressions(source)
        return cls(path=path, source=source, tree=tree,
                   capture_index=CaptureIndex(tree), suppressions=by_line,
                   comment_only_lines=comment_only)

    def mentions(self, *words: str) -> bool:
        """Does the source text contain any of ``words``? (Rules whose
        hazard needs a construct skip files that never name it.)"""
        return any(w in self.source for w in words)

    def suppressions_for(self, line: int) -> List[Suppression]:
        """Suppressions applying to a finding at ``line``: same line,
        plus any stack of comment-only lines directly above."""
        out = list(self.suppressions.get(line, ()))
        ln = line - 1
        while ln in self.comment_only_lines:
            out.extend(self.suppressions.get(ln, ()))
            ln -= 1
        return out


@dataclass
class FileResult:
    path: str
    findings: List[Finding]            # unsuppressed (reportable)
    suppressed: List[Finding]          # matched by a reasoned suppression


def _syntax_error_result(path: str, e: SyntaxError) -> FileResult:
    return FileResult(path, [Finding(
        "JG000", f"syntax error prevents analysis: {e.msg}", path,
        e.lineno or 1, (e.offset or 1) - 1)], [])


def _wire_program(ctxs: Sequence[FileContext]) -> None:
    """Build a ProgramIndex over the parsed contexts, attach it, and
    inject cross-module captured reach into each file's CaptureIndex."""
    from bigdl_tpu_torch.analysis.program import ProgramIndex
    index = ProgramIndex.build([(ctx.path, ctx.tree) for ctx in ctxs])
    per_file_captured: Dict[str, List[ast.AST]] = {}
    for ctx in ctxs:
        rec = index.record_for(ctx.path)
        if rec is None:  # pragma: no cover - every ctx was just indexed
            continue
        # the record's (possibly disambiguated) name, NOT a recomputed
        # one — duplicate stems must resolve against their own file
        ctx.module = rec.name
        ctx.program = index
        per_file_captured[ctx.module] = [
            fn for fn in ctx.capture_index.functions
            if ctx.capture_index.is_captured(fn)]
    index.seed_captured(per_file_captured)
    for ctx in ctxs:
        rec = index.record_for(ctx.path)
        if rec is None:
            continue
        names = index.extern_captured_names(ctx.module)
        ctx.capture_index.add_extern_captured(
            rec.functions[q] for q in names if q in rec.functions)


def lint_source(path: str, source: str,
                rules: Optional[Sequence[Rule]] = None) -> FileResult:
    """Lint one in-memory source buffer (fixture tests use this). The
    buffer is its own one-module program, so same-module resolution
    behaves identically to the whole-program pass."""
    rules = list(rules) if rules is not None else all_rules()
    try:
        ctx = FileContext.parse(path, source)
    except SyntaxError as e:
        return _syntax_error_result(path, e)
    _wire_program([ctx])
    return _apply_rules(ctx, rules)


def _apply_rules(ctx: FileContext, rules: Sequence[Rule]) -> FileResult:
    """Run the rules over a prepared context and apply suppressions."""
    path = ctx.path
    raw: List[Finding] = []
    for rule in rules:
        raw.extend(rule.check(ctx))
    reported: List[Finding] = []
    suppressed: List[Finding] = []
    for f in raw:
        # candidates: the anchor line (plus its comment-only stack above)
        # and every further physical line of the flagged construct, so a
        # flake8-style trailing comment on a multi-line call applies
        cands = ctx.suppressions_for(f.line)
        for ln in range(f.line + 1, max(f.line, f.end_line) + 1):
            cands.extend(ctx.suppressions.get(ln, ()))
        matching = [s for s in cands if f.code in s.codes]
        for s in matching:
            s.used = True  # EVERY match is used — a duplicate reasoned
            # ignore must not be misreported as stale below
        matched = next((s for s in matching if s.reason),
                       matching[0] if matching else None)
        if matched is not None and matched.reason:
            suppressed.append(f)
        else:
            # a reasonless suppression does not suppress (and is itself
            # reported below)
            reported.append(f)
    active_codes = {r.code for r in rules}
    for sups in ctx.suppressions.values():
        for sup in sups:
            if sup.reason is None:
                reported.append(Finding(
                    "JG000", "suppression requires a reason: write "
                    "'# graftlint: ignore[JG0xx] -- why this is deliberate'",
                    path, sup.line))
            elif not sup.used and set(sup.codes) <= active_codes:
                # (only judged when every named rule actually ran, so a
                # --select subset doesn't misreport other codes as stale)
                reported.append(Finding(
                    "JG000", f"unused suppression "
                    f"[{','.join(sup.codes)}]: no matching finding on "
                    f"this line — remove it, or fix its placement",
                    path, sup.line))
    reported.sort(key=lambda f: (f.line, f.col, f.code))
    suppressed.sort(key=lambda f: (f.line, f.col, f.code))
    return FileResult(path, reported, suppressed)


def lint_file(path: str,
              rules: Optional[Sequence[Rule]] = None) -> FileResult:
    """Lint one file on disk; returns its reported + suppressed findings."""
    with open(path, encoding="utf-8") as f:
        return lint_source(path, f.read(), rules)


def _lint_program(files: Sequence[str], rules: Sequence[Rule],
                  sources: Optional[Dict[str, str]] = None
                  ) -> List[FileResult]:
    """Whole-program pass: parse every file once, build the shared
    ProgramIndex, then run the rules per file with cross-module facts
    attached. Unparseable files report JG000 and stay out of the index.
    ``sources`` supplies preloaded file contents (the result cache has
    already read them for hashing)."""
    ctxs: List[FileContext] = []
    results_by_path: Dict[str, FileResult] = {}
    order: List[str] = []
    for path in files:
        order.append(path)
        try:
            if sources is not None and path in sources:
                source = sources[path]
            else:
                with open(path, encoding="utf-8") as f:
                    source = f.read()
            ctxs.append(FileContext.parse(path, source))
        except SyntaxError as e:
            results_by_path[path] = _syntax_error_result(path, e)
    _wire_program(ctxs)
    for ctx in ctxs:
        results_by_path[ctx.path] = _apply_rules(ctx, rules)
    return [results_by_path[p] for p in order]


def iter_python_files(paths: Sequence[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for root, dirs, files in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith(".")
                                 and d != "__pycache__")
                for name in sorted(files):
                    if name.endswith(".py"):
                        yield os.path.join(root, name)


def select_rules(select: Optional[Iterable[str]] = None,
                 ignore: Optional[Iterable[str]] = None) -> List[Rule]:
    """Registered rules filtered by --select/--ignore code lists
    (ValueError on an unknown code)."""
    rules = all_rules()
    for label, codes in (("select", select), ("ignore", ignore)):
        if codes:
            unknown = ({c.strip().upper() for c in codes if c.strip()}
                       - set(RULES))
            if unknown:
                raise ValueError(
                    f"--{label}: unknown rule code(s) {sorted(unknown)}")
    if select:
        want = {c.strip().upper() for c in select}
        rules = [r for r in rules if r.code in want]
    if ignore:
        drop = {c.strip().upper() for c in ignore}
        rules = [r for r in rules if r.code not in drop]
    return rules


def lint_paths(paths: Sequence[str],
               select: Optional[Iterable[str]] = None,
               ignore: Optional[Iterable[str]] = None,
               files: Optional[Sequence[str]] = None,
               use_cache: Optional[bool] = None) -> List[FileResult]:
    """Lint every ``.py`` file under the given files/directories with the
    selected rules as ONE whole program (cross-module facts propagate
    between all of them); one FileResult per file, in walk order.
    ``files`` overrides the walk with an explicit file list (the CLI's
    ``--changed`` filter). Results are served from the content-hash
    cache (``analysis/cache.py``) when every input is byte-identical to a
    stored pass; ``use_cache=False`` (or GRAFTLINT_NO_CACHE=1) forces a
    fresh pass."""
    from bigdl_tpu_torch.analysis import cache as _cache

    rules = select_rules(select, ignore)
    if files is None:
        files = list(iter_python_files(paths))
    if use_cache is None:
        use_cache = _cache.enabled()
    if not use_cache:
        return _lint_program(files, rules)
    sources: Dict[str, str] = {}
    for path in files:
        try:
            with open(path, encoding="utf-8") as f:
                sources[path] = f.read()
        except OSError:
            pass  # _lint_program re-raises on the real read
    key = _cache.program_key(sources, [r.code for r in rules])
    hit = _cache.lookup(key, list(files))
    if hit is not None:
        return hit
    results = _lint_program(files, rules, sources=sources)
    _cache.store(key, results)
    return results


# --------------------------------------------------------------------------
# Reporters
# --------------------------------------------------------------------------


def render_text(results: Sequence[FileResult]) -> str:
    """One ``path:line:col: CODE message`` line per finding, plus a
    summary tail (findings / suppressed / files)."""
    lines: List[str] = []
    n_find = n_sup = 0
    for res in results:
        for f in res.findings:
            lines.append(f.render())
            n_find += 1
        n_sup += len(res.suppressed)
    lines.append(f"graftlint: {n_find} finding(s), {n_sup} suppressed, "
                 f"{len(results)} file(s)")
    return "\n".join(lines)


def render_json(results: Sequence[FileResult]) -> str:
    """Machine-readable report: {findings, suppressed, files} (CI and
    editor integrations consume this)."""
    payload = {
        "findings": [
            {"code": f.code, "message": f.message, "path": f.path,
             "line": f.line, "col": f.col}
            for res in results for f in res.findings],
        "suppressed": [
            {"code": f.code, "path": f.path, "line": f.line}
            for res in results for f in res.suppressed],
        "files": len(results),
    }
    return json.dumps(payload, indent=2)
