"""Lightweight abstract shape/value interpreter for the port's graftlint
(counterpart of ``bigdl_tpu/analysis/shapes.py``).

The mesh rules (JG010-012) check axis *names* but know nothing about
tensor *shapes* — so an axis whose size cannot evenly divide a statically
known dim, or a runtime-dependent length flowing into a program cache,
only surfaces at run time. :class:`ShapeEnv` closes that gap with a
deliberately small abstract domain evaluated lazily over one function:

- **dims** are ``int`` (statically known), :data:`DYN` (derived from
  runtime data — ``len(request.ids)`` and arithmetic over it), or
  :data:`UNKNOWN` (no idea).
- **values** are :class:`Arr` (tensor with an abstract shape),
  :class:`Scalar` (abstract int), :class:`Seq` (tuple/list literal —
  shape material), or :data:`RT` (runtime-opaque data: parameters,
  ``self`` state, and anything reached through them).

Resolution is precision-over-recall, the same stance as the rest of
graftlint:

- only names with exactly ONE assignment in the function resolve (a
  rebound name is control-flow dependent — give up rather than guess);
- module-level int constants resolve through one from-import hop via
  :meth:`ProgramIndex.resolve_int_constant` (``EMBED = 768`` idiom);
- ``len()`` of runtime data is :data:`DYN`; ``+``/``-``/``*``/``//``
  keep DYN alive, but ``%`` by a known int *bounds* the value (a
  modulo is a bucketing operation) and any unmodeled call launders to
  :data:`UNKNOWN` — so ``pow2_bucket(len(ids))`` is clean while a raw
  ``len(ids)`` is not;
- tensor constructors (``torch.zeros/ones/empty/full/rand/randn/arange``
  with a shape tuple or the dims as separate arguments, the ``*_like``
  forms, ``x.new_zeros``/``new_ones``/``new_empty``/``new_full``,
  ``torch.tensor``/``as_tensor`` of a literal, the numpy ones),
  ``reshape``/``view``, elementwise arithmetic and ``.shape`` /
  ``.size(d)`` indexing are modeled; everything else is
  :data:`UNKNOWN`.

Pure ``ast`` throughout: nothing is imported or executed.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from bigdl_tpu_torch.analysis.core import (FileContext, dotted_name,
                                     iter_own_statements)


class _Mark:
    """Sentinel abstract-dim/value marker."""

    __slots__ = ("label",)

    def __init__(self, label: str):
        self.label = label

    def __repr__(self) -> str:
        return self.label


#: dim/scalar derived from runtime data (a compile-storm seed)
DYN = _Mark("dyn")
#: dim/scalar the interpreter cannot say anything about
UNKNOWN = _Mark("?")
#: runtime-opaque non-scalar value (parameters, self state, containers)
RT = _Mark("runtime")


@dataclass(frozen=True)
class Scalar:
    """Abstract int: a known value, DYN, or UNKNOWN."""

    value: object  # int | DYN | UNKNOWN


@dataclass(frozen=True)
class Arr:
    """Array with an abstract shape (tuple of int | DYN | UNKNOWN)."""

    shape: Tuple[object, ...]


@dataclass(frozen=True)
class Seq:
    """Tuple/list literal of abstract scalars (shape material)."""

    items: Tuple[object, ...]  # each int | DYN | UNKNOWN


_UNKNOWN_SCALAR = Scalar(UNKNOWN)

# torch/numpy constructors taking a shape first (torch also takes the
# dims as separate arguments: torch.zeros(4, 8))
_SHAPE_CTORS = {"zeros", "ones", "empty", "full", "rand", "randn"}
_LIKE_CTORS = {"zeros_like", "ones_like", "empty_like", "full_like",
               "rand_like", "randn_like"}
_NEW_CTORS = {"new_zeros", "new_ones", "new_empty", "new_full"}
_TENSOR_PREFIXES = ("torch.", "np.", "numpy.")
# calls that keep their argument's shape
_SHAPE_KEEPING = {"clone", "contiguous", "float", "half", "bfloat16", "to",
                  "cuda", "detach", "abs", "neg", "exp", "relu"}


def _is_numpy_call(callee: str) -> bool:
    return callee.startswith(_TENSOR_PREFIXES)


def _root_name(expr: ast.expr) -> Optional[str]:
    """Leftmost ``Name`` under an Attribute/Subscript chain."""
    while isinstance(expr, (ast.Attribute, ast.Subscript)):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _bound_names(target: ast.expr) -> set:
    """Names an assignment target binds (``a, (b, *c)``; not the names
    inside a subscript or attribute store, which bind nothing)."""
    if isinstance(target, ast.Name):
        return {target.id}
    if isinstance(target, (ast.Tuple, ast.List)):
        out = set()
        for elt in target.elts:
            out |= _bound_names(elt)
        return out
    if isinstance(target, ast.Starred):
        return _bound_names(target.value)
    return set()


class ShapeEnv:
    """Abstract values for the locals of one function (lazy, memoized)."""

    def __init__(self, fn: ast.AST, ctx: FileContext):
        self.fn = fn
        self.ctx = ctx
        a = fn.args
        self.params = {p.arg for p in (list(getattr(a, "posonlyargs", []))
                                       + list(a.args) + list(a.kwonlyargs))}
        if a.vararg is not None:
            self.params.add(a.vararg.arg)
        if a.kwarg is not None:
            self.params.add(a.kwarg.arg)
        # name -> its assignments (value exprs); >1 or aug/unpack targets
        # poison the name to UNKNOWN (control-flow dependent); loop
        # targets iterate runtime data and resolve to RT
        self._assigns: Dict[str, List[ast.expr]] = {}
        self._poisoned = set()
        self._loop_names = set()
        for node in iter_own_statements(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                self._assigns.setdefault(node.targets[0].id,
                                         []).append(node.value)
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                if isinstance(node.target, ast.Name):
                    self._poisoned.add(node.target.id)
            elif isinstance(node, (ast.For, ast.comprehension)):
                tgt = node.target
                for sub in ast.walk(tgt):
                    if isinstance(sub, ast.Name):
                        self._loop_names.add(sub.id)
            elif isinstance(node, ast.Assign):
                for tgt in node.targets:  # tuple-unpack targets: poison
                    self._poisoned |= _bound_names(tgt)
        self._memo: Dict[str, object] = {}
        self._in_progress = set()

    # -- public API ------------------------------------------------------
    def eval(self, expr: ast.expr) -> object:
        """Abstract value of ``expr`` (Scalar / Arr / Seq / RT)."""
        return self._eval(expr)

    def shape_of(self, expr: ast.expr) -> Optional[Tuple[object, ...]]:
        """Abstract shape when ``expr`` is a modeled array, else None."""
        v = self._eval(expr)
        return v.shape if isinstance(v, Arr) else None

    def scalar_of(self, expr: ast.expr) -> object:
        """Abstract int of ``expr``: int | DYN | UNKNOWN."""
        v = self._eval(expr)
        return v.value if isinstance(v, Scalar) else UNKNOWN

    # -- name resolution -------------------------------------------------
    def _value_of_name(self, name: str) -> object:
        if name in self._memo:
            return self._memo[name]
        if name in self.params or name == "self":
            return RT
        if name in self._poisoned or name in self._in_progress:
            return _UNKNOWN_SCALAR
        if name in self._loop_names and name not in self._assigns:
            return RT  # loop variable: one element of runtime data
        assigns = self._assigns.get(name)
        if assigns is not None and len(assigns) == 1:
            self._in_progress.add(name)
            try:
                v = self._eval(assigns[0])
            finally:
                self._in_progress.discard(name)
        elif assigns:
            v = _UNKNOWN_SCALAR
        else:
            # not a local: module-level int constant (one import hop)?
            v = _UNKNOWN_SCALAR
            if self.ctx.program is not None and self.ctx.module is not None:
                c = self.ctx.program.resolve_int_constant(self.ctx.module,
                                                          name)
                if c is not None:
                    v = Scalar(c)
        self._memo[name] = v
        return v

    # -- the interpreter -------------------------------------------------
    def _eval(self, expr: ast.expr) -> object:
        if isinstance(expr, ast.Constant):
            if type(expr.value) is int:
                return Scalar(expr.value)
            return _UNKNOWN_SCALAR
        if isinstance(expr, ast.Name):
            return self._value_of_name(expr.id)
        if isinstance(expr, (ast.Tuple, ast.List)):
            items = []
            for el in expr.elts:
                if isinstance(el, ast.Starred):
                    return _UNKNOWN_SCALAR
                v = self._eval(el)
                items.append(v.value if isinstance(v, Scalar) else UNKNOWN)
            return Seq(tuple(items))
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.USub):
            v = self._eval(expr.operand)
            if isinstance(v, Scalar):
                if isinstance(v.value, int):
                    return Scalar(-v.value)
                return v  # -DYN stays DYN
            return _UNKNOWN_SCALAR
        if isinstance(expr, ast.BinOp):
            return self._binop(expr)
        if isinstance(expr, ast.Attribute):
            return self._attribute(expr)
        if isinstance(expr, ast.Subscript):
            return self._subscript(expr)
        if isinstance(expr, ast.Call):
            return self._call(expr)
        return _UNKNOWN_SCALAR

    def _binop(self, expr: ast.BinOp) -> object:
        lhs, rhs = self._eval(expr.left), self._eval(expr.right)
        # array arithmetic: elementwise keeps the shape; scalar broadcasts
        if isinstance(lhs, Arr) or isinstance(rhs, Arr):
            if isinstance(lhs, Arr) and isinstance(rhs, Arr):
                return lhs if lhs.shape == rhs.shape else _UNKNOWN_SCALAR
            arr = lhs if isinstance(lhs, Arr) else rhs
            other = rhs if isinstance(lhs, Arr) else lhs
            return arr if isinstance(other, Scalar) else _UNKNOWN_SCALAR
        if not (isinstance(lhs, Scalar) and isinstance(rhs, Scalar)):
            return _UNKNOWN_SCALAR
        a, b = lhs.value, rhs.value
        op = expr.op
        if isinstance(a, int) and isinstance(b, int):
            try:
                if isinstance(op, ast.Add):
                    return Scalar(a + b)
                if isinstance(op, ast.Sub):
                    return Scalar(a - b)
                if isinstance(op, ast.Mult):
                    return Scalar(a * b)
                if isinstance(op, ast.FloorDiv):
                    return Scalar(a // b)
                if isinstance(op, ast.Mod):
                    return Scalar(a % b)
                if isinstance(op, ast.Pow) and b >= 0:
                    return Scalar(a ** b)
            except (ZeroDivisionError, OverflowError):
                return _UNKNOWN_SCALAR
            return _UNKNOWN_SCALAR
        if DYN in (a, b):
            # modulo by a KNOWN int bounds the result — that is a
            # bucketing operation, not a storm seed
            if isinstance(op, ast.Mod) and isinstance(b, int):
                return _UNKNOWN_SCALAR
            if isinstance(op, (ast.Add, ast.Sub, ast.Mult, ast.FloorDiv)) \
                    and UNKNOWN not in (a, b):
                return Scalar(DYN)
        return _UNKNOWN_SCALAR

    def _attribute(self, expr: ast.Attribute) -> object:
        base = self._eval(expr.value)
        if expr.attr == "shape" and isinstance(base, Arr):
            return Seq(base.shape)
        if expr.attr == "T" and isinstance(base, Arr):
            return Arr(tuple(reversed(base.shape)))
        if base is RT:
            return RT  # attribute chains on runtime data stay runtime
        return _UNKNOWN_SCALAR

    def _subscript(self, expr: ast.Subscript) -> object:
        base = self._eval(expr.value)
        if isinstance(base, Seq):
            idx = self._eval(expr.slice)
            if isinstance(idx, Scalar) and isinstance(idx.value, int):
                try:
                    item = base.items[idx.value]
                except IndexError:
                    return _UNKNOWN_SCALAR
                return Scalar(item)
        if base is RT:
            return RT
        return _UNKNOWN_SCALAR

    def _shape_from(self, expr: ast.expr) -> Optional[Tuple[object, ...]]:
        """Shape-argument expression -> abstract dim tuple."""
        v = self._eval(expr)
        if isinstance(v, Seq):
            return v.items
        if isinstance(v, Scalar):
            return (v.value,)  # zeros(8) == zeros((8,))
        return None

    def _dims_from_args(self, args: List[ast.expr]
                        ) -> Optional[Tuple[object, ...]]:
        """A constructor's shape: one shape argument, or the dims as
        separate arguments (``torch.zeros(4, 8)``)."""
        if len(args) == 1:
            return self._shape_from(args[0])
        dims = tuple(self.scalar_of(a) for a in args)
        return dims if args else None

    def _call(self, expr: ast.Call) -> object:
        callee = dotted_name(expr.func) or ""
        last = callee.rsplit(".", 1)[-1]
        if isinstance(expr.func, ast.Attribute) and not callee:
            last = expr.func.attr
        if callee == "len" and len(expr.args) == 1:
            return self._len(expr.args[0])
        if last in ("tuple", "list") and callee == last \
                and len(expr.args) == 1:
            v = self._eval(expr.args[0])
            return v if isinstance(v, Seq) else _UNKNOWN_SCALAR
        recv = expr.func.value if isinstance(expr.func, ast.Attribute) \
            else None
        if _is_numpy_call(callee):
            if last in _SHAPE_CTORS and expr.args:
                args = expr.args[:1] if last == "full" else expr.args
                if callee.startswith(("np.", "numpy.")):
                    args = expr.args[:1]
                dims = self._dims_from_args(list(args))
                if dims is not None:
                    return Arr(tuple(dims))
                return _UNKNOWN_SCALAR
            if last in _LIKE_CTORS and expr.args:
                v = self._eval(expr.args[0])
                return v if isinstance(v, Arr) else _UNKNOWN_SCALAR
            if last in ("asarray", "array", "tensor", "as_tensor") \
                    and expr.args:
                v = self._eval(expr.args[0])
                if isinstance(v, Arr):
                    return v
                if isinstance(v, Seq):
                    return Arr((len(v.items),))
                return _UNKNOWN_SCALAR
            if last == "arange" and len(expr.args) == 1:
                n = self._eval(expr.args[0])
                if isinstance(n, Scalar) and n.value is not UNKNOWN:
                    return Arr((n.value,))
                return _UNKNOWN_SCALAR
            if last == "reshape" and len(expr.args) >= 2:
                return self._reshaped(expr.args[1:])
            return _UNKNOWN_SCALAR
        if recv is not None:
            if last in ("reshape", "view") and expr.args:
                return self._reshaped(expr.args)
            if last in _NEW_CTORS and expr.args:
                args = expr.args[:1] if last == "new_full" else expr.args
                dims = self._dims_from_args(list(args))
                return Arr(tuple(dims)) if dims is not None \
                    else _UNKNOWN_SCALAR
            if last == "size" and len(expr.args) == 1:
                base = self._eval(recv)
                idx = self._eval(expr.args[0])
                if isinstance(base, Arr) and isinstance(idx, Scalar) \
                        and isinstance(idx.value, int):
                    try:
                        return Scalar(base.shape[idx.value])
                    except IndexError:
                        return _UNKNOWN_SCALAR
                return _UNKNOWN_SCALAR
            if last in _SHAPE_KEEPING:
                base = self._eval(recv)
                return base if isinstance(base, Arr) else _UNKNOWN_SCALAR
        # unmodeled call: launders DYN (pow2_bucket(len(x)) is clean)
        return _UNKNOWN_SCALAR

    def _reshaped(self, shape_args: List[ast.expr]) -> object:
        if len(shape_args) == 1:
            dims = self._shape_from(shape_args[0])
        else:
            dims = tuple(self.scalar_of(a) for a in shape_args)
        if dims is None or any(d is UNKNOWN or (
                isinstance(d, int) and d < 0) for d in dims):
            return _UNKNOWN_SCALAR
        return Arr(tuple(dims))

    def _len(self, arg: ast.expr) -> object:
        v = self._eval(arg)
        if isinstance(v, Seq):
            return Scalar(len(v.items))
        if isinstance(v, Arr):
            return Scalar(v.shape[0] if v.shape else UNKNOWN)
        if v is RT:
            return Scalar(DYN)  # length of runtime data: the storm seed
        # a Name/attribute chain rooted at runtime data whose value we
        # could not otherwise model still has a runtime-dependent length
        root = _root_name(arg)
        if root is not None and (root in self.params or root == "self"):
            return Scalar(DYN)
        return _UNKNOWN_SCALAR


def shape_env(ctx: FileContext, fn: ast.AST) -> ShapeEnv:
    """Per-(file, function) memoized :class:`ShapeEnv`."""
    envs = ctx.rule_cache("shapes.envs", dict)
    env = envs.get(id(fn))
    if env is None:
        env = envs[id(fn)] = ShapeEnv(fn, ctx)
    return env
