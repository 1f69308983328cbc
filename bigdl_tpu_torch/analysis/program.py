"""Whole-program index: imports, call graph, and cross-module fact
propagation for the port's graftlint (counterpart of
``bigdl_tpu/analysis/program.py``).

Per-file analysis stops at the module boundary: a captured body that
calls a host-reading helper *in another file* is invisible, and the
hazards that matter — a generator drawn inside a capture, a program built
by a helper and cached by its caller, races across the threaded serving
and telemetry modules — cross modules. :class:`ProgramIndex` parses every
linted file once, resolves ``import``/``from-import`` aliases to linted
modules, and computes by worklist fixpoint:

- **externally-captured functions** — the closure of "called (by a
  resolvable name) from captured code in any module". Injected into each
  file's :class:`~bigdl_tpu_torch.analysis.core.CaptureIndex`, so the
  per-file rules (JG001/JG002/JG006) see cross-module capture reach, with
  the propagated-helper stance (parameters not assumed tensors).
- **function summaries** — per top-level function/method: ``sync_params``
  (parameter positions read on the host, directly or through further
  calls), ``gen_params`` (positions handed to a ``torch`` draw as its
  ``generator=``) and ``returns_program`` (the function hands back a
  fresh ``GraphedProgram``/``tracked_jit``/``torch.compile`` wrapper).
- **generator-stream facts** — per module: the names and ``self``
  attributes bound to ``torch.Generator(...)``, and the generators
  registered with a graph (``register_generator_state``) or handed to
  ``GraphedProgram(generators=...)``.
- **loop reachability** — functions (transitively) called from inside a
  Python loop anywhere in the program (JG014).

Everything stays pure ``ast``: modules are never imported, name
resolution is static and gives up (returns ``None``) rather than guess.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

from bigdl_tpu_torch.analysis.core import (_FUNC_TYPES, CAPTURE_WRAPPERS,
                                           HOST_CONVERTERS, HOST_METHODS,
                                           WRAPPER_BUILDERS, dotted_name,
                                           iter_own_statements)

GENERATOR_CTORS = {"torch.Generator", "Generator"}

FuncKey = Tuple[str, str]  # (module dotted name, qualname within module)


def module_name_for(path: str) -> str:
    """Dotted module name for ``path``, walking up while ``__init__.py``
    exists (``.../bigdl_tpu_torch/models/serving.py`` ->
    ``bigdl_tpu_torch.models.serving``; a bare script keeps its stem)."""
    path = os.path.abspath(path)
    parts = [os.path.splitext(os.path.basename(path))[0]]
    d = os.path.dirname(path)
    while os.path.isfile(os.path.join(d, "__init__.py")):
        parts.append(os.path.basename(d))
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    if parts[0] == "__init__":
        parts = parts[1:] or [os.path.basename(os.path.dirname(path))]
    return ".".join(reversed(parts))


@dataclass
class FuncSummary:
    """Cross-module facts about one function, propagated to fixpoint."""

    sync_params: Set[int] = field(default_factory=set)
    gen_params: Set[int] = field(default_factory=set)
    returns_program: bool = False
    # the returned program is a GraphedProgram (static outputs)
    returns_graph: bool = False


@dataclass
class GeneratorFacts:
    """One module's generator streams: the dotted names bound to a
    ``torch.Generator(...)`` (``.manual_seed(s)`` chained or not) and the
    dotted names registered with a CUDA graph."""

    generators: Set[str] = field(default_factory=set)
    registered: Set[str] = field(default_factory=set)


@dataclass
class ModuleRecord:
    """One parsed file: name resolution material for the index."""

    name: str
    path: str
    tree: ast.Module
    # import alias -> imported module dotted name (``import a.b as c``)
    mod_aliases: Dict[str, str] = field(default_factory=dict)
    # local name -> (module, symbol) for ``from a.b import f as g``
    sym_imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    # qualname ("f" | "Cls.m") -> def node, top-level and class methods
    functions: Dict[str, ast.AST] = field(default_factory=dict)
    # module-level NAME = "literal" string constants (mesh-axis idiom)
    str_constants: Dict[str, str] = field(default_factory=dict)
    # module-level NAME = literal int constants (config-dim idiom:
    # EMBED = 512 — the shape interpreter resolves these to dims)
    int_constants: Dict[str, int] = field(default_factory=dict)
    generators: GeneratorFacts = field(default_factory=GeneratorFacts)

    def qualname_of(self, node: ast.AST) -> Optional[str]:
        for qual, fn in self.functions.items():
            if fn is node:
                return qual
        return None


def _positional_names(fn: ast.AST) -> List[str]:
    a = fn.args
    return [p.arg for p in list(getattr(a, "posonlyargs", [])) + list(a.args)]


def _tensor_root(expr: ast.expr) -> Optional[str]:
    """The name a tensor expression computes from: ``t``, ``t.sum()``,
    ``t[0].float()`` -> ``t`` (None for anything else)."""
    while True:
        if isinstance(expr, ast.Name):
            return expr.id
        if isinstance(expr, ast.Call) and isinstance(expr.func,
                                                     ast.Attribute):
            expr = expr.func.value
        elif isinstance(expr, (ast.Attribute, ast.Subscript)):
            if isinstance(expr, ast.Attribute) and expr.attr in (
                    "shape", "dtype", "device", "ndim"):
                return None
            expr = expr.value
        else:
            return None


def generator_names(expr: ast.expr) -> Set[str]:
    """Dotted names of the generators an expression lists (a lambda's
    body, a tuple or list, a single name, ``self.x``)."""
    if isinstance(expr, ast.Lambda):
        expr = expr.body
    elts = expr.elts if isinstance(expr, (ast.Tuple, ast.List)) else [expr]
    out = set()
    for e in elts:
        if isinstance(e, ast.Starred):
            e = e.value
        name = dotted_name(e)
        if name is not None:
            out.add(name)
    return out


def _generator_facts(tree: ast.Module) -> GeneratorFacts:
    facts = GeneratorFacts()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            value = node.value
            # torch.Generator(...).manual_seed(s) is a generator too
            while isinstance(value, ast.Call) and isinstance(
                    value.func, ast.Attribute) \
                    and value.func.attr == "manual_seed":
                value = value.func.value
            if isinstance(value, ast.Call) \
                    and dotted_name(value.func) in GENERATOR_CTORS:
                for tgt in node.targets:
                    name = dotted_name(tgt)
                    if name is not None:
                        facts.generators.add(name)
        if not isinstance(node, ast.Call):
            continue
        callee = dotted_name(node.func) or ""
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr == "register_generator_state" \
                and node.args:
            facts.registered |= generator_names(node.args[0])
        if callee in CAPTURE_WRAPPERS:
            for kw in node.keywords:
                if kw.arg == "generators":
                    facts.registered |= generator_names(kw.value)
    return facts


def _index_module(name: str, path: str, tree: ast.Module) -> ModuleRecord:
    rec = ModuleRecord(name, path, tree)
    pkg = name.rsplit(".", 1)[0] if "." in name else ""
    # imports anywhere in the file (the port lazy-imports torch.distributed
    # and heavy modules inside functions; those resolve the same way)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                rec.mod_aliases[alias.asname or alias.name.split(".")[0]] = (
                    alias.name if alias.asname else alias.name.split(".")[0])
                if alias.asname is None:
                    # ``import a.b.c`` binds ``a``; dotted uses are
                    # resolved against the full path by the caller
                    rec.mod_aliases[alias.name] = alias.name
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                # relative import: strip (level-1) package components
                anchor = name.rsplit(".", node.level)[0] if \
                    name.count(".") >= node.level else pkg
                base = f"{anchor}.{base}" if base else anchor
            for alias in node.names:
                if alias.name == "*":
                    continue
                rec.sym_imports[alias.asname or alias.name] = (base,
                                                               alias.name)
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt = node.targets[0]
            if isinstance(tgt, ast.Name) and isinstance(node.value,
                                                        ast.Constant):
                if isinstance(node.value.value, str):
                    rec.str_constants[tgt.id] = node.value.value
                elif type(node.value.value) is int:
                    rec.int_constants[tgt.id] = node.value.value
    for node in tree.body:
        if isinstance(node, _FUNC_TYPES):
            rec.functions[node.name] = node
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, _FUNC_TYPES):
                    rec.functions[f"{node.name}.{sub.name}"] = sub
    rec.generators = _generator_facts(tree)
    return rec


class ProgramIndex:
    """Cross-module resolution + propagated facts over a set of files."""

    def __init__(self):
        self.modules: Dict[str, ModuleRecord] = {}
        self._by_path: Dict[str, ModuleRecord] = {}
        self.summaries: Dict[FuncKey, FuncSummary] = {}
        self.extern_captured: Set[FuncKey] = set()
        self.loop_reachable: Set[FuncKey] = set()

    # -- construction ------------------------------------------------------
    @classmethod
    def build(cls, parsed: Sequence[Tuple[str, ast.Module]]
              ) -> "ProgramIndex":
        """Index ``(path, tree)`` pairs (each file parsed exactly once by
        the caller) and run every propagation to fixpoint."""
        idx = cls()
        for path, tree in parsed:
            name = module_name_for(path)
            if name in idx.modules:
                # two standalone scripts sharing a stem: disambiguate
                # instead of clobbering, so each file's facts resolve
                # against ITS OWN record (the suffixed name is unimportable,
                # so nothing resolves a call INTO it by name)
                name = f"{name}@{len(idx.modules)}"
            rec = _index_module(name, path, tree)
            idx.modules[name] = rec
            idx._by_path[os.path.abspath(path)] = rec
        idx._compute_summaries()
        idx._compute_loop_reachable()
        return idx

    def record_for(self, path: str) -> Optional[ModuleRecord]:
        return self._by_path.get(os.path.abspath(path))

    # -- name resolution ---------------------------------------------------
    def resolve_call(self, module: str, callee: str,
                     cls: Optional[str] = None) -> Optional[FuncKey]:
        """Resolve a dotted callee seen in ``module`` to a linted
        function: bare imported symbols, ``alias.func`` / full dotted
        module paths, same-module functions, and ``self.m`` /``cls.m``
        methods when ``cls`` (the enclosing class) is given."""
        rec = self.modules.get(module)
        if rec is None or not callee:
            return None
        if "." not in callee:
            if callee in rec.sym_imports:
                tmod, sym = rec.sym_imports[callee]
                return self._lookup(tmod, sym)
            if callee in rec.functions:
                return (module, callee)
            return None
        head, rest = callee.split(".", 1)
        if head in ("self", "cls") and cls is not None and "." not in rest:
            if f"{cls}.{rest}" in rec.functions:
                return (module, f"{cls}.{rest}")
            return None
        if head in rec.sym_imports and "." not in rest:
            # ``from a import b`` then ``b.func()`` — b is a module
            tmod, sym = rec.sym_imports[head]
            return self._lookup(f"{tmod}.{sym}", rest)
        if head in rec.mod_aliases:
            target = rec.mod_aliases[head]
            if "." in rest:
                mod_part, fn_part = rest.rsplit(".", 1)
                return self._lookup(f"{target}.{mod_part}", fn_part)
            return self._lookup(target, rest)
        # full dotted path (``import a.b.c`` style use)
        mod_part, fn_part = callee.rsplit(".", 1)
        return self._lookup(mod_part, fn_part)

    def _lookup(self, module: str, func: str) -> Optional[FuncKey]:
        rec = self.modules.get(module)
        if rec is not None and func in rec.functions:
            return (module, func)
        return None

    def resolve_str_constant(self, module: str, name: str) -> Optional[str]:
        """``TENSOR_AXIS`` -> ``"tensor"``, following one from-import hop."""
        rec = self.modules.get(module)
        if rec is None:
            return None
        if name in rec.str_constants:
            return rec.str_constants[name]
        if name in rec.sym_imports:
            tmod, sym = rec.sym_imports[name]
            trec = self.modules.get(tmod)
            if trec is not None:
                return trec.str_constants.get(sym)
        return None

    def resolve_int_constant(self, module: str, name: str) -> Optional[int]:
        """``EMBED`` -> ``512``, following one from-import hop (mirror of
        :meth:`resolve_str_constant` for the shape interpreter)."""
        rec = self.modules.get(module)
        if rec is None:
            return None
        if name in rec.int_constants:
            return rec.int_constants[name]
        if name in rec.sym_imports:
            tmod, sym = rec.sym_imports[name]
            trec = self.modules.get(tmod)
            if trec is not None:
                return trec.int_constants.get(sym)
        return None

    def summary_for_call(self, module: str, callee: str,
                         cls: Optional[str] = None
                         ) -> Optional[Tuple[FuncKey, FuncSummary]]:
        key = self.resolve_call(module, callee, cls)
        if key is None:
            return None
        summ = self.summaries.get(key)
        return (key, summ) if summ is not None else None

    def _positions(self, key: FuncKey, callee: str,
                   n_args: int) -> Tuple[List[int], Dict[str, int]]:
        """Map a call's positional/keyword arguments to the target's
        parameter indices (``self.m(...)`` shifts by the bound self)."""
        fn = self._func_node(key)
        params = _positional_names(fn)
        skip = 1 if (callee.split(".", 1)[0] in ("self", "cls")
                     and params[:1] in (["self"], ["cls"])) else 0
        pos = [j + skip for j in range(n_args)]
        kw = {name: i for i, name in enumerate(params)}
        return pos, kw

    def call_syncs_tainted(self, module: str, callee: str,
                           arg_taints: Sequence[bool],
                           kw_taints: Dict[Optional[str], bool],
                           cls: Optional[str] = None) -> Optional[str]:
        """Does this call hand a TENSOR argument to a parameter the
        target (possibly in another module) reads on the host? Returns
        the qualified target name when so, else None."""
        resolved = self.summary_for_call(module, callee, cls)
        if resolved is None or not resolved[1].sync_params:
            return None
        key, summ = resolved
        pos, kw_index = self._positions(key, callee, len(arg_taints))
        for j, tainted in enumerate(arg_taints):
            if tainted and pos[j] in summ.sync_params:
                return f"{key[0]}.{key[1]}"
        for name, tainted in kw_taints.items():
            if tainted and name is not None \
                    and kw_index.get(name) in summ.sync_params:
                return f"{key[0]}.{key[1]}"
        return None

    def call_draws_from(self, module: str, callee: str, arg_pos: int,
                        kw_name: Optional[str],
                        cls: Optional[str] = None) -> bool:
        """Does the argument at ``arg_pos`` (or keyword ``kw_name``) of
        this call land on a parameter the target draws random numbers
        from (its ``generator=``)? (JG003 cross-module draws.)"""
        resolved = self.summary_for_call(module, callee, cls)
        if resolved is None or not resolved[1].gen_params:
            return False
        key, summ = resolved
        if kw_name is not None:
            _, kw_index = self._positions(key, callee, 0)
            return kw_index.get(kw_name) in summ.gen_params
        pos, _ = self._positions(key, callee, arg_pos + 1)
        return pos[arg_pos] in summ.gen_params

    def generator_facts(self, module: str) -> GeneratorFacts:
        rec = self.modules.get(module)
        return rec.generators if rec is not None else GeneratorFacts()

    # -- summaries ---------------------------------------------------------
    def _func_node(self, key: FuncKey) -> Optional[ast.AST]:
        rec = self.modules.get(key[0])
        return rec.functions.get(key[1]) if rec else None

    def _enclosing_class(self, rec: ModuleRecord, qual: str) -> Optional[str]:
        return qual.split(".", 1)[0] if "." in qual else None

    def _own(self, key: FuncKey) -> List[ast.AST]:
        """The function's own Call and Return nodes, collected once."""
        nodes = self._own_nodes.get(key)
        if nodes is None:
            nodes = self._own_nodes[key] = [
                n for n in iter_own_statements(self._func_node(key))
                if isinstance(n, (ast.Call, ast.Return))]
        return nodes

    def _compute_summaries(self) -> None:
        self._own_nodes: Dict[FuncKey, List[ast.AST]] = {}
        keys = [(m, q) for m, rec in self.modules.items()
                for q in rec.functions]
        self.summaries = {k: FuncSummary() for k in keys}
        for key in keys:
            self._direct_summary(key)
        # fixpoint: facts flow backwards through call argument positions
        changed = True
        rounds = 0
        while changed and rounds < 20:
            changed = False
            rounds += 1
            for key in keys:
                if self._propagate_summary(key):
                    changed = True

    def _param_index(self, fn: ast.AST, name: str) -> Optional[int]:
        try:
            return _positional_names(fn).index(name)
        except ValueError:
            return None

    def _direct_summary(self, key: FuncKey) -> None:
        fn = self._func_node(key)
        summ = self.summaries[key]
        pset = set(_positional_names(fn))
        for node in self._own(key):
            if isinstance(node, ast.Return) and node.value is not None:
                built = self._program_expr(node.value, fn)
                if built is not None:
                    summ.returns_program = True
                    summ.returns_graph |= built in CAPTURE_WRAPPERS
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            read = []
            if callee in HOST_CONVERTERS:
                read = list(node.args)
            elif (isinstance(node.func, ast.Attribute)
                    and node.func.attr in HOST_METHODS):
                read = [node.func.value]
            for arg in read:
                root = _tensor_root(arg)
                if root is not None and root in pset:
                    i = self._param_index(fn, root)
                    if i is not None:
                        summ.sync_params.add(i)
            if callee and callee.startswith("torch."):
                for kw in node.keywords:
                    if kw.arg == "generator" and isinstance(kw.value,
                                                            ast.Name) \
                            and kw.value.id in pset:
                        i = self._param_index(fn, kw.value.id)
                        if i is not None:
                            summ.gen_params.add(i)

    def _program_expr(self, expr: ast.expr, fn: ast.AST) -> Optional[str]:
        """The builder when the value is a fresh program wrapper: a direct
        builder call or a local name bound to one anywhere in ``fn``."""
        if isinstance(expr, ast.Call):
            name = dotted_name(expr.func)
            return name if name in WRAPPER_BUILDERS else None
        if isinstance(expr, ast.Name):
            for node in iter_own_statements(fn):
                if (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Call)
                        and dotted_name(node.value.func) in WRAPPER_BUILDERS):
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name) and tgt.id == expr.id:
                            return dotted_name(node.value.func)
        return None

    def _propagate_summary(self, key: FuncKey) -> bool:
        mod, qual = key
        rec = self.modules[mod]
        fn = rec.functions[qual]
        summ = self.summaries[key]
        cls = self._enclosing_class(rec, qual)
        pset = set(_positional_names(fn))
        changed = False
        for node in self._own(key):
            if isinstance(node, ast.Return) and node.value is not None \
                    and isinstance(node.value, ast.Call):
                resolved = self.summary_for_call(
                    mod, dotted_name(node.value.func) or "", cls)
                if resolved is not None and resolved[1].returns_program \
                        and not summ.returns_program:
                    summ.returns_program = changed = True
                if resolved is not None and resolved[1].returns_graph \
                        and not summ.returns_graph:
                    summ.returns_graph = changed = True
            if not isinstance(node, ast.Call):
                continue
            resolved = self.summary_for_call(mod,
                                             dotted_name(node.func) or "",
                                             cls)
            if resolved is None:
                continue
            tkey, tsumm = resolved
            tfn = self._func_node(tkey)
            if not (tsumm.sync_params or tsumm.gen_params):
                continue
            skip_self = 1 if (isinstance(node.func, ast.Attribute)
                              and isinstance(node.func.value, ast.Name)
                              and node.func.value.id in ("self", "cls")
                              and _positional_names(tfn)[:1] == ["self"]
                              ) else 0
            for j, arg in enumerate(node.args):
                if not (isinstance(arg, ast.Name) and arg.id in pset):
                    continue
                i = self._param_index(fn, arg.id)
                if i is None:
                    continue
                if j + skip_self in tsumm.sync_params \
                        and i not in summ.sync_params:
                    summ.sync_params.add(i)
                    changed = True
                if j + skip_self in tsumm.gen_params \
                        and i not in summ.gen_params:
                    summ.gen_params.add(i)
                    changed = True
        return changed

    # -- captured-context propagation --------------------------------------
    def seed_captured(self, per_file_captured: Dict[str, List[ast.AST]]
                      ) -> None:
        """Fixpoint the externally-captured set from each module's locally
        captured functions (``per_file_captured``: module name -> captured
        def nodes from its CaptureIndex)."""
        work: List[Tuple[str, ast.AST]] = []
        for mod, fns in per_file_captured.items():
            for fn in fns:
                work.append((mod, fn))
        seen_nodes: Set[int] = {id(fn) for _, fn in work}
        while work:
            mod, fn = work.pop()
            rec = self.modules.get(mod)
            if rec is None:
                continue
            qual = rec.qualname_of(fn)
            cls = self._enclosing_class(rec, qual) if qual else None
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                target = self.resolve_call(mod, dotted_name(node.func) or "",
                                           cls)
                if target is None or target in self.extern_captured:
                    continue
                tnode = self._func_node(target)
                if tnode is None:
                    continue
                self.extern_captured.add(target)
                if id(tnode) not in seen_nodes:
                    seen_nodes.add(id(tnode))
                    work.append((target[0], tnode))

    def extern_captured_names(self, module: str) -> Set[str]:
        """Qualnames in ``module`` captured from another module's body."""
        return {q for m, q in self.extern_captured if m == module}

    # -- loop reachability --------------------------------------------------
    def _compute_loop_reachable(self) -> None:
        loops = (ast.For, ast.While, ast.ListComp, ast.SetComp, ast.DictComp,
                 ast.GeneratorExp)
        work: List[FuncKey] = []
        for mod, rec in self.modules.items():
            for qual, fn in rec.functions.items():
                cls = self._enclosing_class(rec, qual)
                for node in iter_own_statements(fn):
                    if not isinstance(node, loops):
                        continue
                    for sub in ast.walk(node):
                        if not isinstance(sub, ast.Call):
                            continue
                        target = self.resolve_call(
                            mod, dotted_name(sub.func) or "", cls)
                        if target is not None \
                                and target not in self.loop_reachable:
                            self.loop_reachable.add(target)
                            work.append(target)
        while work:
            key = work.pop()
            fn = self._func_node(key)
            if fn is None:
                continue
            rec = self.modules[key[0]]
            cls = self._enclosing_class(rec, key[1])
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                target = self.resolve_call(key[0],
                                           dotted_name(node.func) or "", cls)
                if target is not None and target not in self.loop_reachable:
                    self.loop_reachable.add(target)
                    work.append(target)

    def called_from_loop(self, module: str, fn_node: ast.AST) -> bool:
        rec = self.modules.get(module)
        if rec is None:
            return False
        qual = rec.qualname_of(fn_node)
        return qual is not None and (module, qual) in self.loop_reachable
