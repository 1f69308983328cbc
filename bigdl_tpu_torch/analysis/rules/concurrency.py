"""JG015–JG017 — concurrency: unguarded shared state in thread-spawning
classes, lock-order inversions, and blocking device reads held under a
lock (counterpart of ``bigdl_tpu/analysis/rules/concurrency.py``; JG017's
blocking calls are the port's).

The port's ingest engine, router, serving engine and summary writers run
threads against client threads full time. These rules are static
races-by-construction checks, not a model checker: a *class that spawns
a thread* and writes the same ``self`` attribute from both the worker
closure and its public methods without any lock IS the bug, whatever the
interleaving. Locks are recognized
structurally (``threading.Lock()``/``RLock()`` assigned to a module
global, a class attribute, or ``self.<attr>``), acquisition only via
``with``.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from bigdl_tpu_torch.analysis.core import (_FUNC_TYPES, FileContext, Finding,
                                           Rule, dotted_name,
                                           iter_own_statements, register)

_LOCK_CTORS = {"Lock", "RLock"}
# attributes holding inherently thread-safe coordination objects: their
# method calls are not "unguarded writes"
_SYNC_CTORS = {"Lock", "RLock", "Event", "Condition", "Semaphore",
               "BoundedSemaphore", "Barrier", "Queue", "LifoQueue",
               "PriorityQueue", "SimpleQueue", "deque", "local"}
# method calls that mutate common containers in place
_MUTATORS = {"append", "appendleft", "extend", "insert", "remove", "pop",
             "popleft", "popitem", "clear", "update", "setdefault", "add",
             "discard"}
# blocking device reads: a copy to the host, or a wait on the card
_SYNC_METHODS = {"synchronize"}
_HOST_PULLS = {"item", "tolist", "cpu"}
_SYNC_CALLS = {"torch.cuda.synchronize", "cuda.synchronize"}


def _ctor_last(expr: ast.expr) -> Optional[str]:
    if isinstance(expr, ast.Call):
        name = dotted_name(expr.func)
        if name is not None:
            return name.rsplit(".", 1)[-1]
    return None


def _self_attr(node: ast.expr) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


class _Locks:
    """Known lock objects in a module: globals, class/instance attrs,
    and function locals, each with a stable identity key."""

    def __init__(self, ctx: FileContext):
        self.ctx = ctx
        self.module_locks: Set[str] = set()
        self.class_locks: Dict[str, Set[str]] = {}   # class -> attr names
        self.local_locks: Dict[int, Set[str]] = {}   # id(fn) -> names
        # class name -> {method name -> def node} (shared by the rules)
        self.class_methods: Dict[str, Dict[str, ast.AST]] = {}
        for node in ctx.walk():
            if isinstance(node, ast.ClassDef):
                self.class_methods[node.name] = {
                    m.name: m for m in node.body
                    if isinstance(m, _FUNC_TYPES)}
            if not isinstance(node, ast.Assign):
                continue
            if _ctor_last(node.value) not in _LOCK_CTORS:
                continue
            for tgt in node.targets:
                attr = _self_attr(tgt)
                if attr is not None:
                    cls = self._enclosing_class(node)
                    if cls is not None:
                        self.class_locks.setdefault(cls, set()).add(attr)
                elif isinstance(tgt, ast.Name):
                    fn = self._enclosing_fn(node)
                    if fn is None:
                        self.module_locks.add(tgt.id)
                        cls = self._enclosing_class(node)
                        if cls is not None:
                            self.class_locks.setdefault(cls, set()).add(
                                tgt.id)
                    else:
                        self.local_locks.setdefault(id(fn), set()).add(
                            tgt.id)

    def _enclosing_class(self, node: ast.AST) -> Optional[str]:
        cur = self.ctx.capture_index.parent.get(node)
        while cur is not None:
            if isinstance(cur, ast.ClassDef):
                return cur.name
            cur = self.ctx.capture_index.parent.get(cur)
        return None

    def _enclosing_fn(self, node: ast.AST) -> Optional[ast.AST]:
        cur = self.ctx.capture_index.parent.get(node)
        while cur is not None and not isinstance(cur, _FUNC_TYPES):
            cur = self.ctx.capture_index.parent.get(cur)
        return cur

    def lock_key(self, expr: ast.expr, fn: ast.AST,
                 cls: Optional[str]) -> Optional[str]:
        """Identity key of the lock a ``with`` item acquires, or None."""
        attr = _self_attr(expr)
        if attr is not None and cls is not None \
                and attr in self.class_locks.get(cls, ()):
            return f"{cls}.{attr}"
        if isinstance(expr, ast.Name):
            cur: Optional[ast.AST] = fn
            while cur is not None:
                if expr.id in self.local_locks.get(id(cur), ()):
                    return f"<local:{id(cur)}>.{expr.id}"
                cur = self._enclosing_fn(cur)
            if expr.id in self.module_locks:
                return f"<module>.{expr.id}"
            if cls is not None and expr.id in self.class_locks.get(cls, ()):
                return f"{cls}.{expr.id}"
        name = dotted_name(expr)
        if name is not None and "." in name:
            head, attr = name.rsplit(".", 1)
            if attr in self.class_locks.get(head, ()):
                return f"{head}.{attr}"
        return None

    def held_at(self, node: ast.AST, fn: ast.AST,
                cls: Optional[str]) -> List[str]:
        """Locks whose ``with`` lexically encloses ``node`` inside
        ``fn``."""
        out: List[str] = []
        cur = self.ctx.capture_index.parent.get(node)
        while cur is not None and cur is not fn:
            if isinstance(cur, ast.With):
                for item in cur.items:
                    key = self.lock_key(item.context_expr, fn, cls)
                    if key is not None:
                        out.append(key)
            if isinstance(cur, (*_FUNC_TYPES, ast.Lambda)):
                break
            cur = self.ctx.capture_index.parent.get(cur)
        return out


def _attr_writes(fn: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    """(attr, node) for every mutation of ``self.<attr>`` in ``fn``'s own
    statements: rebinds, subscript stores/deletes, aug-assigns, and
    in-place mutator calls."""
    for node in iter_own_statements(fn):
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                elts = tgt.elts if isinstance(tgt, (ast.Tuple, ast.List)) \
                    else [tgt]
                for elt in elts:
                    attr = _self_attr(elt)
                    if attr is not None:
                        yield attr, node
                    elif isinstance(elt, ast.Subscript):
                        attr = _self_attr(elt.value)
                        if attr is not None:
                            yield attr, node
        elif isinstance(node, ast.Delete):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript):
                    attr = _self_attr(tgt.value)
                    if attr is not None:
                        yield attr, node
        elif isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Attribute) \
                and node.func.attr in _MUTATORS:
            attr = _self_attr(node.func.value)
            if attr is not None:
                yield attr, node


class _ClassThreads:
    """Per-class view: methods, worker closure (functions that run on
    threads the class spawns), and sync-safe attributes."""

    def __init__(self, ctx: FileContext, node: ast.ClassDef):
        self.ctx = ctx
        self.node = node
        self.methods: Dict[str, ast.AST] = {
            n.name: n for n in node.body if isinstance(n, _FUNC_TYPES)}
        self.sync_attrs: Set[str] = set()
        self.targets: List[ast.AST] = []
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign) \
                    and _ctor_last(sub.value) in _SYNC_CTORS:
                for tgt in sub.targets:
                    attr = _self_attr(tgt)
                    if attr is not None:
                        self.sync_attrs.add(attr)
            if isinstance(sub, ast.Call):
                callee = dotted_name(sub.func) or ""
                if callee.rsplit(".", 1)[-1] != "Thread":
                    continue
                for kw in sub.keywords:
                    if kw.arg != "target":
                        continue
                    attr = _self_attr(kw.value)
                    if attr is not None and attr in self.methods:
                        self.targets.append(self.methods[attr])
                    elif isinstance(kw.value, ast.Name):
                        for fn in ctx.capture_index.resolve_name(kw.value.id,
                                                              sub):
                            self.targets.append(fn)

    def worker_closure(self) -> Set[int]:
        """ids of function nodes running on spawned threads: the targets
        plus every method reachable from them via ``self.m()`` calls."""
        work = list(self.targets)
        seen: Set[int] = {id(fn) for fn in work}
        while work:
            fn = work.pop()
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    attr = None
                    if isinstance(node.func, ast.Attribute):
                        attr = _self_attr(node.func)
                    if attr is not None and attr in self.methods:
                        m = self.methods[attr]
                        if id(m) not in seen:
                            seen.add(id(m))
                            work.append(m)
        return seen


@register
class UnguardedSharedStateRule(Rule):
    """A class that spawns a ``threading.Thread`` and mutates the same
    ``self`` attribute from both the worker's call closure and its
    other (client-called) methods, with any of those writes outside a
    lock, races by construction: torn list/dict state, lost updates,
    double-frees of pooled slots. ``Event``/``Queue``/lock attributes
    are exempt (internally synchronized), as is ``__init__`` (runs
    before the thread starts). Guard every write of the shared
    attribute with one lock.
    """

    code = "JG015"
    summary = ("attribute written by both the worker thread and other "
               "methods of a thread-spawning class without a lock")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        locks = _locks_for(ctx)
        for cnode in ctx.walk():
            if not isinstance(cnode, ast.ClassDef):
                continue
            info = _ClassThreads(ctx, cnode)
            if not info.targets:
                continue
            workers = info.worker_closure()
            # units: (fn node, is_worker), nested defs inherit the side
            # unless they ARE a thread target
            units: List[Tuple[ast.AST, bool]] = []
            for name, m in info.methods.items():
                if name == "__init__":
                    continue
                units.append((m, id(m) in workers))
            expanded: List[Tuple[ast.AST, bool]] = []
            while units:
                fn, side = units.pop()
                expanded.append((fn, side))
                for node in iter_own_statements(fn):
                    if isinstance(node, _FUNC_TYPES):
                        units.append((node, side or id(node) in workers))
            writes: Dict[str, List[Tuple[bool, bool, ast.AST]]] = {}
            for fn, is_worker in expanded:
                for attr, wnode in _attr_writes(fn):
                    if attr in info.sync_attrs:
                        continue
                    locked = bool(locks.held_at(wnode, fn, cnode.name))
                    writes.setdefault(attr, []).append(
                        (is_worker, locked, wnode))
            for attr, sites in sorted(writes.items()):
                if not ({w for w, _, _ in sites} == {True, False}):
                    continue  # one-sided: not shared across threads
                unlocked = sorted((n for _, lk, n in sites if not lk),
                                  key=lambda n: n.lineno)
                if not unlocked:
                    continue
                yield self.finding(
                    ctx, unlocked[0],
                    f"'self.{attr}' of thread-spawning class "
                    f"'{cnode.name}' is written by both the worker "
                    f"thread and other methods, and this write holds no "
                    f"lock — guard every mutation of '{attr}' with one "
                    f"lock")


@register
class LockOrderInversionRule(Rule):
    """Two locks acquired in opposite orders on two code paths (directly
    nested ``with``, or a call made under one lock into code that takes
    the other) can deadlock the moment both paths run concurrently —
    exactly the serving-scrapes-telemetry-while-telemetry-calls-serving
    shape. Keep a global acquisition order, or narrow one critical
    section until it no longer calls out.
    """

    code = "JG016"
    summary = ("lock-order inversion: two locks are acquired in opposite "
               "orders on different paths")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        locks = _locks_for(ctx)
        idx = ctx.capture_index
        acquires_cache: Dict[int, Set[str]] = {}

        def acquires_all(fn: ast.AST, stack: Set[int]) -> Set[str]:
            if id(fn) in acquires_cache:
                return acquires_cache[id(fn)]
            if id(fn) in stack:
                return set()
            stack = stack | {id(fn)}
            cls = idx.enclosing_class_name(fn)
            out: Set[str] = set()
            for node in iter_own_statements(fn):
                if isinstance(node, ast.With):
                    for item in node.items:
                        key = locks.lock_key(item.context_expr, fn, cls)
                        if key is not None:
                            out.add(key)
                elif isinstance(node, ast.Call):
                    for callee in _resolve_local(ctx, node, cls):
                        out |= acquires_all(callee, stack)
            acquires_cache[id(fn)] = out
            return out

        # edges: held -> acquired, with the acquiring node for anchoring
        edges: Dict[Tuple[str, str], ast.AST] = {}
        for fn in idx.functions:
            cls = idx.enclosing_class_name(fn)
            for node in iter_own_statements(fn):
                if not isinstance(node, ast.With):
                    continue
                held = [locks.lock_key(i.context_expr, fn, cls)
                        for i in node.items]
                held = [h for h in held if h is not None]
                if not held:
                    continue
                for sub in iter_own_statements(node):
                    inner: Set[str] = set()
                    if isinstance(sub, ast.With):
                        for item in sub.items:
                            key = locks.lock_key(item.context_expr, fn, cls)
                            if key is not None:
                                inner.add(key)
                    elif isinstance(sub, ast.Call):
                        for callee in _resolve_local(ctx, sub, cls):
                            inner |= acquires_all(callee, set())
                    for h in held:
                        for a in inner:
                            if a != h:
                                edges.setdefault((h, a), sub)
        reported: Set[Tuple[str, str]] = set()
        for (a, b), node in sorted(edges.items(),
                                   key=lambda kv: kv[1].lineno):
            if (b, a) in edges and (b, a) not in reported:
                reported.add((a, b))
                yield self.finding(
                    ctx, node,
                    f"lock '{_pretty(b)}' is acquired while holding "
                    f"'{_pretty(a)}' here, but another path acquires "
                    f"them in the opposite order — a deadlock the first "
                    f"time both run concurrently; pick one order")


@register
class DeviceSyncUnderLockRule(Rule):
    """``.item()`` / ``.tolist()`` / ``.cpu()`` /
    ``torch.cuda.synchronize()`` / ``Event.synchronize()`` under a held
    lock pins every thread contending for that lock behind a device
    round-trip (milliseconds to seconds while a decode block drains) —
    the metrics scrape stalls the serving loop. Copy the handle under the
    lock and read it after releasing it.
    """

    code = "JG017"
    summary = ("blocking device read (.item/.tolist/.cpu/"
               "torch.cuda.synchronize/Event.synchronize) under a lock")

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        locks = _locks_for(ctx)
        idx = ctx.capture_index
        for fn in idx.functions:
            cls = idx.enclosing_class_name(fn)
            for node in iter_own_statements(fn):
                if not isinstance(node, ast.Call):
                    continue
                detail = None
                callee = dotted_name(node.func) or ""
                if isinstance(node.func, ast.Attribute) \
                        and node.func.attr in (_SYNC_METHODS | _HOST_PULLS):
                    detail = f".{node.func.attr}()"
                elif callee in _SYNC_CALLS:
                    detail = f"{callee}()"
                if detail is None:
                    continue
                held = locks.held_at(node, fn, cls)
                if held:
                    yield self.finding(
                        ctx, node,
                        f"{detail} blocks on the device while holding "
                        f"lock '{_pretty(held[0])}' — every contending "
                        f"thread stalls behind the transfer; copy the "
                        f"handle under the lock and sync outside it")


def _locks_for(ctx: FileContext) -> _Locks:
    """One shared lock index per file (JG015/16/17 all consume it)."""
    return ctx.rule_cache("concurrency._Locks", lambda: _Locks(ctx))


def _resolve_local(ctx: FileContext, call: ast.Call,
                   cls: Optional[str]) -> List[ast.AST]:
    """Call targets within this module: lexically visible ``name()``
    defs and same-class ``self.m()`` methods."""
    if isinstance(call.func, ast.Name):
        return list(ctx.capture_index.resolve_name(call.func.id, call))
    attr = _self_attr(call.func) if isinstance(call.func,
                                               ast.Attribute) else None
    if attr is not None and cls is not None:
        m = _locks_for(ctx).class_methods.get(cls, {}).get(attr)
        return [m] if m is not None else []
    return []


def _pretty(key: str) -> str:
    return key.split(".", 1)[-1] if key.startswith("<local:") else key
