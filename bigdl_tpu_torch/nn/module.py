"""BigDL-style module base over ``torch.nn.Module``.

Counterpart of ``bigdl_tpu/nn/module.py``. The JAX package splits module
objects from a pure ``functional_apply`` so that XLA can trace them; PyTorch
runs eagerly, so the port keeps only the object half: subclasses implement
``forward``, hold weights as parameters and decode state (KV caches,
positions) as module state, and keep the reference's ``evaluate_mode()``
and ``name`` (the class name unless ``set_name`` gives another; ``Graph``
names its children by it).

Per-parameter regularizers (the reference's ``wRegularizer`` /
``bRegularizer``) ride on ``register_parameter``'s third argument;
``Optimizer`` adds their loss to the training loss.

Per-module timing (the reference's ``getTimes``): ``enable_timing()``
installs PyTorch's global module hooks, so with timing off a forward runs
no extra code at all. With it on, every port module's forward is timed on
the host clock between two ``torch.cuda.synchronize()`` calls when CUDA is
in use (a clock around an asynchronous launch would time the launch), and
its backward from the moment the gradient of its output is complete to
the moment the gradient of its input is: each floating-point input passes
through an identity ``torch.autograd.Function`` whose backward stops the
clock, so that input's gradient is computed even where nothing else asks
for it. A module whose input holds no floating-point tensor (a lookup of
ids) has no backward time. A container's times include its children's.

The reference's instance surface is here too, over torch's own
``parameters``, ``named_modules``, ``modules``, ``train``, ``eval``,
``apply`` and ``zero_grad``, which it leaves as they are (they return
generators where the reference returns lists, and ``named_modules``
names the root ``""``):

- ``parameter_tree()`` / ``buffer_tree()``: nested dicts of the live
  tensors under the reference's keys; ``load_parameter_tree`` /
  ``load_buffer_tree`` copy numpy arrays or tensors into them IN PLACE
  (the reference rebinds), so optimiser state and CUDA-graph addresses
  stay valid. A model sharded over a tensor or expert axis holds, returns
  and loads its local shards; ``interop.state_dict.export_tree_state``
  gathers.
- ``get_parameters()``: ``(flat, unravel)`` as ``jax.flatten_util
  .ravel_pytree`` gives it, in JAX's leaf order (keys sorted as strings at
  every level: child ``"10"`` before ``"2"``); ``n_parameters()``,
  ``summary()``.
- ``output`` / ``grad_input``: a call of a port module records its
  ``output``, as the reference's ``forward`` does, where the user made
  it. The outermost port-module call on a thread decides for the whole
  call tree: it records when no frame of this package is on the
  thread's stack (so the port's own loops, training, evaluation,
  generation, serving, the pipeline schedules, a rematerialized forward,
  record nothing, as the reference's run through ``functional_apply``,
  which clears them: a recorded output would hold its activations alive
  until the next call). ``record_outputs(False)`` turns it off for a
  user's own loop.
- ``backward(input, grad_output)``: the input gradient by autograd over a
  re-run forward, parameters' ``.grad`` and buffers left as they were;
  ``predict`` / ``predict_class`` / ``evaluate``; ``clone_module``;
  ``find_module``, ``apply_to_modules``, ``reset`` and the mode switches.
"""

from __future__ import annotations

import contextlib
import copy
import functools
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.nn.modules import module as _torch_module


class _Recording(threading.local):
    on = True          # ``record_outputs``' switch
    active = None      # the decision of the outermost call running here


_RECORDING = _Recording()
_PACKAGE = __name__.split(".")[0]


@contextlib.contextmanager
def record_outputs(on: bool = True):
    """Whether the port modules' calls that the user makes on this thread
    within the block record their ``output`` (on by default); a decorator
    too. The port's own loops never record."""
    prev = _RECORDING.on
    _RECORDING.on = on
    try:
        yield
    finally:
        _RECORDING.on = prev


def _called_by_user() -> bool:
    """Whether the stack above the outermost port-module call holds no
    frame of this package and some frame outside torch (a forward that
    autograd replays on its own thread has none)."""
    outside = False
    f = sys._getframe(2)
    while f is not None:
        mod = f.f_globals.get("__name__", "")
        if mod == _PACKAGE or mod.startswith(_PACKAGE + "."):
            return False
        if not (mod == "torch" or mod.startswith("torch.")):
            outside = True
        f = f.f_back
    return outside


def _clear_outputs(model: torch.nn.Module) -> None:
    for m in model.modules():
        if isinstance(m, Module):
            m.__dict__["output"] = None
            m.__dict__["grad_input"] = None


class Module(torch.nn.Module):
    """Base of every port module.

    ``enable_decode`` / ``disable_decode`` is the incremental-generation hook
    that ``models.generation.generate`` toggles: here it only flips
    ``_decode``; modules that keep decode state (``MultiHeadAttention``'s KV
    cache, ``PositionalEncoding``'s offset) extend it."""

    _decode = False

    #: caches that models attach through ``__dict__`` and that must not go
    #: with a model through ``copy.deepcopy`` or pickle (the reference's
    #: ``Module._EPHEMERAL_CACHES``): the serving engine's prefix trie holds
    #: KV snapshots and a thread lock; a block's ``_StreamBlock``
    #: (``nn/attention.py``), made again at first use
    _EPHEMERAL_CACHES = ("_prefix_trie", "_stream_block")

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.__dict__["output"] = None
        self.__dict__["grad_input"] = None

    def __call__(self, *args, **kwargs):
        rec = _RECORDING
        if rec.active is None:      # the outermost call on this thread
            rec.active = rec.on and _called_by_user()
            try:
                out = torch.nn.Module.__call__(self, *args, **kwargs)
                record = rec.active
            finally:
                rec.active = None
        else:
            out = torch.nn.Module.__call__(self, *args, **kwargs)
            record = rec.active
        if record:
            self.__dict__["output"] = out
        return out

    def __getstate__(self):
        d = self.__dict__.copy()
        for key in self._EPHEMERAL_CACHES:
            d.pop(key, None)
        # a recorded activation is not state (and a non-leaf tensor has
        # no deepcopy)
        for key in ("output", "grad_input"):
            if key in d:
                d[key] = None
        return d

    @property
    def name(self) -> str:
        """The module's name: the class name unless ``set_name`` gave
        another (reference ``Module.name``)."""
        return self.__dict__.get("_name") or type(self).__name__

    @name.setter
    def name(self, value: str) -> None:
        self.__dict__["_name"] = value

    def set_name(self, name: str) -> "Module":
        self.name = name
        return self

    def get_name(self) -> str:
        return self.name

    def evaluate_mode(self) -> "Module":
        return self.eval()

    def enable_decode(self) -> "Module":
        self._decode = True
        return self

    def disable_decode(self) -> "Module":
        self._decode = False
        return self

    # ------------------------------------------------------ regularizers
    def register_parameter(self, name: str, param, regularizer=None) -> None:
        """``torch.nn.Module.register_parameter``, and the reference's
        third argument: a ``Regularizer`` whose loss ``Optimizer`` adds to
        the training loss. A tensor that is not a ``Parameter`` is made
        one."""
        if param is not None and not isinstance(param, torch.nn.Parameter):
            param = torch.nn.Parameter(torch.as_tensor(param))
        super().register_parameter(name, param)
        regs = self.__dict__.setdefault("_param_regularizers", {})
        if regularizer is not None:
            regs[name] = regularizer
        else:
            regs.pop(name, None)

    def regularizer_tree(self) -> Dict[str, Any]:
        """``{name: Regularizer or None}`` over this module's parameters and
        ``{child: subtree}`` over its children with parameters (reference
        ``regularizer_tree``)."""
        regs = self.__dict__.get("_param_regularizers", {})
        tree: Dict[str, Any] = {n: regs.get(n)
                                for n in self._parameters}
        for name, child in self._modules.items():
            sub = child.regularizer_tree() if isinstance(child, Module) else {}
            if sub:
                tree[name] = sub
        return tree

    # ------------------------------------------------------------ timing
    def get_times(self) -> List[Tuple[torch.nn.Module, float, float]]:
        """``(module, forward_s, backward_s)`` of this module and, depth
        first, every descendant (reference ``get_times``); zeros until
        ``enable_timing()``."""
        out = [(self, self.__dict__.get("_forward_time", 0.0),
                self.__dict__.get("_backward_time", 0.0))]
        for child in self._modules.values():
            if isinstance(child, Module):
                out.extend(child.get_times())
        return out

    def reset_times(self) -> None:
        """Zero this module's and its descendants' times (reference
        ``reset_times``)."""
        for m in self.modules():
            m.__dict__["_forward_time"] = 0.0
            m.__dict__["_backward_time"] = 0.0

    def time_report(self) -> str:
        """``get_times()`` as a table (a debugging aid)."""
        lines = ["module                                  fwd(s)    bwd(s)"]
        for m, f, b in self.get_times():
            label = f"{type(m).__name__} ({getattr(m, 'name', '')})"
            lines.append(f"{label:38s} {f:8.4f}  {b:8.4f}")
        return "\n".join(lines)

    # ----------------------------------------------------------- the trees
    def parameter_tree(self) -> Dict[str, Any]:
        """``{name: parameter}`` of this module, and ``{child: subtree}``
        of each child holding one; ``None`` entries (a dropped bias) are
        left out. The leaves are the live parameters (reference
        ``parameter_tree``)."""
        return _tree(self, "_parameters")

    def buffer_tree(self) -> Dict[str, Any]:
        """``parameter_tree``'s counterpart over the buffers."""
        return _tree(self, "_buffers")

    def load_parameter_tree(self, tree: Dict[str, Any]) -> None:
        """Copy ``tree``'s numpy arrays or tensors into the parameters of
        the same keys, in place and without autograd; keys that are absent
        keep their values (reference ``load_parameter_tree``). Every shape
        is checked before anything is written."""
        _load(_targets(self, tree, "_parameters", ""))

    def load_buffer_tree(self, tree: Dict[str, Any]) -> None:
        """``load_parameter_tree``'s counterpart over the buffers."""
        _load(_targets(self, tree, "_buffers", ""))

    def functional_state(self) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """``(parameter_tree(), buffer_tree())``."""
        return self.parameter_tree(), self.buffer_tree()

    def get_parameters(self) -> Tuple[torch.Tensor, Callable]:
        """``(flat, unravel)``: every parameter in one new vector, in JAX's
        leaf order (keys sorted as strings at every level), in the
        promotion of their dtypes and on their device, and the function
        that gives a flat vector back as the nested tree with each leaf's
        shape and dtype (reference ``get_parameters``)."""
        items = list(_sorted_leaves(_tree(self, "_parameters")))
        if items:
            dtype = functools.reduce(torch.promote_types,
                                     [t.dtype for _, t in items])
            flat = torch.cat([t.detach().reshape(-1).to(dtype)
                              for _, t in items])
        else:
            flat = torch.zeros(0)
        specs = [(path, tuple(t.shape), t.dtype, t.numel())
                 for path, t in items]

        def unravel(vec: torch.Tensor) -> Dict[str, Any]:
            out: Dict[str, Any] = {}
            off = 0
            for path, shape, dt, n in specs:
                node = out
                for key in path[:-1]:
                    node = node.setdefault(key, {})
                node[path[-1]] = vec[off:off + n].reshape(shape).to(dt)
                off += n
            return out

        return flat, unravel

    def n_parameters(self) -> int:
        """The number of elements over ``parameter_tree()``'s leaves."""
        return _count(self)

    def summary(self, max_depth: int = 2) -> str:
        """Per-module parameter table to ``max_depth`` and the total, the
        reference's ``summary`` character for character."""
        lines = []

        def walk(mod, depth, label, copies):
            own, children = (mod._summary_view() if isinstance(mod, Module)
                             else _summary_view(mod))
            collapsed = depth >= max_depth or not children
            count = (_count(mod) if collapsed else own) // copies
            lines.append(f"{'  ' * depth}{label} ({type(mod).__name__})"
                         .ljust(52) + f"{count:>12,}")
            if depth < max_depth:
                for key, child, n in children:
                    name = _name_of(child)
                    label = name if name != type(child).__name__ \
                        else f"{key}:{name}"
                    walk(child, depth + 1, label, copies * n)

        walk(self, 0, self.name, 1)
        lines.append("-" * 64)
        lines.append(f"Total parameters: {self.n_parameters():,}")
        return "\n".join(lines)

    def _summary_view(self) -> Tuple[int, List[Tuple[str, Any, int]]]:
        """What ``summary`` shows of this module: its own parameters'
        count and ``(key, child, n)`` of its children, ``n`` the number of
        copies of the child's leaves stacked here (``PipelineStack``)."""
        return _summary_view(self)

    # ---------------------------------------------------- forward, backward
    def backward(self, input, grad_output):
        """The gradient of the output with respect to ``input`` (a tensor,
        a ``Table``, a list or a tuple) for ``grad_output``: the forward is
        run again, in the module's own mode, on detached copies of the
        input's floating-point tensors (a dropout mask is a fresh draw, as
        the reference's re-run under ``functional_apply`` draws anew) and
        autograd differentiates it. No parameter's ``.grad`` changes, and
        the buffers are put back as they were (a training-mode batch norm
        does not update its statistics twice). Sets and returns
        ``grad_input``, with ``None`` at non-floating entries; every
        module's ``output`` is cleared, as the reference's re-run
        clears it."""
        timing = bool(_TIMING_HANDLES)
        saved = ({m: (m.__dict__.get("_forward_time", 0.0),
                      m.__dict__.get("_backward_time", 0.0))
                  for m in self.modules()} if timing else None)
        t0 = _sync() if timing else 0.0
        leaves: List[torch.Tensor] = []

        def leaf(t):
            if not (torch.is_tensor(t) and t.is_floating_point()):
                return t
            t = t.detach().requires_grad_()
            leaves.append(t)
            return t

        x = _map_tensors(input, leaf)
        if not leaves:
            raise TypeError(
                f"{self.name}.backward: the input holds no floating-point "
                "tensor to differentiate with respect to")
        buffers = [(b, b.clone()) for b in self.buffers()]
        try:
            with torch.enable_grad():
                out = self(x)
        finally:
            with torch.no_grad():
                for b, old in buffers:
                    b.copy_(old)
        outs, grads = [], []
        for o, g in zip(_each_tensor(out), _each_tensor(grad_output)):
            if o.requires_grad:
                outs.append(o)
                grads.append(torch.as_tensor(g).to(o.device, o.dtype))
        got = (torch.autograd.grad(outs, leaves, grads, allow_unused=True)
               if outs else [None] * len(leaves))
        got = iter([torch.zeros_like(t) if g is None else g
                    for t, g in zip(leaves, got)])
        grad_input = _map_tensors(
            x, lambda t: next(got) if torch.is_tensor(t)
            and t.is_floating_point() else None)
        _clear_outputs(self)
        self.__dict__["grad_input"] = grad_input
        if timing:
            now = _sync()
            for m, (f, b) in saved.items():
                m.__dict__["_forward_time"] = f
                m.__dict__["_backward_time"] = b
            self.__dict__["_backward_time"] = saved[self][1] + now - t0
        return grad_input

    def predict(self, x):
        """The eval-mode forward of ``x`` (numpy or tensors) under
        ``torch.no_grad()``, on the model's device: its first parameter's,
        else its first buffer's, else the input's, else ``"cuda"``. The
        mode is restored and every ``output`` left ``None``, as the
        reference's ``predict`` leaves it."""
        dev = _state_device(self)
        if dev is None:
            dev = next((t.device for t in _each_tensor(x)), None)
        if dev is None:
            from bigdl_tpu_torch.utils.device import resolve_device
            dev = resolve_device("cuda")
        x = _map_tensors(x, lambda a: _as_tensor(a).to(dev))
        was_training = self.training
        self.eval()
        try:
            with torch.no_grad():
                return self(x)
        finally:
            self.train(was_training)
            _clear_outputs(self)

    def predict_class(self, x) -> torch.Tensor:
        """1-based classes of ``predict(x)`` (reference
        ``predict_class``)."""
        return self.predict(x).argmax(dim=-1) + 1

    def evaluate(self, dataset, methods):
        """``Evaluator(self, device=<the model's device>).test(dataset,
        methods)``, batches of 128 (reference ``evaluate``)."""
        from bigdl_tpu_torch.optim.evaluator import Evaluator
        from bigdl_tpu_torch.utils.device import module_device
        return Evaluator(self, device=module_device(self)).test(
            dataset, methods)

    # ------------------------------------------------------------- helpers
    def clone_module(self) -> "Module":
        """A deep copy at fresh addresses, without the
        ``_EPHEMERAL_CACHES`` and recorded outputs; a model sharded over
        a mesh shares the mesh's process groups with its clone."""
        return copy.deepcopy(self)

    def apply_to_modules(self, fn: Callable[[torch.nn.Module], Any]
                         ) -> "Module":
        """``fn`` on this module and every descendant, pre-order."""
        for m in self.modules():
            fn(m)
        return self

    def find_module(self, name: str) -> Optional[torch.nn.Module]:
        """The first module, pre-order, whose ``name`` is ``name``."""
        for m in self.modules():
            if _name_of(m) == name:
                return m
        return None

    def reset(self) -> None:
        """Draw the parameters anew; here, each child's (layers with
        parameters override it)."""
        for child in self._modules.values():
            if isinstance(child, Module):
                child.reset()

    def training_mode(self) -> "Module":
        return self.train()

    def set_training(self, is_training: bool = True) -> "Module":
        return self.train(is_training)

    def is_training(self) -> bool:
        return self.training

    def zero_grad_parameters(self) -> None:
        """``zero_grad(set_to_none=True)``: gradients are state here (the
        reference's are values, and its method does nothing)."""
        self.zero_grad(set_to_none=True)


class TensorModule(Module):
    """Tensor-to-tensor module marker (reference ``TensorModule``)."""


# --------------------------------------------------------------- the trees
def _tree(m: torch.nn.Module, kind: str) -> Dict[str, Any]:
    tree = {k: v for k, v in getattr(m, kind).items() if v is not None}
    for name, child in m._modules.items():
        if child is None:
            continue
        sub = _tree(child, kind)
        if sub:
            tree[name] = sub
    return tree


def _sorted_leaves(tree: Dict[str, Any], path: Tuple[str, ...] = ()):
    """``(key path, leaf)`` in JAX's order: keys sorted at every level."""
    for key in sorted(tree):
        v = tree[key]
        if isinstance(v, dict):
            yield from _sorted_leaves(v, path + (key,))
        else:
            yield path + (key,), v


def _targets(m: torch.nn.Module, tree: Dict[str, Any], kind: str,
             prefix: str) -> List[Tuple[str, torch.Tensor, Any]]:
    """``(dotted name, live tensor, value)`` for each key of ``tree`` that
    ``m`` holds."""
    own = getattr(m, "_stacked_targets", None)
    if own is not None:
        return own(tree, kind, prefix)
    out = []
    for name, t in getattr(m, kind).items():
        if t is not None and name in tree:
            out.append((prefix + name, t, tree[name]))
    for name, child in m._modules.items():
        if child is not None and name in tree:
            out.extend(_targets(child, tree[name], kind,
                                f"{prefix}{name}."))
    return out


def _as_tensor(value) -> torch.Tensor:
    if isinstance(value, np.ndarray) and value.dtype.name == "bfloat16":
        return torch.from_numpy(value.view(np.uint16)).view(torch.bfloat16)
    return torch.as_tensor(value)


def _load(targets) -> None:
    values = []
    for name, t, v in targets:
        v = _as_tensor(v)
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{name}: shape {tuple(v.shape)} does not match "
                             f"the module's {tuple(t.shape)}; nothing loaded")
        values.append(v)
    with torch.no_grad():
        for (_, t, _), v in zip(targets, values):
            t.copy_(v)


def _count(m: torch.nn.Module) -> int:
    return sum(t.numel() for _, t in _sorted_leaves(_tree(m, "_parameters")))


def _summary_view(m: torch.nn.Module):
    own = sum(p.numel() for p in m._parameters.values() if p is not None)
    return own, [(k, c, 1) for k, c in m._modules.items() if c is not None]


def _name_of(m: torch.nn.Module) -> str:
    return m.name if isinstance(m, Module) else type(m).__name__


def _state_device(m: torch.nn.Module) -> Optional[torch.device]:
    for t in m.parameters():
        return t.device
    for t in m.buffers():
        return t.device
    return None


# ------------------------------------------------------------------ timing
_TIMING_HANDLES: List[Any] = []


def _sync() -> float:
    """The host clock after the card, where one is in use, has drained."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return time.perf_counter()


class _BackwardEnd(torch.autograd.Function):
    """Identity on ``x``; its backward, which runs once the module's whole
    backward has produced ``x``'s gradient, stops the module's clock.
    ``anchor`` is a scalar that requires grad, so the node is reached even
    where ``x`` needs no gradient."""

    @staticmethod
    def forward(ctx, record, anchor, x):
        ctx.record = record
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        record = ctx.record
        if record["last"] is not None:
            # several inputs: the clock runs on to the last one's gradient
            now = _sync()
            m = record["module"]
            m.__dict__["_backward_time"] = (
                m.__dict__.get("_backward_time", 0.0) + now - record["last"])
            record["last"] = now
        return None, None, grad


def _map_tensors(obj, fn):
    """``fn`` over the tensors and numpy arrays of a nest."""
    if torch.is_tensor(obj) or isinstance(obj, np.ndarray):
        return fn(obj)
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_map_tensors(o, fn) for o in obj)
    if isinstance(obj, dict):   # a Table
        return type(obj)({k: _map_tensors(v, fn) for k, v in obj.items()})
    return obj


def _each_tensor(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (list, tuple, dict)):
        for o in (obj.values() if isinstance(obj, dict) else obj):
            yield from _each_tensor(o)


def _pre_hook(module, args):
    if not isinstance(module, Module):
        return None
    record = {"module": module, "last": None}
    module.__dict__.setdefault("_timing_stack", []).append(record)
    new_args = None
    if torch.is_grad_enabled():
        anchor = torch.zeros((), requires_grad=True)

        def mark(t):
            if not (torch.is_tensor(t) and t.is_floating_point()):
                return t
            return _BackwardEnd.apply(record, anchor.to(t.device), t)

        new_args = _map_tensors(tuple(args), mark)
    record["t0"] = _sync()
    return new_args


def _post_hook(module, args, output):
    if not isinstance(module, Module):
        return None
    now = _sync()
    record = module.__dict__["_timing_stack"].pop()
    module.__dict__["_forward_time"] = (
        module.__dict__.get("_forward_time", 0.0) + now - record["t0"])

    def start(grad):
        if record["last"] is None:
            record["last"] = _sync()
        return grad

    for t in _each_tensor(output):
        if t.requires_grad:
            t.register_hook(start)
    return None


def enable_timing(flag: bool = True) -> None:
    """Turn per-module forward and backward timing on (or off with
    ``False``); read it with ``Module.get_times()`` (reference
    ``enable_timing``). It synchronizes the card around every module, so
    it is for finding where the time goes, never for a training run."""
    while _TIMING_HANDLES:
        _TIMING_HANDLES.pop().remove()
    if flag:
        _TIMING_HANDLES.append(
            _torch_module.register_module_forward_pre_hook(_pre_hook))
        _TIMING_HANDLES.append(
            _torch_module.register_module_forward_hook(_post_hook))


def named_regularizers(model: torch.nn.Module
                       ) -> List[Tuple[str, Any]]:
    """``[(dotted parameter name, Regularizer)]`` over ``model``'s
    parameters that carry one, in ``named_parameters()`` order (the
    reference optimizer's ``_regularizer_pairs``)."""
    out = []
    for prefix, m in model.named_modules():
        regs = m.__dict__.get("_param_regularizers")
        if not regs:
            continue
        for name, reg in regs.items():
            if m._parameters.get(name) is not None:
                out.append((f"{prefix}.{name}" if prefix else name, reg))
    return out

