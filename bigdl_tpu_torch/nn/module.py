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
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Tuple

import torch
from torch.nn.modules import module as _torch_module


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
    #: KV snapshots and a thread lock
    _EPHEMERAL_CACHES = ("_prefix_trie",)

    def __getstate__(self):
        d = self.__dict__.copy()
        for key in self._EPHEMERAL_CACHES:
            d.pop(key, None)
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


class TensorModule(Module):
    """Tensor-to-tensor module marker (reference ``TensorModule``)."""


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
    if torch.is_tensor(obj):
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
            if not t.is_floating_point():
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

