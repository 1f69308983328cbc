"""Activation recomputation (counterpart of ``bigdl_tpu/ops/remat.py`` and
of the ``jax.checkpoint`` calls behind ``Optimizer.set_remat``).

``checkpoint(fn, *args, policy=None)`` runs ``fn(*args)`` under
``torch.utils.checkpoint`` (``use_reentrant=False``): the backward re-runs
the forward for the activations it needs instead of keeping them.
``Recompute`` applies it to a model's training forward child by child.
``policy="conv"`` keeps the outputs of the ops tagged with a name in
``REMAT_SAVED_NAMES`` and recomputes the rest (PyTorch's selective
checkpointing). The tags are this package's ops (``tagged_op``): kernel K5
and K6's conv-with-statistics ops and the plain conv are ``"conv_out"``,
batch norm's statistics are ``"bn_stats"``; so under ``"conv"`` K5 and K6
launch once a step, as without recomputation, and only the elementwise
tail (the normalise, the ReLU, the residual adds) runs twice.

Three things make a recomputed forward the forward it replaces, as
``jax.checkpoint``'s replay of the same keys does in the reference:

- random draws: every dropout mask goes through ``keep_mask``. Inside a
  region the first pass records each mask and the recomputation replays
  them in order, so the second pass never touches a generator. This needs
  no generator state, which a CUDA graph capture could not read
  (``torch.utils.checkpoint``'s ``preserve_rng_state`` is off), and it
  leaves every generator where the forward left it;
- side effects: ``recomputing()`` is true during a replay; batch norm's
  running-statistic update (``nn.normalization.blend_running_stats``)
  skips it, so the statistics move once a step;
- nesting: a region inside another records into both, and a replay serves
  the masks of the outermost region that is replaying;
- parameters: ``checkpoint_module`` binds a module's parameters as the
  forward saw them (a compute-dtype copy under a mixed ``DtypePolicy``).
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Set

import torch
import torch.utils.checkpoint as torch_checkpoint

#: the tags whose ops the "conv" policy keeps (the reference's one
#: spelling of its save-list)
REMAT_SAVED_NAMES = ("conv_out", "bn_stats")
#: the recomputation policies ``Optimizer.set_remat`` takes
POLICIES = ("full", "conv", "block")

_TAGGED: Dict[str, Set] = {"conv_out": {torch.ops.aten.convolution.default}}
_LOCAL = threading.local()


def tagged_op(qualname: str, tag: str, fn: Callable):
    """``fn`` registered as the custom op ``qualname`` and tagged ``tag``
    for the "conv" policy; returns the op. ``fn`` must be typed as
    ``torch.library.custom_op`` wants and return fresh tensors. A name
    already registered (a second import of the module) is reused."""
    ns, name = qualname.split("::")
    packet = getattr(getattr(torch.ops, ns), name, None)
    if packet is None:
        torch.library.custom_op(qualname, mutates_args=())(fn)
        packet = getattr(getattr(torch.ops, ns), name)
    _TAGGED.setdefault(tag, set()).add(packet.default)
    return packet.default


class _Region:
    """The masks of one checkpointed call, recorded by its first pass."""

    def __init__(self):
        self.masks: List[torch.Tensor] = []
        self.passes = 0
        self.pos = 0
        self.replaying = False


def _stack() -> List[_Region]:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def recomputing() -> bool:
    """True while a checkpointed region's forward is being recomputed."""
    return any(r.replaying for r in _stack())


def keep_mask(shape, keep: float, generator: torch.Generator,
              device) -> torch.Tensor:
    """A boolean mask, True with probability ``keep``, drawn from
    ``generator``; inside a recomputation the mask the forward drew."""
    stack = _stack()
    for region in stack:
        if region.replaying:
            if region.pos >= len(region.masks):
                raise RuntimeError("a recomputed forward drew more dropout "
                                   "masks than the forward it replays")
            mask = region.masks[region.pos]
            region.pos += 1
            break
    else:
        mask = torch.rand(tuple(shape), generator=generator,
                          device=device) < keep
    for region in stack:
        if not region.replaying:
            region.masks.append(mask)
    return mask


def _conv_policy(ctx, op, *args, **kwargs):
    saved = any(op in _TAGGED.get(tag, ()) for tag in REMAT_SAVED_NAMES)
    return (torch_checkpoint.CheckpointPolicy.MUST_SAVE if saved
            else torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE)


def checkpoint(fn: Callable, *args, policy: Optional[str] = None):
    """``fn(*args)``, its activations recomputed in the backward (see the
    module docstring); ``policy`` None recomputes everything, ``"conv"``
    keeps the tagged ops' outputs."""
    region = _Region()

    def run(*a):
        region.replaying = region.passes > 0
        region.passes += 1
        region.pos = 0
        stack = _stack()
        stack.append(region)
        try:
            return fn(*a)
        finally:
            stack.pop()
            region.replaying = False

    kwargs = {}
    if policy == "conv":
        kwargs["context_fn"] = lambda: \
            torch_checkpoint.create_selective_checkpoint_contexts(_conv_policy)
    elif policy is not None:
        raise ValueError(f"unknown checkpoint policy {policy!r}")
    return torch_checkpoint.checkpoint(run, *args, use_reentrant=False,
                                       preserve_rng_state=False, **kwargs)


def checkpoint_module(module: torch.nn.Module, *args,
                      policy: Optional[str] = None):
    """``module(*args)`` under ``checkpoint``, its parameters bound as they
    are now: inside ``torch.func.functional_call`` (the training step's
    compute-dtype copies) they are the substituted tensors, which the
    recomputation in the backward, after that call has returned, would no
    longer find on the module. Buffers are the module's own (a running
    statistic moves in the forward, which the recomputation skips)."""
    named = list(module.named_parameters())
    names = [n for n, _ in named]
    k = len(args)

    def run(*a):
        return torch.func.functional_call(module, dict(zip(names, a[k:])),
                                          a[:k])

    return checkpoint(run, *args, *(t for _, t in named), policy=policy)


class Recompute(torch.nn.Module):
    """``model``'s training forward with its activations recomputed in the
    backward (``Optimizer.set_remat``'s ``"full"`` and ``"conv"``). A chain
    container (``Sequential``) runs each child that holds parameters as a
    region of its own, the segments of torch's ``checkpoint_sequential``,
    so that the backward recomputes one child at a time: one region round
    the whole forward would rematerialise every activation at once in its
    backward and lower no peak. Parameterless children (activations,
    pools, a tied head that reads another child's table) run as they are.
    Any other model is one region. Call it through
    ``torch.func.functional_call`` with its parameters named
    ``model.<name>``."""

    def __init__(self, model: torch.nn.Module, policy: Optional[str] = None):
        super().__init__()
        self.model = model
        self.policy = policy

    def forward(self, x):
        from bigdl_tpu_torch.nn.containers import Sequential
        if not isinstance(self.model, Sequential):
            return checkpoint_module(self.model, x, policy=self.policy)
        for child in self.model.children():
            if next(child.parameters(), None) is None:
                x = child(x)
            else:
                x = checkpoint_module(child, x, policy=self.policy)
        return x
