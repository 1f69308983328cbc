"""Optimization methods and learning-rate schedules (counterpart of
``bigdl_tpu/optim/methods.py``: ``SGD``, ``Adagrad``, ``Adam``, ``AdamW`` and
the schedules ``Default``, ``Poly``, ``Step``, ``MultiStep``,
``CosineDecay``, ``Warmup`` are ported).

The reference's update rules, written out here rather than taken from
``torch.optim``, whose decay and schedule rules differ (``AdamW`` below
multiplies by ``1 - lr * decay`` with the scheduled rate before the Adam
step). ``update(grads, state, params)`` takes ``{name: tensor}`` dicts and
UPDATES THE PARAMETERS AND THE MOMENT TENSORS IN PLACE, under
``torch.no_grad()`` (the reference returns new trees); it returns
``(params, state)`` as the reference does. The per-method state is a plain
dict holding ``evalCounter`` and ``epoch`` (Python ints) beside its
tensors. Schedules are functions of those counters and return Python
floats.

A captured training window (``Optimizer.set_steps_per_dispatch`` on a card)
cannot read Python floats that change per iteration: a CUDA graph would
replay the values of its capture. So each method also gives
``step_scalars(state)``, the iteration's schedule values as float32
numbers, which the host writes into a device tensor before each replay;
``update(..., scalars=row)`` reads them from that tensor. Without
``scalars`` the update keeps its Python-float arithmetic. On a card the two
agree to the bit: CUDA multiplies a tensor by a host scalar in float32 and
divides by one as a product with its reciprocal, which ``step_scalars``
supplies where the update divides.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


# ----------------------------------------------------------------- schedules
class LearningRateSchedule:
    def rate(self, base_lr: float, state: Dict) -> float:
        raise NotImplementedError


class Default(LearningRateSchedule):
    """lr / (1 + neval * decay) (reference ``SGD.Default``)."""

    def rate(self, base_lr, state):
        decay = state.get("learningRateDecay", 0.0)
        return base_lr / (1.0 + state["evalCounter"] * decay)


class Poly(LearningRateSchedule):
    """lr * (1 - iter / max)^power (reference ``SGD.Poly``)."""

    def __init__(self, power: float, max_iteration: int):
        self.power, self.max_iteration = power, max_iteration

    def rate(self, base_lr, state):
        it = min(state["evalCounter"], self.max_iteration)
        return base_lr * (1.0 - it / self.max_iteration) ** self.power


class Step(LearningRateSchedule):
    """lr * gamma^floor(iter / step_size) (reference ``SGD.Step``)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def rate(self, base_lr, state):
        return base_lr * self.gamma ** math.floor(
            state["evalCounter"] / self.step_size)


class MultiStep(LearningRateSchedule):
    """lr * gamma^(milestones passed) (reference ``MultiStep``)."""

    def __init__(self, step_sizes: Sequence[int], gamma: float):
        self.step_sizes = list(step_sizes)
        self.gamma = gamma

    def rate(self, base_lr, state):
        passed = sum(state["evalCounter"] >= s for s in self.step_sizes)
        return base_lr * self.gamma ** passed


class CosineDecay(LearningRateSchedule):
    """Cosine annealing from base_lr to ``min_lr`` over
    ``decay_iterations`` (reference ``CosineDecay``)."""

    def __init__(self, decay_iterations: int, min_lr: float = 0.0):
        if decay_iterations <= 0:
            raise ValueError("decay_iterations must be > 0")
        self.decay_iterations = decay_iterations
        self.min_lr = min_lr

    def rate(self, base_lr, state):
        frac = min(state["evalCounter"], self.decay_iterations) \
            / self.decay_iterations
        return self.min_lr + 0.5 * (base_lr - self.min_lr) * (
            1.0 + math.cos(math.pi * frac))


class Warmup(LearningRateSchedule):
    """Linear warmup over ``warmup_iterations``, then ``after`` counted from
    the end of the warmup (reference ``Warmup``)."""

    def __init__(self, warmup_iterations: int, after: LearningRateSchedule):
        self.warmup_iterations = warmup_iterations
        self.after = after

    def rate(self, base_lr, state):
        it = state["evalCounter"]
        if it < self.warmup_iterations:
            return base_lr * (it + 1) / self.warmup_iterations
        return self.after.rate(
            base_lr, {**state, "evalCounter": it - self.warmup_iterations})


# ------------------------------------------------------------------- methods
def _f32_reciprocal(x: float) -> float:
    """1/x as CUDA multiplies by it when a float32 tensor is divided by the
    host scalar x: divided in double, rounded to float32 (``chip_smoke.py``
    phase 3f holds the two updates bit for bit on the card)."""
    return float(np.float32(1.0 / x))


def _zeros(params: Tensors, dtype: Optional[torch.dtype] = None) -> Tensors:
    return {k: torch.zeros_like(p, dtype=dtype) for k, p in params.items()}


class OptimMethod:
    """Base optimizer (reference ``OptimMethod``)."""

    def __init__(self, learningrate: float = 1e-3, weightdecay: float = 0.0):
        self.learningrate = learningrate
        self.weightdecay = weightdecay

    def init_state(self, params: Tensors) -> Dict:
        return {"evalCounter": 0, "epoch": 1}

    def update(self, grads: Tensors, state: Dict, params: Tensors,
               scalars: Optional[torch.Tensor] = None
               ) -> Tuple[Tensors, Dict]:
        """One step in place; ``scalars``: this iteration's
        ``step_scalars`` as a device tensor, read in place of the Python
        floats."""
        raise NotImplementedError

    def step_scalars(self, state: Dict) -> List[float]:
        """The coming iteration's schedule values (float32 numbers), in the
        order ``update(scalars=...)`` reads them."""
        raise NotImplementedError(
            f"{type(self).__name__} has no step_scalars: it cannot run "
            "inside a captured training window")

    def _decayed(self, grads: Tensors, params: Tensors) -> Tensors:
        """Coupled L2 decay: ``g + weightdecay * p`` (new tensors)."""
        if self.weightdecay:
            return {k: g + self.weightdecay * params[k]
                    for k, g in grads.items()}
        return grads


class SGD(OptimMethod):
    """SGD with momentum, dampening, nesterov, coupled weight decay and a
    learning-rate schedule (reference ``SGD``)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, weightdecay: float = 0.0,
                 momentum: float = 0.0, dampening: Optional[float] = None,
                 nesterov: bool = False,
                 learningrate_schedule: Optional[LearningRateSchedule] = None):
        super().__init__(learningrate, weightdecay)
        self.learningrate_decay = learningrate_decay
        self.momentum = momentum
        self.dampening = dampening if dampening is not None else momentum
        self.nesterov = nesterov
        if nesterov and not (momentum > 0 and self.dampening == 0):
            raise ValueError("nesterov requires momentum > 0, dampening = 0")
        self.schedule = learningrate_schedule or Default()

    def init_state(self, params):
        s = super().init_state(params)
        s["learningRateDecay"] = self.learningrate_decay
        if self.momentum > 0:
            s["velocity"] = _zeros(params)
        return s

    def current_rate(self, state) -> float:
        return self.schedule.rate(self.learningrate, state)

    def step_scalars(self, state):
        return [self.current_rate(state)]

    @torch.no_grad()
    def update(self, grads, state, params, scalars=None):
        lr = self.current_rate(state) if scalars is None else scalars[0]
        grads = self._decayed(grads, params)
        mu, damp = self.momentum, self.dampening
        for k, p in params.items():
            g = grads[k]
            if mu > 0:
                v = state["velocity"][k]
                v.copy_(mu * v + (1 - damp) * g)
                step_dir = g + mu * v if self.nesterov else v
            else:
                step_dir = g
            p.sub_(lr * step_dir)
        state["evalCounter"] += 1
        return params, state


class Adagrad(OptimMethod):
    """reference ``Adagrad``."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, weightdecay: float = 0.0):
        super().__init__(learningrate, weightdecay)
        self.learningrate_decay = learningrate_decay

    def init_state(self, params):
        s = super().init_state(params)
        s["accum"] = _zeros(params)
        return s

    def step_scalars(self, state):
        return [self.learningrate / (1.0 + state["evalCounter"]
                                     * self.learningrate_decay)]

    @torch.no_grad()
    def update(self, grads, state, params, scalars=None):
        grads = self._decayed(grads, params)
        lr = (self.step_scalars(state) if scalars is None else scalars)[0]
        for k, p in params.items():
            g, a = grads[k], state["accum"][k]
            a.add_(g * g)
            p.sub_(lr * g / (torch.sqrt(a) + 1e-10))
        state["evalCounter"] += 1
        return params, state


class Adam(OptimMethod):
    """Bias-corrected Adam with coupled L2 decay (reference ``Adam``).

    ``state_dtype="bfloat16"`` stores the two moments in bf16; their
    arithmetic stays f32 (widened on read, rounded on store)."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weightdecay: float = 0.0, state_dtype=None):
        super().__init__(learningrate, weightdecay)
        self.learningrate_decay = learningrate_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.state_dtype = (getattr(torch, state_dtype)
                            if isinstance(state_dtype, str) else state_dtype)

    def init_state(self, params):
        s = super().init_state(params)
        s["m"] = _zeros(params, self.state_dtype)
        s["v"] = _zeros(params, self.state_dtype)
        return s

    def _scheduled_lr(self, state) -> float:
        return self.learningrate / (1.0 + state["evalCounter"]
                                    * self.learningrate_decay)

    def step_scalars(self, state):
        """(lr, 1 / bc1, 1 / bc2) of the coming iteration."""
        t = state["evalCounter"] + 1
        return [self._scheduled_lr(state),
                _f32_reciprocal(1 - self.beta1 ** t),
                _f32_reciprocal(1 - self.beta2 ** t)]

    @torch.no_grad()
    def update(self, grads, state, params, scalars=None):
        grads = self._decayed(grads, params)
        t = state["evalCounter"] + 1
        b1, b2 = self.beta1, self.beta2
        if scalars is None:
            lr = self._scheduled_lr(state)
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
        else:
            lr, inv_bc1, inv_bc2 = scalars[0], scalars[1], scalars[2]
        for k, p in params.items():
            g, m, v = grads[k], state["m"][k], state["v"][k]
            m.copy_(b1 * m.float() + (1 - b1) * g)   # rounds on store
            v.copy_(b2 * v.float() + (1 - b2) * g * g)
            if scalars is None:
                m_hat, v_hat = m.float() / bc1, v.float() / bc2
            else:
                m_hat, v_hat = m.float() * inv_bc1, v.float() * inv_bc2
            p.sub_(lr * m_hat / (torch.sqrt(v_hat) + self.epsilon))
        state["evalCounter"] = t
        return params, state


class AdamW(Adam):
    """Adam with DECOUPLED weight decay (reference ``AdamW``): each
    parameter is first multiplied by ``1 - lr * decay`` with the scheduled
    rate, outside the moment estimates, then takes the Adam step."""

    def __init__(self, learningrate: float = 1e-3,
                 learningrate_decay: float = 0.0, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 weightdecay: float = 0.01, state_dtype=None):
        super().__init__(learningrate, learningrate_decay, beta1, beta2,
                         epsilon, weightdecay=0.0, state_dtype=state_dtype)
        self.decoupled_decay = weightdecay

    def step_scalars(self, state):
        """Adam's three, then the decay's ``1 - lr * decay``."""
        return super().step_scalars(state) + [
            1.0 - self._scheduled_lr(state) * self.decoupled_decay]

    @torch.no_grad()
    def update(self, grads, state, params, scalars=None):
        if self.decoupled_decay:
            shrink = (1.0 - self._scheduled_lr(state) * self.decoupled_decay
                      if scalars is None else scalars[3])
            for p in params.values():
                p.mul_(shrink)
        return super().update(grads, state, params, scalars)
