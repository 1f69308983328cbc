"""Optimization methods and learning-rate schedules (counterpart of
``bigdl_tpu/optim/methods.py``; every class is ported: ``SGD``,
``Adagrad``, ``Adam``, ``AdamW``, ``Adamax``, ``Adadelta``, ``RMSprop``,
``LBFGS`` and the schedules ``Default``, ``Poly``, ``Step``,
``MultiStep``, ``EpochStep``, ``EpochDecay``, ``CosineDecay``,
``Warmup``, and ``EpochSchedule`` with its ``Regime`` rows).

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

``LBFGS`` is a full-batch method (``supports_minibatch = False``): it
drives its own ``optimize(feval, x)`` loop on the host around the
caller's loss-and-gradient function, as the reference does, and
``Optimizer`` refuses it.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.utils.table import T, Table

Tensors = Dict[str, torch.Tensor]


# ----------------------------------------------------------------- schedules
class LearningRateSchedule:
    def rate(self, base_lr: float, state: Dict) -> float:
        raise NotImplementedError

    def weight_decay(self, base_wd: float, state: Dict) -> float:
        """The coupled decay for the state: the method's own, unless the
        schedule sets it (``EpochSchedule``)."""
        return base_wd


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


class EpochStep(LearningRateSchedule):
    """lr * gamma^floor((epoch - 1) / step_size) (reference
    ``SGD.EpochStep``)."""

    def __init__(self, step_size: int, gamma: float):
        self.step_size, self.gamma = step_size, gamma

    def rate(self, base_lr, state):
        return base_lr * self.gamma ** math.floor(
            (state["epoch"] - 1) / self.step_size)


class EpochDecay(LearningRateSchedule):
    """lr * 0.1^decay_fn(epoch) (reference ``SGD.EpochDecay``);
    ``decay_fn`` maps the 1-based epoch (an int) to a number."""

    def __init__(self, decay_fn):
        self.decay_fn = decay_fn

    def rate(self, base_lr, state):
        return base_lr * 0.1 ** self.decay_fn(state["epoch"])


class Regime:
    """One row of an epoch-range schedule (reference ``Regime``): epochs
    ``start_epoch`` to ``end_epoch`` (inclusive) take the hyper-parameters
    of ``config``, a ``utils.table.T`` with ``learningRate`` and/or
    ``weightDecay``."""

    def __init__(self, start_epoch: int, end_epoch: int, config):
        self.start_epoch, self.end_epoch = start_epoch, end_epoch
        self.config = config


class EpochSchedule(LearningRateSchedule):
    """Per-epoch hyper-parameters from ``Regime`` rows (reference
    ``EpochSchedule``): the last row whose range holds the state's epoch
    gives the rate and the weight decay; an epoch in no row keeps the base
    values."""

    def __init__(self, regimes):
        self.regimes = list(regimes)

    def _pick(self, key: str, base: float, state) -> float:
        value = base
        for r in self.regimes:
            if r.start_epoch <= state["epoch"] <= r.end_epoch:
                value = r.config.get(key, base)
        return value

    def rate(self, base_lr, state):
        return self._pick("learningRate", base_lr, state)

    def weight_decay(self, base_wd, state):
        return self._pick("weightDecay", base_wd, state)


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

    #: False for a full-batch method (``LBFGS``) that drives its own
    #: ``optimize(feval, x)`` loop and cannot step inside ``Optimizer``
    supports_minibatch = True

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

    def optimize(self, feval, x, state: Optional[Dict] = None):
        """Torch-style step (reference ``optimize``): ``feval(x) -> (loss,
        grad)`` for ``x`` a tensor or a ``{name: tensor}`` dict and
        ``grad`` of the same form; one ``update`` of ``x`` IN PLACE, with
        the state kept on the method between calls. Returns ``(x,
        [loss])``."""
        params = x if isinstance(x, dict) else {"x": x}
        if state is None:
            state = self.__dict__.get("_state")
            if state is None:
                state = self.init_state(params)
        loss, grad = feval(x)
        self.update(grad if isinstance(grad, dict) else {"x": grad}, state,
                    params)
        self._state = state
        return x, [loss]

    def get_hyper_parameter(self) -> Table:
        """``T(learningRate=..., weightDecay=...)`` (reference
        ``get_hyper_parameter``)."""
        return T(learningRate=self.learningrate, weightDecay=self.weightdecay)

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

    def current_weight_decay(self, state) -> float:
        return self.schedule.weight_decay(self.weightdecay, state)

    def step_scalars(self, state):
        """(lr, weight decay)."""
        return [self.current_rate(state), self.current_weight_decay(state)]

    @torch.no_grad()
    def update(self, grads, state, params, scalars=None):
        lr, wd = self.step_scalars(state) if scalars is None else scalars
        # as the reference: a schedule of decays applies one even where it
        # is 0, so a captured window keeps one program for every epoch
        if self.weightdecay or isinstance(self.schedule, EpochSchedule):
            grads = {k: g + wd * params[k] for k, g in grads.items()}
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

    def get_hyper_parameter(self) -> Table:
        """The decoupled decay is the weight decay reported."""
        return T(learningRate=self.learningrate,
                 weightDecay=self.decoupled_decay)

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


class Adamax(OptimMethod):
    """Adam with the infinity norm (reference ``Adamax``): ``u = max(beta2
    u, |g| + epsilon)``, ``p -= lr / (1 - beta1^t) * m / u``."""

    def __init__(self, learningrate: float = 0.002, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-38,
                 weightdecay: float = 0.0):
        super().__init__(learningrate, weightdecay)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def init_state(self, params):
        s = super().init_state(params)
        s["m"] = _zeros(params)
        s["u"] = _zeros(params)
        return s

    def step_scalars(self, state):
        """(lr / (1 - beta1^t)) of the coming iteration."""
        t = state["evalCounter"] + 1
        return [self.learningrate / (1 - self.beta1 ** t)]

    @torch.no_grad()
    def update(self, grads, state, params, scalars=None):
        grads = self._decayed(grads, params)
        step = (self.step_scalars(state) if scalars is None else scalars)[0]
        b1 = self.beta1
        for k, p in params.items():
            g, m, u = grads[k], state["m"][k], state["u"][k]
            m.copy_(b1 * m + (1 - b1) * g)
            u.copy_(torch.maximum(self.beta2 * u, g.abs() + self.epsilon))
            p.sub_(step * m / u)
        state["evalCounter"] += 1
        return params, state


class Adadelta(OptimMethod):
    """reference ``Adadelta``: no learning rate; the step is
    ``sqrt(delta_accum + eps) / sqrt(accum + eps) * g`` over running
    averages of the squared gradients and steps. It has no per-iteration
    values, so its ``step_scalars`` is empty."""

    def __init__(self, decayrate: float = 0.9, epsilon: float = 1e-10):
        super().__init__(learningrate=1.0)
        self.rho, self.epsilon = decayrate, epsilon

    def init_state(self, params):
        s = super().init_state(params)
        s["accum"] = _zeros(params)
        s["delta_accum"] = _zeros(params)
        return s

    def step_scalars(self, state):
        return []

    @torch.no_grad()
    def update(self, grads, state, params, scalars=None):
        rho, eps = self.rho, self.epsilon
        for k, p in params.items():
            g, a, d = grads[k], state["accum"][k], state["delta_accum"][k]
            a.copy_(rho * a + (1 - rho) * g * g)
            delta = torch.sqrt(d + eps) / torch.sqrt(a + eps) * g
            d.copy_(rho * d + (1 - rho) * delta * delta)
            p.sub_(delta)
        state["evalCounter"] += 1
        return params, state


class RMSprop(OptimMethod):
    """reference ``RMSprop``: ``accum = rho accum + (1 - rho) g^2``,
    ``p -= lr_t g / (sqrt(accum) + epsilon)`` with ``lr_t = lr / (1 +
    neval * learningrate_decay)``."""

    def __init__(self, learningrate: float = 1e-2,
                 learningrate_decay: float = 0.0, decayrate: float = 0.99,
                 epsilon: float = 1e-8):
        super().__init__(learningrate)
        self.learningrate_decay = learningrate_decay
        self.rho, self.epsilon = decayrate, epsilon

    def init_state(self, params):
        s = super().init_state(params)
        s["accum"] = _zeros(params)
        return s

    def step_scalars(self, state):
        return [self.learningrate / (1.0 + state["evalCounter"]
                                     * self.learningrate_decay)]

    @torch.no_grad()
    def update(self, grads, state, params, scalars=None):
        lr = (self.step_scalars(state) if scalars is None else scalars)[0]
        rho = self.rho
        for k, p in params.items():
            g, a = grads[k], state["accum"][k]
            a.copy_(rho * a + (1 - rho) * g * g)
            p.sub_(lr * g / (torch.sqrt(a) + self.epsilon))
        state["evalCounter"] += 1
        return params, state


def _flat(x) -> torch.Tensor:
    """A tensor or ``{name: tensor}`` dict as one 1-D tensor."""
    if isinstance(x, dict):
        return torch.cat([t.reshape(-1) for t in x.values()])
    return x.reshape(-1)


def _unflat(flat: torch.Tensor, like):
    """``flat`` in the form of ``like`` (``_flat``'s inverse)."""
    if isinstance(like, dict):
        out, i = {}, 0
        for k, t in like.items():
            out[k] = flat[i:i + t.numel()].reshape(t.shape)
            i += t.numel()
        return out
    return flat.reshape(like.shape)


def _wolfe_line_search(feval, x, d, f0, g0, t0, c1: float = 1e-4,
                       c2: float = 0.9, max_iter: int = 25,
                       t_max: float = 1e8):
    """Strong-Wolfe line search along ``d`` (reference
    ``_wolfe_line_search``, Torch's ``lswolfe``): bracket by doubling,
    then bisect until the sufficient decrease (c1) and the curvature (c2)
    conditions hold. ``feval`` takes and returns flat tensors. Returns
    ``(t, f_t, g_t, evals)``; when the budget runs out, the best point
    evaluated (t = 0: no step)."""
    gtd0 = float(torch.dot(g0, d))
    lo_t, lo_f, lo_g = 0.0, f0, g0
    hi_t = None
    t = t0
    evals = 0
    for _ in range(max_iter):
        f_t, g_t = feval(x + t * d)
        f_t = float(f_t)
        evals += 1
        gtd = float(torch.dot(g_t, d))
        if not math.isfinite(f_t):
            hi_t = t  # overflow at this step: shrink, never extend
        elif f_t > f0 + c1 * t * gtd0 or (evals > 1 and f_t >= lo_f):
            hi_t = t  # overshot: the minimum lies in (lo_t, t)
        elif abs(gtd) <= -c2 * gtd0:
            return t, f_t, g_t, evals  # strong Wolfe satisfied
        elif gtd >= 0:
            hi_t = t  # the slope turned positive: bracketed
        else:
            lo_t, lo_f, lo_g = t, f_t, g_t
            if hi_t is None:
                t = min(2.0 * t, t_max)  # still descending: extend
                continue
        t = 0.5 * (lo_t + hi_t)
        if hi_t - lo_t < 1e-12:
            break
    return lo_t, lo_f, lo_g, evals


class LBFGS(OptimMethod):
    """Limited-memory BFGS with an optional strong-Wolfe line search
    (reference ``LBFGS``, Torch's ``lbfgs``): a full-batch method, run as
    ``optimize(feval, x)`` on the host around the caller's loss and
    gradient. ``x`` is a tensor or a ``{name: tensor}`` dict; the result
    is a new ``x`` of the same form and the losses of the iterations."""

    supports_minibatch = False

    def __init__(self, max_iter: int = 20, max_eval: Optional[float] = None,
                 tolfun: float = 1e-5, tolx: float = 1e-9,
                 ncorrection: int = 100, learningrate: float = 1.0,
                 linesearch: bool = False):
        super().__init__(learningrate)
        self.max_iter = max_iter
        self.max_eval = max_eval if max_eval is not None else max_iter * 1.25
        self.tolfun, self.tolx = tolfun, tolx
        self.ncorrection = ncorrection
        self.linesearch = linesearch

    @torch.no_grad()
    def optimize(self, feval, x, state=None):
        like = x

        def feval_flat(xf):
            loss, g = feval(_unflat(xf, like))
            return loss, _flat(g)

        x_flat = _flat(x).clone()
        loss, g_flat = feval_flat(x_flat)
        losses = [float(loss)]
        old_dirs: List[torch.Tensor] = []
        old_steps: List[torch.Tensor] = []
        h_diag = 1.0
        prev_flat, prev_g = x_flat, g_flat
        n_eval = 1
        for it in range(self.max_iter):
            if float(g_flat.abs().max()) <= self.tolfun:
                break
            if it == 0:
                d = -g_flat
            else:
                y = g_flat - prev_g
                s = x_flat - prev_flat
                ys = torch.dot(y, s)
                if float(ys) > 1e-10:
                    if len(old_dirs) >= self.ncorrection:
                        old_dirs.pop(0)
                        old_steps.pop(0)
                    old_dirs.append(y)
                    old_steps.append(s)
                    h_diag = ys / torch.dot(y, y)
                # the two-loop recursion
                k = len(old_dirs)
                ro = [1.0 / torch.dot(old_dirs[i], old_steps[i])
                      for i in range(k)]
                q = -g_flat
                al = [None] * k
                for i in range(k - 1, -1, -1):
                    al[i] = torch.dot(old_steps[i], q) * ro[i]
                    q = q - al[i] * old_dirs[i]
                d = q * h_diag
                for i in range(k):
                    be_i = torch.dot(old_dirs[i], d) * ro[i]
                    d = d + (al[i] - be_i) * old_steps[i]
            prev_flat, prev_g, prev_loss = x_flat, g_flat, loss
            if float(torch.dot(g_flat, d)) > -self.tolx:
                break
            t = (min(1.0, 1.0 / float(g_flat.abs().sum())) if it == 0
                 else self.learningrate)
            if self.linesearch:
                t, loss, g_flat, evals = _wolfe_line_search(
                    feval_flat, x_flat, d, float(loss), g_flat, t)
                x_flat = x_flat + t * d
                n_eval += evals
            else:
                x_flat = x_flat + t * d
                loss, g_flat = feval_flat(x_flat)
                n_eval += 1
            losses.append(float(loss))
            if n_eval >= self.max_eval:
                break
            if abs(float(loss) - float(prev_loss)) < self.tolfun:
                break
            if float((t * d).abs().max()) <= self.tolx:
                break
        return _unflat(x_flat, like), losses

    def update(self, grads, state, params, scalars=None):
        raise NotImplementedError("LBFGS uses optimize(feval, x)")
