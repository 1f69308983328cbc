"""Expert parallelism: the mixture of experts (counterpart of
``bigdl_tpu/parallel/expert.py``).

``MoE`` is the reference's top-k gated mixture of expert FFNs: the gate's
softmax in f32, an iterative top-k (argmax, ties to the first index, the
pick masked out), the capacity ``ceil(T / E * capacity_factor * k)``
(at most T), the GShard combine (the kept gate weights renormalised, then
scaled by the whole top-k mass, in f32 in the pick order) and the expert
products in the compute dtype. The expert leaves are stacked on a leading
expert axis (``w1`` (E, D, H), ``b1`` (E, H), ``w2`` (E, H, D), ``b2``
(E, D)) beside ``gate_weight`` (D, E), the reference's names and layouts.
The three dispatches route alike and differ only in how tokens reach the
(E, C, D) buffer: ``sort`` (one stable argsort; a capacity slot is a
pick's rank in its expert's sorted run; a pure gather), ``scatter``
(running counts; ``index_put`` with accumulate) and ``einsum`` (dense
(T, E, C) masks; the combine a dense selection of the experts' rows
round by round). The three are bit-equal in the forward and in the
gradients at k = 2 (a token's two contributions commute; the dense
products select exact values), where the reference's einsum combine
agrees with its sort to rounding. Tokens over
capacity are dropped: their combine weight is 0. The Switch load-balance
loss ``E * sum_e frac_e * mean_p_e * aux_loss_weight`` joins the backward
through ``inject_loss`` in training mode.

No host synchronisation in the forward: no ``bincount``, ``item``,
``nonzero`` or boolean-mask indexing; counts come from one-hot sums, so a
captured CUDA graph (a k-step window, a decode round) can hold the layer.

The reference routes the global batch under GSPMD. The port runs one
process a rank, so inside ``global_routing(model, mesh)`` (the
``DistriOptimizer`` enters it around each training step, and only there)
the layer routes as the reference does from per-rank pieces; outside it
(validation, inference) each rank routes the tokens it holds, as the
reference's multi-process validation does:

- over a ``data`` axis above 1, each rank's per-round expert counts are
  all-gathered (n_data x k x E numbers) and a pick's slot is its global one
  (the picks of its expert in earlier rounds on every rank, in this round
  on lower data ranks, then its rank here), kept iff below the global
  capacity ``ceil(T_global / E * cf * k)``; the kept picks of an expert
  are a prefix of its local run, so the local buffer holds
  ``min(C_global, T_local)`` rows an expert. ``frac`` is all-reduced over
  the axis (it has no gradient) and ``mean_p`` stays local, so the ranks'
  mean gradient is the reference's aux gradient;
- over an ``expert`` axis above 1 (``shard_experts``: E / N experts a
  rank) the tokens are replicated, every rank routes the same tokens and
  runs its experts on its E / N rows of the buffer (``split``: backward an
  all-gather), and the experts' outputs are all-gathered (``gather``:
  backward the rank's slice), which keeps the combine's op order.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.nn import initialization as init
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.parallel.mesh import DATA_AXIS, EXPERT_AXIS

DISPATCHES = ("sort", "scatter", "einsum")


class _InjectLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, aux):
        ctx.aux_meta = (aux.dtype, aux.device)
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        dtype, device = ctx.aux_meta
        return g, torch.ones((), dtype=dtype, device=device)


def inject_loss(y: torch.Tensor, aux: torch.Tensor) -> torch.Tensor:
    """Identity on ``y`` whose backward gives ``aux`` the cotangent 1.0,
    whatever follows: ``aux`` joins the total loss without touching the
    training loop (reference ``inject_loss``)."""
    return _InjectLoss.apply(y, aux)


def _one_hot(idx: torch.Tensor, n: int, dtype=torch.float32) -> torch.Tensor:
    """``jax.nn.one_hot``: a comparison, no range check (no host sync)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def _exclusive_cumsum(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    return torch.cumsum(x, dim) - x


class MoE(Module):
    """Top-k gated mixture of expert FFNs (reference ``MoE``); input
    (..., D), its leading axes one token axis; each expert D -> H -> D.
    See the module docstring."""

    def __init__(self, input_size: int, hidden_size: int, n_experts: int,
                 k: int = 2, capacity_factor: float = 1.25,
                 activation: str = "gelu", aux_loss_weight: float = 1e-2,
                 dispatch: str = "sort"):
        super().__init__()
        if dispatch not in DISPATCHES:
            raise ValueError(f"dispatch must be 'sort', 'scatter' or "
                             f"'einsum', got {dispatch!r}")
        self.input_size = input_size
        self.hidden_size = hidden_size
        self.n_experts = n_experts
        self.k = min(k, n_experts)
        self.capacity_factor = capacity_factor
        self.activation = activation
        self.aux_loss_weight = aux_loss_weight
        self.dispatch = dispatch
        d, h, e = input_size, hidden_size, n_experts
        self.gate_weight = torch.nn.Parameter(init.xavier((d, e), d, e))
        self.w1 = torch.nn.Parameter(
            torch.stack([init.xavier((d, h), d, h) for _ in range(e)]))
        self.b1 = torch.nn.Parameter(init.zeros((e, h)))
        self.w2 = torch.nn.Parameter(
            torch.stack([init.xavier((h, d), h, d) for _ in range(e)]))
        self.b2 = torch.nn.Parameter(init.zeros((e, d)))

    #: ``shard_experts``'s mesh and axis: the experts split over it
    _mesh = None
    _expert_axis: Optional[str] = None
    #: ``global_routing``'s mesh: the global batch routed over its data axis
    _route_mesh = None
    #: True: each forward leaves its routing in ``routing`` (``picks`` and
    #: ``keep``, (k, T) each), for checks
    record_routing = False

    def _act(self, x):
        # the reference's: gelu (tanh form) for "gelu", relu otherwise
        return (F.gelu(x, approximate="tanh") if self.activation == "gelu"
                else F.relu(x))

    # ------------------------------------------------------------ routing
    def _data_ranks(self) -> Tuple[int, int]:
        mesh = self._route_mesh
        if mesh is None:
            return 1, 0
        return mesh.axis_size(DATA_AXIS), mesh.axis_index(DATA_AXIS)

    def _global_offsets(self, counts: torch.Tensor) -> torch.Tensor:
        """(k, E) offsets turning a pick's local slot (its rank among this
        rank's picks of its expert, round-major) into its global one:
        every rank's picks of the expert in earlier rounds, less this
        rank's, plus the lower data ranks' in this round (one all-gather
        of ``counts``, this rank's (k, E) per-round picks)."""
        n, r = self._data_ranks()
        if n == 1:
            return torch.zeros_like(counts)
        every = self._route_mesh.all_gather(counts.float().reshape(-1),
                                            DATA_AXIS)
        every = every.view(n, *counts.shape).to(counts.dtype)   # (n, k, E)
        earlier = _exclusive_cumsum(every.sum(0) - counts, 0)
        lower = every[:r].sum(0)
        return earlier + lower

    def forward(self, input):
        orig_shape = input.shape
        d, e, k = self.input_size, self.n_experts, self.k
        x = input.reshape(-1, d)
        t = x.shape[0]
        n_data, _ = self._data_ranks()
        t_glob = t * n_data
        capacity = min(max(1, int(math.ceil(
            t_glob / e * self.capacity_factor * k))), t_glob)
        rows = min(capacity, t)     # a rank's buffer rows an expert

        from bigdl_tpu_torch.telemetry import get_registry, instruments
        instruments(get_registry()).moe_dispatch_total.labels(
            path=self.dispatch).inc()

        gw = self.gate_weight
        gt = torch.promote_types(x.dtype, gw.dtype)
        logits = x.to(gt) @ gw.to(gt)                          # (T, E)
        probs = torch.softmax(logits.float(), dim=-1)

        masked = probs
        topk_mask = torch.zeros_like(probs)
        picks, gates, onehots = [], [], []
        for _ in range(k):
            pick = torch.argmax(masked, dim=-1)                # first max
            onehot = _one_hot(pick, e)
            topk_mask = topk_mask + onehot
            gates.append(torch.sum(probs * onehot, dim=-1))
            picks.append(pick)
            onehots.append(onehot)
            masked = masked * (1.0 - onehot)

        long_oh = [o.to(torch.int64) for o in onehots]
        counts = torch.stack([o.sum(0) for o in long_oh])       # (k, E)
        before = _exclusive_cumsum(counts, 0)                   # (k, E)
        if self.dispatch == "sort":
            kt = k * t
            expert_flat = torch.cat(picks)                      # (kT,)
            order = torch.argsort(expert_flat, stable=True)
            per_expert = counts.sum(0)                          # (E,)
            offsets = _exclusive_cumsum(per_expert, 0)
            inv = torch.empty_like(order).scatter_(
                0, order, torch.arange(kt, device=order.device))
            slot_flat = inv - offsets[expert_flat]
            slots = list(slot_flat.view(k, t).unbind(0))
        else:
            slots = [(_exclusive_cumsum(o, 0) * o).sum(-1)
                     + before[j][picks[j]] for j, o in enumerate(long_oh)]
        shift = self._global_offsets(counts)                   # (k, E)
        keeps, ws, kept_slots = [], [], []
        for j in range(k):
            keep = (slots[j] + shift[j][picks[j]]) < capacity
            keeps.append(keep)
            ws.append(gates[j] * keep)
            kept_slots.append(torch.where(keep, slots[j],
                                          torch.zeros_like(slots[j])))

        if self.record_routing:
            self.routing = {"picks": torch.stack(picks).detach(),
                            "keep": torch.stack(keeps).detach()}
        denom = sum(ws)
        scale = torch.sum(probs * topk_mask, dim=-1)
        coef = scale / torch.clamp(denom, min=1e-9)

        cd = input.dtype
        if self.dispatch == "sort":
            sorted_tokens = torch.arange(t, device=x.device).repeat(k)[order]
            ar = torch.arange(rows, device=x.device)
            n_kept = sum((o * kp[:, None]).sum(0)
                         for o, kp in zip(long_oh, keeps))       # (E,)
            src = offsets[:, None] + ar[None, :]
            valid = ar[None, :] < n_kept[:, None]               # (E, C)
            gathered = sorted_tokens[src.clamp(0, kt - 1)]
            xe = torch.where(valid[:, :, None], x[gathered],
                             torch.zeros((), dtype=x.dtype,
                                         device=x.device)).to(cd)
        elif self.dispatch == "scatter":
            # one use of x: the k rounds' rows in one accumulate
            keep_flat = torch.cat(keeps).to(cd)[:, None]
            xe = torch.zeros((e, rows, d), dtype=cd, device=x.device)
            xe = xe.index_put((torch.cat(picks), torch.cat(kept_slots)),
                              x.to(cd).repeat(k, 1) * keep_flat,
                              accumulate=True)
        else:
            dispatch_t = torch.zeros((t, e, rows), dtype=cd, device=x.device)
            for pick, slot, keep in zip(picks, kept_slots, keeps):
                dispatch_t = dispatch_t + (
                    _one_hot(pick, e, cd)[:, :, None]
                    * _one_hot(slot, rows, cd)[:, None, :]
                    * keep[:, None, None].to(cd))
            # "tec,td->ecd" as one product over the flat (E*C) rows
            xe = (dispatch_t.reshape(t, e * rows).T @ x.to(cd)).reshape(
                e, rows, d)

        ye = self._experts(xe, cd)                              # (E, C, D)

        # the combine in f32, round by round in the pick order: a gather of
        # (expert, slot) rows, or (einsum) a dense (T, E, C) selection of
        # them, so that the three dispatches agree bit for bit
        y = torch.zeros((t, d), dtype=torch.float32, device=x.device)
        ye32 = ye.float()
        for pick, slot, keep, w in zip(picks, kept_slots, keeps, ws):
            if self.dispatch == "einsum":
                sel = (_one_hot(pick, e)[:, :, None]
                       * _one_hot(slot, rows)[:, None, :]
                       * keep[:, None, None])
                rows_j = sel.reshape(t, e * rows) @ ye32.reshape(e * rows, d)
            else:
                rows_j = ye32[pick, slot]
            y = y + (w * coef)[:, None] * rows_j
        y = y.to(input.dtype)

        if self.aux_loss_weight and self.training:
            if n_data == 1:
                frac = torch.mean(topk_mask / k, dim=0)
            else:
                frac = self._route_mesh.all_reduce(
                    torch.sum(topk_mask / k, dim=0), axis=DATA_AXIS) / t_glob
            mean_p = torch.mean(probs, dim=0)
            aux = e * torch.sum(frac * mean_p) * self.aux_loss_weight
            y = inject_loss(y, aux)
        return y.reshape(orig_shape)

    def _experts(self, xe: torch.Tensor, cd) -> torch.Tensor:
        """The experts' FFNs on the (E, C, D) buffer: under an expert axis
        this rank's E / N rows against its E / N experts, the outputs
        gathered back."""
        axis = self._expert_axis
        if axis is not None:
            from bigdl_tpu_torch.parallel.tensor_parallel import split
            xe = split(xe, self._mesh, axis, 0)
        hdn = self._act(torch.bmm(xe, self.w1.to(cd))
                        + self.b1.to(cd)[:, None, :])
        ye = torch.bmm(hdn, self.w2.to(cd)) + self.b2.to(cd)[:, None, :]
        if axis is not None:
            from bigdl_tpu_torch.parallel.tensor_parallel import gather
            ye = gather(ye, self._mesh, axis, 0)
        return ye

    def extra_repr(self) -> str:
        return (f"{self.input_size}->{self.hidden_size}, "
                f"experts={self.n_experts}, k={self.k}")


def expert_param_specs(moe: MoE, axis: str = EXPERT_AXIS
                       ) -> Dict[str, Tuple]:
    """Specs sharding the stacked expert leaves over ``axis`` (the gate
    replicated), as the reference's."""
    return {"gate_weight": (), "w1": (axis, None, None), "b1": (axis, None),
            "w2": (axis, None, None), "b2": (axis, None)}


_EXPERT_LEAVES = ("w1", "b1", "w2", "b2")


@contextlib.contextmanager
def global_routing(model, mesh):
    """Inside the block every ``MoE`` under ``model`` routes the global
    batch over ``mesh``'s data axis (collective: every data rank runs the
    same forwards); after it each routes the tokens it is given again.
    Yields the layers reached."""
    moes = [m for m in model.modules() if isinstance(m, MoE)]
    for m in moes:
        m._route_mesh = mesh
    try:
        yield len(moes)
    finally:
        for m in moes:
            m._route_mesh = None


def shard_experts(model, mesh, axis: str = EXPERT_AXIS) -> Dict[str, Tuple]:
    """Keep this rank's E / N experts of every ``MoE`` under ``model``
    (their stacked leaves cut on dim 0) and route through ``mesh``;
    returns the expert leaves' specs by dotted name. A model already
    sharded over this mesh is left as it is."""
    if getattr(model, "_ep_mesh", None) is mesh:
        return model._ep_specs
    n, r = mesh.axis_size(axis), mesh.axis_index(axis)
    specs = {}
    for prefix, m in model.named_modules():
        if not isinstance(m, MoE):
            continue
        if m.n_experts % n:
            raise ValueError(f"{m.n_experts} experts do not divide over the "
                             f"{axis!r} axis's {n} ranks")
        m._mesh, m._expert_axis = mesh, axis
        base = f"{prefix}." if prefix else ""
        for name, spec in expert_param_specs(m, axis).items():
            if name not in _EXPERT_LEAVES:
                continue
            p = m._parameters[name]
            size = p.shape[0] // n
            with torch.no_grad():
                p.data = p.data.narrow(0, r * size, size).contiguous()
            specs[base + name] = spec
    model._ep_mesh, model._ep_specs = mesh, specs
    return specs


def gather_experts(model, tensors: Dict[str, torch.Tensor]
                   ) -> Dict[str, torch.Tensor]:
    """``tensors`` (by parameter name; this rank's expert slices, or any
    leaf shaped like one) with the expert leaves all-gathered over the
    expert axis (collective)."""
    mesh, specs = model._ep_mesh, model._ep_specs
    out = dict(tensors)
    for name, spec in specs.items():
        if name in out:
            out[name] = mesh.all_gather(out[name].contiguous(), spec[0], dim=0)
    return out


def local_experts(model, tensors: Dict) -> Dict:
    """Full leaves (tensors or numpy, by parameter name) cut to this
    rank's experts (the inverse of ``gather_experts``)."""
    mesh, specs = model._ep_mesh, model._ep_specs
    out = dict(tensors)
    for name, spec in specs.items():
        if name not in out:
            continue
        n, r = mesh.axis_size(spec[0]), mesh.axis_index(spec[0])
        full = out[name]
        size = full.shape[0] // n
        out[name] = full[r * size:(r + 1) * size]
    return out
