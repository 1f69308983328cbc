"""Recurrent layers (counterpart of ``bigdl_tpu/nn/recurrent.py``: ``Cell``,
``RnnCell``, ``LSTM``, ``LSTMPeephole``, ``GRU``, ``Recurrent``,
``RecurrentDecoder``, ``BiRecurrent`` and ``TimeDistributed``).

Input is batch-first (N, T, F). The gate layouts and parameter names are
the reference's (Torch's): LSTM gates i, f, g, o stacked in one (4H, F)
``w_ih``, (4H, H) ``w_hh`` and (4H,) ``bias``; GRU gates r, z, n with
separate input and hidden biases; so weights carry across with
``interop.state_dict`` as they are.

As in the reference, the state-independent input projection is hoisted
out of the time loop: ``Recurrent`` makes one (T*N, F) x (F, G) product for
the whole sequence (``project_input``), then loops over time with the
hidden projection and the gate arithmetic alone (``step_projected``). The
loop is a Python loop of eager launches, where the reference scans one
compiled program; ``Optimizer.set_steps_per_dispatch(k)`` captures it
whole in the window's CUDA graph on the card.
"""

from __future__ import annotations

import copy
from typing import Optional

import torch

from bigdl_tpu_torch.nn import initialization as init
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.precision import match_compute


def _param(shape, fan_in: int, generator: Optional[torch.Generator]):
    return torch.nn.Parameter(init.default_init(shape, fan_in, generator))


class Cell(Module):
    """Recurrent cell protocol (reference ``Cell``): ``step(x_t, state) ->
    (out_t, new_state)``; ``initial_state(batch_size, dtype, device)``
    builds zeros. A cell whose input enters its gates independently of the
    state implements the split protocol ``project_input`` (any leading
    dims) and ``step_projected``, and ``Recurrent`` hoists the first out of
    its time loop. ``forward((x_t, state))`` is one step."""

    hidden_size: int

    def step(self, x_t, state):
        px = self.project_input(x_t)
        if px is None:
            raise NotImplementedError(
                f"{type(self).__name__} must implement step() or the "
                "project_input/step_projected pair")
        return self.step_projected(px, state)

    def initial_state(self, batch_size: int, dtype=torch.float32,
                      device=None):
        raise NotImplementedError

    def project_input(self, xs):
        """xs (..., F) -> the input's share of the gates (..., G), or None
        when the cell has no hoistable input path."""
        return None

    def step_projected(self, px_t, state):
        raise NotImplementedError

    def _zeros(self, batch_size, dtype, device):
        return torch.zeros((batch_size, self.hidden_size), dtype=dtype,
                           device=device)

    def forward(self, input):
        x_t, state = input
        return self.step(x_t, state)


class RnnCell(Cell):
    """Vanilla RNN cell ``act(W x + U h + b)`` (reference ``RnnCell``)."""

    def __init__(self, input_size: int, hidden_size: int,
                 activation=torch.tanh, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.activation = activation
        self.w_ih = _param((hidden_size, input_size), input_size, generator)
        self.w_hh = _param((hidden_size, hidden_size), hidden_size, generator)
        self.bias = _param((hidden_size,), input_size, generator)

    def project_input(self, xs):
        return xs @ self.w_ih.T + self.bias

    def step_projected(self, px_t, h):
        h_new = self.activation(px_t + h @ self.w_hh.T)
        return h_new, h_new

    def initial_state(self, batch_size, dtype=torch.float32, device=None):
        return self._zeros(batch_size, dtype, device)


class LSTM(Cell):
    """LSTM cell with the i, f, g, o gates in one product (reference
    ``LSTM``); ``forget_bias`` is added to the forget gate's input."""

    def __init__(self, input_size: int, hidden_size: int,
                 forget_bias: float = 0.0, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        self.forget_bias = forget_bias
        h4 = 4 * hidden_size
        self.w_ih = _param((h4, input_size), input_size, generator)
        self.w_hh = _param((h4, hidden_size), hidden_size, generator)
        self.bias = _param((h4,), input_size, generator)

    def project_input(self, xs):
        return xs @ self.w_ih.T + self.bias

    def step_projected(self, px_t, state):
        h, c = state
        i, f, g, o = (px_t + h @ self.w_hh.T).chunk(4, dim=-1)
        c_new = (torch.sigmoid(f + self.forget_bias) * c
                 + torch.sigmoid(i) * torch.tanh(g))
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        return h_new, (h_new, c_new)

    def initial_state(self, batch_size, dtype=torch.float32, device=None):
        z = self._zeros(batch_size, dtype, device)
        return (z, z)


class LSTMPeephole(Cell):
    """LSTM with peephole connections (reference ``LSTMPeephole``): the i
    and f gates see c_{t-1}, the o gate sees c_t, through elementwise
    weights ``p_i``, ``p_f``, ``p_o``."""

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        h4 = 4 * hidden_size
        self.w_ih = _param((h4, input_size), input_size, generator)
        self.w_hh = _param((h4, hidden_size), hidden_size, generator)
        self.bias = _param((h4,), input_size, generator)
        self.p_i = _param((hidden_size,), hidden_size, generator)
        self.p_f = _param((hidden_size,), hidden_size, generator)
        self.p_o = _param((hidden_size,), hidden_size, generator)

    def project_input(self, xs):
        return xs @ self.w_ih.T + self.bias

    def step_projected(self, px_t, state):
        h, c = state
        i, f, g, o = (px_t + h @ self.w_hh.T).chunk(4, dim=-1)
        c_new = (torch.sigmoid(f + self.p_f * c) * c
                 + torch.sigmoid(i + self.p_i * c) * torch.tanh(g))
        h_new = torch.sigmoid(o + self.p_o * c_new) * torch.tanh(c_new)
        return h_new, (h_new, c_new)

    def initial_state(self, batch_size, dtype=torch.float32, device=None):
        z = self._zeros(batch_size, dtype, device)
        return (z, z)


class GRU(Cell):
    """GRU cell, r, z, n gates in one product each side (reference
    ``GRU``)."""

    def __init__(self, input_size: int, hidden_size: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size, self.hidden_size = input_size, hidden_size
        h3 = 3 * hidden_size
        self.w_ih = _param((h3, input_size), input_size, generator)
        self.w_hh = _param((h3, hidden_size), hidden_size, generator)
        self.bias_ih = _param((h3,), input_size, generator)
        self.bias_hh = _param((h3,), hidden_size, generator)

    def project_input(self, xs):
        return xs @ self.w_ih.T + self.bias_ih

    def step_projected(self, px_t, h):
        i_r, i_z, i_n = px_t.chunk(3, dim=-1)
        h_r, h_z, h_n = (h @ self.w_hh.T + self.bias_hh).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h_new = (1.0 - z) * n + z * h
        return h_new, h_new

    def initial_state(self, batch_size, dtype=torch.float32, device=None):
        return self._zeros(batch_size, dtype, device)


class Recurrent(Module):
    """Time loop over (N, T, F) input (reference ``Recurrent``): all the
    cell's outputs, (N, T, H). ``reverse`` runs the loop from the last
    step to the first and returns the outputs in input order."""

    def __init__(self, reverse: bool = False):
        super().__init__()
        self.cell: Optional[Cell] = None
        self.reverse = reverse

    def add(self, cell: Cell) -> "Recurrent":
        self.cell = cell
        return self

    def forward(self, input):
        if self.cell is None:
            raise ValueError("Recurrent needs a Cell: .add(LSTM(...))")
        cell = self.cell
        input = match_compute(input, cell.w_ih)
        state = cell.initial_state(input.shape[0], input.dtype, input.device)
        xs = input.transpose(0, 1)                 # (T, N, F), time-major
        if self.reverse:
            xs = xs.flip(0)
        px = cell.project_input(xs)                # one product for all T
        outs = []
        for t in range(xs.shape[0]):
            if px is None:
                out, state = cell.step(xs[t], state)
            else:
                out, state = cell.step_projected(px[t], state)
            outs.append(out)
        outs = torch.stack(outs)
        if self.reverse:
            outs = outs.flip(0)
        return outs.transpose(0, 1)                # (N, T, H)


class RecurrentDecoder(Recurrent):
    """Autoregressive decoder (reference ``RecurrentDecoder``): from one
    (N, F) input frame, feeds each output back as the next input for
    ``seq_length`` steps; (N, seq_length, H)."""

    def __init__(self, seq_length: int):
        super().__init__()
        self.seq_length = seq_length

    def forward(self, input):
        cell = self.cell
        x = match_compute(input, cell.w_ih)
        state = cell.initial_state(x.shape[0], x.dtype, x.device)
        outs = []
        for _ in range(self.seq_length):
            x, state = cell.step(x, state)
            outs.append(x)
        return torch.stack(outs, dim=1)


class BiRecurrent(Module):
    """Bidirectional wrapper (reference ``BiRecurrent``): a forward and a
    reversed ``Recurrent``, the second over a copy of the cell (its own
    parameters, starting equal), merged by ``"concat"`` on the feature
    axis or ``"sum"``."""

    def __init__(self, merge: str = "concat"):
        super().__init__()
        if merge not in ("concat", "sum"):
            raise ValueError(f"unknown merge {merge!r}")
        self.fwd = Recurrent()
        self.bwd = Recurrent(reverse=True)
        self.merge = merge

    def add(self, cell: Cell) -> "BiRecurrent":
        self.fwd.add(cell)
        self.bwd.add(copy.deepcopy(cell))
        return self

    def forward(self, input):
        a, b = self.fwd(input), self.bwd(input)
        return torch.cat([a, b], dim=-1) if self.merge == "concat" else a + b


class TimeDistributed(Module):
    """Apply an inner module at every timestep (reference
    ``TimeDistributed``): one reshape of (N, T, ...) to (N*T, ...), one
    application, one reshape back.

    In generation mode (``enable_decode``) only the last timestep is
    applied: an LM-head tail never needs the earlier positions while
    sampling. ``_decode_all`` (set by the serving engine's bucketed prefill
    and by speculative verification) keeps every position, as for the
    ``LMHead`` tails."""

    _decode_all = False

    def __init__(self, module: Module):
        super().__init__()
        self.inner = module

    def forward(self, input):
        if self._decode and not self._decode_all:
            input = input[:, -1:]
        n, t = input.shape[0], input.shape[1]
        out = self.inner(input.reshape((n * t,) + tuple(input.shape[2:])))
        return out.reshape((n, t) + tuple(out.shape[1:]))
