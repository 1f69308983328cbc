"""Recurrent models (counterpart of ``bigdl_tpu/models/rnn.py``): the
SimpleRNN language model (``build``) and the LSTM/GRU/RNN text classifier
(``build_classifier``), which ``apps/perf.py``'s ``lstm`` model runs.
Parameters are drawn on the CPU from ``seed`` (PyTorch's global generator
is left as it was), then the model moves to ``device``.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch.nn.activation import LogSoftMax
from bigdl_tpu_torch.nn.containers import Sequential
from bigdl_tpu_torch.nn.linear import Linear, LookupTable
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.nn.recurrent import (GRU, LSTM, Recurrent, RnnCell,
                                          TimeDistributed)
from bigdl_tpu_torch.utils.device import DeviceLike, resolve_device

CELLS = {"lstm": LSTM, "gru": GRU, "rnn": RnnCell}


def build(input_size: int, hidden_size: int, output_size: int, *,
          device: DeviceLike = "cuda", seed: int = 0) -> Sequential:
    """SimpleRNN: one-hot (N, T, input_size) -> (N, T, output_size)
    log-probs (train with
    ``TimeDistributedCriterion(ClassNLLCriterion())``)."""
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = (Sequential()
                 .add(Recurrent().add(RnnCell(input_size, hidden_size)))
                 .add(TimeDistributed(Sequential()
                                      .add(Linear(hidden_size, output_size))
                                      .add(LogSoftMax()))))
    return model.to(dev)


class _LastStep(Module):
    """The last timestep of (N, T, H)."""

    def forward(self, input):
        return input[:, -1, :]


def build_classifier(vocab_size: int, embed_dim: int, hidden_size: int,
                     class_num: int, cell: str = "lstm", *,
                     device: DeviceLike = "cuda", seed: int = 0
                     ) -> Sequential:
    """Text classifier: 1-based token ids (N, T) -> ``LookupTable`` ->
    ``Recurrent`` of ``cell`` (``"lstm"``, ``"gru"`` or ``"rnn"``) -> the
    last state -> ``Linear`` -> ``LogSoftMax``."""
    if cell not in CELLS:
        raise ValueError(f"unknown cell {cell!r}: one of {sorted(CELLS)}")
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = (Sequential()
                 .add(LookupTable(vocab_size, embed_dim))
                 .add(Recurrent().add(CELLS[cell](embed_dim, hidden_size)))
                 .add(_LastStep())
                 .add(Linear(hidden_size, class_num))
                 .add(LogSoftMax()))
    return model.to(dev)
