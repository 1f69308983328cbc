"""Timestep wrappers (counterpart of ``bigdl_tpu/nn/recurrent.py``: only
``TimeDistributed`` is ported, for the causal LM's unfused tail; the
recurrent cells wait for ROADMAP A.6)."""

from __future__ import annotations

from bigdl_tpu_torch.nn.module import Module


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
