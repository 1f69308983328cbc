"""Linear layers of the LM slice (counterpart of ``bigdl_tpu/nn/linear.py``:
``Linear``, ``LookupTable``, ``LMHead`` and ``TiedLMHead`` are ported).

Weight layouts keep the reference's (and Torch's) conventions: (out, in)
for ``Linear`` and the heads, (vocab, dim) for the embedding table.
Parameters are drawn with the reference's distributions from the
``generator`` a builder passes (PyTorch's default one when it passes
none); weights that must match another model are carried across with
``interop.state_dict``.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.nn import initialization as init
from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.precision import match_compute


def _uniform(shape, fan_in: int,
             generator: Optional[torch.Generator] = None
             ) -> torch.nn.Parameter:
    """Torch default init: uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return torch.nn.Parameter(init.default_init(shape, fan_in, generator))


class Linear(Module):
    """Affine map ``y = x W^T + b`` (reference ``nn/linear.py:Linear``)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.weight = _uniform((output_size, input_size), input_size,
                               generator)
        if with_bias:
            self.bias = _uniform((output_size,), input_size, generator)

    def forward(self, input):
        y = torch.matmul(match_compute(input, self.weight), self.weight.T)
        if self.with_bias:
            y = y + self.bias
        return y


class LookupTable(Module):
    """Embedding lookup with 1-based ids (reference
    ``nn/linear.py:LookupTable``; padding and max-norm are not ported). Ids
    are clipped into ``[1, n_index]``, never rejected."""

    def __init__(self, n_index: int, n_output: int):
        super().__init__()
        self.n_index, self.n_output = n_index, n_output
        self.weight = torch.nn.Parameter(torch.randn(n_index, n_output))

    def _ids(self, input):
        return (input.to(torch.int64) - 1).clamp(0, self.n_index - 1)

    def forward(self, input):
        return self.weight[self._ids(input)]


class _VocabHead(Module):
    """What the two LM heads share: the last position only while decoding,
    unless ``_decode_all`` is set (the serving engine's bucketed prefill
    reads the true last token inside a padded bucket, and speculative
    verification reads every position of its chunk).

    In training mode a head returns the tuple ``(hidden, weight[, bias])``
    that ``FusedLMHeadCriterion`` takes (the reference's ``Table``), so the
    (B, S, vocab) logits are never formed; in eval mode it returns
    log-probabilities."""

    _decode_all = False

    def _last(self, input):
        if self._decode and not self._decode_all:
            return input[:, -1:]
        return input


class LMHead(_VocabHead):
    """Vocabulary projection of the fused-CE LM tail (reference
    ``nn/linear.py:LMHead``)."""

    def __init__(self, input_size: int, vocab_size: int,
                 with_bias: bool = True):
        super().__init__()
        self.input_size = input_size
        self.vocab_size = vocab_size
        self.with_bias = with_bias
        self.weight = _uniform((vocab_size, input_size), input_size)
        if with_bias:
            self.bias = _uniform((vocab_size,), input_size)

    def forward(self, input):
        if self.training:
            if self.with_bias:
                return input, self.weight, self.bias
            return input, self.weight
        input = self._last(input)
        y = torch.matmul(match_compute(input, self.weight), self.weight.T)
        if self.with_bias:
            y = y + self.bias
        return torch.log_softmax(y, dim=-1)


class TiedLMHead(_VocabHead):
    """Vocabulary projection tied to the embedding table (reference
    ``nn/linear.py:TiedLMHead``). Holds a plain reference to the
    ``LookupTable`` (not a registered child, so the table is stored once)
    and reads its weight at forward time. Training mode hands out that live
    parameter (never a copy), so its gradient sums the lookup's and the
    head's."""

    def __init__(self, embed: LookupTable):
        super().__init__()
        # bypass Module.__setattr__: the embedding must not become a child
        object.__setattr__(self, "embed_ref", embed)

    def forward(self, input):
        w = self.embed_ref.weight
        if self.training:
            return input, w
        input = self._last(input)
        y = torch.matmul(match_compute(input, w), w.T)
        return torch.log_softmax(y, dim=-1)
