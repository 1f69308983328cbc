"""Linear layers of the LM slice (counterpart of ``bigdl_tpu/nn/linear.py``:
``Linear``, ``LookupTable``, ``LMHead`` and ``TiedLMHead`` are ported).

Weight layouts keep the reference's (and Torch's) conventions: (out, in)
for ``Linear`` and the heads, (vocab, dim) for the embedding table.
Parameters are drawn from PyTorch's default generator with the reference's
distributions; weights that must match another model are carried across
with ``interop.state_dict``.
"""

from __future__ import annotations

import math

import torch

from bigdl_tpu_torch.nn.module import Module
from bigdl_tpu_torch.ops.precision import match_compute


def _uniform(shape, fan_in: int) -> torch.nn.Parameter:
    """Torch default init: uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    stdv = 1.0 / math.sqrt(max(1, fan_in))
    return torch.nn.Parameter(torch.empty(shape).uniform_(-stdv, stdv))


class Linear(Module):
    """Affine map ``y = x W^T + b`` (reference ``nn/linear.py:Linear``)."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.weight = _uniform((output_size, input_size), input_size)
        if with_bias:
            self.bias = _uniform((output_size,), input_size)

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
    """What the two LM heads share: eval-mode only (the training-mode output,
    the Table the fused cross-entropy takes, waits for the training slice),
    and the last position only while decoding."""

    def _check_eval(self):
        if self.training:
            raise NotImplementedError(
                f"{type(self).__name__}: the training-mode output (fused "
                "cross-entropy) is not ported yet (ROADMAP A2); call "
                "evaluate_mode()")

    def _last(self, input):
        return input[:, -1:] if self._decode else input


class LMHead(_VocabHead):
    """Vocabulary projection of the fused-CE LM tail (reference
    ``nn/linear.py:LMHead``): log-probabilities in eval mode."""

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
        self._check_eval()
        input = self._last(input)
        y = torch.matmul(match_compute(input, self.weight), self.weight.T)
        if self.with_bias:
            y = y + self.bias
        return torch.log_softmax(y, dim=-1)


class TiedLMHead(_VocabHead):
    """Vocabulary projection tied to the embedding table (reference
    ``nn/linear.py:TiedLMHead``). Holds a plain reference to the
    ``LookupTable`` (not a registered child, so the table is stored once)
    and reads its weight at forward time."""

    def __init__(self, embed: LookupTable):
        super().__init__()
        # bypass Module.__setattr__: the embedding must not become a child
        object.__setattr__(self, "embed_ref", embed)

    def forward(self, input):
        self._check_eval()
        input = self._last(input)
        w = self.embed_ref.weight
        y = torch.matmul(match_compute(input, w), w.T)
        return torch.log_softmax(y, dim=-1)
