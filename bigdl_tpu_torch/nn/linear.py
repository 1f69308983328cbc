"""Linear layers (counterpart of ``bigdl_tpu/nn/linear.py``; every class
is ported).

Weight layouts keep the reference's (and Torch's) conventions: (out, in)
for ``Linear`` and the heads, (vocab, dim) for the embedding table.
Parameters are drawn with the reference's distributions from the
``generator`` a builder passes (PyTorch's default one when it passes
none); weights that must match another model are carried across with
``interop.state_dict``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from bigdl_tpu_torch.nn import initialization as init
from bigdl_tpu_torch.nn.module import Module, TensorModule
from bigdl_tpu_torch.ops.precision import match_compute
from bigdl_tpu_torch.utils.table import elements


def _uniform(shape, fan_in: int,
             generator: Optional[torch.Generator] = None
             ) -> torch.nn.Parameter:
    """Torch default init: uniform(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return torch.nn.Parameter(init.default_init(shape, fan_in, generator))


class Linear(TensorModule):
    """Affine map ``y = x W^T + b`` (reference ``nn/linear.py:Linear``);
    ``w_regularizer`` / ``b_regularizer`` ride on the weight and the
    bias."""

    def __init__(self, input_size: int, output_size: int,
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_size = input_size
        self.output_size = output_size
        self.with_bias = with_bias
        self.register_parameter(
            "weight", _uniform((output_size, input_size), input_size,
                               generator), w_regularizer)
        if with_bias:
            self.register_parameter(
                "bias", _uniform((output_size,), input_size, generator),
                b_regularizer)

    def forward(self, input):
        y = torch.matmul(match_compute(input, self.weight), self.weight.T)
        if self.with_bias:
            y = y + self.bias
        return y


class CAdd(TensorModule):
    """Learnable bias of any shape that broadcasts against the input
    (reference ``CAdd``), zeros at first: ViT's learned positions are one
    ``CAdd((n_patches, embed_dim))`` over (B, n_patches, embed_dim)."""

    def __init__(self, size: Sequence[int]):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.bias = torch.nn.Parameter(init.zeros(self.size))

    def forward(self, input):
        return input + self.bias


class Mul(TensorModule):
    """One learnable scalar gain (reference ``Mul``), drawn as the
    reference's ``default_init((1,), 1)``."""

    def __init__(self, *, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _uniform((1,), 1, generator)

    def forward(self, input):
        return input * self.weight[0]


class CMul(TensorModule):
    """Learnable componentwise gain of any broadcastable shape (reference
    ``CMul``), drawn with fan-in the number of its elements."""

    def __init__(self, size: Sequence[int], *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.size = tuple(int(s) for s in size)
        self.weight = _uniform(self.size, int(np.prod(self.size)), generator)

    def forward(self, input):
        return input * self.weight


class LookupTable(TensorModule):
    """Embedding lookup with 1-based ids (reference
    ``nn/linear.py:LookupTable``). Ids are clipped into ``[1, n_index]``,
    never rejected.

    Rows whose id equals a non-zero ``padding_value`` come out zero. With a
    finite ``max_norm`` every forward looks up a renormalised table: a row
    whose ``norm_type``-norm exceeds ``max_norm`` is scaled down to it. As
    in the reference the renormalisation is part of the forward (the
    gradient flows through the scaling) and the stored weight is left as
    it is. ``should_scale_grad_by_freq`` is accepted and, as in the
    reference, changes nothing."""

    def __init__(self, n_index: int, n_output: int,
                 padding_value: float = 0.0,
                 max_norm: float = float("inf"), norm_type: float = 2.0,
                 should_scale_grad_by_freq: bool = False):
        super().__init__()
        self.n_index, self.n_output = n_index, n_output
        self.padding_value = padding_value
        self.max_norm = max_norm
        self.norm_type = norm_type
        self.should_scale_grad_by_freq = should_scale_grad_by_freq
        self.weight = torch.nn.Parameter(torch.randn(n_index, n_output))

    def _ids(self, input):
        return (input.to(torch.int64) - 1).clamp(0, self.n_index - 1)

    def _pad(self, input, out):
        if self.padding_value != 0:
            out = torch.where((input == self.padding_value)[..., None],
                              0.0, out)
        return out

    def forward(self, input):
        w = self.weight
        if self.max_norm != float("inf"):
            norms = torch.linalg.vector_norm(w, ord=self.norm_type, dim=1,
                                             keepdim=True)
            w = torch.where(norms > self.max_norm,
                            w * (self.max_norm / norms), w)
        return self._pad(input, w[self._ids(input)])


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
                 with_bias: bool = True, w_regularizer=None,
                 b_regularizer=None):
        super().__init__()
        self.input_size = input_size
        self.vocab_size = vocab_size
        self.with_bias = with_bias
        self.register_parameter(
            "weight", _uniform((vocab_size, input_size), input_size),
            w_regularizer)
        if with_bias:
            self.register_parameter(
                "bias", _uniform((vocab_size,), input_size), b_regularizer)

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
        if embed.max_norm != float("inf"):
            raise ValueError(
                "cannot tie to a max-norm LookupTable: the embedding path "
                "renormalises per forward, so the head would project with "
                "a different matrix than the one that embeds")
        # bypass Module.__setattr__: the embedding must not become a child
        object.__setattr__(self, "embed_ref", embed)

    def forward(self, input):
        w = self.embed_ref.weight
        if self.training:
            return input, w
        input = self._last(input)
        y = torch.matmul(match_compute(input, w), w.T)
        return torch.log_softmax(y, dim=-1)


class Add(TensorModule):
    """Learnable bias of ``input_size`` (reference ``Add``)."""

    def __init__(self, input_size: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bias = _uniform((input_size,), input_size, generator)

    def forward(self, input):
        return input + self.bias


class Scale(TensorModule):
    """``CMul`` then ``CAdd`` of one shape (reference ``Scale``; children
    ``cmul`` and ``cadd``)."""

    def __init__(self, size: Sequence[int], *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cmul = CMul(size, generator=generator)
        self.cadd = CAdd(size)

    def forward(self, input):
        return self.cadd(self.cmul(input))


class Bilinear(Module):
    """``y_k = x1^T W_k x2 + b_k`` over the table {x1 (N, I1), x2 (N, I2)}
    (reference ``Bilinear``); weight (O, I1, I2)."""

    def __init__(self, input_size1: int, input_size2: int, output_size: int,
                 bias_res: bool = True, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.bias_res = bias_res
        fan_in = input_size1 * input_size2
        self.weight = _uniform((output_size, input_size1, input_size2),
                               fan_in, generator)
        if bias_res:
            self.bias = _uniform((output_size,), fan_in, generator)

    def forward(self, input):
        x1, x2 = elements(input)[:2]
        y = torch.einsum("ni,oij,nj->no", x1, self.weight, x2)
        if self.bias_res:
            y = y + self.bias
        return y


class Cosine(TensorModule):
    """Cosine similarity of the input to each weight row (reference
    ``Cosine``); norms are floored at 1e-12."""

    def __init__(self, input_size: int, output_size: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _uniform((output_size, input_size), input_size,
                               generator)

    def forward(self, input):
        w = self.weight / torch.linalg.vector_norm(
            self.weight, dim=1, keepdim=True).clamp_min(1e-12)
        x = input / torch.linalg.vector_norm(
            input, dim=-1, keepdim=True).clamp_min(1e-12)
        return torch.matmul(x, w.T)


class Euclidean(TensorModule):
    """Euclidean distance of the input to each weight column (reference
    ``Euclidean``); weight (input_size, output_size)."""

    def __init__(self, input_size: int, output_size: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.weight = _uniform((input_size, output_size), input_size,
                               generator)

    def forward(self, input):
        diff = input[..., :, None] - self.weight
        return torch.sqrt((diff * diff).sum(dim=-2).clamp_min(1e-24))


class MM(Module):
    """Batched matrix product of the table {A, B}, either transposed
    first (reference ``MM``)."""

    def __init__(self, trans_a: bool = False, trans_b: bool = False):
        super().__init__()
        self.trans_a, self.trans_b = trans_a, trans_b

    def forward(self, input):
        a, b = elements(input)[:2]
        if self.trans_a:
            a = a.transpose(-1, -2)
        if self.trans_b:
            b = b.transpose(-1, -2)
        return torch.matmul(a, b)


class MV(Module):
    """Batched matrix-vector product of the table {M, v} (reference
    ``MV``)."""

    def __init__(self, trans: bool = False):
        super().__init__()
        self.trans = trans

    def forward(self, input):
        m, v = elements(input)[:2]
        if self.trans:
            m = m.transpose(-1, -2)
        return torch.einsum("...ij,...j->...i", m, v)


class DotProduct(Module):
    """Row-wise dot product of the table {x, y} (reference
    ``DotProduct``)."""

    def forward(self, input):
        x, y = elements(input)[:2]
        return (x * y).sum(dim=-1)
