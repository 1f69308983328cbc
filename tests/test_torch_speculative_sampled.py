"""Rejection-sampled speculative decoding of the port, on the CPU.

JAX's PRNG draws cannot be matched token for token, so the port is held,
as the reference's ``tests/test_generation.py::TestSpeculativeSampled``
holds the reference, to the target's own distribution: the second emitted
token's frequencies over N runs against its exact marginal, enumerated at
a vocabulary of 12 (V=12, one layer), for a draft of other weights, a
second instance of the target's weights and a near-uniform draft. Bound:
Pearson chi-square below 45 at 11 degrees of freedom (the 0.999 quantile is
31.3); the draws come from seeded ``torch.Generator``s, so the test is
deterministic.
"""

import numpy as np
import pytest
import torch

from bigdl_tpu_torch.models.generation import generate_speculative
from bigdl_tpu_torch.models.transformer import build_lm

torch.set_num_threads(1)

V = 12
N = 700
CHI2_BOUND = 45.0


def _mk(seed):
    return build_lm(V, 16, 2, 32, num_layers=1, max_len=16, device="cpu",
                    seed=seed).evaluate_mode()


def _exact_marginal(target, prompt):
    """P(token at s0 + 1) = sum_x0 P(x0 | prompt) P(x1 | prompt, x0)."""
    with torch.inference_mode():
        p0 = torch.exp(target(torch.as_tensor(prompt))[0, -1].double())
        ext = torch.cat([torch.as_tensor(prompt).repeat(V, 1),
                         torch.arange(1, V + 1)[:, None]], dim=1)
        p1 = torch.exp(target(ext)[:, -1].double())
    marg = (p0[:, None] * p1).sum(0)
    return (marg / marg.sum()).numpy()


@pytest.mark.parametrize("draft_kind", ["independent", "identical",
                                        "uniformish"])
def test_matches_target_distribution(draft_kind):
    target = _mk(11)
    if draft_kind == "identical":
        draft = _mk(11)
    elif draft_kind == "uniformish":
        draft = _mk(12)
        with torch.no_grad():   # a shrunken head: near-uniform proposals
            for p in draft.parameters():
                p.mul_(0.05)
    else:
        draft = _mk(13)
    prompt = np.array([[3, 7, 2]])
    want = _exact_marginal(target, prompt)
    gen = torch.Generator().manual_seed(1234)
    counts = np.zeros(V)
    for _ in range(N):
        out = generate_speculative(target, draft, prompt, 3, spec_len=2,
                                   generator=gen, device="cpu")
        counts[int(out[0, prompt.shape[1] + 1]) - 1] += 1
    exp = want * N
    chi2 = float(((counts - exp) ** 2 / np.maximum(exp, 1e-9)).sum())
    assert chi2 < CHI2_BOUND, (draft_kind, chi2, counts / N, want)


def test_temperature_rescales_both_distributions():
    """At a low temperature the sampled run concentrates on the greedy
    token; outputs stay in the vocabulary."""
    target, draft = _mk(11), _mk(13)
    gen = torch.Generator().manual_seed(5)
    greedy = generate_speculative(target, draft, [[3, 7, 2]], 4,
                                  device="cpu")
    cold = generate_speculative(target, draft, [[3, 7, 2]], 4,
                                generator=gen, temperature=1e-3,
                                device="cpu")
    assert torch.equal(cold, greedy)
    hot = generate_speculative(target, draft, [[3, 7, 2]], 6, generator=gen,
                               temperature=2.0, device="cpu")
    assert hot.shape == (1, 9) and 1 <= hot.min() and hot.max() <= V
