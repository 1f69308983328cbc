"""Data of the causal-LM app (counterpart of ``bigdl_tpu/apps/transformer.py``;
only its synthetic corpus is ported, the command line waits for ROADMAP A8).
"""

from __future__ import annotations

from typing import List

import numpy as np

from bigdl_tpu_torch.dataset.base import Sample


def synthetic_corpus(n: int, seq_len: int, vocab: int,
                     seed: int = 17) -> List[Sample]:
    """Next-token samples over a learnable synthetic grammar: token t+1 is a
    fixed affine map of token t, replaced by a uniform draw one time in ten
    (the reference's ``_synthetic_corpus``, the same numbers from the same
    seed). Features and labels are 1-based ids as float32."""
    rng = np.random.RandomState(seed)
    samples = []
    for _ in range(n):
        toks = np.empty(seq_len + 1, np.int64)
        toks[0] = rng.randint(1, vocab + 1)
        for t in range(seq_len):
            nxt = (toks[t] * 31 + 7) % vocab + 1
            toks[t + 1] = nxt if rng.rand() < 0.9 \
                else rng.randint(1, vocab + 1)
        samples.append(Sample(toks[:-1].astype(np.float32),
                              toks[1:].astype(np.float32)))
    return samples
