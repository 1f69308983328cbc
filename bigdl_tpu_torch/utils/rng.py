"""RandomGenerator: the host's seedable generator (counterpart of
``bigdl_tpu/utils/rng.py``, its host half).

A process-global object per thread (``RandomGenerator.RNG()``, seed 1 until
``set_seed``) whose draws are numpy's, from ``np.random.default_rng(seed)``,
as the reference's are. The data pipeline's augmentations (crops, flips,
colour jitter, lighting) draw from it in the reference's order, so one seed
gives both packages the same images bit for bit.

The reference's JAX key plumbing (``next_key``, ``get_key_state``,
``set_key_state``) has no counterpart: the port's modules draw dropout
masks from their own ``torch.Generator`` (``nn/regularization.py``).
"""

from __future__ import annotations

import threading

import numpy as np


class RandomGenerator:
    """Per-thread seedable generator (reference ``RandomGenerator.RNG``)."""

    _thread_local = threading.local()

    def __init__(self, seed: int = 1):
        self.set_seed(seed)

    @classmethod
    def RNG(cls) -> "RandomGenerator":
        inst = getattr(cls._thread_local, "inst", None)
        if inst is None:
            inst = cls(seed=1)
            cls._thread_local.inst = inst
        return inst

    def set_seed(self, seed: int) -> "RandomGenerator":
        self._seed = int(seed)
        self._np = np.random.default_rng(self._seed)
        return self

    def get_seed(self) -> int:
        return self._seed

    def uniform(self, low: float = 0.0, high: float = 1.0, size=None):
        return self._np.uniform(low, high, size)

    def normal(self, mean: float = 0.0, stdv: float = 1.0, size=None):
        return self._np.normal(mean, stdv, size)

    def exponential(self, lam: float = 1.0, size=None):
        return self._np.exponential(1.0 / lam, size)

    def cauchy(self, median: float = 0.0, sigma: float = 1.0, size=None):
        return median + sigma * self._np.standard_cauchy(size)

    def log_normal(self, mean: float = 1.0, stdv: float = 2.0, size=None):
        # Torch semantics: mean and stdv are of the lognormal itself
        var = stdv * stdv
        mu = np.log(mean * mean / np.sqrt(var + mean * mean))
        sigma = np.sqrt(np.log(var / (mean * mean) + 1.0))
        return self._np.lognormal(mu, sigma, size)

    def geometric(self, p: float = 0.5, size=None):
        return self._np.geometric(p, size)

    def bernoulli(self, p: float = 0.5, size=None):
        return (self._np.random(size) < p).astype(np.float32)

    def randperm(self, n: int) -> np.ndarray:
        """1-based random permutation (Torch ``randperm`` semantics)."""
        return self._np.permutation(n) + 1

    def shuffle(self, arr) -> None:
        self._np.shuffle(arr)


def manual_seed(seed: int) -> None:
    RandomGenerator.RNG().set_seed(seed)
