"""BigDL-style module base over ``torch.nn.Module``.

Counterpart of ``bigdl_tpu/nn/module.py``. The JAX package splits module
objects from a pure ``functional_apply`` so that XLA can trace them; PyTorch
runs eagerly, so the port keeps only the object half: subclasses implement
``forward``, hold weights as parameters and decode state (KV caches,
positions) as module state, and keep the reference's ``evaluate_mode()``.
"""

from __future__ import annotations

import torch


class Module(torch.nn.Module):
    """Base of every port module.

    ``enable_decode`` / ``disable_decode`` is the incremental-generation hook
    that ``models.generation.generate`` toggles: here it only flips
    ``_decode``; modules that keep decode state (``MultiHeadAttention``'s KV
    cache, ``PositionalEncoding``'s offset) extend it."""

    _decode = False

    #: caches that models attach through ``__dict__`` and that must not go
    #: with a model through ``copy.deepcopy`` or pickle (the reference's
    #: ``Module._EPHEMERAL_CACHES``): the serving engine's prefix trie holds
    #: KV snapshots and a thread lock
    _EPHEMERAL_CACHES = ("_prefix_trie",)

    def __getstate__(self):
        d = self.__dict__.copy()
        for key in self._EPHEMERAL_CACHES:
            d.pop(key, None)
        return d

    def evaluate_mode(self) -> "Module":
        return self.eval()

    def enable_decode(self) -> "Module":
        self._decode = True
        return self

    def disable_decode(self) -> "Module":
        self._decode = False
        return self
