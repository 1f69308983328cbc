"""Lua-style ``Table`` and its ``T(...)`` builder (counterpart of
``bigdl_tpu/utils/table.py``, the part a hyper-parameter config needs:
``Regime``'s in ``optim/methods.py``).

A dict whose positional entries are keyed 1, 2, ... The reference also
registers it as a JAX pytree, so that Tables of arrays flow through
``jit``; the port passes several inputs and outputs as tuples instead
(``nn/graph.py``).
"""

from __future__ import annotations

from typing import Any


class Table(dict):
    """Heterogeneous container keyed by ints (1-based) or strings."""

    def __init__(self, *args: Any, **kwargs: Any):
        if len(args) == 1 and isinstance(args[0], dict):
            super().__init__(args[0])
        else:
            super().__init__({i + 1: v for i, v in enumerate(args)})
        self.update(kwargs)


def T(*args: Any, **kwargs: Any) -> Table:
    """Builder mirroring the reference's ``T(...)``."""
    return Table(*args, **kwargs)
