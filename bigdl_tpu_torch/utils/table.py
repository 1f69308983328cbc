"""Lua-style ``Table`` and its ``T(...)`` builder (counterpart of
``bigdl_tpu/utils/table.py``: the hyper-parameter configs of ``Regime`` in
``optim/methods.py``, and the multi-tensor activities of the table
modules).

A dict whose positional entries are keyed 1, 2, ... The reference also
registers it as a JAX pytree, so that Tables of arrays flow through
``jit``; the port passes several inputs and outputs as lists or tuples
(``nn/graph.py``, ``nn/containers.py``), and every module that takes a
table takes a ``Table``, a list or a tuple alike (``elements``).
"""

from __future__ import annotations

from typing import Any, List


class Table(dict):
    """Heterogeneous container keyed by ints (1-based) or strings."""

    def __init__(self, *args: Any, **kwargs: Any):
        if len(args) == 1 and isinstance(args[0], dict):
            super().__init__(args[0])
        else:
            super().__init__({i + 1: v for i, v in enumerate(args)})
        self.update(kwargs)

    def length(self) -> int:
        """The number of positional entries 1, 2, ... (reference
        ``length``)."""
        n = 0
        while (n + 1) in self:
            n += 1
        return n

    def insert(self, value: Any) -> "Table":
        """``value`` as the next positional entry (reference ``insert``)."""
        self[self.length() + 1] = value
        return self

    def get_or_else(self, key: Any, default: Any) -> Any:
        return self.get(key, default)

    def clone(self) -> "Table":
        """A shallow copy (reference ``clone``)."""
        return Table(dict(self))


def elements(table) -> List[Any]:
    """The positional entries of a ``Table`` (keys 1, 2, ...), or of a list
    or tuple, as a list in order."""
    if isinstance(table, Table):
        return [table[i] for i in range(1, table.length() + 1)]
    return list(table)


def T(*args: Any, **kwargs: Any) -> Table:
    """Builder mirroring the reference's ``T(...)``."""
    return Table(*args, **kwargs)
