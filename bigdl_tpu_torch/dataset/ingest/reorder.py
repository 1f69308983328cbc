"""Sequence-numbered reorder buffer (counterpart of
``bigdl_tpu/dataset/ingest/reorder.py``): the determinism hinge of the
pipelined ingest engine.

Worker pools finish out of order (shard 3's read may land before shard
1's); the consumer must see items in exact sequence order or shuffle
replay and mid-epoch resume (``bigdl_tpu_torch/resilience``) stop being
bit-exact. The buffer accepts ``(seq, item)`` pairs in any order and
releases them strictly ascending from 0.

Memory is NOT bounded here — the engine bounds it upstream with
admission tickets (a semaphore acquired before work is submitted,
released when the ordered consumer pops), so a producer holding the
*next* sequence number can never be blocked by the buffer itself: that
shape deadlocks, a ticket bound cannot.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

__all__ = ["ReorderBuffer"]

_WAIT_SLICE_S = 0.05  # poll quantum for stop-aware blocking waits


class ReorderBuffer:
    """Release out-of-order ``(seq, item)`` arrivals in ascending order.

    ``close(total)`` declares how many sequence numbers exist; ``pop``
    returns ``None`` once every one of them has been released. All waits
    are stop-aware: when ``stop`` is set mid-wait, ``put`` drops the item
    and ``pop`` returns ``None`` so pool threads can unwind.
    """

    def __init__(self) -> None:
        self._cond = threading.Condition()
        # all three guarded by _cond's lock (worker threads write _items
        # and _total; the consumer thread writes _next)
        self._items: Dict[int, Any] = {}
        self._next = 0
        self._total: Optional[int] = None

    def put(self, seq: int, item: Any, stop: threading.Event) -> bool:
        with self._cond:
            if stop.is_set():
                return False
            self._items[seq] = item
            self._cond.notify_all()
            return True

    def close(self, total: int) -> None:
        """Declare the final sequence count (producer side, once known)."""
        with self._cond:
            self._total = int(total)
            self._cond.notify_all()

    def pop(self, stop: threading.Event):
        """Next in-order item, blocking until it arrives; ``None`` at end
        of stream or when ``stop`` is set."""
        with self._cond:
            while True:
                if self._next in self._items:
                    item = self._items.pop(self._next)
                    self._next += 1
                    return item
                if self._total is not None and self._next >= self._total:
                    return None
                if stop.is_set():
                    return None
                self._cond.wait(_WAIT_SLICE_S)

    def pending(self) -> int:
        """Completed-but-unreleased items (queue-depth telemetry)."""
        with self._cond:
            return len(self._items)
