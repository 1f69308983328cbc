"""Cross-request KV prefix cache of the continuous serving engine
(counterpart of ``bigdl_tpu/models/prefix_cache.py``).

The chunked prefill (``models/serving.py``) snapshots its per-request
state (``generation.partition_prefill_state``: the b=1 KV caches and write
positions) at every FULL chunk boundary. A later admission whose prompt
shares a chunk-aligned prefix takes an owned copy of the deepest snapshot
and prefills only the tail. Resuming at a chunk boundary reproduces the
cold prefill's chunk partition of the remaining tokens (the same (1, C)
forwards on the same inputs), so a hit gives the cold prefill's bits.

Entries are chunk-aligned token prefixes keyed by a polynomial rolling
hash, with the exact token tuple kept to reject collisions; a lookup
extends the hash one chunk at a time and probes deepest first. The bytes
held (the snapshot tensors' ``nbytes`` on their device) are bounded by
``max_bytes``: an insert over budget evicts least-recently-used entries one
at a time, and counts them. Every mutation holds the cache's lock.

The trie attaches to the model (``model.__dict__["_prefix_trie"]``, keyed
by (chunk, cache_len)), so a new server over the same weights starts warm;
``nn.Module.__getstate__`` drops it, so ``copy.deepcopy`` and pickle of a
served model carry neither the snapshots nor the lock.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import List, Sequence, Tuple

import torch

from bigdl_tpu_torch.models.generation import clone_prefill_state

__all__ = ["PrefixCache", "prefix_cache_for", "rolling_hash",
           "DEFAULT_PREFIX_CACHE_MB"]

#: Default held-snapshot budget (MiB) for one server's prefix trie.
DEFAULT_PREFIX_CACHE_MB = 64.0

# Polynomial rolling hash over 1-based token ids: extending a prefix by one
# chunk extends its hash without rehashing the prefix. Collisions are
# survivable (the stored token tuple is always compared).
_HASH_BASE = 1_000_003
_HASH_MOD = (1 << 61) - 1


def rolling_hash(tokens: Sequence[int], seed: int = 0) -> int:
    """Extend ``seed`` (the hash of everything before ``tokens``) by the
    given tokens, so ``rolling_hash(b, rolling_hash(a))`` equals
    ``rolling_hash(a + b)``."""
    h = seed
    for t in tokens:
        h = (h * _HASH_BASE + int(t) + 1) % _HASH_MOD
    return h


class _Node:
    """One stored chunk-aligned prefix: its exact tokens, the owned
    snapshot and its byte cost."""

    __slots__ = ("tokens", "state", "nbytes")

    def __init__(self, tokens: Tuple[int, ...], state: list, nbytes: int):
        self.tokens = tokens
        self.state = state
        self.nbytes = nbytes


class PrefixCache:
    """Chunk-aligned prefix trie of prefill-state snapshots (module doc),
    with cumulative ``hits``, ``misses`` and ``evictions`` counters."""

    def __init__(self, chunk: int, max_bytes: int):
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.chunk = int(chunk)
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        # rolling hash of the prefix -> _Node, in LRU order (oldest first)
        self._entries: "OrderedDict[int, _Node]" = OrderedDict()
        self.nbytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def boundaries(self) -> List[int]:
        """Stored prefix depths (token counts)."""
        with self._lock:
            return sorted(len(n.tokens) for n in self._entries.values())

    def match(self, tokens: Sequence[int]):
        """``(depth, owned copy of the snapshot)`` of the deepest cached
        chunk-aligned prefix of ``tokens``, or ``(0, None)``."""
        c = self.chunk
        tokens = [int(t) for t in tokens]
        probes: List[Tuple[int, int]] = []          # (depth, hash)
        h = 0
        for b in range(c, (len(tokens) // c) * c + 1, c):
            h = rolling_hash(tokens[b - c:b], h)
            probes.append((b, h))
        with self._lock:
            for depth, h in reversed(probes):
                node = self._entries.get(h)
                if node is not None and node.tokens == tuple(tokens[:depth]):
                    self._entries.move_to_end(h)
                    self.hits += 1
                    # copied inside the lock: an eviction must not drop the
                    # node mid-read
                    return depth, clone_prefill_state(node.state)
            self.misses += 1
        return 0, None

    def put(self, tokens: Sequence[int], state: list) -> int:
        """Store an owned copy of ``state`` for the chunk-aligned prefix
        ``tokens`` (the caller's state is written in place by the next
        chunk). A known prefix is refreshed in the LRU order without a
        copy; a snapshot larger than the whole budget is refused. Returns
        the number of evictions the insert forced."""
        if len(tokens) % self.chunk != 0 or not tokens:
            raise ValueError(
                f"prefix length {len(tokens)} is not a whole number of "
                f"chunks (chunk={self.chunk})")
        key = tuple(int(t) for t in tokens)
        h = rolling_hash(key)
        with self._lock:
            node = self._entries.get(h)
            if node is not None and node.tokens == key:
                self._entries.move_to_end(h)
                return 0
            nbytes = sum(x.nbytes for x in state if torch.is_tensor(x))
            if nbytes > self.max_bytes:
                return 0
            if node is not None:                    # hash collision: replace
                self.nbytes -= node.nbytes
            self._entries[h] = _Node(key, clone_prefill_state(state), nbytes)
            self.nbytes += nbytes
            evicted = 0
            # one entry at a time, oldest first; the newest always stays
            while self.nbytes > self.max_bytes and len(self._entries) > 1:
                _, old = self._entries.popitem(last=False)
                self.nbytes -= old.nbytes
                evicted += 1
            self.evictions += evicted
        return evicted

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self.nbytes = 0

    def __repr__(self) -> str:
        return (f"PrefixCache(chunk={self.chunk}, entries={len(self)}, "
                f"bytes={self.nbytes}/{self.max_bytes}, hits={self.hits}, "
                f"misses={self.misses}, evictions={self.evictions})")


def prefix_cache_for(model, *, chunk: int, cache_len: int,
                     max_bytes: int) -> PrefixCache:
    """Get or create the model's prefix trie for one prefill configuration.

    Keyed by (chunk, cache_len), the two numbers that shape a snapshot. At
    most four configurations are kept per model; the latest server's budget
    wins."""
    tries = model.__dict__.setdefault("_prefix_trie", OrderedDict())
    key = (int(chunk), int(cache_len))
    pc = tries.get(key)
    if pc is None:
        pc = tries[key] = PrefixCache(chunk, max_bytes)
        while len(tries) > 4:
            tries.popitem(last=False)
    else:
        tries.move_to_end(key)
        pc.max_bytes = int(max_bytes)
    return pc
