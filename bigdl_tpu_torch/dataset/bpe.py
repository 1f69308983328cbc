"""Byte-level BPE tokenizer (counterpart of ``bigdl_tpu/dataset/bpe.py``),
the open-vocabulary companion of ``dataset/text.py`` for causal LMs:

- the base vocabulary is the 256 bytes, so any text encodes losslessly
  and decodes to the exact string;
- training merges the most frequent adjacent pair until ``vocab_size``,
  ties broken on the larger pair, as the reference's
  ``max(pairs.items(), key=(freq, pair))`` does, so the merges, the ids
  and the saved file are the reference's;
- words split on the ASCII space byte only, the space carried as a word
  prefix: merges never cross a space; tabs and newlines stay inside words.

Ids follow the framework's 1-based convention (``LookupTable``): byte
``b`` is ``b + 1`` (1..256), merged symbols 257, 258, ... in merge order,
and ``eos_id`` is one past the vocabulary. Pure Python on the host.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Pair = Tuple[int, int]


def _to_words(text: str) -> List[bytes]:
    """Split on the ASCII space byte (kept as a word prefix), so
    ``b"".join(words) == text.encode()`` exactly; tabs/newlines remain
    inside words."""
    raw = text.encode("utf-8")
    words: List[bytes] = []
    start = 0
    for i in range(1, len(raw)):
        if raw[i: i + 1] == b" ":
            words.append(raw[start:i])
            start = i
    if start < len(raw) or not raw:
        words.append(raw[start:])
    return [w for w in words if w]


class BPETokenizer:
    """Byte-level BPE: ``train`` -> ``encode``/``decode`` -> 1-based ids."""

    def __init__(self, merges: Optional[Sequence[Pair]] = None):
        # symbol id space (0-based internally): 0..255 bytes, 256+ merges
        self.merges: List[Pair] = list(merges or [])
        self._ranks: Dict[Pair, int] = {p: i for i, p in
                                        enumerate(self.merges)}
        self._bytes: List[bytes] = [bytes([b]) for b in range(256)]
        for a, b in self.merges:
            self._bytes.append(self._bytes[a] + self._bytes[b])
        self._cache: Dict[bytes, Tuple[int, ...]] = {}

    # ------------------------------------------------------------- training
    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int = 1024,
              min_freq: int = 2) -> "BPETokenizer":
        """Learn merges until the vocab reaches ``vocab_size`` (>= 256) or
        no pair occurs at least ``min_freq`` times."""
        if vocab_size < 256:
            raise ValueError("vocab_size must be >= 256 (the byte alphabet)")
        word_freq: Counter = Counter()
        for text in texts:
            word_freq.update(_to_words(text))
        corpus: List[Tuple[List[int], int]] = [
            (list(w), f) for w, f in word_freq.items()]
        # pair -> total freq, plus pair -> set of word indexes containing it
        # (the standard Sennrich incremental bookkeeping: each merge only
        # touches the words that contain the merged pair, not the corpus)
        pairs: Counter = Counter()
        where: Dict[Pair, set] = {}
        for wi, (syms, freq) in enumerate(corpus):
            for i in range(len(syms) - 1):
                pr = (syms[i], syms[i + 1])
                pairs[pr] += freq
                where.setdefault(pr, set()).add(wi)
        merges: List[Pair] = []
        n_symbols = 256
        while n_symbols < vocab_size and pairs:
            best, freq = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
            if freq < min_freq:
                break
            new_id = n_symbols
            merges.append(best)
            a, b = best
            for wi in sorted(where.get(best, ())):
                syms, wfreq = corpus[wi]
                # retract this word's current pair contributions
                for i in range(len(syms) - 1):
                    pr = (syms[i], syms[i + 1])
                    pairs[pr] -= wfreq
                    if pairs[pr] <= 0:
                        del pairs[pr]
                    w = where.get(pr)
                    if w is not None:
                        w.discard(wi)
                        if not w:
                            del where[pr]
                i = 0
                while i < len(syms) - 1:
                    if syms[i] == a and syms[i + 1] == b:
                        syms[i: i + 2] = [new_id]
                    else:
                        i += 1
                # re-add the merged word's contributions
                for i in range(len(syms) - 1):
                    pr = (syms[i], syms[i + 1])
                    pairs[pr] += wfreq
                    where.setdefault(pr, set()).add(wi)
            n_symbols += 1
        return cls(merges)

    # ------------------------------------------------------------ encoding
    def _bpe_word(self, word: bytes) -> Tuple[int, ...]:
        cached = self._cache.get(word)
        if cached is not None:
            return cached
        syms = list(word)
        while len(syms) > 1:
            ranked = [(self._ranks.get((syms[i], syms[i + 1])), i)
                      for i in range(len(syms) - 1)]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            rank, i = min(ranked)
            a, b = self.merges[rank]
            # merge EVERY occurrence of this lowest-ranked pair
            j = 0
            while j < len(syms) - 1:
                if syms[j] == a and syms[j + 1] == b:
                    syms[j: j + 2] = [256 + rank]
                else:
                    j += 1
        out = tuple(syms)
        if len(self._cache) < 65536:
            self._cache[word] = out
        return out

    def encode(self, text: str) -> List[int]:
        """UTF-8 text -> 1-based token ids."""
        ids: List[int] = []
        for word in _to_words(text):
            ids.extend(s + 1 for s in self._bpe_word(word))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """1-based ids -> text (exact inverse of encode; ids outside the
        vocab — e.g. an ``eos_id`` — are skipped)."""
        n = len(self._bytes)
        data = b"".join(self._bytes[int(i) - 1] for i in ids
                        if 1 <= int(i) <= n)
        return data.decode("utf-8", errors="replace")

    # ------------------------------------------------------------- surface
    @property
    def vocab_size(self) -> int:
        return len(self._bytes)

    @property
    def eos_id(self) -> int:
        """A reserved id one past the learned vocab (give the LM
        ``vocab_size = tokenizer.vocab_size + 1`` to use it)."""
        return len(self._bytes) + 1

    def save(self, path: str) -> None:
        """The merges in the reference's file format (``file_io``), so a
        file saved by either package loads in the other."""
        from bigdl_tpu_torch.utils import file_io
        file_io.save({"merges": [tuple(int(x) for x in p)
                                 for p in self.merges]}, path)

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        from bigdl_tpu_torch.utils import file_io
        return cls([tuple(int(x) for x in p)
                    for p in file_io.load(path, device="cpu")["merges"]])

    def __repr__(self):
        return f"BPETokenizer(vocab_size={self.vocab_size})"
