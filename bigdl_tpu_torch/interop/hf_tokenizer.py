"""GPT-2-style byte-level BPE tokenizer reader (counterpart of
``bigdl_tpu/interop/hf_tokenizer.py``): the text half of the HF checkpoint
interop. ``interop/hf.py`` loads the weights; this reads the
``tokenizer.json`` (or ``vocab.json`` + ``merges.txt``) beside them, so
``--fromHF`` speaks text.

The scheme is GPT-2's: every byte maps through a printable-unicode table
(``bytes_to_unicode``), text splits with the GPT-2 pre-tokenizer, and ids
come from the file's vocabulary, since they must match the checkpoint's
embedding rows. ``encode`` returns the framework's 1-based ids (HF id + 1,
as ``interop.hf`` copies the embedding table verbatim) and ``decode`` takes
them back.

The reference splits text with the ``regex`` package's pattern
``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+| ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+``.
The port does not depend on that package: ``pretokenize`` walks the same
alternatives by hand over ``unicodedata`` categories (L*, N*) and the
Unicode White_Space set.

A SentencePiece checkpoint (``tokenizer.model``, the Llama family) is read
by ``interop/sentencepiece.py``: ``load_checkpoint_tokenizer`` dispatches.
"""

from __future__ import annotations

import json
import os
import unicodedata
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

#: the contractions the GPT-2 pattern tries first, in its order
_CONTRACTIONS = ("'s", "'t", "'re", "'ve", "'m", "'ll", "'d")

#: Unicode's White_Space property (what ``\s`` matches in ``regex``)
_SPACE = frozenset(chr(c) for c in (
    *range(0x09, 0x0E), 0x20, 0x85, 0xA0, 0x1680, *range(0x2000, 0x200B),
    0x2028, 0x2029, 0x202F, 0x205F, 0x3000))


@lru_cache(maxsize=65536)
def _kind(ch: str) -> str:
    """'s' (white space), 'L' (a letter), 'N' (a number) or 'o' (other)."""
    if ch in _SPACE:
        return "s"
    cat = unicodedata.category(ch)[0]
    return cat if cat in "LN" else "o"


def pretokenize(text: str) -> List[str]:
    """The pieces the GPT-2 pre-tokenizer pattern finds in ``text``, left
    to right, each alternative tried in the pattern's order."""
    out: List[str] = []
    i, n = 0, len(text)
    while i < n:
        if text[i] == "'":
            hit = next((c for c in _CONTRACTIONS if text.startswith(c, i)),
                       None)
            if hit is not None:
                out.append(hit)
                i += len(hit)
                continue
        # ' ?\p{L}+', ' ?\p{N}+', ' ?[^\s\p{L}\p{N}]+': a run of one kind,
        # which one space may lead
        j = i + 1 if (text[i] == " " and i + 1 < n
                      and _kind(text[i + 1]) != "s") else i
        kind = _kind(text[j])
        k = j
        while k < n and _kind(text[k]) == kind:
            k += 1
        if kind == "s" and k < n and k - 1 > i:
            # '\s+(?!\S)': a space run before a non-space leaves its last
            # space to lead the next piece (a single one is '\s+' alone)
            k -= 1
        out.append(text[i:k])
        i = k
    return out


@lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte <-> printable-unicode table: printable ASCII and
    Latin-1 map to themselves, the rest shift into code points 256 and up."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class HFTokenizer:
    """Byte-level BPE with an explicit vocabulary (the GPT-2 scheme)."""

    def __init__(self, vocab: Dict[str, int],
                 merges: Sequence[Tuple[str, str]],
                 eos_token: str = "<|endoftext|>"):
        self.vocab = dict(vocab)
        self._id_to_tok = {i: t for t, i in self.vocab.items()}
        self._merges = [tuple(m) for m in merges]
        self._ranks = {m: i for i, m in enumerate(self._merges)}
        self._byte_enc = bytes_to_unicode()
        self._byte_dec = {c: b for b, c in self._byte_enc.items()}
        self._cache: Dict[str, List[str]] = {}
        self._eos_tok = eos_token if eos_token in self.vocab else None

    # ----------------------------------------------------------------- load
    @classmethod
    def from_dir(cls, path: str) -> "HFTokenizer":
        """Read ``tokenizer.json`` (the fast format) or ``vocab.json`` +
        ``merges.txt`` from an HF checkpoint directory."""
        tj = os.path.join(path, "tokenizer.json")
        if os.path.exists(tj):
            with open(tj, encoding="utf-8") as f:
                data = json.load(f)
            model = data.get("model", {})
            if model.get("type") != "BPE":
                raise ValueError(f"tokenizer.json model type "
                                 f"{model.get('type')!r} is not BPE")
            # a SentencePiece-derived BPE (Llama) marks words with ▁ and
            # has other pre-tokenizers: byte-mapping it would mis-tokenize
            pre = data.get("pre_tokenizer") or {}
            pres = (pre.get("pretokenizers", [pre])
                    if pre.get("type") == "Sequence" else [pre])
            if not any(p.get("type") == "ByteLevel" for p in pres):
                raise ValueError(
                    "tokenizer.json is not a GPT-2-style ByteLevel BPE "
                    f"(pre_tokenizer {pre.get('type')!r}); Llama-family "
                    "tokenizers are not supported by this reader")
            merges = [tuple(m.split(" ", 1)) if isinstance(m, str)
                      else tuple(m) for m in model["merges"]]
            return cls(model["vocab"], merges)
        vj = os.path.join(path, "vocab.json")
        mt = os.path.join(path, "merges.txt")
        if os.path.exists(vj) and os.path.exists(mt):
            with open(vj, encoding="utf-8") as f:
                vocab = json.load(f)
            merges = []
            with open(mt, encoding="utf-8") as f:
                for line in f:
                    line = line.rstrip("\n")
                    if not line or line.startswith("#version"):
                        continue
                    merges.append(tuple(line.split(" ", 1)))
            return cls(vocab, merges)
        raise FileNotFoundError(
            f"no tokenizer.json or vocab.json+merges.txt in {path}")

    @staticmethod
    def present_in(path: str) -> bool:
        return (os.path.exists(os.path.join(path, "tokenizer.json"))
                or (os.path.exists(os.path.join(path, "vocab.json"))
                    and os.path.exists(os.path.join(path, "merges.txt"))))

    # ------------------------------------------------------------------ BPE
    def _bpe(self, mapped: str) -> List[str]:
        cached = self._cache.get(mapped)
        if cached is not None:
            return cached
        parts = list(mapped)
        while len(parts) > 1:
            ranked = [(self._ranks.get((parts[i], parts[i + 1])), i)
                      for i in range(len(parts) - 1)]
            ranked = [(r, i) for r, i in ranked if r is not None]
            if not ranked:
                break
            rank, _ = min(ranked)
            a, b = self._merges[rank]
            j = 0
            while j < len(parts) - 1:
                if parts[j] == a and parts[j + 1] == b:
                    parts[j: j + 2] = [a + b]
                else:
                    j += 1
        if len(self._cache) < 65536:
            self._cache[mapped] = parts
        return parts

    def encode(self, text: str) -> List[int]:
        """Text -> the framework's 1-based ids (HF id + 1)."""
        ids: List[int] = []
        for piece in pretokenize(text):
            mapped = "".join(self._byte_enc[b]
                             for b in piece.encode("utf-8"))
            for tok in self._bpe(mapped):
                tid = self.vocab.get(tok)
                if tid is None:  # unmerged byte runs: one id per byte
                    for ch in tok:
                        cid = self.vocab.get(ch)
                        if cid is None:
                            raise ValueError(
                                f"byte token {ch!r} missing from the vocab "
                                "(tokenizer trained without the full "
                                "ByteLevel alphabet); refusing to drop "
                                "input text")
                        ids.append(cid + 1)
                else:
                    ids.append(tid + 1)
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        """The framework's 1-based ids -> text (unknown ids and eos
        skipped)."""
        chars = []
        for i in ids:
            tok = self._id_to_tok.get(int(i) - 1)
            if tok is not None and tok != self._eos_tok:
                chars.append(tok)
        data = bytes(self._byte_dec[c] for c in "".join(chars)
                     if c in self._byte_dec)
        return data.decode("utf-8", errors="replace")

    # -------------------------------------------------------------- surface
    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def eos_id(self) -> Optional[int]:
        """The framework's 1-based eos id (None when the vocab has none)."""
        if self._eos_tok is None:
            return None
        return self.vocab[self._eos_tok] + 1

    def __repr__(self):
        return (f"HFTokenizer(vocab={len(self.vocab)}, "
                f"merges={len(self._ranks)})")


def load_checkpoint_tokenizer(path: str):
    """The ``--fromHF`` text reader of a checkpoint directory: a
    SentencePiece ``tokenizer.model`` (the Llama family) through
    ``interop.sentencepiece``, else the GPT-2-style byte-level BPE
    (``tokenizer.json`` / ``vocab.json``) through :class:`HFTokenizer`.
    No tokenizer at all raises ``FileNotFoundError``, an unreadable one
    ``ValueError``."""
    from bigdl_tpu_torch.interop.sentencepiece import SentencePieceTokenizer
    if SentencePieceTokenizer.present_in(path):
        return SentencePieceTokenizer.from_dir(path)
    if HFTokenizer.present_in(path):
        return HFTokenizer.from_dir(path)
    raise FileNotFoundError(f"no tokenizer.model / tokenizer.json / "
                            f"vocab.json+merges.txt in {path}")
