"""SentencePiece ``tokenizer.model`` reader and writer (counterpart of
``bigdl_tpu/interop/sentencepiece.py``), with no sentencepiece package:
the ``ModelProto`` is walked on the wire (``utils/protowire.py``) and both
segmentations are reimplemented:

- **unigram**: Viterbi over the normalized text with per-piece log
  scores, ties to the longest match first; an unknown character takes the
  unk penalty and, under ``byte_fallback``, becomes ``<0xNN>`` byte pieces
  (the Llama configuration);
- **bpe**: the best-scoring adjacent merge, again and again (a piece's
  score is its merge priority), ties to the leftmost.

Normalization: ``identity`` (Llama) is exact; a model with a precompiled
charsmap (``nmt_nfkc``) is approximated with ``unicodedata`` NFKC, with a
warning. ``add_dummy_prefix``, ``escape_whitespaces`` and
``remove_extra_whitespaces`` follow the NormalizerSpec.

``encode``, ``decode`` and ``eos_id`` speak the framework's 1-based ids
(spm id + 1), so the tokenizer drops in where ``interop.hf_tokenizer``'s
does (``apps.transformer generate|serve --fromHF``). ``write_model``
writes a ``ModelProto`` byte for byte as the reference's does.
"""

from __future__ import annotations

import os
import struct
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

from bigdl_tpu_torch.utils.protowire import WT_LEN, WT_VARINT, iter_fields

# SentencePiece piece types (sentencepiece_model.proto)
NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6
_UNIGRAM, _BPE = 1, 2
_WS = "▁"  # the metaspace word-boundary mark
_UNK_PENALTY = 10.0  # C++ kUnkPenalty: unk score = min_score - 10


class SentencePieceModel:
    """Parsed ModelProto: pieces, scores, types + the spec flags that
    affect encoding."""

    def __init__(self):
        self.pieces: List[str] = []
        self.scores: List[float] = []
        self.types: List[int] = []
        self.model_type = _UNIGRAM
        self.unk_id = 0
        self.bos_id: Optional[int] = 1
        self.eos_id: Optional[int] = 2
        self.pad_id: Optional[int] = -1
        self.byte_fallback = False
        self.normalizer = "identity"
        self.has_charsmap = False
        self.add_dummy_prefix = True
        self.remove_extra_whitespaces = True
        self.escape_whitespaces = True

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceModel":
        with open(path, "rb") as f:
            buf = memoryview(f.read())
        m = cls()
        for field, wt, val in iter_fields(buf):
            if field == 1 and wt == WT_LEN:  # SentencePiece
                piece, score, typ = "", 0.0, NORMAL
                for f2, w2, v2 in iter_fields(val):
                    if f2 == 1 and w2 == WT_LEN:
                        piece = bytes(v2).decode("utf-8")
                    elif f2 == 2:  # float (I32)
                        score = struct.unpack("<f", bytes(v2))[0]
                    elif f2 == 3 and w2 == WT_VARINT:
                        typ = v2
                m.pieces.append(piece)
                m.scores.append(score)
                m.types.append(typ)
            elif field == 2 and wt == WT_LEN:  # TrainerSpec
                for f2, w2, v2 in iter_fields(val):
                    if w2 != WT_VARINT:
                        continue
                    if f2 == 3:
                        m.model_type = v2
                    elif f2 == 35:
                        m.byte_fallback = bool(v2)
                    elif f2 == 40:
                        m.unk_id = _signed(v2)
                    elif f2 == 41:
                        m.bos_id = _signed(v2)
                    elif f2 == 42:
                        m.eos_id = _signed(v2)
                    elif f2 == 43:
                        m.pad_id = _signed(v2)
            elif field == 3 and wt == WT_LEN:  # NormalizerSpec
                for f2, w2, v2 in iter_fields(val):
                    if f2 == 1 and w2 == WT_LEN:
                        m.normalizer = bytes(v2).decode()
                    elif f2 == 2 and w2 == WT_LEN and len(v2):
                        m.has_charsmap = True
                    elif f2 == 3 and w2 == WT_VARINT:
                        m.add_dummy_prefix = bool(v2)
                    elif f2 == 4 and w2 == WT_VARINT:
                        m.remove_extra_whitespaces = bool(v2)
                    elif f2 == 5 and w2 == WT_VARINT:
                        m.escape_whitespaces = bool(v2)
        if m.model_type not in (_UNIGRAM, _BPE):
            raise ValueError(
                f"unsupported sentencepiece model_type {m.model_type} "
                "(unigram=1 and bpe=2 are implemented)")
        return m


def _signed(v: int) -> int:
    """proto int32 negatives arrive as 2^64-complement varints."""
    return v - (1 << 64) if v >= (1 << 63) else v


class SentencePieceTokenizer:
    """Encoder/decoder over a parsed model (unigram Viterbi or BPE)."""

    def __init__(self, model: SentencePieceModel):
        self.m = model
        self.vocab: Dict[str, int] = {}
        for i, (p, t) in enumerate(zip(model.pieces, model.types)):
            if t in (NORMAL, USER_DEFINED) and p not in self.vocab:
                self.vocab[p] = i
        self._byte_ids = {}
        for i, (p, t) in enumerate(zip(model.pieces, model.types)):
            if t == BYTE:  # "<0xNN>"
                self._byte_ids[int(p[3:5], 16)] = i
        self._max_len = max((len(p) for p in self.vocab), default=1)
        min_score = min(self.m.scores) if self.m.scores else 0.0
        self._unk_score = min_score - _UNK_PENALTY
        if model.has_charsmap:
            warnings.warn(
                "sentencepiece model carries a precompiled charsmap "
                f"(normalizer {model.normalizer!r}); approximating with "
                "unicodedata NFKC — ids may differ on exotic codepoints",
                stacklevel=2)

    @classmethod
    def from_file(cls, path: str) -> "SentencePieceTokenizer":
        return cls(SentencePieceModel.from_file(path))

    @staticmethod
    def present_in(path: str) -> bool:
        return os.path.exists(os.path.join(path, "tokenizer.model"))

    @classmethod
    def from_dir(cls, path: str) -> "SentencePieceTokenizer":
        return cls.from_file(os.path.join(path, "tokenizer.model"))

    # ------------------------------------------------------------ normalize
    def _normalize(self, text: str) -> str:
        if self.m.has_charsmap:
            import unicodedata
            text = unicodedata.normalize("NFKC", text)
        if self.m.remove_extra_whitespaces:
            text = " ".join(s for s in text.split(" ") if s) \
                if text.strip(" ") else ""
        if self.m.add_dummy_prefix and text:
            text = " " + text
        if self.m.escape_whitespaces:
            text = text.replace(" ", _WS)
        return text

    # -------------------------------------------------------------- unigram
    def _viterbi(self, s: str) -> List[Tuple[str, Optional[int]]]:
        """Best segmentation: [(piece_text, piece_id_or_None_for_unk)].
        Scores accumulate piece log-probs; an unknown single char costs
        unk_score. Ties prefer the LONGER piece (C++ lattice iteration
        order inserts longer arcs first and keeps strict improvement)."""
        n = len(s)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, Optional[int]]]] = [None] * (n + 1)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            # unknown single character (merged runs handled at emit time)
            cand = best[i] + self._unk_score
            if cand > best[i + 1]:
                best[i + 1] = cand
                back[i + 1] = (i, None)
            for j in range(i + 1, min(n, i + self._max_len) + 1):
                pid = self.vocab.get(s[i:j])
                if pid is None:
                    continue
                cand = best[i] + self.m.scores[pid]
                if cand > best[j] or (cand == best[j] and back[j] is not None
                                      and back[j][0] > i):
                    best[j] = cand
                    back[j] = (i, pid)
        out: List[Tuple[str, Optional[int]]] = []
        pos = n
        while pos > 0:
            i, pid = back[pos]
            out.append((s[i:pos], pid))
            pos = i
        return out[::-1]

    # ------------------------------------------------------------------ bpe
    def _bpe(self, s: str) -> List[Tuple[str, Optional[int]]]:
        parts: List[str] = list(s)
        while len(parts) > 1:
            best_score, best_i = None, None
            for i in range(len(parts) - 1):
                pid = self.vocab.get(parts[i] + parts[i + 1])
                if pid is None:
                    continue
                sc = self.m.scores[pid]
                if best_score is None or sc > best_score:
                    best_score, best_i = sc, i
            if best_i is None:
                break
            parts[best_i: best_i + 2] = [parts[best_i] + parts[best_i + 1]]
        return [(p, self.vocab.get(p)) for p in parts]

    # -------------------------------------------------------------- surface
    def encode(self, text: str) -> List[int]:
        """Text -> FRAMEWORK 1-based ids (spm id + 1)."""
        s = self._normalize(text)
        if not s:
            return []
        segment = self._viterbi if self.m.model_type == _UNIGRAM else self._bpe
        pieces = segment(s)
        ids: List[int] = []
        prev_unk = False
        for piece, pid in pieces:
            if pid is not None:
                ids.append(pid + 1)
                prev_unk = False
            elif self.m.byte_fallback and self._byte_ids:
                for b in piece.encode("utf-8"):
                    bid = self._byte_ids.get(b)
                    if bid is None:
                        raise ValueError(
                            f"byte piece <0x{b:02X}> missing from a "
                            "byte_fallback vocab")
                    ids.append(bid + 1)
                prev_unk = False
            else:
                # fuse consecutive unknown characters into ONE unk —
                # SentencePiece/tokenizers (fuse_unk) semantics; emitting
                # one per char would change the sequence length
                if not prev_unk:
                    ids.append(self.m.unk_id + 1)
                prev_unk = True
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: List[bytes] = []
        pending: List[int] = []

        def flush():
            if pending:
                out.append(bytes(pending))
                del pending[:]

        for i in ids:
            spm_id = int(i) - 1
            if not (0 <= spm_id < len(self.m.pieces)):
                continue
            t = self.m.types[spm_id]
            if t == BYTE:
                pending.append(int(self.m.pieces[spm_id][3:5], 16))
                continue
            flush()
            if t in (CONTROL, UNKNOWN, UNUSED):
                continue
            out.append(self.m.pieces[spm_id].encode("utf-8"))
        flush()
        text = b"".join(out).decode("utf-8", errors="replace") \
            .replace(_WS, " ")
        if self.m.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text

    @property
    def vocab_size(self) -> int:
        return len(self.m.pieces)

    @property
    def eos_id(self) -> Optional[int]:
        e = self.m.eos_id
        if e is None or e < 0 or e >= len(self.m.pieces):
            return None
        return e + 1

    @property
    def bos_id(self) -> Optional[int]:
        b = self.m.bos_id
        if b is None or b < 0 or b >= len(self.m.pieces):
            return None
        return b + 1

    def __repr__(self):
        kind = "unigram" if self.m.model_type == _UNIGRAM else "bpe"
        return (f"SentencePieceTokenizer({kind}, "
                f"vocab={len(self.m.pieces)})")


# ------------------------------------------------------------------- writer

def write_model(path: str, pieces: Sequence[Tuple[str, float, int]],
                model_type: str = "unigram", byte_fallback: bool = False,
                add_dummy_prefix: bool = True, unk_id: int = 0,
                bos_id: int = 1, eos_id: int = 2) -> str:
    """Serialize a ModelProto (tests + exporting framework vocabs to the
    ecosystem format). ``pieces``: (text, score, type) in id order."""
    from bigdl_tpu_torch.visualization.proto import (_float_field,
                                                     _len_field,
                                                     _varint_field)

    blob = b""
    for text, score, typ in pieces:
        sp = (_len_field(1, text.encode("utf-8")) + _float_field(2, score)
              + _varint_field(3, typ))
        blob += _len_field(1, sp)
    trainer = (_varint_field(3, {"unigram": 1, "bpe": 2}[model_type])
               + _varint_field(35, int(byte_fallback))
               + _varint_field(40, unk_id) + _varint_field(41, bos_id)
               + _varint_field(42, eos_id))
    norm = (_len_field(1, b"identity")
            + _varint_field(3, int(add_dummy_prefix))
            + _varint_field(4, 0) + _varint_field(5, 1))
    blob += _len_field(2, trainer) + _len_field(3, norm)
    with open(path, "wb") as f:
        f.write(blob)
    return path
