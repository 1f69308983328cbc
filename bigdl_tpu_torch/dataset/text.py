"""Text pipeline (counterpart of ``bigdl_tpu/dataset/text.py``):
``LabeledSentence``, ``Dictionary``, ``SentenceSplitter``,
``SentenceTokenizer``, ``SentenceBiPadding``, ``TextToLabeledSentence``,
``LabeledSentenceToSample``, ``load_glove_vectors``,
``load_category_folder``, ``TokensToIndexedSample`` and
``IndexedToEmbeddedSample``, with the reference's semantics: regex
tokens, sentence-boundary padding tokens, a vocabulary whose unknown
words map to one slot past it, one-hot or 1-based index samples. Host
numpy throughout; ``Optimizer`` moves each batch to the device.
"""

from __future__ import annotations

import json
import logging
import os
import re
from collections import Counter
from typing import Iterator, List, Optional, Sequence

import numpy as np

from bigdl_tpu_torch.dataset.base import Sample, Transformer

SENTENCE_START = "SENTENCE_START"
SENTENCE_END = "SENTENCE_END"
_TOKEN_RE = re.compile(r"[A-Za-z0-9']+|[.,!?;]")


class LabeledSentence:
    """Token-index sequence + per-position (or scalar) labels
    (reference ``text/LabeledSentence.scala``)."""

    __slots__ = ("data", "label")

    def __init__(self, data: Sequence[float], label: Sequence[float]):
        self.data = np.asarray(data, np.float32)
        self.label = np.asarray(label, np.float32)

    def length(self) -> int:
        return int(self.data.shape[0])


class Dictionary:
    """Vocabulary with save/load and UNK handling
    (reference ``text/Dictionary.scala:225``)."""

    def __init__(self, sentences: Optional[Iterator[List[str]]] = None,
                 vocab_size: Optional[int] = None):
        self._word2index = {}
        self._index2word = {}
        self._vocab_size = 0
        if sentences is not None:
            counts = Counter()
            for tokens in sentences:
                counts.update(tokens)
            most = counts.most_common(vocab_size)
            for i, (w, _) in enumerate(most):
                self._word2index[w] = i
                self._index2word[i] = w
            self._vocab_size = len(self._word2index)

    def get_index(self, word: str) -> int:
        """0-based index; unknown words map to vocab_size (the UNK slot)."""
        return self._word2index.get(word, self._vocab_size)

    def get_word(self, index: int) -> str:
        return self._index2word.get(int(index), "<unk>")

    def vocab_size(self) -> int:
        return self._vocab_size

    def word2index(self):
        return dict(self._word2index)

    def save(self, folder: str) -> None:
        os.makedirs(folder, exist_ok=True)
        with open(os.path.join(folder, "dictionary.json"), "w") as f:
            json.dump(self._word2index, f)

    @staticmethod
    def load(folder: str) -> "Dictionary":
        d = Dictionary()
        with open(os.path.join(folder, "dictionary.json")) as f:
            d._word2index = json.load(f)
        d._index2word = {v: k for k, v in d._word2index.items()}
        d._vocab_size = len(d._word2index)
        return d


class SentenceSplitter(Transformer):
    """Paragraph → sentences (reference ``SentenceSplitter``, which loads
    a trained OpenNLP sentence model —
    ``dataset/text/SentenceSplitter.scala``).

    Rule-based here, with the standard model-free heuristics rather than
    a bare ``[.!?]\\s`` split: a candidate boundary is REJECTED when the
    period belongs to (a) a known never-sentence-final abbreviation
    (titles, latinisms, months), (b) a single-letter initial ("J. K.
    Rowling"), (c) a numeric reference ("No. 7", "sec. 3" — only when a digit
    follows, so "The answer is no." still ends a sentence), or when
    the following token starts lowercase (mid-sentence ellipsis or
    abbreviation not in the list). Trailing quotes/brackets travel with
    the closing sentence. Not OpenNLP-grade on adversarial prose, but
    covers the failure modes a trained model is usually bought for."""

    # Abbreviations that (almost) never END a sentence: a following
    # capitalized word is still the same sentence ("Dr. Smith", "Jan. 5",
    # "fig. 3"). Sentence-final-CAPABLE abbreviations (p.m., etc., Inc.)
    # are deliberately NOT listed: for those the next-word-lowercase rule
    # alone decides ("at 3 p.m. on" joins, "at 3 p.m. It" splits).
    # ... and NOT ordinary English words (no/sat/sun/art/sec/gen/...):
    # "He sat. The dog barked." must split, so an entry earns its place
    # only when the bare word is rare as a sentence ender.
    _ABBREV = {
        "mr", "mrs", "ms", "dr", "prof", "rev", "sen",
        "st", "e.g", "i.e", "cf", "vs", "dept", "fig",
        "nos", "pp", "vol", "ch",
        "jan", "feb", "apr", "jun", "jul", "aug", "sep",
        "sept", "oct", "nov", "dec",
    }
    # Numeric-reference abbreviations: common English words that only act
    # as abbreviations when a NUMBER follows ("No. 7", "sec. 3", "op. 9")
    # — guarded by the next-char-is-digit check, so "The answer is no.
    # We move on." still splits.
    _NUM_REF = {"no", "p", "sec", "art", "op", "para", "pt"}
    _CAND = re.compile(r"([.!?]+)([\"'”’)\]]*)\s+(?=\S)")

    def _split_one(self, para: str) -> List[str]:
        out, start = [], 0
        for m in self._CAND.finditer(para):
            end = m.end(2)
            nxt = para[m.end():m.end() + 1]
            if nxt.islower() and nxt.isalpha():
                continue  # quote attribution / mid-sentence continuation
            if m.group(1).endswith("."):
                before = para[start:m.start(1)]
                word = re.split(r"\s", before)[-1] if before else ""
                token = word.rstrip(".").lstrip("(\"'“‘[").lower()
                if (token in self._ABBREV
                        or (token in self._NUM_REF and nxt.isdigit())
                        or (len(token) == 1 and token.isalpha()
                            and token not in ("i", "a"))):
                    # abbreviation, numeric reference ("No. 7"), or
                    # single-letter initial — but the words "I"/"a" end
                    # sentences ("So did I.")
                    continue
            out.append(para[start:end].strip())
            start = m.end()
        tail = para[start:].strip()
        if tail:
            out.append(tail)
        return [s for s in out if s]

    def __call__(self, prev: Iterator[str]) -> Iterator[List[str]]:
        for para in prev:
            yield self._split_one(para.strip())


class SentenceTokenizer(Transformer):
    """Sentence → tokens (reference ``SentenceTokenizer``)."""

    def __call__(self, prev: Iterator[str]) -> Iterator[List[str]]:
        for sent in prev:
            yield _TOKEN_RE.findall(sent.lower())


class SentenceBiPadding(Transformer):
    """Wrap with SENTENCE_START/END tokens (reference ``SentenceBiPadding``)."""

    def __call__(self, prev: Iterator[List[str]]) -> Iterator[List[str]]:
        for tokens in prev:
            yield [SENTENCE_START] + list(tokens) + [SENTENCE_END]


class TextToLabeledSentence(Transformer):
    """Language-model pairs: data = tokens[:-1], label = tokens[1:]
    (reference ``TextToLabeledSentence``). Indices stay 0-based here;
    ``LabeledSentenceToSample`` shifts to the framework's 1-based convention.
    """

    def __init__(self, dictionary: Dictionary):
        self.dictionary = dictionary

    def __call__(self, prev: Iterator[List[str]]) -> Iterator[LabeledSentence]:
        for tokens in prev:
            idx = [self.dictionary.get_index(t) for t in tokens]
            if len(idx) < 2:
                continue
            yield LabeledSentence(idx[:-1], idx[1:])


class LabeledSentenceToSample(Transformer):
    """Encode a LabeledSentence as a Sample
    (reference ``LabeledSentenceToSample``): one-hot features (vocab+1 wide,
    UNK included) or raw 1-based indices; labels always 1-based indices.
    """

    def __init__(self, vocab_length: int,
                 fixed_length: Optional[int] = None,
                 one_hot: bool = True):
        self.vocab_length = vocab_length
        self.fixed_length = fixed_length
        self.one_hot = one_hot

    def __call__(self, prev: Iterator[LabeledSentence]) -> Iterator[Sample]:
        for s in prev:
            n = s.length() if self.fixed_length is None else self.fixed_length
            data_idx = s.data[:n].astype(np.int64)
            label = s.label[:n].astype(np.float32) + 1.0
            if len(data_idx) < n:
                pad = n - len(data_idx)
                data_idx = np.concatenate([data_idx, np.zeros(pad, np.int64)])
                label = np.concatenate([label, np.ones(pad, np.float32)])
            if self.one_hot:
                feat = np.zeros((n, self.vocab_length), np.float32)
                feat[np.arange(n), np.minimum(data_idx, self.vocab_length - 1)] = 1.0
            else:
                feat = (data_idx + 1).astype(np.float32)
            yield Sample(feat, label)


def load_glove_vectors(path: str, word2index,
                       embedding_dim: int) -> np.ndarray:
    """Read GloVe word vectors for a known vocabulary into an embedding
    matrix (reference ``example/utils/TextClassifier.scala:56-70``
    ``buildWord2Vec``: only vocabulary words are kept).

    Returns ``(len(word2index) + 1, embedding_dim)`` float32 — row 0 is the
    all-zero padding/UNK vector, row ``i+1`` the vector of the word with
    index ``i``; words missing from the file stay zero.
    """
    mat = np.zeros((len(word2index) + 1, embedding_dim), np.float32)
    found = 0
    # official glove.6B files are UTF-8 (the reference reads ISO-8859-1,
    # which garbles accented words into never-matching tokens)
    with open(path, encoding="utf-8", errors="replace") as f:
        for line in f:
            values = line.rstrip().split(" ")
            word = values[0]
            idx = word2index.get(word)
            if idx is None or len(values) != embedding_dim + 1:
                continue
            mat[idx + 1] = np.asarray(values[1:], np.float32)
            found += 1
    logging.getLogger(__name__).info("Found %d word vectors.", found)
    return mat


def _labeled_files(folder: str):
    """(path, 1-based label) of every regular file of a labeled tree, one
    subdirectory per class, labels by sorted class name (the reference's
    ``image_folder_paths(folder, extensions=None)``)."""
    pairs = []
    classes = sorted(d for d in os.listdir(folder)
                     if os.path.isdir(os.path.join(folder, d)))
    for label, cls in enumerate(classes, start=1):
        cls_dir = os.path.join(folder, cls)
        for name in sorted(os.listdir(cls_dir)):
            p = os.path.join(cls_dir, name)
            if os.path.isfile(p):
                pairs.append((p, float(label)))
    return pairs


def load_category_folder(base_dir: str):
    """Read a 20-newsgroup-style tree — one subdirectory per category, one
    text file per document (reference ``TextClassifier.scala:96-121``
    ``loadRawData``). Returns ``(texts, labels, class_num)`` with 1-based
    labels assigned by sorted category name."""
    texts, labels = [], []
    for path, label in _labeled_files(base_dir):
        with open(path, encoding="latin-1") as f:
            texts.append(f.read())
        labels.append(label)
    # max, not len(set(...)): an empty category dir still consumed a label
    # slot, and the model's output width must cover every assigned label
    return texts, labels, int(max(labels)) if labels else 0


class TokensToIndexedSample(Transformer):
    """(tokens, label) -> Sample((seq_len,) 1-based indices, label):
    out-of-vocabulary tokens are dropped (reference filters tokens without a
    word2Meta entry, ``TextClassifier.scala:140-169``), the rest truncated /
    zero-padded to ``seq_len``. Index 0 is the padding row."""

    def __init__(self, word2index, seq_len: int):
        self.word2index = word2index
        self.seq_len = seq_len

    def __call__(self, prev: Iterator[tuple]) -> Iterator[Sample]:
        for tokens, label in prev:
            feat = np.zeros((self.seq_len,), np.float32)
            t = 0
            for tok in tokens:
                if t == self.seq_len:
                    break
                idx = self.word2index.get(tok)
                if idx is None:
                    continue
                feat[t] = idx + 1
                t += 1
            yield Sample(feat, np.float32(label))


class IndexedToEmbeddedSample(Transformer):
    """Sample((T,) indices) -> Sample((T, embedding_dim)) by embedding-matrix
    row lookup, applied lazily per iteration so the dataset stores ~4-byte
    indices, not dense vectors (the reference pre-embeds the whole corpus up
    front; at 20-newsgroup scale that is gigabytes of host RAM)."""

    def __init__(self, embeddings: np.ndarray):
        self.embeddings = np.asarray(embeddings, np.float32)

    def __call__(self, prev: Iterator[Sample]) -> Iterator[Sample]:
        for s in prev:
            idx = np.asarray(s.feature, np.int64)
            yield Sample(self.embeddings[idx], s.label)
