"""``dataset/text.py`` in the port against the JAX package's, on the CPU:
every class and loader on sentences made from a seed, outputs equal (ids,
tokens, one-hot and index samples exactly; GloVe rows exactly). The GloVe
file and the category tree are written by the test."""

import os

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import text as jtext
from bigdl_tpu_torch.dataset import text

WORDS = ["the", "cat", "sat", "on", "mat", "Dr.", "Smith", "went", "home",
         "No.", "7", "is", "here", "it's", "fine", "J.", "K.", "Rowling",
         "wrote", "a", "book", "p.m.", "I", "did", "Jan.", "5", "we", "go"]
ENDS = [".", "!", "?", ".\"", "..."]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paragraphs(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        sents = []
        for _ in range(rng.integers(1, 5)):
            words = rng.choice(WORDS, size=rng.integers(2, 9)).tolist()
            words[0] = words[0].capitalize()
            sents.append(" ".join(words) + rng.choice(ENDS))
        out.append(" ".join(sents))
    return out


def _sentences(n, seed=1):
    return [s for p in _paragraphs(n, seed) for s in
            jtext.SentenceSplitter()._split_one(p)]


def test_sentence_splitter_matches_reference():
    paras = _paragraphs(200) + ["He sat. The dog barked.", "So did I. Yes.",
                                "At 3 p.m. on Monday. At 3 p.m. It rained.",
                                "See No. 7 here. The answer is no. We move."]
    got = list(text.SentenceSplitter()(iter(paras)))
    want = list(jtext.SentenceSplitter()(iter(paras)))
    assert got == want
    assert got[-4] == ["He sat.", "The dog barked."]


def test_tokenizer_and_bipadding_match_reference():
    sents = _sentences(100)
    got = list(text.SentenceBiPadding()(text.SentenceTokenizer()(iter(sents))))
    want = list(jtext.SentenceBiPadding()(
        jtext.SentenceTokenizer()(iter(sents))))
    assert got == want
    assert got[0][0] == text.SENTENCE_START == jtext.SENTENCE_START
    assert got[0][-1] == text.SENTENCE_END


@pytest.mark.parametrize("vocab_size", [None, 5, 12])
def test_dictionary_matches_reference(vocab_size, tmp_path):
    tokens = list(text.SentenceTokenizer()(iter(_sentences(80))))
    got = text.Dictionary(iter(tokens), vocab_size=vocab_size)
    want = jtext.Dictionary(iter(tokens), vocab_size=vocab_size)
    assert got.word2index() == want.word2index()
    assert got.vocab_size() == want.vocab_size()
    for w in ["the", "cat", "zebra"]:
        assert got.get_index(w) == want.get_index(w)
    assert got.get_word(0) == want.get_word(0)
    assert got.get_word(10 ** 6) == want.get_word(10 ** 6) == "<unk>"
    got.save(str(tmp_path / "port"))
    back = jtext.Dictionary.load(str(tmp_path / "port"))   # cross-package
    assert back.word2index() == want.word2index()
    want.save(str(tmp_path / "ref"))
    assert text.Dictionary.load(str(tmp_path / "ref")).word2index() == \
        got.word2index()


@pytest.mark.parametrize("one_hot, fixed_length", [(True, None), (True, 6),
                                                   (False, None),
                                                   (False, 12)])
def test_labeled_sentences_and_samples_match_reference(one_hot,
                                                       fixed_length):
    tokens = list(text.SentenceBiPadding()(
        text.SentenceTokenizer()(iter(_sentences(40)))))
    d = text.Dictionary(iter(tokens), vocab_size=10)
    jd = jtext.Dictionary(iter(tokens), vocab_size=10)
    got_ls = list(text.TextToLabeledSentence(d)(iter(tokens)))
    want_ls = list(jtext.TextToLabeledSentence(jd)(iter(tokens)))
    assert len(got_ls) == len(want_ls) > 0
    for g, w in zip(got_ls, want_ls):
        assert g.length() == w.length()
        np.testing.assert_array_equal(g.data, w.data)
        np.testing.assert_array_equal(g.label, w.label)
    vocab = d.vocab_size() + 1
    got = list(text.LabeledSentenceToSample(vocab, fixed_length, one_hot)(
        iter(got_ls)))
    want = list(jtext.LabeledSentenceToSample(vocab, fixed_length, one_hot)(
        iter(want_ls)))
    for g, w in zip(got, want):
        assert g.feature.dtype == w.feature.dtype
        np.testing.assert_array_equal(g.feature, w.feature)
        np.testing.assert_array_equal(g.label, w.label)


def test_glove_vectors_match_reference(tmp_path):
    rng = np.random.default_rng(3)
    vocab = {w: i for i, w in enumerate(["the", "cat", "sat", "café"])}
    path = tmp_path / "glove.txt"
    with open(path, "w", encoding="utf-8") as f:
        for w in ["cat", "dog", "café", "the"]:
            f.write(w + " " + " ".join(f"{v:.5f}" for v in
                                       rng.normal(size=4)) + "\n")
        f.write("sat 1.0 2.0\n")   # a short line is skipped
    got = text.load_glove_vectors(str(path), vocab, 4)
    want = jtext.load_glove_vectors(str(path), vocab, 4)
    assert got.shape == (5, 4)
    np.testing.assert_array_equal(got, want)
    assert not got[0].any() and not got[3].any()   # padding, "sat"


def test_category_folder_matches_reference(tmp_path):
    for cat, docs in (("sci.space", ["orbit and moon", "rocket"]),
                      ("alt.atheism", ["a text\nwith lines"]),
                      ("empty", [])):
        os.makedirs(tmp_path / cat)
        for i, doc in enumerate(docs):
            (tmp_path / cat / f"{i}").write_text(doc, encoding="latin-1")
    got = text.load_category_folder(str(tmp_path))
    want = jtext.load_category_folder(str(tmp_path))
    assert got == want
    # "empty" sorts between the two: it holds nothing but keeps label 2
    assert got[1] == [1.0, 3.0, 3.0] and got[2] == 3


def test_indexed_and_embedded_samples_match_reference():
    rng = np.random.default_rng(5)
    word2index = {w: i for i, w in enumerate(WORDS[:10])}
    pairs = [(rng.choice(WORDS, size=rng.integers(1, 15)).tolist(),
              float(rng.integers(1, 4))) for _ in range(30)]
    got = list(text.TokensToIndexedSample(word2index, 8)(iter(pairs)))
    want = list(jtext.TokensToIndexedSample(word2index, 8)(iter(pairs)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.feature, w.feature)
        np.testing.assert_array_equal(g.label, w.label)
    emb = rng.normal(size=(11, 3)).astype(np.float32)
    got_e = list(text.IndexedToEmbeddedSample(emb)(iter(got)))
    want_e = list(jtext.IndexedToEmbeddedSample(emb)(iter(want)))
    for g, w in zip(got_e, want_e):
        assert g.feature.shape == (8, 3)
        np.testing.assert_array_equal(g.feature, w.feature)
