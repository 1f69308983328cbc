"""The port's byte-level BPE reader (``bigdl_tpu_torch/interop/
hf_tokenizer.py``) against the JAX package's, on the CPU: ``encode`` and
``decode`` on the vendored fixture's ``tokenizer.json`` and on a tokenizer
trained in the test by the ``tokenizers`` library (the implementation HF
runs), the ``vocab.json`` + ``merges.txt`` form, the refusals, and the
hand-written pre-tokenizer against the ``regex`` pattern it replaces on
strings drawn from a seed. Every comparison is exact.
"""

import json
import os
import random

import pytest

from bigdl_tpu.interop.hf_tokenizer import HFTokenizer as JaxTokenizer
from bigdl_tpu_torch.interop.hf_tokenizer import (HFTokenizer,
                                                  bytes_to_unicode,
                                                  load_checkpoint_tokenizer,
                                                  pretokenize)

RES = os.path.join(os.path.dirname(__file__), "resources", "hf_tiny_gpt2")
TEXTS = [
    "The five boxing wizards jump quickly, don't they?",
    "a brand new sentence with 42 numbers and... punctuation!?",
    "unicode: café naïve — emoji \U0001f600 works",
    "  leading spaces and\ttabs\nand newlines  \n\n",
    "don't can't won't it's we're I'll they'd you've I'm 'S",
    "", " ", "word", "x²+y² ⅔ 中文 ١٢٣",
]


def test_fixture_tokenizer_matches_reference():
    ours = HFTokenizer.from_dir(RES)
    ref = JaxTokenizer.from_dir(RES)
    assert ours.vocab_size == ref.vocab_size and ours.eos_id == ref.eos_id
    for text in TEXTS:
        ids = ours.encode(text)
        assert ids == ref.encode(text), text
        assert ours.decode(ids) == ref.decode(ids) == text


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers.decoders import ByteLevel as ByteLevelDecoder
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import ByteLevel
    from tokenizers.trainers import BpeTrainer
    tok = tokenizers.Tokenizer(BPE(unk_token=None))
    tok.pre_tokenizer = ByteLevel(add_prefix_space=False, use_regex=True)
    tok.decoder = ByteLevelDecoder()
    trainer = BpeTrainer(vocab_size=400, special_tokens=["<|endoftext|>"],
                         initial_alphabet=ByteLevel.alphabet(),
                         show_progress=False)
    tok.train_from_iterator(TEXTS * 4, trainer)
    d = tmp_path_factory.mktemp("hftok")
    tok.save(str(d / "tokenizer.json"))
    return tok, str(d)


def test_trained_tokenizer_matches_library_and_reference(trained):
    lib, path = trained
    ours, ref = HFTokenizer.from_dir(path), JaxTokenizer.from_dir(path)
    for text in TEXTS + ["held out: Sphinx of black quartz, 1234!"]:
        ids = ours.encode(text)
        assert ids == [i + 1 for i in lib.encode(text).ids], text
        assert ids == ref.encode(text)
        assert ours.decode(ids) == text
    assert ours.eos_id == lib.token_to_id("<|endoftext|>") + 1


def test_vocab_and_merges_files_match_tokenizer_json(trained, tmp_path):
    _, path = trained
    with open(os.path.join(path, "tokenizer.json"), encoding="utf-8") as f:
        model = json.load(f)["model"]
    with open(tmp_path / "vocab.json", "w", encoding="utf-8") as f:
        json.dump(model["vocab"], f)
    with open(tmp_path / "merges.txt", "w", encoding="utf-8") as f:
        f.write("#version: 0.2\n")
        for m in model["merges"]:
            f.write((m if isinstance(m, str) else " ".join(m)) + "\n")
    a, b = HFTokenizer.from_dir(path), HFTokenizer.from_dir(str(tmp_path))
    assert HFTokenizer.present_in(str(tmp_path))
    for text in TEXTS:
        assert a.encode(text) == b.encode(text)


def test_pretokenize_matches_the_regex_pattern():
    regex = pytest.importorskip("regex")
    pat = regex.compile(r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+|"
                        r" ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
    rng = random.Random(0)
    alphabet = (list("ab Z9'\t\n\r .,!?-_") + ["'s", "'ll", "'re", "'d",
                "  ", "   ", "é", "²", "Ⅻ", "　", "\x85", "\xa0",
                " ", "\U0001f600", "中", "\x1c", "٣"])
    for _ in range(3000):
        text = "".join(rng.choice(alphabet) for _ in range(rng.randint(0, 16)))
        assert pretokenize(text) == pat.findall(text), repr(text)


def test_byte_table_is_a_bijection():
    table = bytes_to_unicode()
    assert sorted(table) == list(range(256))
    assert len(set(table.values())) == 256


def test_sentencepiece_directory_waits_for_a6(tmp_path):
    """A ``tokenizer.model`` directory (ROADMAP A.6, now ported) loads as
    the port's SentencePiece tokenizer, with the reference's ids."""
    from bigdl_tpu.interop.sentencepiece import \
        SentencePieceTokenizer as JaxSentencePiece
    from bigdl_tpu_torch.interop.sentencepiece import (NORMAL,
                                                       SentencePieceTokenizer,
                                                       write_model)
    pieces = ([("<unk>", 0.0, 2), ("<s>", 0.0, 3), ("</s>", 0.0, 3)]
              + [(f"<0x{b:02X}>", 0.0, 6) for b in range(256)]
              + [(p, -float(i), NORMAL) for i, p in
                 enumerate(["\u2581he", "llo", "\u2581", "h", "e", "l", "o"])])
    write_model(str(tmp_path / "tokenizer.model"), pieces,
                byte_fallback=True)
    tok = load_checkpoint_tokenizer(str(tmp_path))
    assert isinstance(tok, SentencePieceTokenizer)
    want = JaxSentencePiece.from_dir(str(tmp_path))
    assert tok.encode("hello wörld") == want.encode("hello wörld")
    assert tok.decode(tok.encode("hello wörld")) == "hello wörld"


def test_refusals_match_reference(tmp_path):
    with pytest.raises(FileNotFoundError):
        load_checkpoint_tokenizer(str(tmp_path))
    for bad in ({"model": {"type": "WordPiece"}},
                {"model": {"type": "BPE", "vocab": {}, "merges": []},
                 "pre_tokenizer": {"type": "Metaspace"}}):
        with open(tmp_path / "tokenizer.json", "w") as f:
            json.dump(bad, f)
        with pytest.raises(ValueError):
            JaxTokenizer.from_dir(str(tmp_path))
        with pytest.raises(ValueError):
            load_checkpoint_tokenizer(str(tmp_path))
    partial = HFTokenizer({"a": 0}, [])
    assert partial.encode("a") == [1] and partial.eos_id is None
    with pytest.raises(ValueError, match="missing from the vocab"):
        partial.encode("b")
