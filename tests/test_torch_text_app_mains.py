"""The text app mains of the port against the JAX package's, on the CPU:

- the textclassifier's ``prepare`` gives the reference's samples,
  embeddings and vocabulary exactly, in synthetic mode and in ``--folder``
  mode (a 20-newsgroup tree and a GloVe file written by the test); the app
  trains end to end with ``Adagrad`` and Top-1 validation and saves its
  ``classifier_bundle``;
- the rnn app's ``_pipeline`` gives the reference's batches exactly, and
  the app trains end to end with ``--summary``, whose ``TrainSummary``
  holds every iteration's ``Loss`` and ``Throughput``;
- ``generate --tokenizer`` prints the decoded ``generate`` of the encoded
  prompt, and ``serve --tokenizer`` (a subprocess) answers a POST
  ``{"text": ...}`` with the same ids and text.
"""

import argparse
import json
import os
import re
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from bigdl_tpu.apps import rnn as jrnn_app
from bigdl_tpu.apps import textclassifier as jtc_app
from bigdl_tpu_torch.apps import rnn as rnn_app
from bigdl_tpu_torch.apps import textclassifier as tc_app
from bigdl_tpu_torch.apps import transformer as tr_app
from bigdl_tpu_torch.dataset.bpe import BPETokenizer
from bigdl_tpu_torch.models.generation import generate
from bigdl_tpu_torch.utils import file_io

ROOT = Path(__file__).resolve().parent.parent
ENV = dict(os.environ, OMP_NUM_THREADS="1")
WORDS = ["the", "cat", "sat", "on", "mat", "über", "naïve", "café", "a",
         "dog", "ran", "far"]


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tc_args(**kw):
    base = dict(folder=None, synthetic_size=40, maxWordsNum=30,
                embeddingDim=6, trainingSplit=0.8, maxSequenceLength=160)
    base.update(kw)
    return argparse.Namespace(**base)


def _same_prepared(got, want):
    for g_list, w_list in zip(got[:2], want[:2]):
        assert len(g_list) == len(w_list) > 0
        for g, w in zip(g_list, w_list):
            np.testing.assert_array_equal(g.feature, w.feature)
            np.testing.assert_array_equal(g.label, w.label)
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[3], want[3])
    assert got[4] == want[4]


def _newsgroups(tmp_path, dim):
    rng = np.random.default_rng(2)
    for c, cat in enumerate(["comp.graphics", "rec.autos", "sci.med"]):
        os.makedirs(tmp_path / "20_newsgroup" / cat)
        for d in range(5):
            words = rng.choice(WORDS + [f"topic{c}"] * 4, size=30).tolist()
            (tmp_path / "20_newsgroup" / cat / f"{d}").write_text(
                "Subject: " + " ".join(words) + "\n", encoding="latin-1")
    os.makedirs(tmp_path / "glove.6B")
    with open(tmp_path / "glove.6B" / f"glove.6B.{dim}d.txt", "w",
              encoding="utf-8") as f:
        for w in WORDS + ["topic0", "topic1", "subject"]:
            f.write(w + " " + " ".join(f"{v:.4f}" for v in
                                       rng.normal(size=dim)) + "\n")


def test_textclassifier_prepare_matches_reference(tmp_path):
    _same_prepared(tc_app.prepare(_tc_args()), jtc_app.prepare(_tc_args()))
    _newsgroups(tmp_path, 6)
    args = _tc_args(folder=str(tmp_path))
    got, want = tc_app.prepare(args), jtc_app.prepare(args)
    _same_prepared(got, want)
    assert got[2] == 3 and got[3].shape == (len(got[4]) + 1, 6)
    assert tc_app.tokenize("Hello, World-2 it's") == \
        jtc_app.tokenize("Hello, World-2 it's") == ["hello", "world", "it",
                                                    "s"]


def test_textclassifier_trains_and_saves_its_bundle(tmp_path):
    ck = str(tmp_path / "ck")
    opt, args, _ = tc_app.optimizer([
        "--maxSequenceLength", "150", "--embeddingDim", "4", "-b", "8",
        "-e", "2", "--synthetic-size", "40", "--checkpoint", ck,
        "--device", "cpu"])
    assert type(opt.optim_method).__name__ == "Adagrad"
    model = tc_app.train(["--maxSequenceLength", "150", "--embeddingDim",
                          "4", "-b", "8", "-e", "2", "--synthetic-size",
                          "40", "--checkpoint", ck, "--device", "cpu"])
    bundle = file_io.load(os.path.join(ck, "classifier_bundle"),
                          device="cpu")
    assert bundle["seq_len"] == 150 and bundle["embeddings"].shape[1] == 4
    x = torch.from_numpy(bundle["embeddings"][
        np.zeros((2, 150), np.int64)])
    with torch.no_grad():
        out = bundle["model"].eval()(x)
        assert torch.equal(out, model.eval()(x))
    assert out.shape == (2, 4) and torch.isfinite(out).all()


def test_rnn_pipeline_matches_reference():
    sents = jrnn_app._synthetic_corpus(30) + ["The cat sat. On the mat!"]
    assert rnn_app._synthetic_corpus(30) == sents[:-1]
    ds, vocab = rnn_app._pipeline(sents, 4, 10)
    jds, jvocab = jrnn_app._pipeline(sents, 4, 10)
    assert vocab == jvocab
    got, want = list(ds.data(train=False)), list(jds.data(train=False))
    assert len(got) == len(want) == 7
    for g, w in zip(got, want):
        assert g.data.shape == (4, 10, vocab)
        np.testing.assert_array_equal(g.data, w.data)
        np.testing.assert_array_equal(g.labels, w.labels)


def test_rnn_trains_with_summary(tmp_path):
    opt = rnn_app.optimizer(["-b", "4", "-e", "2", "--synthetic-size", "96",
                             "--hiddenSize", "8", "--sequenceLength", "6",
                             "--summary", str(tmp_path), "--appName", "rnn",
                             "--device", "cpu"])
    opt.optimize()
    n = len(opt.history)
    assert n == 2 * (96 // 8 // 4)
    losses = opt.train_summary.read_scalar("Loss")
    assert [s for s, _, _ in losses] == list(range(1, n + 1))
    assert np.allclose([v for _, v, _ in losses],
                       [h["loss"] for h in opt.history], rtol=1e-6)
    assert len(opt.train_summary.read_scalar("Throughput")) == n
    assert len(opt.validation_summary.read_scalar("Loss")) == 2
    assert opt.train_summary.folder == os.path.join(str(tmp_path), "rnn",
                                                    "train")


def _tiny_text_model(tmp_path):
    path = tmp_path / "corpus.txt"
    rng = np.random.default_rng(4)
    path.write_text("\n".join(" ".join(rng.choice(WORDS, size=6).tolist())
                              for _ in range(30)), encoding="utf-8")
    ck = str(tmp_path / "ck")
    tr_app.train(["--textFile", str(path), "--bpeVocab", "280", "--seqLen",
                  "8", "-b", "4", "-e", "1", "--embedDim", "16",
                  "--numHeads", "2", "--numLayers", "1", "--checkpoint", ck,
                  "--device", "cpu"])
    return ck


def _expected(ck, prompt, n):
    model = file_io.load(os.path.join(ck, "model_final"), device="cpu")
    tok = BPETokenizer.load(os.path.join(ck, "tokenizer.bigdl"))
    ids = tok.encode(prompt)
    out = generate(model.evaluate_mode(), [ids], n, greedy=True,
                   eos_id=tok.eos_id, device="cpu")[0].tolist()
    return tok, ids, out[len(ids):]


def test_generate_and_serve_take_text(tmp_path, capsys):
    ck = _tiny_text_model(tmp_path)
    prompt = "the naïve cat"
    tok, ids, cont = _expected(ck, prompt, 5)
    capsys.readouterr()
    tr_app.main(["generate", "--model", os.path.join(ck, "model_final"),
                 "--tokenizer", os.path.join(ck, "tokenizer.bigdl"),
                 "--prompt", prompt, "--greedy", "--maxNewTokens", "5",
                 "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == [f"prompt:       {tok.decode(ids)!r}",
                     f"continuation: {tok.decode(cont)!r}"]
    proc = subprocess.Popen(
        [sys.executable, "-m", "bigdl_tpu_torch.apps.transformer", "serve",
         "--model", os.path.join(ck, "model_final"), "--tokenizer",
         os.path.join(ck, "tokenizer.bigdl"), "--port", "0", "--greedy",
         "--maxNewTokens", "5", "--device", "cpu"],
        cwd=ROOT, env=ENV, stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True)
    try:
        port, seen, deadline = None, [], time.time() + 120
        while port is None and time.time() < deadline:
            line = proc.stderr.readline()
            if not line:
                break
            seen.append(line)
            m = re.search(r"serving on http://[\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        assert port, "".join(seen)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/generate",
            data=json.dumps({"text": prompt}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            answer = json.loads(r.read())
        assert answer["ids"] == cont
        assert answer["text"] == tok.decode(cont)
    finally:
        proc.terminate()
        proc.wait(timeout=30)


def test_transformer_optimizer_is_the_unstarted_run():
    """``transformer.optimizer(argv)`` is ``train``'s run before it starts:
    no iteration yet, then one an epoch's batch, each in ``history``."""
    opt, args = tr_app.optimizer([
        "--synthetic-size", "16", "-b", "4", "-e", "1", "--seqLen", "8",
        "--embedDim", "16", "--numHeads", "2", "--numLayers", "1",
        "--device", "cpu"])
    assert opt.history == [] and args.checkpoint is None
    opt.optimize()
    assert [h["neval"] for h in opt.history] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) and h["seconds"] > 0
               for h in opt.history)
