"""The image and model-file apps of the port against the reference's
``main``s on the same files, on the CPU (``--device cpu``).

A seeded tree of JPEG and PNG images (odd sizes, two classes, ``train``
and ``val``) is the input of every app:

- ``seqfilegen`` packs it into byte-identical shards and prints the
  reference's line;
- ``modelvalidator`` with a tiny registry entry in both packages (as
  ``tests/test_modelvalidator.py`` uses): ``-t bigdl`` (each package's
  snapshot of one set of weights), ``-t torch`` (one ``.t7`` file),
  ``-t caffe`` with and without ``--caffeDefPath`` and with
  ``--meanFile``: the printed Top-1 and Top-5 lines are the reference's;
- ``imageclassifier``'s (path, class) rows are the reference's;
- ``udfpredictor`` over a classifier bundle of one set of weights in each
  package: ``run``'s classes, ``make_udf``'s and a ``--watch`` run that
  classifies a file written after it started exactly once.

``inception train --folder/--caffeModel/--torchModel`` on the same tree
is in ``test_torch_image_apps_inception.py``.
"""

import os

import numpy as np
import pytest
import torch

from bigdl_tpu import nn as jnn
from bigdl_tpu.apps import imageclassifier as jimageclassifier
from bigdl_tpu.apps import modelvalidator as jmodelvalidator
from bigdl_tpu.apps import seqfilegen as jseqfilegen
from bigdl_tpu.apps import udfpredictor as judfpredictor
from bigdl_tpu.interop import torch_file as jtf
from bigdl_tpu.models import textclassifier as jtextclassifier
from bigdl_tpu.utils import file_io as jfile_io
from bigdl_tpu_torch import nn
from bigdl_tpu_torch.apps import imageclassifier, modelvalidator, seqfilegen
from bigdl_tpu_torch.apps import udfpredictor
from bigdl_tpu_torch.dataset import shards
from bigdl_tpu_torch.interop.state_dict import flatten_tree, import_tree_state
from bigdl_tpu_torch.models import textclassifier
from bigdl_tpu_torch.utils import file_io

MEAN, STD = (127.0, 120.0, 110.0), (64.0, 60.0, 70.0)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tree(tmp_path):
    """train/ and val/ with classes a_dog, b_cat: JPEGs and PNGs whose
    sides are drawn from 20-45, from a seed."""
    from PIL import Image
    rng = np.random.default_rng(31)
    root = tmp_path / "imgs"
    for split, n in (("train", 8), ("val", 4)):
        for ci, cls in enumerate(("a_dog", "b_cat")):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                w, h = (int(v) for v in rng.integers(20, 46, 2))
                px = rng.integers(0, 60, (h, w, 3)) + 150 * ci
                ext, fmt = (("jpg", "JPEG"), ("png", "PNG"))[i % 2]
                Image.fromarray(px.astype(np.uint8)).save(
                    d / f"{i:02d}.{ext}", fmt)
    return root


def _carried(jm, tm):
    import_tree_state(tm, flatten_tree(jm.parameter_tree()),
                      flatten_tree(jm.buffer_tree()))
    return tm


def test_seqfilegen_matches_the_reference(tree, tmp_path, capsys):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    seqfilegen.main(["-f", str(tree), "-o", port, "-p", "2", "-b", "4"])
    port_out = capsys.readouterr().out
    jseqfilegen.main(["-f", str(tree), "-o", ref, "-p", "2", "-b", "4"])
    assert port_out == capsys.readouterr().out == "packed 24 records\n"
    for split in ("train", "val"):
        names = sorted(os.listdir(os.path.join(port, split)))
        assert names == sorted(os.listdir(os.path.join(ref, split)))
        for n in names:
            assert open(os.path.join(port, split, n), "rb").read() == \
                open(os.path.join(ref, split, n), "rb").read()
        back = [(r.label, r.data)
                for p in shards.list_shards(os.path.join(ref, split))
                for r in shards.read_shard(p)]
        files = sorted((lbl, open(p, "rb").read()) for p, lbl in
                       modelvalidator.image_folder_paths(
                           str(tree / split)))
        assert sorted(back) == files
    seqfilegen.main(["-f", str(tree), "-o", str(tmp_path / "t"),
                     "--trainOnly"])
    assert os.listdir(tmp_path / "t") == ["train"]
    seqfilegen.main(["-f", str(tree / "val"), "-o", str(tmp_path / "flat")])
    assert shards.list_shards(str(tmp_path / "flat"))


# ------------------------------------------------------ validator, classifier

def _tiny(mod, class_num=2):
    return (mod.Sequential()
            .add(mod.SpatialConvolution(3, 4, 3, 3, 1, 1, 1, 1)
                 .set_name("conv1"))
            .add(mod.ReLU())
            .add(mod.SpatialMaxPooling(16, 16, 16, 16))
            .add(mod.Reshape((4 * 2 * 2,)))
            .add(mod.Linear(4 * 2 * 2, class_num).set_name("ip1"))
            .add(mod.LogSoftMax()))


@pytest.fixture
def tiny_pair(monkeypatch):
    """A registry entry "tiny" (32x32 crops) in both packages whose
    builders return models of one set of weights."""
    jm = _tiny(jnn)
    tm = _carried(jm, _tiny(nn))
    monkeypatch.setitem(jmodelvalidator._MODELS, "tiny",
                        (lambda n: jm, 32, MEAN, STD))
    monkeypatch.setitem(modelvalidator._MODELS, "tiny",
                        (lambda n, device: tm.to(device), 32, MEAN, STD))
    return jm, tm


def _caffe_files(tmp_path, jm):
    """A caffemodel of ``jm``'s weights and a deploy prototxt naming its
    layers."""
    from test_torch_caffe import write_caffemodel
    conv, ip = jm.find_module("conv1"), jm.find_module("ip1")
    mp = str(tmp_path / "net.caffemodel")
    write_caffemodel(mp, [
        ("conv1", "Convolution",
         [np.transpose(np.asarray(conv.weight), (3, 2, 0, 1)),
          np.asarray(conv.bias)]),
        ("ip1", "InnerProduct", [np.asarray(ip.weight), np.asarray(ip.bias)])])
    dp = tmp_path / "deploy.prototxt"
    dp.write_text('name: "tiny"\nlayer { name: "conv1" type: "Convolution" }\n'
                  'layer { name: "ip1" type: "InnerProduct" }\n')
    return mp, str(dp)


def _mean_file(tmp_path):
    from test_torch_caffe import _blob
    mean = np.random.default_rng(4).uniform(100, 140, (3, 40, 40))
    p = tmp_path / "mean.binaryproto"
    p.write_bytes(_blob(mean))
    return str(p)


@pytest.mark.parametrize("kind", ["bigdl", "torch", "caffe",
                                  "caffe_def", "caffe_mean"])
def test_modelvalidator_prints_the_references_results(tree, tmp_path,
                                                      tiny_pair, kind,
                                                      capsys):
    jm, tm = tiny_pair
    folder = str(tree / "val")
    common = ["-f", folder, "-m", "tiny", "-b", "4", "--classNum", "2"]
    if kind == "bigdl":
        jfile_io.save(jm, str(tmp_path / "ref_snap"))
        file_io.save(tm, str(tmp_path / "port_snap"))
        port_argv = common + ["-t", "bigdl", "--modelPath",
                              str(tmp_path / "port_snap")]
        ref_argv = common + ["-t", "bigdl", "--modelPath",
                             str(tmp_path / "ref_snap")]
    elif kind == "torch":
        jtf.save_torch(jm, str(tmp_path / "m.t7"))
        port_argv = ref_argv = common + ["-t", "torch", "--modelPath",
                                         str(tmp_path / "m.t7")]
    else:
        mp, dp = _caffe_files(tmp_path, jm)
        port_argv = ref_argv = common + ["-t", "caffe", "--modelPath", mp] + (
            ["--caffeDefPath", dp] if kind == "caffe_def" else []) + (
            ["--meanFile", _mean_file(tmp_path)] if kind == "caffe_mean"
            else [])
    results = modelvalidator.main(port_argv + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    jmodelvalidator.main(ref_argv)
    ref_out = capsys.readouterr().out
    assert port_out == ref_out
    assert "tiny Top1Accuracy" in port_out and "tiny Top5Accuracy" in port_out
    assert [r.count for r, _ in results] == [8, 8]


def test_modelvalidator_main_is_validator_then_evaluate(tree, tmp_path,
                                                       tiny_pair, capsys):
    _, tm = tiny_pair
    file_io.save(tm, str(tmp_path / "snap"))
    argv = ["-f", str(tree / "val"), "-m", "tiny", "-b", "4", "--classNum",
            "2", "-t", "bigdl", "--modelPath", str(tmp_path / "snap"),
            "--device", "cpu"]
    results = modelvalidator.main(argv)
    out = capsys.readouterr().out
    args, model, ds = modelvalidator.validator(argv)
    assert capsys.readouterr().out == "" and args.folder == str(tree / "val")
    again = modelvalidator.evaluate(args, model, ds)
    assert capsys.readouterr().out == out
    assert [(r.correct, r.count) for r, _ in again] == \
        [(r.correct, r.count) for r, _ in results]


def test_modelvalidator_refusals():
    with pytest.raises(SystemExit, match="unknown model"):
        modelvalidator.main(["-f", "x", "-m", "nope9000", "-t", "bigdl",
                             "--modelPath", "y", "--device", "cpu"])
    with pytest.raises(ValueError, match="smaller than the cropped"):
        list(modelvalidator.SubtractMeanImage(np.zeros((4, 4, 3)))(
            iter([modelvalidator.LabeledImage(np.zeros((5, 5, 3)), 1)])))


def test_imageclassifier_rows_are_the_references(tree, tmp_path, tiny_pair,
                                                 capsys):
    jm, tm = tiny_pair
    jfile_io.save(jm, str(tmp_path / "ref_snap"))
    file_io.save(tm, str(tmp_path / "port_snap"))
    (tree / "val" / "README.txt").write_text("not an image")
    argv = ["-f", str(tree / "val"), "-m", "tiny", "-t", "bigdl", "-b", "4"]
    rows = imageclassifier.main(argv + ["--modelPath",
                                        str(tmp_path / "port_snap"),
                                        "--device", "cpu"])
    port_out = capsys.readouterr().out
    jimageclassifier.main(argv + ["--modelPath", str(tmp_path / "ref_snap")])
    assert port_out == capsys.readouterr().out
    assert len(rows) == 8 and {c for _, c in rows} <= {1, 2}
    assert imageclassifier.list_images(str(tree / "val")) == \
        jimageclassifier.list_images(str(tree / "val"))
    (tmp_path / "empty").mkdir()
    assert imageclassifier.predict_folder(tm, str(tmp_path / "empty"), 4, 32,
                                          MEAN, STD, "cpu") == []


# ---------------------------------------------------------------- udf

@pytest.fixture
def bundles(tmp_path):
    """One classifier bundle in each package: a T=150 text CNN of one set
    of weights, a vocabulary and embeddings from a seed."""
    rng = np.random.default_rng(41)
    words = [f"klass{c}{k}" for c in "abcd" for k in "mnop"] + [
        "the", "of", "and"]
    w2i = {w: i for i, w in enumerate(words)}   # 0-based; 0 pads
    emb = rng.normal(size=(len(words) + 1, 16)).astype(np.float32)
    emb[0] = 0.0
    jm = jtextclassifier.build_cnn(4, 150, 16)
    tm = _carried(jm, textclassifier.build_cnn(4, 150, 16, device="cpu"))
    jfile_io.save({"model": jm, "word2index": w2i, "embeddings": emb,
                   "seq_len": 150}, str(tmp_path / "ref_bundle"))
    file_io.save({"model": tm, "word2index": w2i, "embeddings": emb,
                  "seq_len": 150}, str(tmp_path / "port_bundle"))
    docs = tmp_path / "docs"
    docs.mkdir()
    for i in range(7):
        text = " ".join(rng.choice(words, size=int(rng.integers(5, 60))))
        (docs / f"doc{i}.txt").write_text(text)
    (docs / "skip.md").write_text("klassam " * 20)
    return str(tmp_path / "port_bundle"), str(tmp_path / "ref_bundle"), docs


def test_udfpredictor_classes_are_the_references(bundles, capsys):
    port_bundle, ref_bundle, docs = bundles
    rows = udfpredictor.run(["--modelPath", port_bundle, "-f", str(docs),
                             "-b", "3", "--device", "cpu"])
    port_out = capsys.readouterr().out
    ref_rows = judfpredictor.run(["--modelPath", ref_bundle, "-f", str(docs),
                                  "-b", "3"])
    assert port_out == capsys.readouterr().out
    assert rows == [(p, int(c)) for p, c in ref_rows] and len(rows) == 7
    bundle = file_io.load(port_bundle, device="cpu")
    udf = udfpredictor.make_udf(bundle, device="cpu")
    judf = judfpredictor.make_udf(jfile_io.load(ref_bundle))
    texts = [open(p).read() for p, _ in rows]
    assert [udf(t) for t in texts] == [judf(t) for t in texts] == \
        [c for _, c in rows]
    assert udfpredictor.predict_texts(bundle, texts, 4, "cpu") == \
        [c for _, c in rows]


def test_udfpredictor_watch_classifies_a_new_file_once(bundles, monkeypatch,
                                                       capsys):
    port_bundle, _, docs = bundles
    sleeps = []

    def sleep(seconds):   # the file arrives while the watcher waits
        sleeps.append(seconds)
        if len(sleeps) == 1:
            (docs / "late.txt").write_text("klassbm klassbn " * 10)
    monkeypatch.setattr(udfpredictor.time, "sleep", sleep)
    rows = udfpredictor.run(["--modelPath", port_bundle, "-f", str(docs),
                             "--watch", "--pollSeconds", "0.5",
                             "--device", "cpu"], max_polls=4)
    assert sleeps == [0.5] * 3
    names = [os.path.basename(p) for p, _ in rows]
    assert names.count("late.txt") == 1 and len(names) == 8
    assert names[-1] == "late.txt"
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 8 and out[-1].split("\t")[0].endswith("late.txt")


def test_udfpredictor_on_poll_sees_each_polls_rows(bundles, monkeypatch):
    port_bundle, _, docs = bundles
    polls = []

    def sleep(seconds):
        if len(polls) == 1:
            (docs / "late.txt").write_text("klassbm klassbn " * 10)
    monkeypatch.setattr(udfpredictor.time, "sleep", sleep)
    rows = udfpredictor.run(["--modelPath", port_bundle, "-f", str(docs),
                             "--watch", "--pollSeconds", "0.5",
                             "--device", "cpu"], max_polls=3,
                            on_poll=polls.append)
    assert [len(p) for p in polls] == [7, 1, 0]
    assert [r for p in polls for r in p] == rows
    assert os.path.basename(polls[1][0][0]) == "late.txt"
