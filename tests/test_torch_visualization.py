"""``visualization/`` in the port against the JAX package's, on the CPU:
event bytes bit-equal for the same scalars and histograms at a fixed wall
time; ``crc32c`` equal on bytes made from a seed; each package reads the
other's event files (with their CRCs checked); ``TrainSummary`` and
``ValidationSummary`` driven by the port's ``Optimizer``; every writer is
closed (its thread joined) by the test that opens it."""

import os
import struct

import numpy as np
import pytest
import torch

from bigdl_tpu.visualization import proto as jproto
from bigdl_tpu.visualization import tensorboard as jtb
from bigdl_tpu_torch.dataset.base import DataSet, MiniBatch
from bigdl_tpu_torch.models import lenet
from bigdl_tpu_torch.nn import ClassNLLCriterion
from bigdl_tpu_torch.optim import SGD, Optimizer, Top1Accuracy, Trigger
from bigdl_tpu_torch.visualization import (FileReader, FileWriter,
                                           TrainSummary, ValidationSummary,
                                           proto)
from bigdl_tpu_torch.visualization import tensorboard as tb


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_crc32c_matches_reference():
    rng = np.random.default_rng(0)
    assert tb.crc32c(b"123456789") == 0xE3069283   # the standard check
    for n in (0, 1, 7, 64, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tb.crc32c(data) == jtb.crc32c(data)
        assert tb.masked_crc32c(data) == jtb.masked_crc32c(data)


@pytest.mark.parametrize("values", [
    np.random.default_rng(1).normal(0, 3, 1000),
    np.array([0.0, 1e-13, -1e25, 5.0]),
    np.array([np.nan, 1.0, np.inf, -2.0]),
    np.array([np.nan, np.nan])])
def test_event_bytes_match_reference(values):
    for step in (0, 1, 2 ** 40):
        got = proto.encode_event(123.25, step=step, summary_values=[
            proto.encode_scalar_value("Loss", 0.125),
            proto.encode_histo_value("w/x", values)])
        want = jproto.encode_event(123.25, step=step, summary_values=[
            jproto.encode_scalar_value("Loss", 0.125),
            jproto.encode_histo_value("w/x", values)])
        assert got == want
        assert proto.decode_event(got) == jproto.decode_event(want)
    assert proto.encode_event(5.0, file_version="brain.Event:2") == \
        jproto.encode_event(5.0, file_version="brain.Event:2")


def _write(writer_cls, folder, n):
    w = writer_cls(folder, flush_secs=0.05)
    for i in range(n):
        w.add_scalar("Loss", 1.0 / (i + 1), i)
        w.add_histogram("p", np.arange(i + 3, dtype=np.float32), i)
    w.close()


def test_each_package_reads_the_others_files(tmp_path):
    _write(FileWriter, str(tmp_path / "port"), 6)
    _write(jtb.FileWriter, str(tmp_path / "ref"), 6)
    for folder in ("port", "ref"):
        path = str(tmp_path / folder)
        got = FileReader.read_scalar(path, "Loss")
        want = jtb.FileReader.read_scalar(path, "Loss")
        assert [(s, v) for s, v, _ in got] == [(s, v) for s, v, _ in want]
        assert [s for s, _, _ in got] == list(range(6))
        first = next(FileReader.read_records(
            FileReader.list_event_files(path)[0]))
        assert proto.decode_event(first)["file_version"] == "brain.Event:2"


def test_corruption_and_truncation(tmp_path):
    _write(FileWriter, str(tmp_path), 2)
    path = FileReader.list_event_files(str(tmp_path))[0]
    blob = open(path, "rb").read()
    with open(path, "wb") as f:   # a truncated tail ends the file
        f.write(blob[:-3])
    assert len(list(FileReader.read_records(path))) == \
        len(list(jtb.FileReader.read_records(path))) == 4
    bad = bytearray(blob)
    bad[20] ^= 0xFF               # inside the first payload
    with open(path, "wb") as f:
        f.write(bytes(bad))
    with pytest.raises(IOError, match="corrupt"):
        list(FileReader.read_records(path))
    (length,) = struct.unpack("<Q", blob[:8])
    assert length == len(proto.encode_event(0.0,
                                            file_version="brain.Event:2"))


def test_two_writers_in_one_second_keep_both_files(tmp_path):
    a, b = FileWriter(str(tmp_path)), FileWriter(str(tmp_path))
    a.add_scalar("x", 1.0, 1)
    b.add_scalar("x", 2.0, 2)
    a.close()
    b.close()
    assert len(FileReader.list_event_files(str(tmp_path))) == 2
    assert [v for _, v, _ in FileReader.read_scalar(str(tmp_path), "x")] == \
        [1.0, 2.0]


def test_summary_triggers_and_folders(tmp_path):
    s = TrainSummary(str(tmp_path), "app")
    assert s.folder == os.path.join(str(tmp_path), "app", "train")
    assert ValidationSummary(str(tmp_path), "app").folder.endswith(
        os.path.join("app", "validation"))
    with pytest.raises(ValueError):
        s.set_summary_trigger("Bogus", Trigger.every_epoch())
    trig = Trigger.several_iteration(2)
    assert s.set_summary_trigger("Parameters", trig) is s
    assert s.get_summary_trigger("Parameters") is trig
    assert s.get_summary_trigger("Loss") is None
    s.close()


def test_optimizer_writes_train_and_validation_summaries(tmp_path):
    rng = np.random.default_rng(0)
    batches = [MiniBatch(rng.standard_normal((4, 28, 28, 1)).astype(
        np.float32), rng.integers(1, 11, (4,)).astype(np.float32))
        for _ in range(3)]
    model = lenet.build(10, device="cpu", seed=1)
    opt = Optimizer(model,
                    DataSet.array(batches, seed=2), ClassNLLCriterion(),
                    device="cpu")
    train = TrainSummary(str(tmp_path), "lenet")
    train.set_summary_trigger("Parameters", Trigger.several_iteration(3))
    val = ValidationSummary(str(tmp_path), "lenet")
    opt.set_optim_method(SGD(learningrate=0.1)) \
       .set_end_when(Trigger.max_epoch(2)) \
       .set_validation(Trigger.every_epoch(), DataSet.array(batches[:2]),
                       [Top1Accuracy()]) \
       .set_train_summary(train).set_validation_summary(val)
    opt.optimize()
    losses = train.read_scalar("Loss")
    assert [s for s, _, _ in losses] == [1, 2, 3, 4, 5, 6]
    assert np.allclose([v for _, v, _ in losses],
                       [h["loss"] for h in opt.history], rtol=1e-6)
    assert len(train.read_scalar("Throughput")) == 6
    ref = jtb.FileReader.read_scalar(train.folder, "LearningRate")
    assert [v for _, v, _ in ref] == pytest.approx([0.1] * 6)
    top1 = val.read_scalar("Top1Accuracy")
    assert [s for s, _, _ in top1] == [3, 6]
    assert all(0.0 <= v <= 1.0 for _, v, _ in top1)
    records = [proto.decode_event(r) for f in FileReader.list_event_files(
        train.folder) for r in FileReader.read_records(f)]
    # the version, 3 scalars a step, each parameter's histogram at 3 and 6
    n_params = len(list(model.parameters()))
    assert len(records) == 1 + 6 * 3 + 2 * n_params
