"""Record shards in the port against the reference's, on the CPU.

The same (label, bytes) records written by ``ShardWriter`` in both
packages give byte-identical files, and each package reads the other's,
through the host library's scan and through the Python framing. A
truncated tail ends a shard in both; a corrupt header or payload CRC and
a record shorter than its label raise in both. ``ShardFolder.paths``
splits shards between hosts as the reference does;
``StreamingShardDataSet``'s size, shuffled order and evaluation order are
the reference's under the same ``RandomGenerator`` seed.
"""

import filecmp
import os

import numpy as np
import pytest
import torch

from bigdl_tpu.dataset import image as jimage
from bigdl_tpu.dataset import shards as jshards
from bigdl_tpu.utils.rng import RandomGenerator as JaxRNG
from bigdl_tpu_torch.dataset import image, shards
from bigdl_tpu_torch.utils.rng import RandomGenerator


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _records(seed, n=37):
    rng = np.random.default_rng(seed)
    return [(float(rng.integers(1, 11)), rng.bytes(int(rng.integers(0, 400))))
            for _ in range(n)]


def _write(mod, folder, records, per_shard):
    with mod.ShardWriter(os.path.join(folder, "part"), per_shard) as w:
        for label, payload in records:
            w.write(label, payload)
    return w.written_paths


def _read(mod, folder, plain=False):
    read = shards.read_shard_plain if plain else mod.read_shard
    return [(r.label, r.data) for p in mod.list_shards(folder)
            for r in read(p)]


@pytest.mark.parametrize("per_shard", [1, 8, 37, 100])
def test_writers_give_identical_files_read_across(tmp_path, per_shard):
    records = _records(per_shard)
    port = _write(shards, str(tmp_path / "port"), records, per_shard)
    ref = _write(jshards, str(tmp_path / "ref"), records, per_shard)
    assert [os.path.basename(p) for p in port] == \
        [os.path.basename(p) for p in ref]
    for a, b in zip(port, ref):
        assert filecmp.cmp(a, b, shallow=False)
    assert _read(shards, str(tmp_path / "ref")) == records
    assert _read(shards, str(tmp_path / "ref"), plain=True) == records
    assert _read(jshards, str(tmp_path / "port")) == records


def test_close_then_write_rolls_a_fresh_shard(tmp_path):
    paths = []
    for mod, name in ((shards, "port"), (jshards, "ref")):
        w = mod.ShardWriter(str(tmp_path / name / "p"), 4)
        w.write(1.0, b"a")
        w.close()
        w.write(2.0, b"b")
        w.close()
        paths.append([os.path.basename(p) for p in w.written_paths])
    assert paths[0] == paths[1] == ["p-00000.bigdl-shard",
                                    "p-00001.bigdl-shard"]


def _one_shard(tmp_path, name, records):
    (path,) = _write(jshards, str(tmp_path / name), records, 1000)
    return path, bytearray(open(path, "rb").read())


@pytest.mark.parametrize("plain", [False, True])
def test_truncated_tail_ends_the_shard(tmp_path, plain):
    records = _records(4, 6)
    path, buf = _one_shard(tmp_path, "t", records)
    with open(path, "wb") as f:
        f.write(buf[:-7])   # the writer died inside the last record
    read = shards.read_shard_plain if plain else shards.read_shard
    got = [(r.label, r.data) for r in read(path)]
    ref = [(r.label, r.data) for r in jshards.read_shard(path)]
    assert got == ref == records[:5]
    assert shards._count_records(path) == jshards._count_records(path) == 5


@pytest.mark.parametrize("plain", [False, True])
@pytest.mark.parametrize("where,match", [(2, "header"), (-2, "payload")])
def test_corrupt_crc_is_refused(tmp_path, plain, where, match):
    records = _records(5, 6)
    path, buf = _one_shard(tmp_path, "c", records)
    buf[where] ^= 0x10
    with open(path, "wb") as f:
        f.write(buf)
    read = shards.read_shard_plain if plain else shards.read_shard
    with pytest.raises(IOError) as port_err:
        list(read(path))
    with pytest.raises(IOError) as ref_err:
        list(jshards.read_shard(path))
    if not plain:   # the scan names the part, as the reference's scan does
        assert match in str(port_err.value)
        assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("plain", [False, True])
def test_record_shorter_than_its_label_is_refused(tmp_path, plain):
    from bigdl_tpu_torch.visualization.tensorboard import RecordWriter
    path = str(tmp_path / "s.bigdl-shard")
    with open(path, "wb") as f:
        RecordWriter(f).write(b"ab")
    read = shards.read_shard_plain if plain else shards.read_shard
    with pytest.raises(IOError, match="shorter than its 4-byte label"):
        list(read(path))
    with pytest.raises(IOError, match="shorter than its 4-byte label"):
        list(jshards.read_shard(path))


@pytest.mark.parametrize("count", [1, 2, 3, 5, 8])
def test_paths_split_between_hosts_as_the_reference(tmp_path, count):
    _write(shards, str(tmp_path), _records(6, 7), 1)
    for index in range(count):
        got = shards.ShardFolder.paths(str(tmp_path), index, count)
        assert got == jshards.ShardFolder.paths(str(tmp_path), index, count)
    assert shards.ShardFolder.paths(str(tmp_path)) == \
        shards.list_shards(str(tmp_path))   # no process group: one host


def test_files_and_stream(tmp_path):
    records = _records(7, 23)
    _write(shards, str(tmp_path), records, 5)
    files = shards.ShardFolder.files(str(tmp_path), 1, 2)
    ref_files = jshards.ShardFolder.files(str(tmp_path), 1, 2)
    assert [(r.label, r.data) for r in files.data(train=False)] == \
        [(r.label, r.data) for r in ref_files.data(train=False)]
    ds = shards.ShardFolder.stream(str(tmp_path))
    ref = jshards.ShardFolder.stream(str(tmp_path))
    assert ds.size() == ref.size() == 23
    # this process's shard files, as the reference's: data-parallel
    assert ds.is_distributed() and ref.is_distributed()
    assert [(r.label, r.data) for r in ds.data(train=True)] == records
    RandomGenerator.RNG().set_seed(3)
    JaxRNG.RNG().set_seed(3)
    for _ in range(2):   # two epochs: shard order and in-shard order
        ds.shuffle()
        ref.shuffle()
        got = [(r.label, r.data) for r in ds.data(train=True)]
        want = [(r.label, r.data) for r in ref.data(train=True)]
        assert got == want and got != records
        assert sorted(got) == sorted(records)
        assert [(r.label, r.data) for r in ds.data(train=False)] == records


def test_images_pack_and_read_back(tmp_path):
    rng = np.random.default_rng(8)
    imgs = [image.LabeledImage(rng.integers(0, 256, (5, 6, 3)).astype(
        np.float32), i % 3 + 1) for i in range(7)]
    jimgs = [jimage.LabeledImage(i.data, i.label) for i in imgs]
    port = list(shards.BGRImgToLocalSeqFile(str(tmp_path / "p/x"), 3)(
        iter(imgs)))
    ref = list(jshards.BGRImgToLocalSeqFile(str(tmp_path / "r/x"), 3)(
        iter(jimgs)))
    assert len(port) == len(ref) == 3
    for a, b in zip(port, ref):
        assert filecmp.cmp(a, b, shallow=False)
    back = list((shards.LocalSeqFileToBytes()
                 >> image.BytesToBGRImg(5, 6))(iter(port)))
    assert all(np.array_equal(a.data, b.data) and a.label == b.label
               for a, b in zip(back, imgs))
    bad = [image.LabeledImage(np.full((2, 2, 3), 256.0), 1)]
    with pytest.raises(ValueError, match=r"outside \[0, 255\]"):
        list(shards.BGRImgToLocalSeqFile(str(tmp_path / "b/x"))(iter(bad)))
