"""The port's host library against the reference's, on the CPU.

``bigdl_tpu_torch.native`` builds its own copy of the C++ sources with
g++ (present on this box, so the library is built for real). Each entry
point is held, on inputs made from a seed, to the reference's library
(``bigdl_tpu.native``) and to the port's numpy plain version: CRC32C and
the bf16 codec bit for bit, quickselect exactly, the batch decode within
1e-6 of the plain version and equal to the reference's, the shard scan's
index and its refusals. A broken copy of the sources fails to compile
and the call raises with g++'s output; the call counters count.
"""

import shutil

import numpy as np
import pytest
import torch

from bigdl_tpu import native as jnative
from bigdl_tpu.visualization import tensorboard as jtb
from bigdl_tpu_torch import native
from bigdl_tpu_torch.visualization import tensorboard as tb

DECODE_ATOL = 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_library_builds_from_the_port_sources():
    assert native.is_loaded()
    path = native.BUILD_INFO["path"]
    assert "build/bigdl_tpu_torch/libbigdl_tpu_torch_native-" in path
    assert sorted(p.name for p in native._SRC_DIR.glob("*.cc")) == [
        "codec.cc", "crc32c.cc", "decode.cc", "shard.cc", "util.cc"]
    for src in native._SRC_DIR.glob("*.cc"):
        assert "bigdl_tpu/native/src/" in src.read_text().split("\n\n")[0]
    native.set_num_threads(2)
    native.set_num_threads(0)


@pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 1024, 4097, 65536 + 3])
def test_crc32c_matches_reference_and_plain(n):
    data = np.random.default_rng(n).bytes(n)
    got = native.crc32c(data)
    assert got == native.crc32c_plain(data) == jtb.crc32c(data)
    assert got == jnative.load().bt_crc32c(data, n)
    assert tb.crc32c(data) == got
    assert native.crc32c(b"123456789") == 0xE3069283   # the standard check


def _bf16_inputs(seed, n=100_003):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 10.0 ** rng.integers(-30, 30, n)).astype(
        np.float32)
    x[:4] = [0.0, -0.0, np.inf, -np.inf]
    return x


def _ref_call(name, *arrays):
    import ctypes
    dll = jnative.load()
    getattr(dll, name)(*[a.ctypes.data_as(ctypes.POINTER(
        ctypes.c_float if a.dtype == np.float32 else ctypes.c_uint16))
        for a in arrays], arrays[0].size)


def test_codec_bit_for_bit():
    x = _bf16_inputs(1)
    y = _bf16_inputs(2)
    v = native.fp32_to_bf16(x)
    assert np.array_equal(v, native.fp32_to_bf16_plain(x))
    ref_v = np.empty(x.shape, np.uint16)
    _ref_call("bt_fp32_to_bf16", x, ref_v)
    assert np.array_equal(v, ref_v)
    w = native.bf16_to_fp32(v)
    ref_w = np.empty(x.shape, np.float32)
    _ref_call("bt_bf16_to_fp32", ref_v, ref_w)
    assert np.array_equal(w.view(np.uint32), ref_w.view(np.uint32))
    assert np.array_equal(w.view(np.uint32),
                          native.bf16_to_fp32_plain(v).view(np.uint32))
    a, b = native.fp32_to_bf16(x), native.fp32_to_bf16(y)
    plain, ref = a.copy(), a.copy()
    native.bf16_add(a, b)
    native.bf16_add_plain(plain, b)
    _ref_call("bt_bf16_add", ref, b)
    assert np.array_equal(a, plain) and np.array_equal(a, ref)
    acc = np.ones(x.shape, np.float32)
    acc_plain, acc_ref = acc.copy(), acc.copy()
    native.bf16_accumulate(acc, b)
    native.bf16_accumulate_plain(acc_plain, b)
    _ref_call("bt_bf16_accumulate", acc_ref, b)
    assert np.array_equal(acc.view(np.uint32), acc_plain.view(np.uint32))
    assert np.array_equal(acc.view(np.uint32), acc_ref.view(np.uint32))
    with pytest.raises(ValueError, match="C-contiguous"):
        native.bf16_add(a.astype(np.int32), b)
    with pytest.raises(ValueError, match="sizes differ"):
        native.bf16_accumulate(acc, b[:5])


@pytest.mark.parametrize("k", [0, 1, 2, 17, 500, 999, 1000, 1001])
def test_kth_largest(k):
    import ctypes
    v = np.random.default_rng(k).normal(size=1000)
    v[::7] = 0.5   # ties
    want = jnative.load().bt_kth_largest(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), v.size, k)
    assert native.kth_largest(v, k) == want == native.kth_largest_plain(v, k)
    assert native.kth_largest([], 1) == 0.0


@pytest.mark.parametrize("channels,workers", [(3, 1), (3, 4), (1, 3)])
def test_decode_normalize(channels, workers):
    import ctypes
    rng = np.random.default_rng(channels * 10 + workers)
    raw = rng.integers(0, 256, (5, 7 * 9 * channels), dtype=np.uint8)
    mean = np.asarray([104.0, 117.0, 123.0][:channels], np.float32)
    rstd = 1.0 / np.asarray([58.0, 57.0, 59.0][:channels], np.float32)
    got = native.decode_normalize(raw, mean, rstd, channels, workers)
    plain = native.decode_normalize_plain(raw, mean, rstd, channels)
    assert np.abs(got - plain).max() <= DECODE_ATOL
    ref = np.empty(raw.shape, np.float32)
    fp = ctypes.POINTER(ctypes.c_float)
    jnative.load().bt_decode_normalize(
        raw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), 5, raw.shape[1],
        mean.ctypes.data_as(fp), rstd.ctypes.data_as(fp), channels,
        ref.ctypes.data_as(fp), workers)
    assert np.array_equal(got, ref)


def _framed(payloads):
    import io
    buf = io.BytesIO()
    w = tb.RecordWriter(buf)
    for p in payloads:
        w.write(p)
    return buf.getvalue()


def test_shard_scan_index_and_refusals():
    rng = np.random.default_rng(3)
    payloads = [rng.bytes(int(rng.integers(0, 200))) for _ in range(40)]
    buf = _framed(payloads)
    n, offs, lens = native.shard_scan(buf, 64)
    assert n == 40
    assert [buf[o:o + n] for o, n in zip(offs.tolist(), lens.tolist())] \
        == payloads
    assert native.shard_scan(buf, 39)[0] == native.SCAN_FULL
    # a truncated tail ends the scan
    assert native.shard_scan(buf[:-3], 64)[0] == 39
    assert native.shard_scan(b"", 4)[0] == 0
    bad = bytearray(buf)
    bad[3] ^= 1                                        # the first length
    assert native.shard_scan(bytes(bad), 64)[0] == native.SCAN_CORRUPT_HEADER
    bad = bytearray(buf)
    bad[len(buf) - 5] ^= 1                             # the last payload
    assert native.shard_scan(bytes(bad), 64)[0] == native.SCAN_CORRUPT_PAYLOAD
    assert native.shard_scan(bytes(bad), 64, validate=False)[0] == 40


def test_counters_count_library_calls_only():
    framed = _framed([b"x"])   # the writer's CRCs are library calls too
    native.reset_counts()
    native.crc32c(b"abc")
    native.crc32c(b"abcd")
    native.crc32c_plain(b"abc")
    native.fp32_to_bf16(np.ones(3, np.float32))
    native.shard_scan(framed, 4)
    got = native.counts()
    assert got["bt_crc32c"] == 2 and got["bt_fp32_to_bf16"] == 1
    assert got["bt_shard_scan"] == 1 and got["bt_decode_normalize"] == 0
    native.reset_counts()
    assert set(native.counts().values()) == {0}


def test_broken_source_fails_to_compile_and_the_call_raises(tmp_path,
                                                            monkeypatch):
    src = tmp_path / "src"   # the smallest source alone keeps this quick
    src.mkdir()
    (src / "util.cc").write_text((native._SRC_DIR / "util.cc").read_text()
                                 + "\nthis is not C++;\n")
    with pytest.raises(RuntimeError, match="util.cc") as err:
        native.build_library(src, tmp_path / "build", shutil.which("g++"))
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").glob("*.so"))
    monkeypatch.setattr(native, "_SRC_DIR", src)
    monkeypatch.setattr(native, "_BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="building the native library"):
        native.crc32c(b"abc")


def test_edited_source_rebuilds_and_unchanged_is_reused(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(native._SRC_DIR / "util.cc", src)
    cxx = shutil.which("g++")
    path, built = native.build_library(src, tmp_path / "b", cxx)
    assert built and path.exists()
    again, built = native.build_library(src, tmp_path / "b", cxx)
    assert again == path and not built
    (src / "util.cc").write_text((src / "util.cc").read_text() + "\n// x\n")
    edited, built = native.build_library(src, tmp_path / "b", cxx)
    assert built and edited != path


def test_no_compiler_runs_the_plain_paths(monkeypatch, caplog):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_no_compiler", False)
    monkeypatch.setenv("CXX", "no-such-compiler-here")
    native.reset_counts()
    data = np.random.default_rng(5).bytes(100)
    with caplog.at_level("WARNING", logger="bigdl_tpu_torch.native"):
        assert native.crc32c(data) == jtb.crc32c(data)
        assert native.shard_scan(data, 4) is None
        native.crc32c(data)
    assert sum("no C++ compiler" in r.message for r in caplog.records) == 1
    assert set(native.counts().values()) == {0}
    assert not native.is_loaded()
