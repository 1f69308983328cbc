"""The host library (counterpart of ``bigdl_tpu/native/__init__.py``):
C++ for the runtime around the compute path, from ``src/*.cc``.

- ``bt_crc32c``: CRC32C of the TFRecord framing (event files, shards);
- ``bt_fp32_to_bf16`` / ``bt_bf16_to_fp32`` / ``bt_bf16_add`` /
  ``bt_bf16_accumulate``: the bf16 compression codec (fp32 truncated to
  its top 16 bits), threaded;
- ``bt_kth_largest``: quickselect, 1-based k;
- ``bt_set_num_threads``: the codec's thread count (0: one per core);
- ``bt_shard_scan``: a whole shard's record index with every CRC checked,
  the payloads' CRCs on threads (``dataset/shards.py``);
- ``bt_decode_normalize``: a batch of uint8 records to f32 with the
  per-channel ``(x - mean) * (1 / std)`` fused, threaded over records
  (``dataset/image.py``'s ``NativeBGRBatchDecoder``).

The library is compiled at first use, never at import, with ``g++ -O3
-std=c++17 -fPIC -shared -pthread`` from this package's ``src/`` into
``build/bigdl_tpu_torch/`` at the repository root, named by a hash of the
sources, the compiler and the flags (an edited source rebuilds, an
unchanged one is reused), and bound with ``ctypes``. A failed compile
raises with g++'s output. With no ``g++`` on the box every wrapper runs
its numpy plain version, and a warning says so once.

Each wrapper below counts its calls into the library in ``CALLS`` (the
plain versions count nothing), so a run can show that the native path was
taken. The ``*_plain`` functions are the reference's numpy paths, kept for
the tests.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

logger = logging.getLogger("bigdl_tpu_torch.native")

_SRC_DIR = Path(__file__).resolve().parent / "src"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bigdl_tpu_torch"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_no_compiler = False
#: how this process got the library: path, whether it compiled it, seconds
BUILD_INFO: Dict[str, object] = {}


class CallCounter:
    """Thread-safe count of calls into the library."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


ENTRIES = ("bt_crc32c", "bt_fp32_to_bf16", "bt_bf16_to_fp32", "bt_bf16_add",
           "bt_bf16_accumulate", "bt_kth_largest", "bt_shard_scan",
           "bt_decode_normalize")
#: C entry -> calls made through its wrapper
CALLS: Dict[str, CallCounter] = {name: CallCounter() for name in ENTRIES}


def reset_counts() -> None:
    for c in CALLS.values():
        c.reset()


def counts() -> Dict[str, int]:
    return {name: c.value for name, c in CALLS.items()}


def _sources(src_dir: Path) -> List[Path]:
    return sorted(src_dir.glob("*.cc"))


def library_path(src_dir: Path, build_dir: Path, cxx: str) -> Path:
    """The library of ``src_dir``'s sources: named by a hash of each
    source's name and bytes, the compiler and the flags."""
    h = hashlib.sha256()
    for src in _sources(src_dir):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(cxx.encode())
    h.update(" ".join(CXX_FLAGS).encode())
    return build_dir / f"libbigdl_tpu_torch_native-{h.hexdigest()[:16]}.so"


def build_library(src_dir: Path, build_dir: Path,
                  cxx: str) -> Tuple[Path, bool]:
    """Compile ``src_dir/*.cc`` into ``build_dir`` unless the library of
    these sources is there already; returns (path, compiled now). The
    output is written under a private name and renamed into place, so
    processes building at once never load a partial file. Raises with
    g++'s stderr when the compile fails."""
    target = library_path(src_dir, build_dir, cxx)
    if target.exists():
        return target, False
    build_dir.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}."
                           f"{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), *map(str, _sources(src_dir))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the native library failed "
                           f"({' '.join(cmd)}):\n{proc.stderr}")
    os.replace(tmp, target)
    return target, True


def _bind(path: Path) -> ctypes.CDLL:
    dll = ctypes.CDLL(str(path))
    dll.bt_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_size_t]
    dll.bt_crc32c.restype = ctypes.c_uint32
    p = ctypes.c_void_p
    dll.bt_fp32_to_bf16.argtypes = [p, p, ctypes.c_size_t]
    dll.bt_bf16_to_fp32.argtypes = [p, p, ctypes.c_size_t]
    dll.bt_bf16_add.argtypes = [p, p, ctypes.c_size_t]
    dll.bt_bf16_accumulate.argtypes = [p, p, ctypes.c_size_t]
    dll.bt_set_num_threads.argtypes = [ctypes.c_int]
    dll.bt_kth_largest.argtypes = [p, ctypes.c_size_t, ctypes.c_size_t]
    dll.bt_kth_largest.restype = ctypes.c_double
    dll.bt_shard_scan.argtypes = [p, ctypes.c_size_t, p, p, ctypes.c_size_t,
                                  ctypes.c_int]
    dll.bt_shard_scan.restype = ctypes.c_int64
    dll.bt_decode_normalize.argtypes = [p, ctypes.c_int64, ctypes.c_int64, p,
                                        p, ctypes.c_int, p, ctypes.c_int]
    return dll


def load() -> Optional[ctypes.CDLL]:
    """The library, built at the first call; None only when there is no
    C++ compiler (``$CXX``, default ``g++``)."""
    global _lib, _no_compiler
    if _lib is not None or _no_compiler:
        return _lib
    with _lock:
        if _lib is not None or _no_compiler:
            return _lib
        cxx = shutil.which(os.environ.get("CXX", "g++"))
        if cxx is None:
            _no_compiler = True
            logger.warning("no C++ compiler (g++) found: the host library "
                           "is not built and its callers run their numpy "
                           "paths")
            return None
        t0 = time.perf_counter()
        path, built = build_library(_SRC_DIR, _BUILD_DIR, cxx)
        _lib = _bind(path)
        BUILD_INFO.update(path=str(path), built=built,
                          seconds=time.perf_counter() - t0)
        logger.info("native library %s from %s", "built" if built
                    else "loaded", path)
        return _lib


def is_loaded() -> bool:
    """reference ``is_loaded`` (BigDL's ``MKL.isMKLLoaded``)."""
    return load() is not None


def set_num_threads(n: int) -> None:
    """reference ``set_num_threads``: the codec's threads (0: one a core)."""
    dll = load()
    if dll is not None:
        dll.bt_set_num_threads(int(n))


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _call(name: str):
    dll = load()
    if dll is None:
        return None
    CALLS[name].add()
    return getattr(dll, name)


# ------------------------------------------------------------------ CRC32C

_CRC_TABLE: Optional[List[int]] = None


def crc32c_plain(data) -> int:
    """CRC32C byte by byte over the reflected Castagnoli table."""
    global _CRC_TABLE
    if _CRC_TABLE is None:
        c = np.arange(256, dtype=np.uint32)
        for _ in range(8):
            c = np.where(c & 1, (c >> 1) ^ np.uint32(0x82F63B78), c >> 1)
        _CRC_TABLE = [int(v) for v in c]
    table = _CRC_TABLE
    crc = 0xFFFFFFFF
    for b in bytes(data):
        crc = (crc >> 8) ^ table[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def crc32c(data) -> int:
    """CRC32C of a bytes-like object."""
    fn = _call("bt_crc32c")
    if fn is None:
        return crc32c_plain(data)
    buf = np.frombuffer(data, np.uint8) if len(data) else np.zeros(1, np.uint8)
    return int(fn(_ptr(buf), len(data)))


# -------------------------------------------------------------- bf16 codec

def fp32_to_bf16_plain(x: np.ndarray) -> np.ndarray:
    return (np.ascontiguousarray(x, np.float32).view(np.uint32) >> 16
            ).astype(np.uint16)


def bf16_to_fp32_plain(v: np.ndarray) -> np.ndarray:
    return (np.ascontiguousarray(v, np.uint16).astype(np.uint32) << 16
            ).view(np.float32)


def bf16_add_plain(dst: np.ndarray, src: np.ndarray) -> None:
    dst[...] = fp32_to_bf16_plain(bf16_to_fp32_plain(dst)
                                  + bf16_to_fp32_plain(src))


def bf16_accumulate_plain(dst: np.ndarray, src: np.ndarray) -> None:
    dst += bf16_to_fp32_plain(src)


def _checked(a: np.ndarray, dtype) -> np.ndarray:
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise ValueError(f"expected a C-contiguous {np.dtype(dtype)} array, "
                         f"got {a.dtype}")
    return a


def fp32_to_bf16(x: np.ndarray) -> np.ndarray:
    """fp32 truncated to its top 16 bits, as uint16."""
    x = np.ascontiguousarray(x, np.float32)
    fn = _call("bt_fp32_to_bf16")
    if fn is None:
        return fp32_to_bf16_plain(x)
    out = np.empty(x.shape, np.uint16)
    fn(_ptr(x), _ptr(out), x.size)
    return out


def bf16_to_fp32(v: np.ndarray) -> np.ndarray:
    v = np.ascontiguousarray(v, np.uint16)
    fn = _call("bt_bf16_to_fp32")
    if fn is None:
        return bf16_to_fp32_plain(v)
    out = np.empty(v.shape, np.float32)
    fn(_ptr(v), _ptr(out), v.size)
    return out


def bf16_add(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst += src`` in bf16 (both widened, added in f32, truncated), in
    place."""
    _checked(dst, np.uint16)
    src = np.ascontiguousarray(src, np.uint16)
    if src.size != dst.size:
        raise ValueError(f"sizes differ: {dst.size} and {src.size}")
    fn = _call("bt_bf16_add")
    if fn is None:
        return bf16_add_plain(dst, src)
    fn(_ptr(dst), _ptr(src), dst.size)


def bf16_accumulate(dst: np.ndarray, src: np.ndarray) -> None:
    """f32 ``dst += widen(src)``, in place."""
    _checked(dst, np.float32)
    src = np.ascontiguousarray(src, np.uint16)
    if src.size != dst.size:
        raise ValueError(f"sizes differ: {dst.size} and {src.size}")
    fn = _call("bt_bf16_accumulate")
    if fn is None:
        return bf16_accumulate_plain(dst, src)
    fn(_ptr(dst), _ptr(src), dst.size)


# --------------------------------------------------------------- quickselect

def kth_largest_plain(values, k: int) -> float:
    v = np.asarray(values, np.float64).ravel()
    if v.size == 0 or k < 1 or k > v.size:
        return 0.0
    return float(np.sort(v)[::-1][k - 1])


def kth_largest(values, k: int) -> float:
    """The k-th largest value, k 1-based (k = 1: the maximum); 0.0 for a k
    out of range, as the reference's."""
    v = np.ascontiguousarray(values, np.float64).ravel()
    fn = _call("bt_kth_largest")
    if fn is None:
        return kth_largest_plain(v, k)
    if v.size == 0:
        return 0.0
    return float(fn(_ptr(v), v.size, int(k)))


# ----------------------------------------------------------------- shards

SCAN_CORRUPT_HEADER, SCAN_CORRUPT_PAYLOAD, SCAN_FULL = -1, -2, -3


def shard_scan(buf: bytes, max_records: int, validate: bool = True):
    """Index a framed shard: ``(n, offsets, lengths)`` of its payloads, or
    ``(code, None, None)`` for a corrupt header (-1), a corrupt payload
    (-2) or more than ``max_records`` records (-3). None when there is no
    library (the caller then reads the records in Python)."""
    fn = _call("bt_shard_scan")
    if fn is None:
        return None
    offs = np.empty(max(1, max_records), np.uint64)
    lens = np.empty(max(1, max_records), np.uint64)
    data = np.frombuffer(buf, np.uint8) if len(buf) else np.zeros(1, np.uint8)
    n = int(fn(_ptr(data), len(buf), _ptr(offs), _ptr(lens), max_records,
               int(bool(validate))))
    if n < 0:
        return n, None, None
    return n, offs[:n], lens[:n]


# ------------------------------------------------------------------ decode

def decode_normalize_plain(raw: np.ndarray, mean: np.ndarray,
                           rstd: np.ndarray, channels: int) -> np.ndarray:
    """(N, L) uint8 records to (N, L) f32 ``(x - mean[c]) * rstd[c]``, c
    the channel of an interleaved record."""
    n, rec_len = raw.shape
    out = raw.astype(np.float32).reshape(n, -1, channels)
    return ((out - mean) * rstd).reshape(n, rec_len)


def decode_normalize(raw: np.ndarray, mean: np.ndarray, rstd: np.ndarray,
                     channels: int, workers: int) -> np.ndarray:
    """The threaded form of ``decode_normalize_plain``: ``mean`` and
    ``rstd`` hold 3 entries for 3 channels, else 1."""
    raw = _checked(raw, np.uint8)
    mean = np.ascontiguousarray(mean, np.float32)
    rstd = np.ascontiguousarray(rstd, np.float32)
    fn = _call("bt_decode_normalize")
    if fn is None:
        return decode_normalize_plain(raw, mean, rstd, channels)
    n, rec_len = raw.shape
    out = np.empty((n, rec_len), np.float32)
    fn(_ptr(raw), n, rec_len, _ptr(mean), _ptr(rstd), int(channels),
       _ptr(out), int(workers))
    return out
