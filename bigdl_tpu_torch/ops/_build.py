"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Libraries go to
``build/bigdl_tpu_torch/`` at the repository root, named by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an edited
source or header rebuilds and an unchanged one is reused; each library's
``-Xptxas -v`` report is kept beside it. A failed build raises with
``nvcc``'s stderr. Nothing is built when the module is imported: the first
wrapper call on a CUDA tensor builds.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "bigdl_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
#: source -> {C entry: argument types}; pointers and the stream are c_void_p
ENTRIES = {
    "flash_fwd": {"bt_flash_fwd": [_P] * 5 + [_I] * 5 + [_F, _I, _I, _P]},
    "flash_bwd": {"bt_flash_bwd_dq": [_P] * 7 + [_I] * 5 + [_F, _I, _I, _P],
                  "bt_flash_bwd_dkv": [_P] * 8 + [_I] * 5 + [_F, _I, _I, _P],
                  "bt_flash_bwd_dq_mma": [_P] * 7 + [_I] * 5 + [_F, _I, _P],
                  "bt_flash_bwd_dkv_mma": [_P] * 8 + [_I] * 5 + [_F, _I, _P]},
    "int8_matmul": {"bt_int8_matmul": [_P] * 4 + [_I] * 3 + [_P],
                    "bt_int8_empty_launch": [_P]},
    "matmul_bn": {"bt_matmul_stats": [_P] * 7 + [_I] * 4 + [_P],
                  "bt_matmul_stats_mma": [_P] * 7 + [_I] * 3 + [_P],
                  "bt_matmul_stats_row_blocks": [_I]},
    "conv3x3_bn": {"bt_conv3x3_stats": [_P] * 7 + [_I] * 6 + [_P],
                   "bt_conv3x3_stats_row_blocks": [_I] * 3,
                   "bt_conv3x3_stats_mma": [_P] * 7 + [_I] * 5 + [_P],
                   "bt_conv3x3_stats_mma_row_blocks": [_I] * 3,
                   "bt_conv3x3_stats_tf32x3": [_P] * 7 + [_I] * 5 + [_P]},
    "hbm_roof": {"bt_hbm_blocks": [_I] * 3,
                 "bt_hbm_copy": [_P, _P, _L, _I, _I, _I, _P],
                 "bt_hbm_read": [_P] * 4 + [_L, _I, _I, _I, _P],
                 "bt_hbm_triad": [_P] * 3 + [_L, _I, _I, _I, _P],
                 "bt_hbm_staged_blocks": [_I] * 2,
                 "bt_hbm_staged_copy": [_P, _P, _L] + [_I] * 5 + [_P, _P, _P],
                 "bt_hbm_ranged_copy": [_P, _P, _L] + [_I] * 4 + [_P, _P]},
}
KERNELS = tuple(ENTRIES)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
#: ``nvcc -Xptxas -v`` report per kernel source built or loaded in this
#: process (registers, shared memory, spills)
BUILD_LOGS: Dict[str, str] = {}


#: capture stream -> the launches recorded on it (``recording_launches``)
_CAPTURING: Dict[int, Dict["LaunchCounter", int]] = {}
_CAPTURING_LOCK = threading.Lock()


def _current_stream_key() -> int:
    import torch
    return torch.cuda.current_stream().cuda_stream


class LaunchCounter:
    """Thread-safe count of kernel launches (or of calls down a path).

    A launch made while the current stream is one that
    ``recording_launches`` watches (a CUDA graph capture, which launches
    nothing) is recorded there instead, from whichever thread makes it (the
    autograd engine runs a captured backward on threads of its own); the
    graph adds the recorded amounts on each replay."""

    def __init__(self):
        self._n = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        if _CAPTURING:
            with _CAPTURING_LOCK:
                record = _CAPTURING.get(_current_stream_key())
                if record is not None:
                    record[self] = record.get(self, 0) + n
                    return
        with self._lock:
            self._n += n

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


#: operations (2 per multiply-add) of every K1-K6 launch, each launch adding
#: its own count from its shapes where it counts the launch; as a
#: ``LaunchCounter`` it is recorded during a CUDA graph capture and re-added
#: by each replay. ``telemetry.profiling.tracked_jit`` reads it around a
#: program's first call, where ``FlopCounterMode`` sees no ``ctypes`` launch.
KERNEL_FLOPS = LaunchCounter()


@contextlib.contextmanager
def recording_launches(stream_key: int):
    """Divert every ``LaunchCounter.add`` made while the stream with handle
    ``stream_key`` is current into the yielded ``{counter: amount}`` dict
    for the duration (launches on other streams count as usual)."""
    with _CAPTURING_LOCK:
        if stream_key in _CAPTURING:
            raise RuntimeError("launches on this stream are already being "
                               "recorded")
        _CAPTURING[stream_key] = record = {}
    try:
        yield record
    finally:
        with _CAPTURING_LOCK:
            del _CAPTURING[stream_key]


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    found = shutil.which("nvcc")
    if found:
        return found
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       "the kernels (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    """The library of ``name``, named by a hash of its source, every shared
    header in ``csrc/`` (sorted by name) and the flags."""
    h = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start the build of one kernel, or return None when it is built (its
    ``-Xptxas -v`` report is then read from beside the library)."""
    out = _target(name)
    if out.exists():
        report = out.with_suffix(".ptxas.txt")
        if name not in BUILD_LOGS and report.exists():
            BUILD_LOGS[name] = report.read_text()
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    out_text, err_text = proc.communicate()
    out = _target(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{err_text}{out_text}")
    BUILD_LOGS[name] = err_text + out_text
    out.with_suffix(".ptxas.txt").write_text(BUILD_LOGS[name])
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing


def build(names: Iterable[str] = KERNELS) -> float:
    """Build the named kernels, all ``nvcc`` processes at once; returns the
    seconds it took (0 when everything was already built)."""
    t0 = time.perf_counter()
    with _LOCK:
        procs = {}
        try:
            for name in names:
                procs[name] = _start(name)
        finally:
            # wait for every started nvcc, even when a later start raised
            errors = []
            for name, proc in procs.items():
                try:
                    _finish(name, proc)
                except RuntimeError as e:
                    errors.append(str(e))
            if errors:
                raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if needed, with
    its C entries' signatures declared."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_target(name)))
            for symbol, argtypes in ENTRIES[name].items():
                getattr(lib, symbol).argtypes = argtypes
                getattr(lib, symbol).restype = ctypes.c_int
            lib.bt_cuda_error_string.argtypes = [ctypes.c_int]
            lib.bt_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
    return lib


def check_status(lib: ctypes.CDLL, name: str, status: int) -> None:
    """Raise when a kernel's C entry returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {status} "
                           f"({lib.bt_cuda_error_string(status).decode()})")
