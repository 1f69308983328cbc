"""Engine: the process's device topology (counterpart of
``bigdl_tpu/utils/engine.py``, reference ``utils/Engine.scala:32``).

What the reference's Engine does on a TPU host, this one does for CUDA
cards: device discovery (``torch.cuda``), this process's index and the
process count (``torch.distributed``'s rank and world size when a process
group is up, else 0 and 1), the core budget of the host library
(``native.set_num_threads``), a small host I/O thread pool for the data
pipeline, and launch-environment checks.

- ``init()`` with no ``devices`` takes every visible CUDA device and
  raises when there is none: the CPU is used only when the caller passes
  it (``devices=["cpu"]``), as every entry point of the port does.
- ``default_mesh`` raises: the device mesh and the multi-process plane
  wait for ROADMAP A.4 (distributed plane). The reference's
  ``_maybe_init_distributed`` (``jax.distributed.initialize`` from the
  environment) has no counterpart: a ``torch.distributed`` process group
  is started by its caller, with its address, world size and rank.

Torch is imported inside the functions, so ``bigdl_tpu_torch.utils`` stays
cheap to import.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence

logger = logging.getLogger("bigdl_tpu_torch")

__all__ = ["Engine"]


class _EngineState:
    def __init__(self) -> None:
        self.initialized = False
        self.env_warned: set = set()
        self.node_number = 1
        self.core_number = 1
        self._devices: Optional[list] = None
        self._io_pool: Optional[ThreadPoolExecutor] = None
        self._lock = threading.Lock()


_state = _EngineState()


def _cuda_devices() -> list:
    """Every visible CUDA device; raises without one (as
    ``resolve_device`` does: the CPU only when asked for)."""
    import torch

    from bigdl_tpu_torch.utils.device import resolve_device
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class Engine:
    """Process-global topology singleton (reference ``utils/Engine.scala``)."""

    @staticmethod
    def init(node_number: Optional[int] = None,
             core_number: Optional[int] = None,
             devices: Optional[Sequence] = None) -> None:
        """Initialise the topology. ``node_number`` is the number of
        processes (default ``process_count()``), ``core_number`` the host
        threads of this process's native library (default
        ``os.cpu_count()`` over ``node_number``); ``devices`` defaults to
        every visible CUDA device."""
        import torch
        devs = ([torch.device(d) for d in devices] if devices is not None
                else _cuda_devices())
        with _state._lock:
            _state._devices = devs
            _state.node_number = (node_number if node_number is not None
                                  else Engine.process_count())
            _state.core_number = (
                core_number if core_number is not None
                else max(1, (os.cpu_count() or 1) // max(1, _state.node_number)))
            _state.initialized = True
        # the host library's threads get the declared core budget
        # (reference ThreadPool.setMKLThread / MKL.setNumThreads)
        from bigdl_tpu_torch import native
        native.set_num_threads(_state.core_number)
        Engine.check_env()

    @staticmethod
    def check_env(strict: bool = False) -> List[str]:
        """Check the launch environment (reference
        ``Engine.checkSparkContext``): ``OMP_NUM_THREADS`` should be set to
        1-4, or the host's BLAS threads fight the data pipeline's. Warns
        once a process per complaint, raises with ``strict``; returns the
        complaints. ``BIGDL_TPU_DISABLE_ENV_CHECK=1`` turns it off. The
        reference's ``JAX_COMPILATION_CACHE_DIR`` check has no counterpart:
        the port compiles its kernels once into ``build/``."""
        problems: List[str] = []
        disable = os.environ.get("BIGDL_TPU_DISABLE_ENV_CHECK", "")
        if disable.strip().lower() in ("1", "true", "yes", "y", "on"):
            return problems
        omp = os.environ.get("OMP_NUM_THREADS")
        if omp is not None:
            omp = omp.strip()
        if omp is None or not omp.isdigit() or not 1 <= int(omp) <= 4:
            problems.append(
                f"OMP_NUM_THREADS={omp or '<unset>'}: host BLAS/OpenMP "
                "threads fight the data-pipeline IO pool; the launcher "
                "pins it to 1 (reference spark-bigdl.conf OMP_NUM_THREADS=1)")
        for p in problems:
            if p not in _state.env_warned:
                _state.env_warned.add(p)
                logger.warning("[Engine.check_env] %s", p)
        if strict and problems:
            raise RuntimeError("launch environment check failed:\n  "
                               + "\n  ".join(problems))
        return problems

    @staticmethod
    def process_index() -> int:
        """This process's rank (0 is the driver for logging and checkpoint
        IO): ``torch.distributed``'s when a group is up, else 0."""
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_rank()
        return 0

    @staticmethod
    def process_count() -> int:
        import torch.distributed as dist
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size()
        return 1

    @staticmethod
    def local_devices() -> list:
        """This process's CUDA devices (every visible one)."""
        return _cuda_devices()

    @staticmethod
    def is_initialized() -> bool:
        return _state.initialized

    @staticmethod
    def node_number() -> int:
        Engine._ensure()
        return _state.node_number

    @staticmethod
    def core_number() -> int:
        Engine._ensure()
        return _state.core_number

    @staticmethod
    def devices() -> list:
        Engine._ensure()
        return list(_state._devices)

    @staticmethod
    def device_count() -> int:
        return len(Engine.devices())

    @staticmethod
    def default_mesh(axis_name: str = "data"):
        """The data-parallel device mesh: not ported yet."""
        raise NotImplementedError(
            "Engine.default_mesh is not ported yet: ROADMAP A.4 "
            "(distributed plane)")

    @staticmethod
    def io_pool() -> ThreadPoolExecutor:
        """Host-side IO/prefetch pool (reference ``Engine.default``) of
        ``BIGDL_TPU_IO_THREADS`` threads (default min(16, cores))."""
        Engine._ensure()
        with _state._lock:
            if _state._io_pool is None:
                n = int(os.environ.get("BIGDL_TPU_IO_THREADS",
                                       str(min(16, os.cpu_count() or 4))))
                _state._io_pool = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix="bigdl-io")
            return _state._io_pool

    @staticmethod
    def check_singleton() -> bool:
        """One training process per host (reference
        ``Engine.checkSingleton``): an exclusive lock file in
        ``$BIGDL_SINGLETON_DIR`` (default the temp directory). True when
        this process holds (or just took) the claim, False when another
        live process holds it. Off unless ``BIGDL_CHECK_SINGLETON=1``."""
        if os.environ.get("BIGDL_CHECK_SINGLETON", "0") != "1":
            return True
        import tempfile
        lock_dir = os.environ.get("BIGDL_SINGLETON_DIR",
                                  tempfile.gettempdir())
        path = os.path.join(lock_dir, "bigdl_tpu.singleton.lock")
        pid = os.getpid()

        def try_claim() -> bool:
            # the pid goes to a private file that is then hard-linked into
            # place: link(2) is atomic, so one contender wins and the lock
            # file is never seen half written
            tmp = f"{path}.{pid}"
            try:
                with open(tmp, "w") as f:
                    f.write(str(pid))
                os.link(tmp, path)
                return True
            except FileExistsError:
                return False
            finally:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass

        if try_claim():
            return True
        try:
            with open(path) as f:
                holder = int(f.read().strip() or "0")
        except (OSError, ValueError):
            holder = 0
        if holder == pid:
            return True
        if not holder:
            return False  # an unreadable or foreign lock is not taken
        try:
            os.kill(holder, 0)  # is the holder alive?
            return False
        except ProcessLookupError:
            pass  # a stale lock of a dead process: take it over
        except PermissionError:
            return False  # a live process of another user holds it
        try:
            os.unlink(path)
        except OSError:
            pass
        return try_claim()  # one stale-lock contender wins the link

    @staticmethod
    def reset() -> None:
        """Forget the topology (test hook)."""
        with _state._lock:
            if _state._io_pool is not None:
                _state._io_pool.shutdown(wait=False)
            _state.__init__()

    @staticmethod
    def _ensure() -> None:
        if not _state.initialized:
            Engine.init()
