"""A callable captured once as a CUDA graph and replayed (the port's
counterpart of the compile in ``bigdl_tpu/telemetry/profiling.py``
``tracked_jit``: where the reference traces a host loop into one XLA
program, the port records one pass of its eager body into a CUDA graph and
relaunches it whole).

``GraphedProgram(body, device)`` runs ``body()``, which takes no arguments
and reads and writes tensors that the caller keeps at fixed addresses:

- the first call is the warm-up: ``body()`` runs eagerly on a side stream,
  where the lazy set-up of libraries, kernels and the allocator happens
  outside any capture, and its result is that call's result. The body is
  then captured on the same stream into a private memory pool of its own,
  with ``capture_error_mode="thread_local"``, so that other threads may
  synchronise and allocate while this one captures. The tensors that the
  captured pass returns are the program's static outputs;
- each later call replays the graph on the current stream and returns the
  static outputs, which the next replay overwrites;
- ``generators``: a function returning the explicit ``torch.Generator``s
  the body draws from (called after the warm-up, when generators made at
  first use exist), registered with the graph, so that each replay draws
  the next numbers of their streams as an eager call would;
- ``inputs``: a function returning the tensors that the graph reads or
  writes in place; their ``data_ptr``s at capture are checked before every
  replay, which raises if one moved;
- launch counts: the ``LaunchCounter.add`` calls made on the capture
  stream, by any thread (a captured backward runs on the autograd engine's
  threads), are recorded, not counted (a capture launches nothing), and
  each replay adds them, so the counters keep equalling the kernels that
  ran (``_build.KERNEL_FLOPS`` likewise);
- ``telemetry.profiling.tracked_jit`` counts a site's first call as its
  compile: here the warm-up and the capture, whose aten FLOPs, a repeat of
  the warm-up's, are left out (``profiling.uncounted``);
- the cyclic garbage collector is off while any capture runs: it runs
  finalizers in whichever thread happens to allocate, and a finalizer that
  destroys another, un-reset CUDA graph (one held by garbage in a reference
  cycle) inside the capturing thread invalidates the capture. Garbage that
  plain reference counting frees is unaffected.

A failed capture or replay raises; nothing falls back to the eager body.
``close()`` releases the graph and its pool. A CPU device raises: the CPU
path calls the body itself.
"""

from __future__ import annotations

import contextlib
import gc
import threading
from typing import Callable, Dict, Iterable, List, Optional, Sequence

import torch

from bigdl_tpu_torch.ops import _build
from bigdl_tpu_torch.telemetry.profiling import uncounted

__all__ = ["GraphedProgram"]

_gc_lock = threading.Lock()
_gc_captures = 0          # captures in progress, in every thread
_gc_was_enabled = False   # the collector's state before the first of them


@contextlib.contextmanager
def _no_cyclic_gc():
    """The cyclic garbage collector off while the block runs, and back on
    when the last such block in any thread ends, if it was on before the
    first."""
    global _gc_captures, _gc_was_enabled
    with _gc_lock:
        if _gc_captures == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_captures += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_captures -= 1
            if _gc_captures == 0 and _gc_was_enabled:
                gc.enable()


class GraphedProgram:
    """See the module docstring."""

    def __init__(self, body: Callable, device, *,
                 generators: Callable[[], Iterable[torch.Generator]] = tuple,
                 inputs: Optional[Callable[[], Sequence[torch.Tensor]]] = None):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"a CUDA graph needs a CUDA device, got {device}; "
                             "on the CPU call the body itself")
        self.body = body
        self.device = device
        self.generators = generators
        self.inputs = inputs
        self._graph: Optional[torch.cuda.CUDAGraph] = None
        self._out = None
        self._ptrs: List[int] = []
        self._launches: Dict[_build.LaunchCounter, int] = {}

    def _input_ptrs(self) -> List[int]:
        return [] if self.inputs is None else [
            t.data_ptr() for t in self.inputs()]

    def __call__(self):
        if self._graph is None:
            return self._warm_up_and_capture()
        self.replay()
        return self._out

    def _warm_up_and_capture(self):
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm = self.body()
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators():
            graph.register_generator_state(gen)
        with _build.recording_launches(side.cuda_stream) as launches, \
                torch.cuda.stream(side), uncounted(), _no_cyclic_gc():
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = self.body()
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass   # the body's error is the one to report
                raise
            graph.capture_end()
        cur.wait_stream(side)
        self._graph, self._out = graph, out
        self._launches = launches
        self._ptrs = self._input_ptrs()
        return warm

    def replay(self) -> None:
        """Relaunch the captured graph on the current stream."""
        if self._graph is None:
            raise RuntimeError("replay before capture")
        if self._input_ptrs() != self._ptrs:
            raise RuntimeError(
                "a tensor the CUDA graph reads was replaced since its "
                "capture (its data_ptr moved); the graph would read stale "
                "memory")
        self._graph.replay()
        for counter, n in self._launches.items():
            counter.add(n)

    def close(self) -> None:
        """Release the graph and its memory pool (idempotent)."""
        if self._graph is not None:
            self._graph.reset()
        self._graph, self._out, self._launches = None, None, {}
