"""Compile flight recorder, peak FLOP/s and MFU, and device-memory sampling
(counterpart of ``bigdl_tpu/telemetry/profiling.py``).

``tracked_jit(fn, site="train.step")`` wraps a callable the way the
reference wraps ``jax.jit``, and records one ``CompileEvent`` per new
argument signature. The port compiles nothing per call: its "compile" of a
site is the first call of a new signature, which runs the eager body once
(the kernels' ``nvcc`` builds happen at first use before it, in
``ops/_build.py``, and are not part of it); where the site is a CUDA graph
(``utils/cuda_graph.py``) the first call is the eager warm-up plus the
capture. Later calls of a cached signature cost one key and one dict
lookup.

- **Signature**: each tensor leaf's shape, dtype, device and
  ``requires_grad``; numpy arrays by shape and dtype; Python scalars,
  ``None`` and generators by type (the reference keys a Python scalar by
  type: a position does not split programs); every other leaf by its value
  (it must be hashable; an unhashable one bypasses tracking).
- **Cache**: bounded (``cache_size``), oldest-first single-entry eviction,
  each eviction counted in ``bigdl_compile_cache_evictions_total``; an
  evicted signature's next call is a compile again.
- **Timing**: the first call's wall seconds, between two synchronizes of
  the calling thread's current stream on its CUDA device (the device of
  its first CUDA tensor argument), where the call's work is queued. Not
  the whole device: a device-wide synchronize from one thread invalidates
  a CUDA graph capture in progress in another (a server's worker
  tracks its first prefill while another replica captures its round).
- **Cost fields**, each present or ``None``: ``flops`` (at the sites
  built with ``count_flops``: the training sites, whose FLOPs MFU reads)
  from the formulas of ``torch.utils.flop_counter`` (``flop_registry``,
  the ones ``FlopCounterMode`` applies) over the aten ops of the first
  call, plus the operations the hand-written kernels K1-K6 add per launch
  (``ops/_build.KERNEL_FLOPS``: an aten counter sees no ``ctypes``
  launch); a CUDA graph capture, whose work repeats the warm-up's, is left
  out (``uncounted``). The counter is a dispatch mode, a Python call per
  op: on an H100 host it made the first calls of the host-bound
  generation and serving loops about twice as slow (phases 3d-3h of
  ``chip_smoke.py`` 185 s longer together), so the other sites leave
  ``flops`` None.
  ``FlopCounterMode`` itself is not used: it decomposes the ops its
  registry lacks, and its module tracker hooks the backward, and either
  moves the first step's gradients by an ulp from every later step's (a
  resume or a k-window would then not be bit-equal to the run it
  repeats); the counter here runs every op as it is. ``temp_bytes``,
  the rise of ``torch.cuda.max_memory_allocated`` over the first call
  (``None`` on the CPU); ``output_bytes``, the outputs' ``nbytes``;
  ``bytes_accessed`` and ``argument_bytes``, ``None``.
- **Metrics and spans**: ``bigdl_compiles_total{site}``,
  ``bigdl_compile_seconds{site}``, ``bigdl_program_flops{site}``,
  ``bigdl_program_temp_bytes{site}``, ``bigdl_program_output_bytes{site}``
  and a ``profiling.compile`` span, as the reference writes them.

``peak_flops()`` is ``BIGDL_TPU_PEAK_FLOPS`` when set, else the data
sheet's 989.4 TFLOP/s (bf16, dense) for an H100, else ``None``; ``mfu``
divides a step's FLOPs by its seconds and that peak. No TPU figure is
carried over.

Torch is imported inside the functions: ``python -m
bigdl_tpu_torch.telemetry`` runs on a bare host.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence, Tuple

from bigdl_tpu_torch.telemetry.registry import MetricsRegistry, get_registry
from bigdl_tpu_torch.telemetry.tracing import span

__all__ = ["tracked_jit", "TrackedJit", "CompileEvent", "peak_flops", "mfu",
           "sample_device_memory", "DEFAULT_CACHE_SIZE", "uncounted"]

#: Default retained-signature bound per tracked site (a training loop has
#: one signature; the serving prefill a few).
DEFAULT_CACHE_SIZE = 64

#: bf16 dense peak of one NVIDIA H100 SXM (data sheet; at 700 W)
H100_BF16_PEAK = 989.4e12


class CompileEvent:
    """One recorded compile: what, how long, what it costs."""

    __slots__ = ("site", "signature", "seconds", "flops", "bytes_accessed",
                 "temp_bytes", "output_bytes", "argument_bytes")

    def __init__(self, site: str, signature: str, seconds: float,
                 flops: Optional[float] = None,
                 bytes_accessed: Optional[float] = None,
                 temp_bytes: Optional[int] = None,
                 output_bytes: Optional[int] = None,
                 argument_bytes: Optional[int] = None):
        self.site = site
        self.signature = signature
        self.seconds = seconds
        self.flops = flops
        self.bytes_accessed = bytes_accessed
        self.temp_bytes = temp_bytes
        self.output_bytes = output_bytes
        self.argument_bytes = argument_bytes

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


def _leaves(obj, out: list) -> list:
    if isinstance(obj, (list, tuple)):
        for x in obj:
            _leaves(x, out)
    elif isinstance(obj, dict):
        for k in sorted(obj, key=repr):
            out.append(k)
            _leaves(obj[k], out)
    else:
        out.append(obj)
    return out


def _leaf_key(x) -> Tuple:
    import torch
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device, x.requires_grad)
    if x is None or isinstance(x, (bool, int, float, torch.Generator)):
        # as the reference keys a Python scalar (a weak-typed traced
        # input): by type, so a position or a seed does not split programs
        return (type(x),)
    shape = getattr(x, "shape", None)
    if shape is not None and hasattr(x, "dtype"):     # a numpy array
        return (tuple(shape), str(x.dtype))
    hash(x)                 # an unhashable leaf raises TypeError here
    return (type(x), x)


def _tensors(obj) -> list:
    import torch
    return [x for x in _leaves(obj, []) if isinstance(x, torch.Tensor)]


_tls = threading.local()


def _flop_counter():
    """A dispatch mode that runs every op unchanged and adds the
    ``torch.utils.flop_counter`` formula of each op its registry has."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    def dispatch(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += formula(*args, **kwargs, out_val=out)
        return out

    # TorchDispatchMode wraps a subclass's __torch_dispatch__ in
    # torch._disable_dynamo, whose first call imports torch._dynamo (about
    # 2 s on a CPU host, 10-20 s in a fresh process on an H100 host) to
    # exclude it from a torch.compile trace; nothing of this mode is
    # compiled, so the wrapper is handed the function itself as its
    # "disabled" form
    setattr(dispatch, "__dynamo_disable", dispatch)

    class _FlopCount(TorchDispatchMode):
        __torch_dispatch__ = dispatch

        def __init__(self):
            super().__init__()
            self.total = 0

        def get_total_flops(self) -> int:
            return self.total

    return _FlopCount()


@contextlib.contextmanager
def uncounted():
    """Leave the aten FLOPs of the block out of the tracked first call in
    progress on this thread: a CUDA graph capture repeats its warm-up's
    work (``utils/cuda_graph.py`` wraps its capture in this)."""
    counter = getattr(_tls, "counter", None)
    if counter is None:
        yield
        return
    before = counter.get_total_flops()
    try:
        yield
    finally:
        _tls.discount += counter.get_total_flops() - before


class TrackedJit:
    """A callable with a compile flight recorder (see the module
    docstring). ``count_flops``: count the first call's FLOPs (the
    training sites, whose FLOPs MFU reads); elsewhere ``flops`` is None.
    ``donate_argnums`` is accepted and recorded for the reference's call
    sites; it has no effect in PyTorch, where the loop updates its tensors
    in place."""

    def __init__(self, fn: Callable, *, site: str,
                 registry: Optional[MetricsRegistry] = None,
                 cache_size: int = DEFAULT_CACHE_SIZE,
                 donate_argnums: Sequence[int] = (),
                 count_flops: bool = False):
        from bigdl_tpu_torch.telemetry.catalogue import instruments
        self.fn = fn
        self.site = site
        self.cache_size = max(1, int(cache_size))
        self.donate_argnums = tuple(donate_argnums)
        self.count_flops = bool(count_flops)
        self._registry = registry if registry is not None else get_registry()
        self._tm = instruments(self._registry)
        self._programs: "OrderedDict[Tuple, None]" = OrderedDict()
        self._lock = threading.Lock()
        self.events: list = []            # CompileEvent, oldest first
        self.last_event: Optional[CompileEvent] = None
        self.compiles = 0

    @property
    def last_flops(self) -> Optional[float]:
        ev = self.last_event
        return ev.flops if ev is not None else None

    def _signature(self, args, kwargs) -> Tuple:
        return tuple(_leaf_key(x) for x in _leaves([args, kwargs], []))

    @staticmethod
    def _describe(args) -> str:
        """Terse signature for the event and span: leaf count and the
        first few tensor shapes."""
        leaves = _tensors(args)
        shapes = ["x".join(str(d) for d in t.shape) or "scalar"
                  for t in leaves[:4]]
        extra = f"+{len(leaves) - 4}" if len(leaves) > 4 else ""
        return f"{len(leaves)} tensors ({','.join(shapes)}{extra})"

    def __call__(self, *args, **kwargs):
        try:
            key = self._signature(args, kwargs)
        except TypeError:   # an unhashable leaf: not tracked
            return self.fn(*args, **kwargs)
        with self._lock:
            hit = key in self._programs
            if hit:
                self._programs.move_to_end(key)
        if hit:
            return self.fn(*args, **kwargs)
        return self._compile(key, args, kwargs)

    def _compile(self, key, args, kwargs):
        import torch

        from bigdl_tpu_torch.ops import _build
        desc = self._describe(args)
        dev = next((t.device for t in _tensors([args, kwargs])
                    if t.device.type == "cuda"), None)
        if dev is not None:
            stream = torch.cuda.current_stream(dev)
            stream.synchronize()
            peak0 = torch.cuda.max_memory_allocated(dev)
        saved = (getattr(_tls, "counter", None), getattr(_tls, "discount", 0))
        kernel0 = _build.KERNEL_FLOPS.value
        t0 = time.perf_counter()
        with span("profiling.compile", site=self.site, signature=desc):
            counter = _flop_counter() if self.count_flops else None
            _tls.counter, _tls.discount = counter, 0
            try:
                with counter or contextlib.nullcontext():
                    out = self.fn(*args, **kwargs)
                if dev is not None:
                    stream.synchronize()
                seconds = time.perf_counter() - t0
                flops = (counter.get_total_flops() - _tls.discount
                         + _build.KERNEL_FLOPS.value - kernel0
                         if self.count_flops else None)
            finally:
                _tls.counter, _tls.discount = saved
        temp = (max(0, torch.cuda.max_memory_allocated(dev) - peak0)
                if dev is not None else None)
        outb = sum(t.numel() * t.element_size() for t in _tensors(out))
        self._record(CompileEvent(self.site, desc, seconds, flops, None,
                                  temp, outb, None))
        with self._lock:
            self._programs[key] = None
            while len(self._programs) > self.cache_size:
                # oldest-first single-entry eviction, never clear-at-cap
                self._programs.popitem(last=False)
                self._tm.compile_cache_evictions_total.labels(
                    site=self.site).inc()
        return out

    def _record(self, ev: CompileEvent) -> None:
        self.events.append(ev)
        self.last_event = ev
        self.compiles += 1
        site = self.site
        tm = self._tm
        tm.compiles_total.labels(site=site).inc()
        tm.compile_seconds.labels(site=site).observe(ev.seconds)
        if ev.flops is not None:
            tm.program_flops.labels(site=site).set(ev.flops)
        if ev.temp_bytes is not None:
            tm.program_temp_bytes.labels(site=site).set(ev.temp_bytes)
        if ev.output_bytes is not None:
            tm.program_output_bytes.labels(site=site).set(ev.output_bytes)

    def __repr__(self) -> str:
        return (f"TrackedJit(site={self.site!r}, compiles={self.compiles}, "
                f"cached={len(self._programs)})")


def tracked_jit(fn: Callable, *, site: str,
                registry: Optional[MetricsRegistry] = None,
                cache_size: int = DEFAULT_CACHE_SIZE,
                donate_argnums: Sequence[int] = (),
                count_flops: bool = False) -> TrackedJit:
    """Wrap ``fn`` with the compile flight recorder (see
    :class:`TrackedJit`)."""
    return TrackedJit(fn, site=site, registry=registry,
                      cache_size=cache_size, donate_argnums=donate_argnums,
                      count_flops=count_flops)


# ---------------------------------------------------------------------------
# Peak FLOP/s and MFU
# ---------------------------------------------------------------------------

_peak_cache: Dict[str, Optional[float]] = {}


def peak_flops() -> Optional[float]:
    """Peak FLOP/s of this process's card for MFU, or None when unknown:
    ``BIGDL_TPU_PEAK_FLOPS`` when set (any device, the CPU included);
    otherwise an H100 (by ``torch.cuda.get_device_name``) maps to the data
    sheet's bf16 dense 989.4 TFLOP/s; any other card, or none, to None."""
    env = os.environ.get("BIGDL_TPU_PEAK_FLOPS", "")
    if env:
        try:
            return float(env)
        except ValueError:
            pass
    if "name" not in _peak_cache:
        import torch
        name = (torch.cuda.get_device_name(0)
                if torch.cuda.is_available() else "")
        _peak_cache["name"] = H100_BF16_PEAK if "H100" in name else None
    return _peak_cache["name"]


def mfu(flops_per_step: Optional[float],
        step_seconds: float) -> Optional[float]:
    """Model-FLOPs utilization: FLOPs / seconds / peak; None whenever an
    input is unknown."""
    peak = peak_flops()
    if not flops_per_step or not step_seconds or not peak:
        return None
    return flops_per_step / step_seconds / peak


# ---------------------------------------------------------------------------
# Device-memory watermark
# ---------------------------------------------------------------------------

def sample_device_memory(registry: Optional[MetricsRegistry],
                         device) -> Optional[int]:
    """Sample the allocator of ``device`` into the
    ``bigdl_device_memory_bytes`` / ``_peak_bytes`` gauges of ``registry``
    (default the global one) and return the peak; ``None`` for a CPU
    device, which has no allocator statistics. The serving engine calls it
    at each admission and each decode round with its own device, the
    training loop at each window's end. On a CUDA device a failure raises:
    it is never taken for "no statistics"."""
    import torch
    device = torch.device(device)
    if device.type != "cuda":
        return None
    in_use = torch.cuda.memory_allocated(device)
    peak = torch.cuda.max_memory_allocated(device)
    from bigdl_tpu_torch.telemetry.catalogue import instruments
    tm = instruments(registry if registry is not None else get_registry())
    tm.device_memory_bytes.set(in_use)
    tm.device_memory_peak_bytes.set(peak)
    return peak
