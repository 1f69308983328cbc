"""HBM streaming probes (counterpart of the Pallas kernels of
``scripts/roofline_pallas.py``).

Five bf16 streaming functions, each a kernel K7 of ``csrc/hbm_roof.cu`` on a
CUDA tensor and its plain version on a CPU tensor:

- ``copy(x)``, ``read_sum(seed, x)`` and ``triad(a, b)`` (K7a, the
  reference's ``bench_auto`` kernels): ``out = x``; ``seed + sum(f32(x))``;
  ``a + b * 2`` in f32, rounded once to bf16;
- ``staged_copy(x, chunk_bytes, nbuf)`` (K7b, ``bench_manual``): a copy
  staged through ``nbuf`` shared-memory slots of ``chunk_bytes`` per block,
  each slot refilled ``lag`` stores after its own, each block taking its
  next chunk from a shared counter (or a static deal, for comparison);
- ``direct_copy(x, nstreams)`` (K7c, ``bench_hbm_dma``): a register copy
  over ``nstreams`` disjoint row ranges side by side, each range on a full
  grid, in one launch whose blocks alternate between the ranges.

Every function takes its output buffer (``out``), so that a timed chain can
alternate between two buffers allocated ahead of it; without one it
allocates. Each checks dtype, contiguity, 16-byte alignment and device and
raises on what its kernel does not take, on every device.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from bigdl_tpu_torch.ops import _build

#: the K7a sweep's knobs: threads per block, 16-byte vectors per thread, and
#: the grid: ``persistent`` (the blocks the SMs hold at once, each looping
#: over the data) or ``full`` (one tile of threads x vecs vectors a block)
THREADS = (128, 256, 512, 1024)
VECS = (1, 2, 4)
GRIDS = ("persistent", "full")
DEFAULT_THREADS, DEFAULT_VECS, DEFAULT_GRID = 256, 4, "persistent"
MAX_NBUF = 8
#: K7b's chunk dealing (csrc's ``Deal`` codes, in order): a contiguous run
#: of chunks a block, chunk c to block c mod G, or each block the next
#: chunk of a shared counter
DEALS = ("contiguous", "round_robin", "dynamic")
_KINDS = {"copy": 0, "read": 1, "triad": 2}

#: launches of each K7 kernel (counted where the kernel is launched)
LAUNCHES_COPY = _build.LaunchCounter()
LAUNCHES_READ = _build.LaunchCounter()
LAUNCHES_TRIAD = _build.LaunchCounter()
LAUNCHES_STAGED = _build.LaunchCounter()
LAUNCHES_DIRECT = _build.LaunchCounter()
COUNTERS = {"hbm_copy": LAUNCHES_COPY, "hbm_read": LAUNCHES_READ,
            "hbm_triad": LAUNCHES_TRIAD, "hbm_staged_copy": LAUNCHES_STAGED,
            "hbm_direct_copy": LAUNCHES_DIRECT}

_BLOCKS: Dict[Tuple, int] = {}


def copy_plain(x: torch.Tensor) -> torch.Tensor:
    return x.clone()


def read_sum_plain(seed: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return seed + x.float().sum()


def triad_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.float() + b.float() * 2).to(torch.bfloat16)


def _check(name: str, *tensors: torch.Tensor, dtype=torch.bfloat16) -> None:
    """Raise ``ValueError`` for what the K7 kernel ``name`` does not take."""
    for t in tensors:
        if t.dtype != dtype:
            raise ValueError(f"{name} takes {dtype} tensors, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} takes 16-byte aligned tensors")
        if t.numel() == 0:
            raise ValueError(f"{name} takes non-empty tensors")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: tensors on more than one device")


def _check_out(name: str, out: Optional[torch.Tensor], like: torch.Tensor,
               *inputs: torch.Tensor) -> torch.Tensor:
    if out is None:
        return torch.empty_like(like)
    if out.shape != like.shape:
        raise ValueError(f"{name}: out has shape {tuple(out.shape)}, "
                         f"want {tuple(like.shape)}")
    _check(name, out, like, dtype=like.dtype)
    if any(out.data_ptr() == t.data_ptr() for t in inputs):
        raise ValueError(f"{name}: out must not be an input")
    return out


def _check_knobs(threads: int, vecs: int, grid: str = DEFAULT_GRID) -> None:
    if (threads % 32 or not 32 <= threads <= 1024 or vecs not in VECS
            or grid not in GRIDS):
        raise ValueError(f"threads {threads} (a multiple of 32 up to 1024), "
                         f"vecs {vecs} (one of {VECS}) or grid {grid!r} (one "
                         f"of {GRIDS}) out of range")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def persistent_blocks(kind: str, threads: int = DEFAULT_THREADS,
                      vecs: int = DEFAULT_VECS) -> int:
    """The persistent grid of a K7a kernel (``copy``, ``read``, ``triad``)
    on the current card: SMs times the blocks an SM holds at once."""
    key = (torch.cuda.current_device(), kind, threads, vecs)
    if key not in _BLOCKS:
        lib = _build.load("hbm_roof")
        blocks = lib.bt_hbm_blocks(_KINDS[kind], threads, vecs)
        if blocks <= 0:
            _build.check_status(lib, f"hbm {kind} grid", -blocks)
        _BLOCKS[key] = blocks
    return _BLOCKS[key]


def _grid_blocks(kind: str, n: int, threads: int, vecs: int,
                 grid: str) -> int:
    """The blocks of a K7a launch over n bf16 values."""
    if grid == "full":
        return max(1, -(-(n // 8) // (threads * vecs)))
    return persistent_blocks(kind, threads, vecs)


def staged_blocks(chunk_bytes: int, nbuf: int) -> int:
    """K7b's persistent grid at ``nbuf`` slots of ``chunk_bytes``."""
    key = (torch.cuda.current_device(), "staged", chunk_bytes, nbuf)
    if key not in _BLOCKS:
        lib = _build.load("hbm_roof")
        blocks = lib.bt_hbm_staged_blocks(chunk_bytes, nbuf)
        if blocks <= 0:
            _build.check_status(lib, "hbm staged grid", -blocks)
        _BLOCKS[key] = blocks
    return _BLOCKS[key]


def copy(x: torch.Tensor, out: Optional[torch.Tensor] = None,
         threads: int = DEFAULT_THREADS, vecs: int = DEFAULT_VECS,
         grid: str = DEFAULT_GRID) -> torch.Tensor:
    """``out = x`` (K7a copy)."""
    _check("hbm copy", x)
    _check_knobs(threads, vecs, grid)
    out = _check_out("hbm copy", out, x, x)
    if x.device.type == "cpu":
        return out.copy_(copy_plain(x))
    lib = _build.load("hbm_roof")
    status = lib.bt_hbm_copy(
        x.data_ptr(), out.data_ptr(), x.numel(), threads, vecs,
        _grid_blocks("copy", x.numel(), threads, vecs, grid), _stream(x))
    _build.check_status(lib, "hbm copy", status)
    LAUNCHES_COPY.add()
    return out


def read_sum(seed: torch.Tensor, x: torch.Tensor,
             out: Optional[torch.Tensor] = None, threads: int = DEFAULT_THREADS,
             vecs: int = DEFAULT_VECS, grid: str = DEFAULT_GRID) -> torch.Tensor:
    """``seed + sum(f32(x))`` (K7a read), shaped like the one-element f32
    ``seed``; the sum's order is fixed, so two runs give the same bits."""
    _check("hbm read", x)
    _check("hbm read", seed, dtype=torch.float32)
    if seed.numel() != 1 or seed.device != x.device:
        raise ValueError("hbm read: seed is one f32 value on x's device")
    _check_knobs(threads, vecs, grid)
    out = _check_out("hbm read", out, seed, seed)
    if x.device.type == "cpu":
        return out.copy_(read_sum_plain(seed, x))
    lib = _build.load("hbm_roof")
    blocks = _grid_blocks("read", x.numel(), threads, vecs, grid)
    partials = torch.empty(blocks, dtype=torch.float32, device=x.device)
    status = lib.bt_hbm_read(seed.data_ptr(), x.data_ptr(), partials.data_ptr(),
                             out.data_ptr(), x.numel(), threads, vecs, blocks,
                             _stream(x))
    _build.check_status(lib, "hbm read", status)
    LAUNCHES_READ.add()
    return out


def triad(a: torch.Tensor, b: torch.Tensor, out: Optional[torch.Tensor] = None,
          threads: int = DEFAULT_THREADS, vecs: int = DEFAULT_VECS,
          grid: str = DEFAULT_GRID) -> torch.Tensor:
    """``a + b * 2`` (K7a triad): f32 arithmetic, rounded once to bf16."""
    _check("hbm triad", a, b)
    if a.shape != b.shape:
        raise ValueError(f"hbm triad: shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)} differ")
    _check_knobs(threads, vecs, grid)
    out = _check_out("hbm triad", out, a, a, b)
    if a.device.type == "cpu":
        return out.copy_(triad_plain(a, b))
    lib = _build.load("hbm_roof")
    status = lib.bt_hbm_triad(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(), threads, vecs,
        _grid_blocks("triad", a.numel(), threads, vecs, grid), _stream(a))
    _build.check_status(lib, "hbm triad", status)
    LAUNCHES_TRIAD.add()
    return out


def _check_stamps(name: str, stamps: Optional[torch.Tensor], n: int,
                  like: torch.Tensor) -> None:
    if stamps is not None and (stamps.dtype != torch.int64
                               or stamps.numel() != n
                               or not stamps.is_contiguous()
                               or stamps.device != like.device):
        raise ValueError(f"{name}: stamps must be {n} contiguous int64 "
                         f"values on {like.device}")


def staged_copy(x: torch.Tensor, chunk_bytes: int, nbuf: int,
                out: Optional[torch.Tensor] = None, blocks: int = 0,
                lag: int = 0, deal: str = "dynamic",
                stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = x`` through ``nbuf`` shared-memory slots of ``chunk_bytes``
    (a multiple of 16) per block (K7b), each slot refilled ``lag`` stores
    after the store that drains it (0 <= lag < nbuf; 0 is the reference's
    order), the chunks dealt to the blocks by ``deal`` (one of DEALS);
    ``blocks`` 0 takes the persistent grid. ``stamps`` (2 x blocks
    int64, for a check) takes each block's start and end in ns of
    %globaltimer."""
    _check("hbm staged copy", x)
    if (chunk_bytes < 16 or chunk_bytes % 16 or not 1 <= nbuf <= MAX_NBUF
            or not 0 <= lag < nbuf or deal not in DEALS):
        raise ValueError(f"hbm staged copy: chunk_bytes {chunk_bytes} (a "
                         f"multiple of 16), nbuf {nbuf} (1..{MAX_NBUF}), "
                         f"lag {lag} (0..nbuf-1) or deal {deal!r} (one of "
                         f"{DEALS}) out of range")
    out = _check_out("hbm staged copy", out, x, x)
    if x.device.type == "cpu":
        return out.copy_(copy_plain(x))
    lib = _build.load("hbm_roof")
    blocks = blocks or staged_blocks(chunk_bytes, nbuf)
    _check_stamps("hbm staged copy", stamps, 2 * blocks, x)
    # the dynamic deal's counter, zeroed by the C entry on x's stream
    counter = (torch.empty(1, dtype=torch.int64, device=x.device)
               if deal == "dynamic" else None)
    status = lib.bt_hbm_staged_copy(
        x.data_ptr(), out.data_ptr(), x.numel() * 2, chunk_bytes, nbuf, lag,
        DEALS.index(deal), blocks,
        None if counter is None else counter.data_ptr(),
        None if stamps is None else stamps.data_ptr(), _stream(x))
    _build.check_status(lib, "hbm staged copy", status)
    LAUNCHES_STAGED.add()
    return out


def direct_blocks_per_range(span: int, threads: int = DEFAULT_THREADS,
                            vecs: int = DEFAULT_VECS) -> int:
    """K7c's full grid over one range of ``span`` bf16 values: one tile of
    ``threads`` x ``vecs`` 16-byte vectors a block."""
    return max(1, -(-(span // 8) // (threads * vecs)))


def direct_copy(x: torch.Tensor, nstreams: int,
                out: Optional[torch.Tensor] = None,
                threads: int = DEFAULT_THREADS, vecs: int = DEFAULT_VECS,
                stamps: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``out = x`` for a 2-D ``x`` whose rows split into ``nstreams``
    ranges (K7c): one launch, each range on a full grid, block b on range
    b mod nstreams, so the ranges run side by side. ``stamps`` (2 x nstreams
    int64, for a check) takes each range's first block's start and last
    block's end in ns of %globaltimer."""
    _check("hbm direct copy", x)
    _check_knobs(threads, vecs)
    if x.dim() != 2 or nstreams < 1 or x.shape[0] % nstreams:
        raise ValueError(f"hbm direct copy: {nstreams} streams do not split "
                         f"the rows of shape {tuple(x.shape)}")
    span = x.numel() // nstreams
    if span % 8:
        raise ValueError("hbm direct copy: each range must be a whole number "
                         "of 16-byte vectors")
    _check_stamps("hbm direct copy", stamps, 2 * nstreams, x)
    out = _check_out("hbm direct copy", out, x, x)
    if x.device.type == "cpu":
        return out.copy_(copy_plain(x))
    lib = _build.load("hbm_roof")
    status = lib.bt_hbm_ranged_copy(
        x.data_ptr(), out.data_ptr(), span // 8, nstreams, threads, vecs,
        direct_blocks_per_range(span, threads, vecs),
        None if stamps is None else stamps.data_ptr(), _stream(x))
    _build.check_status(lib, "hbm direct copy", status)
    LAUNCHES_DIRECT.add()
    return out
