"""HBM streaming roof of one CUDA card, measured with hand-written kernels
(counterpart of ``scripts/roofline_pallas.py``).

A roofline argument needs the rate at which a kernel can actually stream
device memory, not only the data sheet's. This probe measures it with the
K7 kernels of ``ops/hbm_roof.py``:

1. ``auto``: the grid-stride copy / read / triad kernels (K7a), swept over
   threads per block, 16-byte vectors in flight per thread
   (``"block": "<threads>x<vecs>"``) and the grid (``persistent``: the
   blocks the SMs hold at once; ``full``: one tile a block);
2. ``manual``: the copy staged through ``nbuf`` shared-memory slots of
   ``chunk`` bytes with bulk asynchronous copies (K7b);
3. ``hbm_dma``: the register copy over ``nstreams`` disjoint row ranges,
   one launch per range, each on its own stream (K7c);
4. ``eager``: the same three chains in eager PyTorch, the yardstick a
   hand-written probe has to beat (the reference's ``bench_xla``);
5. ``library``: one PyTorch call per pass: ``Tensor.copy_``,
   ``torch.sum(x, dtype=float32)`` (the seed's add left out) and
   ``torch.add(a, b, alpha=2)``.

Byte counts are the reference's: copy 2 x n x 2, read n x 2, triad
3 x n x 2, for n bf16 values streamed. A pass's time is the slope between a
``k_small``-pass and a ``k_large``-pass chain timed with CUDA events on one
stream, which cancels the launch and event overhead. ``roof_gbps`` is the
highest copy or read rate of a hand-written probe.

Usage: python -m bigdl_tpu_torch.scripts.roofline_hbm [--gib 1]
           [--skip auto,manual,hbm_dma,eager,library] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from bigdl_tpu_torch.ops import hbm_roof
from bigdl_tpu_torch.utils.device import resolve_device

BF16_OPS_PER_S = 989e12   # H100 SXM data sheet, bf16 dense
CAL_N = 8192
CPU_CAL_N = 64            # the CPU runs the probe only for the tests
# The reference waits for a window in which its calibration matmul takes
# under 12 ms, about twice a clean TPU v5e's time. On the card: an
# 8192^3 bf16 product is 1.1 TFLOP, 1.11 ms at the data sheet's rate, and a
# card that nobody else uses runs cuBLAS above half that rate, so a product
# slower than twice 1.11 ms (2.22 ms) means a shared or throttled card.
CLEAN_FACTOR = 2
CLEAN_WAIT_S = 20
FAMILIES = ("auto", "manual", "hbm_dma", "eager", "library")
AUTO_SWEEP = tuple((t, v, g) for g in hbm_roof.GRIDS for t in hbm_roof.THREADS
                   for v in hbm_roof.VECS)
MANUAL_SWEEP = tuple((kib * 1024, nbuf) for kib in (16, 32, 48)
                     for nbuf in (2, 4))
DMA_STREAMS = (1, 2, 4, 8)
K_SMALL, K_LARGE, ITERS, WARMUP = 4, 24, 2, 2
# Each chain is timed REPEATS times, in turns, and its least time kept: a
# host stall inside the timed window only adds time, and one that lands in
# the short chain makes the slope too small (an H100 read 4966 GB/s, above
# the 3352 GB/s its memory clock allows, from one such chain).
REPEATS = 3
#: kernel passes that one ``_slope_timed`` reading runs
PASSES_PER_READING = (K_SMALL + K_LARGE) * (ITERS + WARMUP) * REPEATS
L2_FACTOR = 8
BF16 = torch.bfloat16


def clean_matmul_ms(n: int = CAL_N) -> float:
    return CLEAN_FACTOR * 2 * n ** 3 / BF16_OPS_PER_S * 1e3


def _timed_chain(fn, feed, *args, iters=5, warmup=WARMUP):
    """Seconds per call of ``fn`` over ``iters`` chained calls, after
    ``warmup``; CUDA events on the caller's stream on the card, the host
    clock on the CPU."""
    out = fn(args[0], *args[1:])
    for _ in range(warmup - 1):
        out = fn(feed(out), *args[1:])
    if args[0].device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(feed(out), *args[1:])
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        out = fn(feed(out), *args[1:])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def _slope_timed(make_fn, feed, *args, k_small=K_SMALL, k_large=K_LARGE,
                 iters=ITERS):
    """Seconds per pass with the fixed cost of a chain (launches, events)
    cancelled: the slope between a ``k_small``-pass and a ``k_large``-pass
    chain, each the least of REPEATS timings. ``make_fn(k)`` returns a
    function running k dependent passes."""
    fns = {k: make_fn(k) for k in (k_small, k_large)}
    ts = {k: float("inf") for k in fns}
    for _ in range(REPEATS):
        for k, fn in fns.items():
            ts[k] = min(ts[k], _timed_chain(fn, feed, *args, iters=iters,
                                            warmup=WARMUP))
    return (ts[k_large] - ts[k_small]) / (k_large - k_small)


def _other(t, bufs):
    """The buffer of the pair ``bufs`` that ``t`` is not."""
    return bufs[1] if t is bufs[0] else bufs[0]


def _chain(step, bufs):
    """``make_fn`` for a chain whose pass is ``step(t, *rest, out=...)``,
    alternating between the two buffers ``bufs``."""
    def make(k):
        def run(t, *rest):
            for _ in range(k):
                t = step(t, *rest, out=_other(t, bufs))
            return t
        return run
    return make


def _gbps(nbytes: int, seconds: float):
    return round(nbytes / seconds / 1e9, 1) if seconds > 0 else None


def _reading(out: dict, name: str, nbytes: int, seconds: float) -> None:
    out[f"{name}_gbps"] = _gbps(nbytes, seconds)
    out[f"{name}_ms"] = seconds * 1e3


def _calibrate(device: torch.device, n: int = CAL_N):
    """Per-matmul ms of an n x n bf16 ``torch.matmul`` chain (slope of 2
    and 10 products) and the chain's fixed overhead in ms."""
    a = torch.full((n, n), 1.0 / n, dtype=BF16, device=device)
    make = _chain(lambda t, out: torch.matmul(t, a, out=out),
                  (torch.empty_like(a), torch.empty_like(a)))
    t2 = _timed_chain(make(2), lambda o: o, a, iters=2)
    t10 = _timed_chain(make(10), lambda o: o, a, iters=2)
    per = (t10 - t2) / 8
    return per * 1e3, (t2 - 2 * per) * 1e3


def _streams(total_bytes: int, device: torch.device):
    n = total_bytes // 2
    x = torch.ones(n, dtype=BF16, device=device)
    y = torch.full((n,), 0.5, dtype=BF16, device=device)
    return n, x, y, (torch.empty_like(x), torch.empty_like(x))


def bench_auto(total_bytes: int, threads: int, vecs: int, grid: str,
               device: torch.device) -> dict:
    """K7a copy / read / triad at ``threads`` threads a block, ``vecs``
    16-byte vectors in flight per thread, on the ``grid`` grid."""
    n, x, y, bufs = _streams(total_bytes, device)
    seeds = tuple(torch.zeros((1, 1), dtype=torch.float32, device=device)
                  for _ in range(2))
    knobs = dict(threads=threads, vecs=vecs, grid=grid)
    out = {"block": f"{threads}x{vecs}", "grid": grid, "device": device.type}
    for name, make, args, nbytes in (
            ("copy", _chain(lambda t, out: hbm_roof.copy(t, out, **knobs),
                            bufs), (x,), 2 * n * 2),
            ("read", _chain(lambda s, a, out: hbm_roof.read_sum(
                s, a, out, **knobs), seeds),
             (torch.zeros((1, 1), dtype=torch.float32, device=device), x),
             n * 2),
            ("triad", _chain(lambda t, b, out: hbm_roof.triad(
                t, b, out, **knobs), bufs), (x, y), 3 * n * 2)):
        _reading(out, name, nbytes, _slope_timed(make, lambda o: o, *args))
    return out


def bench_manual(total_bytes: int, chunk_bytes: int, nbuf: int,
                 device: torch.device) -> dict:
    """K7b: the copy staged through ``nbuf`` slots of ``chunk_bytes``."""
    n, x, _, bufs = _streams(total_bytes, device)
    make = _chain(lambda t, out: hbm_roof.staged_copy(t, chunk_bytes, nbuf,
                                                      out), bufs)
    out = {"block": f"{chunk_bytes // 1024}KiB", "nbuf": nbuf,
           "device": device.type}
    _reading(out, "copy", 2 * n * 2, _slope_timed(make, lambda o: o, x))
    return out


def hbm_dma_shape(total_bytes: int, nstreams: int):
    """The reference's shape: 1024 lanes, rows trimmed to a multiple of
    8 * nstreams."""
    lanes = 1024
    rows = total_bytes // (2 * lanes)
    rows -= rows % (8 * nstreams)
    return rows, lanes


def bench_hbm_dma(total_bytes: int, nstreams: int,
                  device: torch.device) -> dict:
    """K7c: the register copy over ``nstreams`` row ranges at once."""
    x = torch.ones(hbm_dma_shape(total_bytes, nstreams), dtype=BF16,
                   device=device)
    bufs = (torch.empty_like(x), torch.empty_like(x))
    make = _chain(lambda t, out: hbm_roof.direct_copy(t, nstreams, out), bufs)
    out = {"nstreams": nstreams, "device": device.type}
    _reading(out, "copy", 2 * x.numel() * 2, _slope_timed(make, lambda o: o, x))
    return out


def bench_eager(total_bytes: int, device: torch.device) -> dict:
    """The three chains in eager PyTorch, with the same byte counts."""
    n, x, y, _ = _streams(total_bytes, device)

    def make_copy(k):
        def run(t):
            for _ in range(k):
                t = t + 1
            return t
        return run

    def make_triad(k):
        def run(t, b):
            for _ in range(k):
                t = t + b * 2
            return t
        return run

    def make_read(k):
        # the carried scalar seeds the sum, as in the reference
        def run(s, a):
            for _ in range(k):
                s = s + (a + s.to(BF16) * 0).float().sum()
            return s
        return run

    out = {"device": device.type}
    _reading(out, "copy", 2 * n * 2, _slope_timed(make_copy, lambda o: o, x))
    _reading(out, "triad", 3 * n * 2,
             _slope_timed(make_triad, lambda o: o, x, y))
    _reading(out, "read", n * 2, _slope_timed(
        make_read, lambda o: o, torch.zeros((), device=device), x))
    return out


def bench_library(total_bytes: int, device: torch.device) -> dict:
    """One PyTorch call per pass: ``copy_``, ``torch.sum(dtype=float32)``
    and ``torch.add(alpha=2)``."""
    n, x, y, bufs = _streams(total_bytes, device)

    def make_read(k):
        def run(s, a):
            for _ in range(k):
                s = torch.sum(a, dtype=torch.float32)
            return s
        return run

    out = {"device": device.type}
    _reading(out, "copy", 2 * n * 2, _slope_timed(
        _chain(lambda t, out: out.copy_(t), bufs), lambda o: o, x))
    _reading(out, "read", n * 2, _slope_timed(
        make_read, lambda o: o, torch.zeros((), device=device), x))
    _reading(out, "triad", 3 * n * 2, _slope_timed(
        _chain(lambda t, b, out: torch.add(t, b, alpha=2, out=out), bufs),
        lambda o: o, x, y))
    return out


def card_state() -> dict:
    """The card's name and power limit, and its memory clock now and at
    most, from ``nvidia-smi``."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.mem,clocks.max.mem",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    name, power, mem, max_mem = (
        f.strip() for f in smi.stdout.strip().splitlines()[0].split(","))
    return {"card": f"{name}, {power}", "clocks_mem": mem,
            "clocks_max_mem": max_mem}


def roof(res: dict):
    """(the highest copy or read rate of a hand-written probe, which probe
    and configuration reached it), or (None, None)."""
    cands = []
    for r in res.get("auto", []):
        cands += [(r[f"{k}_gbps"], f"auto {k}, block {r['block']} {r['grid']} "
                   "grid") for k in ("copy", "read")]
    cands += [(r["copy_gbps"], f"manual copy, block {r['block']} nbuf "
               f"{r['nbuf']}") for r in res.get("manual", [])]
    cands += [(r["copy_gbps"], f"hbm_dma copy, nstreams {r['nstreams']}")
              for r in res.get("hbm_dma", [])]
    cands = [c for c in cands if c[0] is not None]
    return max(cands) if cands else (None, None)


def _log(obj) -> None:
    print(json.dumps(obj), flush=True)


def main(argv=None) -> dict:
    """Run the probe, print one JSON line per reading and the
    ``{"roofline_hbm": ...}`` line, and return that line's dict. Any
    failing reading raises."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--gib", type=float, default=1.0,
                    help="GiB per streamed array (at least 8 x the L2 cache)")
    ap.add_argument("--skip", default="",
                    help="comma list of " + ",".join(FAMILIES))
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    ap.add_argument("--calibration-tries", type=int, default=5,
                    help=f"calibrations to wait for a clean card, "
                         f"{CLEAN_WAIT_S} s apart")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    skip = set(filter(None, args.skip.split(",")))
    if skip - set(FAMILIES):
        ap.error(f"unknown --skip {sorted(skip - set(FAMILIES))}")
    total = int(args.gib * (1 << 30))
    res = {"device": device.type, "total_bytes": total}
    if device.type == "cuda":
        l2 = torch.cuda.get_device_properties(device).L2_cache_size
        if total < L2_FACTOR * l2:
            ap.error(f"--gib {args.gib} is under {L2_FACTOR} x the "
                     f"{l2} B L2 cache: the probe would read the cache")
        res["before"] = card_state()
        _log({"card_before": res["before"]})

    cal_n = CAL_N if device.type == "cuda" else CPU_CAL_N
    clean = clean_matmul_ms(cal_n)
    for attempt in range(max(1, args.calibration_tries)):
        cal, fixed = _calibrate(device, cal_n)
        res["calibration"] = {
            "calibration_matmul_ms": cal, "fixed_overhead_ms": fixed,
            "calibration_tflops": 2 * cal_n ** 3 / cal / 1e9 if cal > 0
            else None,
            "clean_below_ms": clean, "attempt": attempt,
            "device": device.type}
        _log(res["calibration"])
        if device.type != "cuda" or cal < clean:
            break
        if attempt + 1 < args.calibration_tries:
            time.sleep(CLEAN_WAIT_S)

    if "eager" not in skip:
        res["eager"] = bench_eager(total, device)
        _log({"eager": res["eager"]})
    if "library" not in skip:
        res["library"] = bench_library(total, device)
        _log({"library": res["library"]})
    if "hbm_dma" not in skip:
        res["hbm_dma"] = []
        for ns in DMA_STREAMS:
            res["hbm_dma"].append(bench_hbm_dma(total, ns, device))
            _log(res["hbm_dma"][-1])
    if "auto" not in skip:
        res["auto"] = []
        for threads, vecs, grid in AUTO_SWEEP:
            res["auto"].append(bench_auto(total, threads, vecs, grid, device))
            _log(res["auto"][-1])
    if "manual" not in skip:
        res["manual"] = []
        for chunk, nbuf in MANUAL_SWEEP:
            res["manual"].append(bench_manual(total, chunk, nbuf, device))
            _log(res["manual"][-1])
    res["roof_gbps"], res["roof_from"] = roof(res)
    res["library_copy_gbps"] = res.get("library", {}).get("copy_gbps")
    if device.type == "cuda":
        res["after"] = card_state()
    _log({"roofline_hbm": res})
    return res


if __name__ == "__main__":
    main()
