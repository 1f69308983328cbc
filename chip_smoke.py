#!/usr/bin/env python3
"""Drive bigdl_tpu_torch's serving and training paths on one CUDA card and
check them.

Run from the repository root, with one CUDA card visible:

    python3 chip_smoke.py

Phases, each of which raises on failure (the exit code is then non-zero):

1. environment: the card's name and power limit, the torch and CUDA
   versions, and the build of every CUDA kernel from ``bigdl_tpu_torch/csrc``
   (all ``nvcc`` processes at once);
2. kernels: each kernel against its plain PyTorch version on the card, at
   the serving and training paths' shapes, with the tolerances stated
   below; K1's, K2's, K3's and K6's cases each log the variant they took
   (``mma`` on the tensor cores for bf16, ``fma`` for the rest), checked by
   the ``LAUNCHES*_MMA`` counters; the flash backward (K2, K3) through the
   autograd ``Function`` against ``flash_attention_bwd_plain`` fed the same o, lse and
   cotangents, and against autograd through the plain attention core; the
   fused conv+BN-statistics kernels K5 (1x1 matmul) and K6 (3x3 conv) at
   every distinct fused shape of ResNet-50 at B=32 and the reference
   tests' ragged shapes, f32 and bf16, and at every fused shape of the
   training run (B=256) in bf16, with bit-identical statistics on a second
   run, and their training ``Function``s against autograd through the
   plain composition; the HBM streaming kernels K7 (copy, read and triad,
   the staged copy, the direct copy over several streams) at the probe's
   1 GiB shape and at ragged sizes (``check_hbm_roof``), K7c's launches
   side by side in a profiler trace, and the operation that
   ``Tensor.copy_`` (the probe's library copy) runs;
3. slice: the 134M Llama-recipe LM (``scripts/int8_decode_bench.py``'s
   ``134m`` config: V=32000, E=768, 12 heads, 4 kv heads, FFN 3072, 12
   layers, RoPE, SwiGLU, RMSNorm, tied embeddings) built from a seed at full
   width; its bf16 (``cast_model``) and int8 (``quantize_model``) twins each
   serve 8 requests from threads through ``LMServer`` (prompts of 384 and
   128 tokens, 32 new tokens, greedy). Every answer must equal a direct
   ``generate`` on the same prompts, and the launch counters, zeroed just
   before serving, must show that the prefill ran kernel K1 (its ``mma``
   variant only) and the int8 decode kernel K4;
3b. training: the same config built on the card from seed 7. Every
   parameter's gradient on one f32 batch (B=1, S=128) of the synthetic
   grammar, through K1/K2/K3 (their ``fma`` variants, no ``mma`` launch),
   must be finite and within GRAD_RTOL (relative L2, per tensor) of a CPU
   copy carrying the same weights, which takes the plain path. Then
   ``Optimizer`` trains 20 iterations at B=8, S=512 with
   ``set_precision("bf16")``, ``AdamW`` and global-L2 clipping at 1.0: the
   losses must be finite, the mean of the last five below the first, and
   K1, K2 and K3 each launched exactly 12 x 20 times, every launch ``mma``
   (counters zeroed just before the run);
3c. ResNet-50 (bench.py's resnet50 workload, ``resnet.build(1000, 50)``,
   full width and depth) with both fusion gates set: every gradient and
   updated running statistic of one f32 batch (B=8, 224x224) on the card,
   measured against an f64 CPU copy and held to twice the unfused card
   model's distance from it, with the losses of a CPU f32 copy and of the
   unfused card model on the same weights; then ``Optimizer`` trains 20 iterations at B=256 of bench.py's recipe
   (constant N(0, 1) images, ``ClassNLLCriterion``, SGD 0.1 with momentum
   0.9, bf16 compute over f32 masters): finite, falling losses, K5 and K6
   launched exactly 36 x 20 and 13 x 20 times (every K6 launch ``mma``),
   every running statistic finite and moved, and the trained model's eval forward (BN folded)
   equal to the unfused model's; then the A/B with the gates unset
   (cuDNN convs and ``batch_norm_train``): step time, images/s, device
   busy share, peak memory and the top kernels of both paths;
4a. HBM roof: the probe ``python -m bigdl_tpu_torch.scripts.roofline_hbm
   --gib 1`` (``main``, every family, one calibration, no waiting), its
   K7 launch counts against the counts its chains predict, and no reading
   above the data sheet's rate; its ``roofline_hbm`` line holds
   ``roof_gbps``, the highest copy or read rate of a hand-written probe;
4. timing: each kernel is checked once more against its plain version at
   the served shape, then it (``ms``), its plain version (``plain_ms``) and
   one PyTorch library call for the same function (``library_ms``) are
   timed, each by CUDA events around CUDA-graph replays (``graph_ms``): K1
   (at the served shape and, as ``train``, at the training shape), K2 and
   K3 (their ``mma`` variants at the training shape, B=8 S=512 N=12 D=64
   bf16 causal; the library time is the forward and backward of
   ``scaled_dot_product_attention`` less its forward), K4 (one int8 decode token) and K5 and K6 (at
   ResNet-50's stage-1 and stage-4 shapes at B=256, bf16, where the
   library time is the cuBLAS product or the cuDNN conv plus one
   ``torch.var_mean`` of its output); the bound
   (``bound_ms``) is the larger of the bytes the function must move over
   3.35 TB/s and its operations over 989 TFLOP/s (H100 SXM data sheet,
   bf16 dense), and ``bound_measured_ms`` prices the same bytes at the
   roof measured in phase 4a. Phase 1 logs each kernel's ``-Xptxas -v``
   report (registers, shared memory, spills) and whether this run built it.
   K7's rows come from phase 4a's run: the best
   reading of each sweep per pass over 1 GiB, the eager chain as
   ``plain_ms`` and one PyTorch call as ``library_ms``.

The last three lines of standard output are the card's name and power
limit, the ``{"kernels": [...]}`` line, and ``{"ok": true, "device": ...}``.

``python3 chip_smoke.py --resnet-grad-seeds 11 21 31`` builds the kernels
and runs only phase 3c's gradient check, once per seed, printing each
seed's readings and no result line.

``python3 chip_smoke.py --time-kernels-of DIR`` imports ``bigdl_tpu_torch``
from DIR (for example an earlier commit unpacked by ``git archive``),
builds its kernels and times K1, K2, K3, K5 and K6 as phase 4 does,
printing the rows and no result line: an earlier version's kernels and
this one's on one timer, within one machine.
"""

import argparse
import collections
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
BF16_OPS_PER_S = 989e12     # H100 SXM tensor cores, bf16 dense
CONFIG = dict(embed_dim=768, num_heads=12, num_kv_heads=4, ffn_dim=3072,
              num_layers=12, max_len=512, rope=True, activation="swiglu",
              norm="rms", bias=False, tie_embeddings=True)
VOCAB = 32000
NEW_TOKENS = 32
PROMPT_LENS = (384, 128)
REQUESTS_PER_LEN = 4
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 20
TRAIN_LR, TRAIN_DECAY, TRAIN_CLIP = 3e-3, 0.01, 1.0


def log(obj) -> None:
    print(json.dumps(obj) if isinstance(obj, dict) else obj, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


PROFILER_TRIES = 3


def profiled(fn, what: str):
    """Runs ``fn`` once under ``torch.profiler`` (CUDA activity) and returns
    ([(kernel name, device us)], wall seconds of the run). An H100 run has
    seen the profiler, after many sessions in one process, come back with
    no device time for work that launched kernels; such a run is logged and
    repeated, at most PROFILER_TRIES times. Returns (None, None) when no
    run recorded device time."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(1, PROFILER_TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows = [(e.key, e.self_device_time_total)
                for e in prof.key_averages() if e.self_device_time_total > 0]
        if rows:
            return rows, wall
        log({"profiler_recorded_nothing": what, "attempt": attempt})
    return None, None


def graph_ms(fn, what: str, per_graph: int = 20, replays: int = 5) -> float:
    """Device milliseconds per call of ``fn``: CUDA events around
    ``replays`` replays of one CUDA graph that holds ``per_graph`` calls,
    so neither host gaps nor the profiler enter (the profiler's reading of
    one sub-millisecond launch has moved by up to 2x between runs of this
    script, and in one run fell to 0.6x of this timing)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up, as capture wants, on a side stream
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * per_graph)
    check(ms > 0, f"{what}: the graph's replays measured no time")
    del graph
    torch.cuda.empty_cache()
    return ms


def bound(nbytes: float, ops: float) -> dict:
    """The least time of a unit of work on the card by the data sheet
    (``bound_ms``, and which term sets it), with the bytes and operations
    it counts, so that ``add_measured_bound`` can price the bytes at the
    measured HBM roof."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / BF16_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


def add_measured_bound(entry: dict, hbm_bytes_per_s: float) -> dict:
    """``bound_measured_ms``: the bytes term over the HBM roof measured in
    phase 4a, the operations term unchanged (the second readings,
    ``stage4`` and ``train``, too)."""
    entry["bound_measured_ms"] = max(entry["bytes"] / hbm_bytes_per_s,
                                     entry["operations"] / BF16_OPS_PER_S) * 1e3
    for second in ("stage4", "train"):
        if second in entry:
            add_measured_bound(entry[second], hbm_bytes_per_s)
    return entry


def ptxas_report(text: str) -> dict:
    """``nvcc -Xptxas -v``'s lines (registers, shared memory, stack and
    spills) by entry function."""
    report, entry = {}, None
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif entry and ("registers" in line or "spill" in line):
            report.setdefault(entry, []).append(line.split(": ", 1)[-1].strip())
    return report


# ------------------------------------------------------------ 1. environment
def environment():
    from bigdl_tpu_torch.ops import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
         "device": torch.cuda.get_device_name(0),
         "capability": list(torch.cuda.get_device_capability(0))})
    cached = {name: _build._target(name).exists() for name in _build.KERNELS}
    build_s = _build.build()
    log({"kernel_build_s": build_s, "kernels": list(_build.KERNELS)})
    for name, text in _build.BUILD_LOGS.items():
        log({"ptxas": name, "built_in_this_run": not cached[name],
             "entries": ptxas_report(text)})
    return card


# ---------------------------------------------------------------- 2. kernels
def _qkv(gen, b, sq, sk, n, d, dtype):
    mk = lambda s: torch.randn((b, s, n, d), generator=gen, device="cuda")
    return mk(sq).to(dtype), mk(sk).to(dtype), mk(sk).to(dtype)


FLASH_ATOL = 5e-5
INT8_RTOL = 1e-4


def flash_o_close(o: torch.Tensor, po: torch.Tensor):
    """K1's O against the plain version's, element by element: within
    FLASH_ATOL in float32 (f32 sums in another order, values of order 1-10);
    in bfloat16 within one bf16 step of the element, 2^-7 * |po|, plus
    FLASH_ATOL (both round nearly the same f32 value, which may sit on a
    rounding boundary). Returns (max |o - po|, whether every element holds)."""
    diff = (o.float() - po.float()).abs()
    tol = (2 ** -7 * po.float().abs() if o.dtype == torch.bfloat16
           else torch.zeros_like(diff)) + FLASH_ATOL
    return diff.max().item(), bool((diff <= tol).all().item())


def launched_variant(counters, variant_of, fn):
    """Runs ``fn`` (one launch of each kernel that ``counters`` lists as
    (``LAUNCHES``, ``LAUNCHES_MMA``) pairs) and returns the variant that
    ``variant_of`` names, checked against every pair: one launch, and one
    "mma" launch exactly when the variant is "mma"."""
    before = [(total.value, mma.value) for total, mma in counters]
    out = fn()
    want = variant_of()
    for (total, mma), (t0, m0) in zip(counters, before):
        got = (total.value - t0, mma.value - m0)
        check(got == (1, int(want == "mma")),
              f"{want} call counted {got} (launches, mma launches)")
    return want, out


def check_flash():
    """K1 against ``flash_attention_plain`` (O as in ``flash_o_close``, LSE
    within FLASH_ATOL), at the served prefill shapes (B=4, S in {384, 128},
    causal), the training shape (B=8, S=512, causal, bf16) and at ragged,
    full, D=128, Sq != Sk and single-row cases; every bf16 case takes the
    "mma" variant and every f32 case the "fma" one."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    gen = torch.Generator(device="cuda").manual_seed(1)
    dtypes = (torch.float32, torch.bfloat16)
    cases = [(dt, causal, 2, s, s, 12, 64)
             for dt in dtypes for causal in (True, False) for s in (384, 333)]
    cases += [(dt, True, REQUESTS_PER_LEN, s, s, 12, 64)
              for dt in dtypes for s in PROMPT_LENS]
    cases += [(torch.bfloat16, True, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, 12, 64),
              (torch.bfloat16, True, 1, 200, 200, 4, 128),
              (torch.float32, False, 2, 100, 333, 3, 128),
              (torch.float32, True, 4, 1, 1, 12, 64)]
    counters = [(fa.LAUNCHES, fa.LAUNCHES_MMA)]
    worst, variants = 0.0, {}
    for dt, causal, b, sq, sk, n, d in cases:
        q, k, v = _qkv(gen, b, sq, sk, n, d, dt)
        variant, (o, lse) = launched_variant(
            counters, lambda: fa.kernel_variant(q),
            lambda: fa.flash_attention_with_lse(q, k, v, causal=causal))
        po, plse = fa.flash_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err_o, ok_o = flash_o_close(o, po)
        err_l = (lse - plse).abs().max().item()
        what = f"{dt} causal={causal} B={b} Sq={sq} Sk={sk} N={n} D={d}"
        check(o.shape == q.shape and lse.shape == (b, n, sq)
              and o.dtype == dt, f"flash output shapes, B={b} Sq={sq}")
        check(ok_o and err_l <= FLASH_ATOL,
              f"flash {what}: |dO|={err_o} |dLSE|={err_l}")
        check(variant == ("mma" if dt == torch.bfloat16 else "fma"),
              f"flash {what} took the {variant} variant")
        variants[what] = variant
        worst = max(worst, err_o)
    for dt in (torch.float32, torch.bfloat16):
        # dead row: every logit of (b=0, s=5, h=0) overflows to -inf
        q, k, v = _qkv(gen, 1, 70, 70, 2, 64, dt)
        q[0, 5, 0] = 0
        q[0, 5, 0, 0] = -3e38
        k[:, :, 0, 0] = 100
        variant, (o, lse) = launched_variant(
            counters, lambda: fa.kernel_variant(q),
            lambda: fa.flash_attention_with_lse(q, k, v, causal=True))
        po, plse = fa.flash_attention_plain(q, k, v, causal=True)
        check(lse[0, 0, 5].item() == fa.NEG and plse[0, 0, 5].item() == fa.NEG,
              f"dead-row LSE sentinel ({dt}, {variant})")
        check(o[0, 5, 0].abs().max().item() == 0.0, f"dead-row O ({dt})")
        check(torch.isfinite(o.float()).all().item()
              and torch.isfinite(lse).all().item(), f"dead-row finite ({dt})")
        variants[f"{dt} dead row"] = variant
    log({"check": "flash_fwd", "cases": len(cases) + 2, "max_abs_err_o": worst,
         "variants": variants})


BWD_F32_RTOL, BWD_F32_ATOL = 1e-4, 1e-5
BWD_BF16_ATOL = 1e-5


def bwd_close(got: torch.Tensor, ref: torch.Tensor):
    """A backward kernel's output against the plain version's, element by
    element. float32: within BWD_F32_RTOL * max|ref| + BWD_F32_ATOL (f32
    sums of up to Sk or Sq products in another order). bfloat16: within one
    bf16 step of the element, 2^-7 * |ref|, plus BWD_BF16_ATOL: both round
    an f32 sum to bf16, and where that sum is near zero its f32 ordering
    error, and in the mma variants the split of p and dS into bf16 pieces,
    is large against the element's own step (on an H100 the largest excess
    over one step measured 4.6e-8 with the f32 FMA kernels; the mma
    variants' reading per gradient, seeds 5-8 at the training shape, is
    ``check_flash_bwd``'s log). Returns (max |got - ref|, the largest
    excess over the one-step part in bf16, or the error over max|ref| in
    f32, whether all hold)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    if got.dtype == torch.bfloat16:
        step = 2 ** -7 * r.abs()
        ok = diff <= step + BWD_BF16_ATOL
        excess = (diff - step).clamp_min(0).max().item()
    else:
        ok = diff <= BWD_F32_RTOL * r.abs().max() + BWD_F32_ATOL
        excess = (diff.max() / r.abs().max().clamp_min(1e-30)).item()
    return (diff.max().item(), excess,
            bool(ok.all().item() and torch.isfinite(g).all().item()))


def _function_grads(q, k, v, g_o, g_lse, causal):
    """(o, lse, dq, dk, dv) through ``FlashAttention``: K1, then K2 + K3."""
    from bigdl_tpu_torch.ops.flash_attention import flash_attention_with_lse
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    o, lse = flash_attention_with_lse(q, k, v, causal=causal)
    if g_lse is None:
        o.backward(g_o)
    else:
        torch.autograd.backward((o, lse), (g_o, g_lse))
    return o.detach(), lse.detach(), q.grad, k.grad, v.grad


def check_flash_bwd():
    """K2 and K3 through the autograd Function against
    ``flash_attention_bwd_plain`` fed the same o, lse and cotangents (see
    ``bwd_close``): at the training shape in bf16 (B=8 S=512 N=12 D=64,
    causal, with and without an LSE cotangent, inputs from seeds 5-8, each
    gradient's largest excess over one bf16 step logged), f32 causal and
    full at S in {384, 333}, D=128, Sq != Sk, one row, and the dead row of
    ``check_flash``. Then the Function against autograd through the plain
    attention core at the training shape in f32. Every bf16 case (D=128
    included) must launch K2's and K3's "mma" variants and every f32 case
    their "fma" ones, by the counters. Returns the worst |error| of dQ (K2)
    and of dK/dV (K3) at the training shape."""
    from bigdl_tpu_torch.ops import flash_attention as fa
    from bigdl_tpu_torch.ops.attention_core import dot_product_attention
    from bigdl_tpu_torch.ops.flash_attention import flash_attention_bwd_plain
    gen = torch.Generator(device="cuda").manual_seed(6)
    counters = [(fa.LAUNCHES_DQ, fa.LAUNCHES_DQ_MMA),
                (fa.LAUNCHES_DKV, fa.LAUNCHES_DKV_MMA)]
    variants = {}

    def grads_of(q, k, v, g_o, g_lse, causal, what):
        variant, out = launched_variant(
            counters, lambda: fa.kernel_variant(q),
            lambda: _function_grads(q, k, v, g_o, g_lse, causal))
        check(variant == ("mma" if q.dtype == torch.bfloat16 else "fma"),
              f"flash bwd {what} took the {variant} variant")
        variants[what] = variant
        return out

    bf16, f32 = torch.bfloat16, torch.float32
    n_train = CONFIG["num_heads"]
    # (dtype, causal, B, Sq, Sk, N, D, with an LSE cotangent, input seed:
    # None draws from ``gen``, a number from a generator of its own)
    train = [(bf16, True, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, n_train, 64, g,
              seed) for seed in (5, 6, 7, 8) for g in (False, True)]
    others = [(f32, causal, 2, s, s, n_train, 64, True)
              for causal in (True, False) for s in (384, 333)]
    others += [(bf16, False, 2, 333, 333, n_train, 64, True),
               (bf16, True, 1, 200, 200, 4, 128, True),
               (f32, True, 2, 333, 333, 3, 128, False),
               (f32, False, 2, 100, 333, 3, 64, True),
               (bf16, False, 2, 333, 100, 3, 128, True),
               (f32, True, 4, 1, 1, n_train, 64, True)]
    cases = train + [case + (None,) for case in others]
    worst = {"dq": 0.0, "dkv": 0.0}
    excess = {f32: 0.0, bf16: 0.0}
    train_excess = {"dq": 0.0, "dk": 0.0, "dv": 0.0}
    for dt, causal, b, sq, sk, n, d, with_g_lse, seed in cases:
        g = gen if seed is None else torch.Generator(
            device="cuda").manual_seed(seed)
        q, k, v = _qkv(g, b, sq, sk, n, d, dt)
        g_o = torch.randn(q.shape, generator=g, device="cuda").to(dt)
        g_lse = (torch.randn((b, n, sq), generator=g, device="cuda")
                 if with_g_lse else None)
        what = (f"{dt} causal={causal} B={b} Sq={sq} Sk={sk} N={n} D={d} "
                f"g_lse={with_g_lse}")
        if seed is not None:
            what += f" seed={seed}"
        o, lse, *grads = grads_of(q, k, v, g_o, g_lse, causal, what)
        plain = flash_attention_bwd_plain(q, k, v, o, lse, g_o, g_lse,
                                          causal, 1.0 / d ** 0.5)
        torch.cuda.synchronize()
        for name, got, ref in zip(("dq", "dk", "dv"), grads, plain):
            err, ex, ok = bwd_close(got, ref)
            check(ok and got.shape == ref.shape and got.dtype == dt,
                  f"flash bwd {name} {what}: |err| {err} "
                  f"(bf16: excess over one step; f32: over max|ref|: {ex})")
            excess[dt] = max(excess[dt], ex)
            if seed is not None:
                train_excess[name] = max(train_excess[name], ex)
            if (b, sq) == (TRAIN_BATCH, TRAIN_SEQ):
                key = "dq" if name == "dq" else "dkv"
                worst[key] = max(worst[key], err)
    for dt in (f32, bf16):
        # the dead row of check_flash: (b=0, s=5, h=0) sees only -inf logits
        q, k, v = _qkv(gen, 1, 70, 70, 2, 64, dt)
        q[0, 5, 0] = 0
        q[0, 5, 0, 0] = -3e38
        k[:, :, 0, 0] = 100
        g_o = torch.randn(q.shape, generator=gen, device="cuda").to(dt)
        g_lse = torch.randn((1, 2, 70), generator=gen, device="cuda")
        o, lse, *grads = grads_of(q, k, v, g_o, g_lse, True, f"{dt} dead row")
        plain = flash_attention_bwd_plain(q, k, v, o, lse, g_o, g_lse, True,
                                          1.0 / 8)
        for name, got, ref in zip(("dq", "dk", "dv"), grads, plain):
            err, _, ok = bwd_close(got, ref)
            check(ok and torch.isfinite(ref.float()).all().item(),
                  f"dead-row {name} ({dt}): |err| {err}")
        check(grads[0][0, 5, 0].abs().max().item() == 0.0,
              f"dead-row dQ is not 0 ({dt})")
    # the Function against autograd through the plain core, f32, training shape
    q, k, v = _qkv(gen, TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, n_train, 64, f32)
    g_o = torch.randn(q.shape, generator=gen, device="cuda")
    _, _, *grads = grads_of(q, k, v, g_o, None, True, "f32 vs plain core")
    ts = [t.detach().requires_grad_() for t in (q, k, v)]
    dot_product_attention(*ts, causal=True).backward(g_o)
    autograd_err = 0.0
    for name, got, t in zip(("dq", "dk", "dv"), grads, ts):
        err, _, ok = bwd_close(got, t.grad)
        check(ok, f"Function vs autograd of the plain core, {name}: {err}")
        autograd_err = max(autograd_err, err)
    log({"check": "flash_bwd", "cases": len(cases) + 3,
         "max_abs_err_dq_train_shape": worst["dq"],
         "max_abs_err_dkv_train_shape": worst["dkv"],
         "bf16_max_excess_over_one_step": excess[bf16],
         "bf16_train_shape_excess_over_one_step_seeds_5_8": train_excess,
         "f32_max_err_over_max_ref": excess[f32],
         "function_vs_plain_core_autograd_f32": autograd_err,
         "variants": variants})
    return worst


def check_int8():
    """K4 against ``int8_matmul_plain`` through the public ``int8_matmul``
    (compute dtype f32, with and without a bias), M in {1, 4 (the served
    decode batch), 8}. Tolerance: INT8_RTOL of max|y|: the same exact
    int8 x bf16 products summed in f32 in another order (K <= 3072)."""
    from bigdl_tpu_torch.ops.int8_matmul import int8_matmul, int8_matmul_plain
    gen = torch.Generator(device="cuda").manual_seed(2)
    shapes = [(768, 768), (256, 768), (3072, 768), (768, 3072), (32000, 768),
              (1100, 768)]
    cases = [(m, o, kd) for m in (1, REQUESTS_PER_LEN, 8) for o, kd in shapes]
    cases += [(9, 768, 768), (256, 1100, 768), (256, 768, 3072)]
    worst = 0.0
    for m, o, kd in cases:
        w = torch.randint(-127, 128, (o, kd), generator=gen, device="cuda",
                          dtype=torch.int8)
        s = torch.rand((o, 1), generator=gen, device="cuda") * 1e-2 + 1e-3
        x = torch.randn((m, kd), generator=gen, device="cuda")
        bias = torch.randn((o,), generator=gen, device="cuda")
        for xdt in (torch.float32, torch.bfloat16):
            for b in (None, bias):
                y = int8_matmul(x.to(xdt), w, s, b, torch.float32)
                ref = int8_matmul_plain(x.to(xdt), w, s.reshape(o))
                if b is not None:
                    ref = ref + b
                torch.cuda.synchronize()
                err = (y - ref).abs().max().item()
                tol = INT8_RTOL * ref.abs().max().item()
                check(y.shape == (m, o) and err <= tol,
                      f"int8 M={m} O={o} K={kd} x={xdt} bias={b is not None}:"
                      f" err {err} > {tol}")
                worst = max(worst, err / max(ref.abs().max().item(), 1e-30))
    log({"check": "int8_matmul", "cases": 4 * len(cases),
         "max_rel_err": worst})


CONV_F32_RTOL, CONV_F32_ATOL = 1e-4, 1e-5
CONV_BF16_ATOL = 1e-5
STATS_RTOL = 1e-5
CONV_GRAD_RTOL = 1e-4
RESNET_WIDTHS, RESNET_REPS = (64, 128, 256, 512), (3, 4, 6, 3)


def resnet50_conv_shapes(b: int):
    """The distinct conv shapes of ResNet-50's fused pairs at batch b:
    1x1 as (N, H, W, Cin, Cout, stride), the stride-2 projections taking the
    full-resolution input that the module subsamples, and stride-1 3x3 as
    (N, H, W, Cin, Cout)."""
    ones, threes = [], []
    hw, n_in = 56, 64
    for stage, (width, reps) in enumerate(zip(RESNET_WIDTHS, RESNET_REPS)):
        for i in range(reps):
            stride = 2 if stage > 0 and i == 0 else 1
            out_hw = hw // stride
            ones.append((b, hw, hw, n_in, width, 1))
            if stride == 1:
                threes.append((b, hw, hw, width, width))
            ones.append((b, out_hw, out_hw, width, 4 * width, 1))
            if i == 0:
                ones.append((b, hw, hw, n_in, 4 * width, stride))
            hw, n_in = out_hw, 4 * width
    return list(dict.fromkeys(ones)), list(dict.fromkeys(threes))


def y_close(got: torch.Tensor, ref: torch.Tensor):
    """A fused kernel's y against its plain version's, element by element.
    float32: within CONV_F32_RTOL * max|ref| + CONV_F32_ATOL (f32 sums of up
    to 9 * 512 products in another order). bfloat16: within one bf16 step
    of the element, 2^-7 * |ref|, plus CONV_BF16_ATOL: both round an f32
    sum to bf16, and where that sum is near zero its f32 ordering error can
    exceed the element's own step (on an H100 the largest excess over one
    step measured 1.2e-6, at the training run's B=256 shapes, so the atol
    keeps a margin of 8). Returns (max
    |got - ref|, the largest excess over the one-step part in bf16 or the
    error over max|ref| in f32, whether every element holds)."""
    g, r = got.float(), ref.float()
    diff = (g - r).abs()
    if got.dtype == torch.bfloat16:
        step = 2 ** -7 * r.abs()
        ok = diff <= step + CONV_BF16_ATOL
        excess = (diff - step).clamp_min(0).max().item()
    else:
        ok = diff <= CONV_F32_RTOL * r.abs().max() + CONV_F32_ATOL
        excess = (diff.max() / r.abs().max().clamp_min(1e-30)).item()
    return (diff.max().item(), excess,
            bool(ok.all().item() and torch.isfinite(g).all().item()))


def stats_close(got, ref, y_ref: torch.Tensor):
    """The kernel's (col_sum, col_sumsq) against the plain version's, per
    channel, within STATS_RTOL of sum|y| and of sum y^2 of that channel
    (f32 sums of up to 802,816 values in another order; an H100 run
    measured at most 6.7e-7, in f32 and bf16 alike, since both sum f32
    products). Returns the largest error over those scales and whether
    both hold."""
    y = y_ref.float().reshape(-1, y_ref.shape[-1])
    worst, ok = 0.0, True
    for g, r, scale in ((got[0], ref[0], y.abs().sum(0)),
                        (got[1], ref[1], (y * y).sum(0))):
        rel = ((g - r).abs() / scale.clamp_min(1e-30)).max().item()
        worst = max(worst, rel)
        ok = ok and rel <= STATS_RTOL and bool(torch.isfinite(g).all().item())
    return worst, ok


def check_conv_bn():
    """K5 and K6 against ``matmul_with_stats_plain`` and
    ``conv3x3_with_stats_plain`` through the public wrappers, at every
    distinct fused 1x1 and stride-1 3x3 shape of ResNet-50 at B=32 (the
    stride-2 projections through the module's subsample and copy) and at
    the reference tests' ragged shapes (K=3, K=12, odd 5x7 images, Cin=3,
    Cout off the 64-channel tile), each in f32 and bf16, and at every such
    shape of the training run (B=RESNET_BATCH, bf16): y as in ``y_close``,
    the statistics as in ``stats_close``, and two runs of each kernel give
    bit-identical statistics."""
    from bigdl_tpu_torch.ops import conv3x3_bn
    from bigdl_tpu_torch.ops.conv3x3_bn import (conv3x3_with_stats,
                                                conv3x3_with_stats_plain)
    from bigdl_tpu_torch.ops.matmul_bn import (matmul_with_stats,
                                               matmul_with_stats_plain)
    gen = torch.Generator(device="cuda").manual_seed(9)
    f32, bf16 = torch.float32, torch.bfloat16
    ones, threes = resnet50_conv_shapes(32)
    mm_cases = ones + [(1, 1, m, k, n, 1) for m, k, n in
                       ((512, 64, 256), (300, 48, 100), (64, 16, 128),
                        (257, 3, 5), (1000, 12, 70))]
    conv_cases = threes + [(2, 8, 8, 4, 8), (1, 5, 7, 3, 2), (3, 4, 4, 8, 16),
                           (2, 6, 9, 16, 70)]
    train_ones, train_threes = resnet50_conv_shapes(RESNET_BATCH)
    runs = [(f32, mm_cases, conv_cases), (bf16, mm_cases, conv_cases),
            (bf16, train_ones, train_threes)]
    worst = {f32: 0.0, bf16: 0.0, "stats": 0.0}
    k6_variants = {}

    def one(name, fn, plain, x, w):
        got, again, ref = fn(x, w), fn(x, w), plain(x, w)
        torch.cuda.synchronize()
        err, ex, ok = y_close(got[0], ref[0])
        st, st_ok = stats_close(got[1:], ref[1:], ref[0])
        same = torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
        check(ok and st_ok and same and got[0].shape == ref[0].shape
              and got[0].dtype == x.dtype,
              f"{name} {x.dtype}: |y err| {err} (excess {ex}), stats "
              f"{st}, deterministic {same}")
        worst[x.dtype] = max(worst[x.dtype], ex)
        worst["stats"] = max(worst["stats"], st)

    for dt, k5_cases, k6_cases in runs:
        for n, h, w, cin, cout, s in k5_cases:
            x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(dt)
            wt = (torch.randn((cin, cout), generator=gen, device="cuda")
                  / cin ** 0.5).to(dt)
            x2d = x[:, ::s, ::s, :].reshape(-1, cin)  # as FusedConv1x1BN does
            one(f"K5 M={x2d.shape[0]} K={cin} N={cout} stride={s}",
                matmul_with_stats, matmul_with_stats_plain, x2d, wt)
        for n, h, w, cin, cout in k6_cases:
            x = torch.randn((n, h, w, cin), generator=gen, device="cuda").to(dt)
            wt = (torch.randn((3, 3, cin, cout), generator=gen, device="cuda")
                  / (9 * cin) ** 0.5).to(dt)
            name = f"K6 N={n} {h}x{w} {cin}->{cout}"
            variant = conv3x3_bn.kernel_variant(x, wt)
            mma_before = conv3x3_bn.LAUNCHES_MMA.value
            one(name, conv3x3_with_stats, conv3x3_with_stats_plain, x, wt)
            # one() calls the kernel twice
            check(conv3x3_bn.LAUNCHES_MMA.value - mma_before
                  == 2 * (variant == "mma"), f"{name} {dt}: mma launches")
            check(variant == ("mma" if dt == bf16 and cin % 8 == 0
                              and cout % 8 == 0 else "fma"),
                  f"{name} {dt} took the {variant} variant")
            k6_variants[f"{name} {str(dt)[6:]}"] = variant
    log({"check": "conv_bn_kernels",
         "cases": sum(len(a) + len(b) for _, a, b in runs),
         "k5_shapes_resnet50_b32": len(ones), "k6_shapes_resnet50_b32":
         len(threes), f"k5_k6_shapes_resnet50_b{RESNET_BATCH}_bf16":
         [len(train_ones), len(train_threes)],
         "f32_max_err_over_max_ref": worst[f32],
         "bf16_max_excess_over_one_step": worst[bf16],
         "stats_max_err_over_scale": worst["stats"],
         "k6_variants": k6_variants})


def check_conv_bn_autograd():
    """``conv1x1_bn_train`` (K5) and ``conv3x3_bn_train`` (K6) against
    autograd through the plain composition (the f32 product or conv, then
    ``batch_norm_train``), in f32 at ResNet-50 stage-3 shapes (B=32, 14x14:
    1x1 1024 -> 256, 3x3 256 -> 256), with a random cotangent: out, dx,
    dw, dgamma and dbeta within CONV_GRAD_RTOL of max|ref| per tensor."""
    from bigdl_tpu_torch.ops.batch_norm import batch_norm_train
    from bigdl_tpu_torch.ops.conv3x3_bn import _conv3x3, conv3x3_bn_train
    from bigdl_tpu_torch.ops.conv_bn import conv1x1_bn_train
    gen = torch.Generator(device="cuda").manual_seed(10)
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    cases = {
        "conv1x1_bn_train": (conv1x1_bn_train, lambda x, w: x @ w,
                             rnd(32 * 14 * 14, 1024), rnd(1024, 256) / 32),
        "conv3x3_bn_train": (conv3x3_bn_train, _conv3x3,
                             rnd(32, 14, 14, 256), rnd(3, 3, 256, 256) / 48)}
    worst = {}
    for name, (fused, product, x, w) in cases.items():
        cout = w.shape[-1]
        g, b = 1 + 0.1 * rnd(cout), 0.1 * rnd(cout)
        cot = rnd(*x.shape[:-1], cout)
        grads = []
        for path in ("fused", "plain"):
            ts = [t.detach().clone().requires_grad_() for t in (x, w, g, b)]
            if path == "fused":
                out, _, _ = fused(*ts, 1e-5)
            else:
                out, _, _ = batch_norm_train(product(ts[0], ts[1]), ts[2],
                                             ts[3], 1e-5)
            out.backward(cot)
            grads.append([out.detach()] + [t.grad for t in ts])
        torch.cuda.synchronize()
        errs = []
        for what, got, ref in zip(("out", "dx", "dw", "dgamma", "dbeta"),
                                  *grads):
            err = ((got - ref).abs().max() / ref.abs().max()).item()
            check(err <= CONV_GRAD_RTOL and torch.isfinite(got).all().item(),
                  f"{name} {what} against autograd of the plain composition:"
                  f" {err} of max|ref|")
            errs.append(err)
        worst[name] = max(errs)
    log({"check": "conv_bn_autograd_f32", **worst})


HBM_PROBE_BYTES = 1 << 30   # the probe's --gib 1: bytes of each array
READ_RTOL = 1e-6


def bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a - b| in bf16 steps, element by element, from the bit patterns
    (+0 and -0 are one value)."""
    def ordered(t):
        u = t.view(torch.int16).int() & 0xFFFF
        return torch.where(u >= 0x8000, 0x8000 - u, u)
    return (ordered(a) - ordered(b)).abs()


def kernel_spans(prof, name_part: str) -> list:
    """(start, end) in us of the device kernels of a profiler session whose
    name holds ``name_part``."""
    return sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                  if name_part in e.name and e.time_range.end > e.time_range.start
                  and "cuda" in str(e.device_type).lower())


def most_at_once(spans) -> int:
    """The most spans that run at one time."""
    # an end sorts before a start at the same time: touching is not overlap
    edges = sorted([(s, 1) for s, _ in spans] + [(e, -1) for _, e in spans])
    now = most = 0
    for _, step in edges:
        now += step
        most = max(most, now)
    return most


def direct_copy_overlap() -> dict:
    """K7c at every stream count over the probe's 1 GiB shape, once under
    the profiler: the most of its launches that ran side by side, which
    must be at least two for two streams or more. Each launch has its
    share of the SMs, so all of them can; how many do depends on how fast
    the host issues them (an H100 run saw 7 of 8 under the profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from bigdl_tpu_torch.ops import hbm_roof as hr
    from bigdl_tpu_torch.scripts.roofline_hbm import DMA_STREAMS, hbm_dma_shape
    seen = {}
    for ns in DMA_STREAMS:
        x = torch.ones(hbm_dma_shape(HBM_PROBE_BYTES, ns), dtype=torch.bfloat16,
                       device="cuda")
        out = hr.direct_copy(x, ns)
        for _ in range(PROFILER_TRIES):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                hr.direct_copy(x, ns, out)
                torch.cuda.synchronize()
            spans = kernel_spans(prof, "copy_kernel")
            if len(spans) == ns:
                break
        else:   # not measured: the profiler missed launches
            seen[ns] = {"not_measured_kernels_seen": len(spans)}
            continue
        seen[ns] = {"most_at_once": most_at_once(spans),
                    "span_us": spans[-1][1] - spans[0][0],
                    "kernel_us": [e - s for s, e in spans]}
        check(seen[ns]["most_at_once"] >= min(ns, 2),
              f"K7c with {ns} streams ran at most {seen[ns]['most_at_once']} "
              "launch at once")
    return seen


def copy_device_ops():
    """The device operations that ``Tensor.copy_`` of 1 GiB of bf16 runs
    (the probe's library copy), from the profiler; None when it recorded
    nothing."""
    x = torch.ones(HBM_PROBE_BYTES // 2, dtype=torch.bfloat16, device="cuda")
    y = torch.empty_like(x)
    rows, _ = profiled(lambda: y.copy_(x), "Tensor.copy_")
    return None if rows is None else [k for k, _ in rows]


def check_hbm_roof() -> dict:
    """The K7 kernels against their plain versions on seeded N(0, 1) bf16
    inputs, at the probe's timed size (1 GiB an array) and at ragged sizes:
    K7a at every (threads, vecs, grid) of the probe's sweep, with n off the
    16-byte vector and the grid's tile; K7b at every (chunk, nbuf) of the
    sweep, and on one block with fewer chunks than slots, with a chunk
    count that the slots do not divide, a short last chunk and a tail under
    16 bytes; K7c at every stream count, on the reference's trimmed shapes
    from a row count that no stream count divides. Copies must be
    bit-identical; triad within one bf16 step of ``triad_plain`` (the count
    of elements one step apart is logged); read within READ_RTOL x sum|x| of
    an f64 sum, and two runs must give the same bits. Then K7c's overlap
    and the operations of ``Tensor.copy_``. Returns each kernel's largest
    |kernel - plain| at the timed size."""
    from bigdl_tpu_torch.ops import hbm_roof as hr
    from bigdl_tpu_torch.scripts.roofline_hbm import (AUTO_SWEEP, DMA_STREAMS,
                                                      MANUAL_SWEEP,
                                                      hbm_dma_shape)
    gen = torch.Generator(device="cuda").manual_seed(13)
    rnd = lambda *shape: torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    n_timed = HBM_PROBE_BYTES // 2
    errs = {k: 0.0 for k in hr.COUNTERS}
    tally = {"cases": 0, "triad_elements": 0, "triad_one_step": 0,
             "read_max_err_over_sum_abs": 0.0}

    def copied(name, got, x):
        check(torch.equal(got, x), f"{name}: the copy differs ({x.numel()} "
                                   "values)")
        tally["cases"] += 1

    def k7a(n, timed):
        a, b = rnd(n), rnd(n)
        seed = torch.randn((1, 1), generator=gen, device="cuda")
        ref64 = seed.double() + a.double().sum()
        sum_abs = a.double().abs().sum().item()
        plain_read, plain_triad = hr.read_sum_plain(seed, a), hr.triad_plain(a, b)
        for threads, vecs, grid in AUTO_SWEEP:
            knobs = dict(threads=threads, vecs=vecs, grid=grid)
            what = f"n={n} block {threads}x{vecs} {grid} grid"
            copied(f"hbm copy {what}", hr.copy(a, **knobs), a)
            r1, r2 = hr.read_sum(seed, a, **knobs), hr.read_sum(seed, a, **knobs)
            rel = abs(r1.double() - ref64).item() / sum_abs
            check(rel <= READ_RTOL and torch.equal(r1, r2),
                  f"hbm read {what}: {rel} of sum|x| from the f64 sum, "
                  f"runs equal {torch.equal(r1, r2)}")
            t = hr.triad(a, b, **knobs)
            ulps = bf16_ulps(t, plain_triad)
            worst = ulps.max().item()
            check(worst <= 1, f"hbm triad {what}: {worst} bf16 steps off")
            tally["triad_elements"] += n
            tally["triad_one_step"] += int((ulps == 1).sum().item())
            tally["read_max_err_over_sum_abs"] = max(
                tally["read_max_err_over_sum_abs"], rel)
            tally["cases"] += 2
            if timed:
                errs["hbm_read"] = max(errs["hbm_read"],
                                       (r1 - plain_read).abs().item())
                errs["hbm_triad"] = max(errs["hbm_triad"], (
                    t.float() - plain_triad.float()).abs().max().item())

    k7a(n_timed, True)
    for n in (2 ** 20 + 3, 8 * 1000 + 7, 5):
        k7a(n, False)

    x = rnd(n_timed)
    for chunk, nbuf in MANUAL_SWEEP:
        copied(f"hbm staged copy {chunk}x{nbuf}",
               hr.staged_copy(x, chunk, nbuf), x)
    # (elements, chunk bytes, slots, blocks; 0 = the persistent grid)
    for n, chunk, nbuf, blocks in (
            (3 * 8192 + 5, 16384, 4, 1),      # 3 chunks < 4 slots, 10-byte tail
            (6 * 8192 + 100, 16384, 4, 1),    # 7 chunks, 7 % 4 slots, short last
            (7 * 8192 + 1000, 16384, 3, 1),   # 8 chunks, 8 % 3 slots
            (2 ** 20 + 3, 49152, 4, 0),       # ragged ranges on the whole grid
            (2 ** 20, 16384, 2, 3),           # three blocks, many fills a slot
            (5, 16, 2, 0)):                   # the tail alone
        x = rnd(n)
        copied(f"hbm staged copy n={n} {chunk}x{nbuf} blocks={blocks}",
               hr.staged_copy(x, chunk, nbuf, blocks=blocks), x)

    for total in (HBM_PROBE_BYTES, 1001 * 2048 + 1234):
        for ns in DMA_STREAMS:
            x = rnd(*hbm_dma_shape(total, ns))
            copied(f"hbm direct copy {tuple(x.shape)} nstreams={ns}",
                   hr.direct_copy(x, ns), x)
    try:
        hr.direct_copy(rnd(1001, 1024), 8)
        check(False, "hbm direct copy took rows that 8 streams do not split")
    except ValueError:
        pass
    torch.cuda.synchronize()
    log({"check": "hbm_roof", **tally, **{f"max_abs_err_{k}": v
                                          for k, v in errs.items()},
         # before any other profiler session: late in a long process the
         # profiler has come back empty for both
         "direct_copy_overlap": direct_copy_overlap(),
         "copy__device_ops": copy_device_ops()})
    return errs


# ------------------------------------------------------------------ 3. slice
def serve(model, prompts):
    """All prompts from threads through one LMServer; returns the answers,
    the batches served and the wall seconds."""
    from bigdl_tpu_torch.models.lm_server import LMServer
    server = LMServer(model, max_batch=REQUESTS_PER_LEN, batch_timeout_ms=2000,
                      max_new_tokens=NEW_TOKENS, greedy=True, device="cuda")
    results = [None] * len(prompts)
    errors = []
    barrier = threading.Barrier(len(prompts))

    def client(i):
        try:
            barrier.wait(timeout=60)
            results[i] = server.submit(prompts[i], timeout=600)
        except Exception as e:  # collected and raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        seconds = time.perf_counter() - t0
    finally:
        server.close()
    check(not any(t.is_alive() for t in threads), "a client never returned")
    if errors:
        raise errors[0]
    return results, server.batches_served, seconds


def time_generate(model, prompts) -> dict:
    """Prefill and decode times of one batch (host clock around work that
    ends in a synchronize), and the share of the decode run in which the
    device was busy (profiler kernel time over wall time)."""
    from bigdl_tpu_torch.models.generation import generate
    batch = torch.as_tensor(prompts, device="cuda")

    def run(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, batch, n, greedy=True, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    run(NEW_TOKENS)  # warm-up
    t1 = min(run(1) for _ in range(3))
    tn = min(run(NEW_TOKENS) for _ in range(3))
    b, s = batch.shape
    rows, _ = profiled(lambda: generate(model, batch, NEW_TOKENS, greedy=True,
                                        device="cuda"), f"decode B={b} S={s}")
    # None ("not measured") when the profiler recorded nothing
    busy = (None if rows is None
            else sum(t for _, t in rows) / 1e6 / tn)
    top = ([] if rows is None else
           [(k[:60], t) for k, t in sorted(rows, key=lambda r: -r[1])[:3]])
    return {"batch": b, "prompt_len": s, "new_tokens": NEW_TOKENS,
            "prefill_ms": t1 * 1e3,
            "decode_ms_per_token": (tn - t1) / (NEW_TOKENS - 1) * 1e3,
            "tokens_per_s": b * NEW_TOKENS / tn,
            "device_busy_share": busy, "top_kernels_us": top}


def run_slice():
    from bigdl_tpu_torch.models.generation import generate
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.quantized import cast_model, quantize_model
    from bigdl_tpu_torch.ops import flash_attention, int8_matmul

    t0 = time.perf_counter()
    base = build_lm(VOCAB, **CONFIG, device="cuda", seed=7).evaluate_mode()
    twins = {"bf16": cast_model(base, torch.bfloat16, device="cuda"),
             "int8": quantize_model(base, torch.bfloat16, device="cuda")}
    n_params = sum(p.numel() for p in base.parameters())
    log({"model": "134m", "params": n_params,
         "build_s": time.perf_counter() - t0})
    rng = np.random.default_rng(0)
    groups = {s: [rng.integers(1, VOCAB + 1, s).tolist()
                  for _ in range(REQUESTS_PER_LEN)] for s in PROMPT_LENS}
    prompts = [p for s in PROMPT_LENS for p in groups[s]]

    counters = (flash_attention.LAUNCHES, flash_attention.LAUNCHES_MMA,
                int8_matmul.LAUNCHES, int8_matmul.DEQUANT_CALLS)
    launches = {"flash_fwd": 0, "flash_fwd_mma": 0, "int8_matmul": 0}
    answers = {}
    for name, model in twins.items():
        torch.cuda.reset_peak_memory_stats()
        for c in counters:
            c.reset()
        results, batches, seconds = serve(model, prompts)
        k1, k1_mma, k4, deq = (c.value for c in counters)
        peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20
        launches["flash_fwd"] += k1
        launches["flash_fwd_mma"] += k1_mma
        launches["int8_matmul"] += k4
        answers[name] = results
        layers = CONFIG["num_layers"]
        per_token = 7 * layers + 1  # q, k, v, out, up, gate, down; the head
        # each batch: a prefill of M = 4 * prompt_len > 256 rows takes the
        # dequantize path except the head, which reads the last position
        # only (M = 4), then NEW_TOKENS - 1 single-token steps
        k4_want = (1 + per_token * (NEW_TOKENS - 1)) * batches
        log({"twin": name, "served": len(results), "batches": batches,
             "serve_s": seconds, "k1_launches": k1, "k1_mma_launches": k1_mma,
             "k4_launches": k4, "dequant_calls": deq,
             "peak_allocated_mib": peak_mb})
        check(batches == len(PROMPT_LENS), f"{name}: {batches} batches")
        check(k1_mma == k1 == layers * batches and k1 > 0,
              f"{name}: prefill launched K1 {k1} times, {k1_mma} of them "
              "the mma variant")
        if name == "int8":
            check(k4 == k4_want and k4 > 0 and deq == (per_token - 1) * batches,
                  f"int8 twin launched K4 {k4} times (want {k4_want}), "
                  f"dequantized {deq} times")
        else:
            check(k4 == 0 and deq == 0, "bf16 twin touched the int8 path")

    for name, model in twins.items():
        for s in PROMPT_LENS:
            direct = generate(model, groups[s], NEW_TOKENS, greedy=True,
                              device="cuda")[:, s:].cpu().tolist()
            for p, want in zip(groups[s], direct):
                got = answers[name][prompts.index(p)]
                check(got == want, f"{name}: LMServer answer != generate "
                                   f"(prompt length {s})")
                check(len(got) == NEW_TOKENS
                      and all(1 <= t <= VOCAB for t in got),
                      f"{name}: malformed continuation")
        log({"twin": name, "answers_equal_generate": True})

    # the twins against the f32 model on a small input: finite log-probs of
    # the expected shape whose top-1 token agrees at (nearly) every position
    ids = torch.as_tensor(rng.integers(1, VOCAB + 1, (1, 64)), device="cuda")
    with torch.inference_mode():
        ref = base(ids)
        for name, model in twins.items():
            lp = model(ids).float()
            agree = (lp.argmax(-1) == ref.argmax(-1)).float().mean().item()
            check(lp.shape == (1, 64, VOCAB) and torch.isfinite(lp).all().item(),
                  f"{name}: log-probs")
            log({"twin": name, "top1_agreement_vs_f32": agree})
            check(agree >= 0.9, f"{name}: top-1 agreement {agree}")

    for name, model in twins.items():
        for s in PROMPT_LENS:
            log({"twin": name, **time_generate(model, groups[s])})
    return twins["int8"], launches


# -------------------------------------------------------------- 3b. training
GRAD_RTOL = 1e-3


def grad_check(model) -> None:
    """Every parameter's gradient of one f32 batch (B=1, S=128) on the card
    (K1, K2, K3) against a CPU copy with the same weights (the plain path):
    finite, and within GRAD_RTOL in relative L2 per tensor (f32 sums in
    other orders; the two paths agree to ~1e-6)."""
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    from bigdl_tpu_torch.interop.state_dict import (export_lm_state_dict,
                                                    import_lm_state_dict)
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
    from bigdl_tpu_torch.ops import flash_attention as fa
    cpu = build_lm(VOCAB, **CONFIG, device="cpu", seed=0)
    import_lm_state_dict(cpu, export_lm_state_dict(model))
    sample = synthetic_corpus(1, 128, VOCAB, seed=1)[0]
    grads = []   # the card's, then the CPU's
    for m in (model, cpu):
        dev = next(m.parameters()).device
        m.train()
        m.zero_grad(set_to_none=True)
        for c in (fa.LAUNCHES, fa.LAUNCHES_MMA, fa.LAUNCHES_DQ,
                  fa.LAUNCHES_DQ_MMA, fa.LAUNCHES_DKV, fa.LAUNCHES_DKV_MMA):
            c.reset()
        ids = torch.as_tensor(sample.feature[None], device=dev)
        tgt = torch.as_tensor(sample.label[None], device=dev)
        FusedLMHeadCriterion()(m(ids), tgt).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
        if dev.type == "cuda":
            layers = CONFIG["num_layers"]
            check((fa.LAUNCHES.value, fa.LAUNCHES_DQ.value,
                   fa.LAUNCHES_DKV.value) == (layers,) * 3,
                  "the card's gradient did not run K1, K2 and K3 once a layer")
            check((fa.LAUNCHES_MMA.value, fa.LAUNCHES_DQ_MMA.value,
                   fa.LAUNCHES_DKV_MMA.value) == (0, 0, 0),
                  "the f32 gradient check ran an mma variant of K1, K2 or K3")
    model.zero_grad(set_to_none=True)
    worst, worst_name = 0.0, ""
    for name, ref in grads[1].items():
        got = grads[0][name]
        check(got is not None and torch.isfinite(got).all().item(),
              f"gradient of {name} on the card is missing or not finite")
        rel = ((got.cpu() - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        check(rel <= GRAD_RTOL, f"gradient of {name}: relative L2 {rel}")
        if rel > worst:
            worst, worst_name = rel, name
    log({"check": "grad_134m_f32_B1_S128", "params": len(grads[1]),
         "max_rel_l2": worst, "worst_param": worst_name})


def _train(model, ds, steps: int):
    from bigdl_tpu_torch.nn.criterion import FusedLMHeadCriterion
    from bigdl_tpu_torch.optim import AdamW, Optimizer, Trigger
    opt = (Optimizer(model, ds, FusedLMHeadCriterion(), device="cuda")
           .set_precision("bf16")
           .set_optim_method(AdamW(learningrate=TRAIN_LR,
                                   weightdecay=TRAIN_DECAY))
           .set_gradient_clipping_by_l2_norm(TRAIN_CLIP)
           .set_end_when(Trigger.max_iteration(steps)))
    opt.optimize()
    torch.cuda.synchronize()
    return opt.history


def lm_head_ce_peak_mib() -> float:
    """Peak device memory of the fused LM-head CE's forward and backward at
    the training shape (N = 8 x 512 rows, V=32000, E=768, bf16, the
    default chunk 16384), above what its inputs hold."""
    from bigdl_tpu_torch.ops.lm_head_ce import fused_lm_head_ce
    gen = torch.Generator(device="cuda").manual_seed(8)
    n, e = TRAIN_BATCH * TRAIN_SEQ, CONFIG["embed_dim"]
    h = torch.randn((n, e), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((VOCAB, e), generator=gen, device="cuda").to(torch.bfloat16)
    tgt = torch.randint(1, VOCAB + 1, (n,), generator=gen, device="cuda")
    h.requires_grad_()
    w.requires_grad_()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fused_lm_head_ce(h, w, None, tgt).backward()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def run_training() -> dict:
    """Phase 3b; returns the K1, K2, K3 launches of the 20-step run (all,
    and of the "mma" variants)."""
    from bigdl_tpu_torch.apps.transformer import synthetic_corpus
    from bigdl_tpu_torch.dataset.base import DataSet, SampleToBatch
    from bigdl_tpu_torch.models.transformer import build_lm
    from bigdl_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    model = build_lm(VOCAB, **CONFIG, device="cuda", seed=7)
    grad_check(model)
    log({"grad_check_s": time.perf_counter() - t0})
    samples = synthetic_corpus(TRAIN_BATCH * TRAIN_STEPS, TRAIN_SEQ, VOCAB,
                               seed=17)
    ds = DataSet.array(samples, seed=0) >> SampleToBatch(TRAIN_BATCH)
    counters = (fa.LAUNCHES, fa.LAUNCHES_MMA, fa.LAUNCHES_DQ,
                fa.LAUNCHES_DQ_MMA, fa.LAUNCHES_DKV, fa.LAUNCHES_DKV_MMA)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in counters:
        c.reset()
    t1 = time.perf_counter()
    history = _train(model, ds, TRAIN_STEPS)
    train_s = time.perf_counter() - t1
    k1, k1_mma, k2, k2_mma, k3, k3_mma = (c.value for c in counters)
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [h["loss"] for h in history]
    step_s = float(np.median([h["seconds"] for h in history[3:]]))
    want = CONFIG["num_layers"] * TRAIN_STEPS
    log({"train": "134m", "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
         "precision": "bf16", "optim": f"AdamW lr={TRAIN_LR} "
         f"decay={TRAIN_DECAY}", "clip_l2": TRAIN_CLIP, "losses": losses})
    log({"train_steps": len(losses), "train_s": train_s,
         "step_ms_median": step_s * 1e3,
         "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / step_s,
         "peak_allocated_mib": peak_mib, "k1_launches": k1,
         "k1_mma_launches": k1_mma, "k2_launches": k2,
         "k2_mma_launches": k2_mma, "k3_launches": k3,
         "k3_mma_launches": k3_mma})
    check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
          f"training losses {losses}")
    check(float(np.mean(losses[-5:])) < losses[0],
          f"loss did not fall: first {losses[0]}, last five {losses[-5:]}")
    check(k1 == k1_mma == k2 == k2_mma == k3 == k3_mma == want,
          f"training launched K1/K2/K3 {k1}/{k2}/{k3} times ({k1_mma}/"
          f"{k2_mma}/{k3_mma} of them mma), want {want}, all mma")

    # device busy share: kernel time over the wall time of 4 more steps;
    # None ("not measured") when the profiler recorded nothing
    extra = DataSet.array(samples[:4 * TRAIN_BATCH], seed=1) \
        >> SampleToBatch(TRAIN_BATCH)
    rows, wall = profiled(lambda: _train(model, extra, 4), "training steps")
    busy = None if rows is None else sum(t for _, t in rows) / 1e6 / wall
    top = ([] if rows is None else
           sorted(((k[:60], t / 4) for k, t in rows), key=lambda r: -r[1])[:6])
    log({"train_device_busy_share": busy, "profiled_steps": 4,
         "profiled_wall_s": wall, "top_kernels_us_per_step": top,
         "lm_head_ce_peak_mib": lm_head_ce_peak_mib()})
    del model
    torch.cuda.empty_cache()
    return {"flash_fwd": k1, "flash_fwd_mma": k1_mma, "flash_bwd_dq": k2,
            "flash_bwd_dq_mma": k2_mma, "flash_bwd_dkv": k3,
            "flash_bwd_dkv_mma": k3_mma}


# -------------------------------------------------------------- 3c. ResNet-50
RESNET_BATCH, RESNET_STEPS, AB_STEPS = 256, 20, 5
RESNET_LR, RESNET_MOMENTUM = 0.1, 0.9
RESNET_GRAD_BATCH = 8
RESNET_GRAD_SEED = 11
RESNET_LOSS_RTOL = 1e-5
GRAD_TRUTH_FACTOR = 2
EVAL_RTOL = 1e-4
FUSION_GATES = ("BIGDL_TPU_FUSED_1X1", "BIGDL_TPU_FUSED_3X3")
K5_PER_STEP, K6_PER_STEP = 36, 13
_CONV_BN_FIELDS = ("weight", "bias", "gamma", "beta", "running_mean",
                   "running_var")


def build_resnet50(fused: bool, device: str, seed: int):
    """``resnet.build(1000, 50)``, bench.py's resnet50 workload, with both
    fusion gates set (``fused``) or unset; the environment is restored."""
    from bigdl_tpu_torch.models import resnet
    saved = {g: os.environ.get(g) for g in FUSION_GATES}
    try:
        for g in FUSION_GATES:
            if fused:
                os.environ[g] = "1"
            else:
                os.environ.pop(g, None)
        return resnet.build(1000, 50, device=device, seed=seed)
    finally:
        for g, v in saved.items():
            if v is None:
                os.environ.pop(g, None)
            else:
                os.environ[g] = v


def state_units(model):
    """The model's state as ``(kind, {field: tensor})`` units in forward
    order, named alike whether or not conv+BN pairs are fused: every pair
    (a fused module, or a conv followed by a ``BatchNormalization``) is one
    ``"conv_bn"`` unit of ``_CONV_BN_FIELDS``; every other leaf module with
    parameters or buffers is a unit of its own, named by its class. Pairs
    are found by registration order, which is forward order in the ResNet
    builders."""
    from bigdl_tpu_torch.nn.fused import _FusedConvBN
    from bigdl_tpu_torch.nn.normalization import BatchNormalization
    leaves = [m for m in model.modules()
              if not m._modules and (m._parameters or m._buffers)]
    units, i = [], 0
    while i < len(leaves):
        m = leaves[i]
        nxt = leaves[i + 1] if i + 1 < len(leaves) else None
        if isinstance(m, _FusedConvBN):
            units.append(("conv_bn", {f: getattr(m, f) for f in _CONV_BN_FIELDS
                                      if hasattr(m, f)}))
            i += 1
        elif (not isinstance(m, BatchNormalization)
              and isinstance(nxt, BatchNormalization) and nxt.affine):
            unit = {"weight": m.weight, "gamma": nxt.weight, "beta": nxt.bias,
                    "running_mean": nxt.running_mean,
                    "running_var": nxt.running_var}
            if getattr(m, "with_bias", False):
                unit["bias"] = m.bias
            units.append(("conv_bn", unit))
            i += 2
        else:
            units.append((type(m).__name__,
                          {**dict(m.named_parameters()),
                           **dict(m.named_buffers())}))
            i += 1
    return units


def transfer_state(src, dst):
    """Copy every parameter and buffer of ``src`` into ``dst`` where the two
    models are the same network but one fuses conv+BN pairs that the other
    keeps apart (a ResNet built with and without the fusion gates): a
    ``FusedConv1x1BN``/``FusedConv3x3BN`` carries its conv weight (HWIO,
    the same layout), ``gamma``, ``beta`` and running statistics to and
    from a conv and the ``BatchNormalization`` after it. Shapes are checked
    before anything is written."""
    a, b = state_units(src), state_units(dst)
    if len(a) != len(b):
        raise ValueError(f"the models differ: {len(a)} and {len(b)} units "
                         "with state")
    pairs = []
    for (kind_a, ta), (kind_b, tb) in zip(a, b):
        if kind_a != kind_b or sorted(ta) != sorted(tb):
            raise ValueError(f"the models differ: {kind_a}{sorted(ta)} vs "
                             f"{kind_b}{sorted(tb)}")
        for f, t in ta.items():
            if t.shape != tb[f].shape:
                raise ValueError(f"{kind_a}.{f}: shape {tuple(t.shape)} vs "
                                 f"{tuple(tb[f].shape)}")
            pairs.append((tb[f], t))
    with torch.no_grad():
        for dst_t, src_t in pairs:
            dst_t.copy_(src_t)
    return dst


def imagenet_batch(b: int, seed: int):
    """bench.py's constant data: N(0, 1) NHWC images and 1-based labels."""
    from bigdl_tpu_torch.dataset.base import MiniBatch
    rng = np.random.default_rng(seed)
    return MiniBatch(rng.normal(0, 1, (b, 224, 224, 3)).astype(np.float32),
                     rng.integers(1, 1001, (b,)).astype(np.float32))


def conv_bn_counters():
    """K5's, K6's and K6's "mma" variant's launch counters."""
    from bigdl_tpu_torch.ops import conv3x3_bn, matmul_bn
    return matmul_bn.LAUNCHES, conv3x3_bn.LAUNCHES, conv3x3_bn.LAUNCHES_MMA


def _unit_state(model):
    """{name: gradient of a parameter, or a buffer} over every parameter
    and buffer, named by ``state_units`` so that a fused and an unfused
    model agree."""
    return {f"{i}:{kind}.{field}": (t.grad if t.requires_grad else t)
            for i, (kind, unit) in enumerate(state_units(model))
            for field, t in sorted(unit.items())}


def _rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    got, ref = got.detach().cpu().double(), ref.detach().cpu().double()
    return ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def resnet_grad_check(seed: int = RESNET_GRAD_SEED) -> dict:
    """ResNet-50, one f32 batch of RESNET_GRAD_BATCH images at 224x224,
    through four models that carry the same weights (built from ``seed``):
    the fused model on the card (K5 and K6); its CPU copy
    (``export_tree_state`` -> ``import_tree_state``), which takes the
    kernels' plain versions; the unfused model (gates unset, weights
    through ``transfer_state``) on the card, cuDNN convs and
    ``batch_norm_train``; and the unfused model on the CPU in f64, the
    reference that each f32 path is measured against. The f32 losses agree
    with the f64 one within RESNET_LOSS_RTOL; the card launches K5 and K6
    once per fused pair and the unfused model neither. Every gradient and
    updated running statistic of the fused model on the card is finite,
    and its relative L2 distance to the f64 reference is within GRAD_RTOL
    or within GRAD_TRUTH_FACTOR times the unfused card model's distance for
    the same tensor, whichever is larger: ResNet-50 at random init turns
    f32 rounding into percent-level gradient differences on every f32 path,
    so the library path's own distance to the truth is the scale the
    kernels' path is held to. Returns the readings."""
    from bigdl_tpu_torch.interop.state_dict import (export_tree_state,
                                                    import_tree_state)
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    card = build_resnet50(True, "cuda", seed=seed)
    cpu = build_resnet50(True, "cpu", seed=seed + 1)
    import_tree_state(cpu, *export_tree_state(card))
    plain_card = build_resnet50(False, "cuda", seed=seed + 2)
    truth = build_resnet50(False, "cpu", seed=seed + 3)
    for m in (plain_card, truth):
        transfer_state(card, m)
    truth.double()
    batch = imagenet_batch(RESNET_GRAD_BATCH, seed + 4)
    k5, k6, _ = conv_bn_counters()
    losses, states = [], []
    for m in (card, cpu, plain_card, truth):
        p = next(m.parameters())
        m.train()
        k5.reset()
        k6.reset()
        x = torch.as_tensor(batch.data, device=p.device).to(p.dtype)
        loss = ClassNLLCriterion()(m(x), torch.as_tensor(batch.labels,
                                                         device=p.device))
        loss.backward()
        losses.append(loss.item())
        states.append(_unit_state(m))
        want = ((K5_PER_STEP, K6_PER_STEP) if m is card else (0, 0))
        check((k5.value, k6.value) == want,
              f"the gradient run launched K5/K6 {k5.value}/{k6.value} times,"
              f" want {want}")
    for got in losses[:3]:
        rel = abs(got - losses[3]) / abs(losses[3])
        check(rel <= RESNET_LOSS_RTOL,
              f"ResNet-50 losses {losses} (fused card, fused CPU, unfused "
              f"card, f64): {rel}")
    fused, fused_cpu, lib, ref = states
    dist = {f"{path}_{kind}": [] for path in ("fused_card", "fused_cpu_f32",
                                              "unfused_card")
            for kind in ("grads", "running_stats")}
    over, worst, by_depth = [], {"ratio": 0.0, "name": ""}, []
    for name, want in ref.items():
        got = fused[name]
        check(got is not None and torch.isfinite(got).all().item(),
              f"{name} on the card is missing or not finite")
        d_f, d_u = _rel_l2(got, want), _rel_l2(lib[name], want)
        kind = "running_stats" if "running_" in name else "grads"
        dist[f"fused_card_{kind}"].append(d_f)
        dist[f"fused_cpu_f32_{kind}"].append(_rel_l2(fused_cpu[name], want))
        dist[f"unfused_card_{kind}"].append(d_u)
        if name.endswith("conv_bn.weight") or "Linear" in name:
            by_depth.append((name, d_u))
        if d_f > max(GRAD_RTOL, GRAD_TRUTH_FACTOR * d_u):
            over.append((name, d_f, d_u))
        ratio = d_f / max(d_u, GRAD_RTOL)
        if ratio > worst["ratio"]:
            worst.update(ratio=ratio, name=name)
    readings = {"check": f"grad_resnet50_f32_B{RESNET_GRAD_BATCH}_vs_f64",
                "seed": seed, "tensors": len(ref),
                "losses_fused_card_fused_cpu_unfused_card_f64": losses,
                **{f"{k}_rel_l2_median": float(np.median(v))
                   for k, v in dist.items()},
                **{f"{k}_rel_l2_max": max(v) for k, v in dist.items()},
                "max_ratio_fused_over_unfused_card": worst["ratio"],
                "worst_ratio_tensor": worst["name"],
                # the unfused card model's weight-gradient distance from the
                # stem (first) to the head (last): every eighth conv, the
                # last conv and the head's Linear
                "unfused_card_weight_grad_by_depth":
                    by_depth[::8] + by_depth[-3:],
                "fused_card_vs_fused_cpu_rel_l2_median": float(np.median(
                    [_rel_l2(fused[n], fused_cpu[n]) for n in ref]))}
    log(readings)
    check(not over, f"{len(over)} tensors of the fused card model are further"
          f" than {GRAD_TRUTH_FACTOR}x the unfused card model from the f64 "
          f"reference, e.g. (name, fused, unfused): {over[:3]}")
    return readings


def train_resnet(model, batch, steps: int):
    """bench.py's recipe through ``Optimizer``: ``ClassNLLCriterion``,
    SGD(0.1, momentum 0.9), bf16 compute over f32 masters; the dataset is
    the one constant batch, ``steps`` times."""
    from bigdl_tpu_torch.dataset.base import DataSet
    from bigdl_tpu_torch.nn.criterion import ClassNLLCriterion
    from bigdl_tpu_torch.optim import SGD, Optimizer, Trigger
    opt = (Optimizer(model, DataSet.array([batch] * steps, seed=0),
                     ClassNLLCriterion(), device="cuda")
           .set_precision("bf16")
           .set_optim_method(SGD(learningrate=RESNET_LR,
                                 momentum=RESNET_MOMENTUM))
           .set_end_when(Trigger.max_iteration(steps)))
    opt.optimize()
    torch.cuda.synchronize()
    return opt.history


def profile_steps(model, batch, what: str) -> dict:
    """Device busy share, the top five kernels and the fused kernels' time
    (K6: ``conv3x3_stats``, K5: ``matmul_stats``, and the statistics pass
    both share, ``column_reduce``) over two more steps; None ("not
    measured") when the profiler recorded nothing."""
    rows, wall = profiled(lambda: train_resnet(model, batch, 2), what)
    if rows is None:
        return {"device_busy_share": None, "top_kernels_ms_per_step": []}
    per_step = sorted(((k[:70], t / 2e3) for k, t in rows),
                      key=lambda r: -r[1])
    layout = [(k, ms) for k, ms in per_step
              if any(w in k.lower() for w in ("copy", "nchw", "nhwc",
                                               "transpose"))]
    fused = {part: sum(t for k, t in rows if part in k) / 2e3
             for part in ("conv3x3_stats", "matmul_stats", "column_reduce")}
    return {"device_busy_share": sum(t for _, t in rows) / 1e6 / wall,
            "kernel_ms_per_step": sum(t for _, t in rows) / 2e3,
            "top_kernels_ms_per_step": per_step[:5],
            "fused_kernels_ms_per_step": fused,
            "copy_and_layout_kernels_ms_per_step": layout[:6]}


def run_resnet() -> dict:
    """Phase 3c; returns the K5 and K6 launches of the 20-step run."""
    from bigdl_tpu_torch.nn.conv import SpatialConvolution
    t0 = time.perf_counter()
    resnet_grad_check()
    log({"resnet_grad_check_s": time.perf_counter() - t0})
    batch = imagenet_batch(RESNET_BATCH, 5)
    t1 = time.perf_counter()
    torch.as_tensor(batch.data).pin_memory().to("cuda", non_blocking=True)
    torch.cuda.synchronize()
    log({"batch_mib": batch.data.nbytes / 2 ** 20,
         "pin_and_copy_ms": (time.perf_counter() - t1) * 1e3})

    model = build_resnet50(True, "cuda", seed=7)
    k5, k6, k6_mma = conv_bn_counters()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for c in (k5, k6, k6_mma):
        c.reset()
    history = train_resnet(model, batch, RESNET_STEPS)
    launches = {"matmul_bn": k5.value, "conv3x3_bn": k6.value,
                "conv3x3_bn_mma": k6_mma.value}
    peak_mib = torch.cuda.max_memory_allocated() / 2 ** 20
    losses = [h["loss"] for h in history]
    # the last iteration's interval is cut short: its loss is fetched right
    # after the one before it
    step_s = float(np.median([h["seconds"] for h in history[5:-1]]))
    log({"train": "resnet50", "batch": RESNET_BATCH, "precision": "bf16",
         "optim": f"SGD lr={RESNET_LR} momentum={RESNET_MOMENTUM}",
         "fused": True, "losses": losses})
    fused = {"step_ms_median": step_s * 1e3,
             "images_per_s": RESNET_BATCH / step_s,
             "peak_allocated_mib": peak_mib}
    check(len(losses) == RESNET_STEPS and all(np.isfinite(losses)),
          f"ResNet-50 losses {losses}")
    check(float(np.mean(losses[-5:])) < losses[0],
          f"ResNet-50 loss did not fall: first {losses[0]}, last five "
          f"{losses[-5:]}")
    want = {"matmul_bn": K5_PER_STEP * RESNET_STEPS,
            "conv3x3_bn": K6_PER_STEP * RESNET_STEPS,
            "conv3x3_bn_mma": K6_PER_STEP * RESNET_STEPS}
    check(launches == want, f"training launched {launches}, want {want}")
    for name, buf in model.named_buffers():
        start = 0.0 if name.endswith("running_mean") else 1.0
        check(torch.isfinite(buf).all().item()
              and (buf - start).abs().max().item() > 0,
              f"running statistic {name} is not finite or did not move")

    # the trained fused model in eval mode (BN folded, no kernel) against
    # the unfused model carrying the same weights and buffers, within
    # EVAL_RTOL of max(1, max|log-prob|): f32 convs of folded or unfolded
    # weights (an H100 run measured 4.3e-5 at max|log-prob| 17.3)
    plain = build_resnet50(False, "cuda", seed=8)
    transfer_state(model, plain)
    x = torch.as_tensor(batch.data[:8], device="cuda")
    model.eval()
    plain.eval()
    with torch.no_grad():
        got, ref = model(x), plain(x)
    eval_err = (got - ref).abs().max().item()
    check(got.shape == (x.shape[0], 1000) and torch.isfinite(got).all().item()
          and eval_err <= EVAL_RTOL * max(1.0, ref.abs().max().item()),
          f"eval: fused vs unfused log-probs differ by {eval_err}")
    log({"check": "resnet50_eval_fused_vs_unfused_f32",
         "max_abs_err": eval_err, "max_abs_ref": ref.abs().max().item()})
    model.train()
    plain.train()
    fused.update(profile_steps(model, batch, "resnet50 fused steps"))
    del model
    torch.cuda.empty_cache()

    # the A/B: the reference's default path (cuDNN convs + batch_norm_train)
    torch.cuda.reset_peak_memory_stats()
    k5.reset()
    k6.reset()
    hist = train_resnet(plain, batch, AB_STEPS + 4)
    check((k5.value, k6.value) == (0, 0), "the unfused path launched K5/K6")
    step_u = float(np.median([h["seconds"] for h in hist[3:-1]]))
    unfused = {"step_ms_median": step_u * 1e3,
               "images_per_s": RESNET_BATCH / step_u,
               "peak_allocated_mib": torch.cuda.max_memory_allocated()
               / 2 ** 20,
               "losses": [h["loss"] for h in hist]}
    unfused.update(profile_steps(plain, batch, "resnet50 unfused steps"))
    # a plain conv's NHWC input is a channels-last view and its output
    # comes back NHWC-contiguous: no copy around cuDNN
    conv = next(m for m in plain.modules()
                if isinstance(m, SpatialConvolution) and m.kernel_h == 3)
    xin = torch.randn(32, 56, 56, conv.n_input_plane, device="cuda")
    with torch.no_grad():
        out = conv(xin)
    layout = {"input_view_channels_last": xin.permute(0, 3, 1, 2)
              .is_contiguous(memory_format=torch.channels_last),
              "output_nhwc_contiguous": out.is_contiguous()}
    log({"ab": "resnet50_train_bf16_B256", "fused_k5_k6": fused,
         "unfused_cudnn": unfused, "plain_conv_layout": layout})
    del plain
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------ 4a. HBM roof
def run_roofline():
    """Phase 4a: the probe's ``main`` at 1 GiB with every family and one
    calibration, its K7 launch counts against the counts its chains
    predict, and every rate within the data sheet's. Returns (the probe's
    result, the launches)."""
    from bigdl_tpu_torch.ops import hbm_roof as hr
    from bigdl_tpu_torch.scripts import roofline_hbm as probe
    torch.cuda.empty_cache()
    for c in hr.COUNTERS.values():
        c.reset()
    t0 = time.perf_counter()
    res = probe.main(["--gib", str(HBM_PROBE_BYTES / 2 ** 30),
                      "--calibration-tries", "1"])
    seconds = time.perf_counter() - t0
    launches = {name: c.value for name, c in hr.COUNTERS.items()}
    p = probe.PASSES_PER_READING
    want = {"hbm_copy": p * len(probe.AUTO_SWEEP),
            "hbm_read": p * len(probe.AUTO_SWEEP),
            "hbm_triad": p * len(probe.AUTO_SWEEP),
            "hbm_staged_copy": p * len(probe.MANUAL_SWEEP),
            "hbm_direct_copy": p * sum(probe.DMA_STREAMS)}
    check(launches == want, f"the probe launched {launches}, want {want}")
    rates = [r[k] for fam in ("auto", "manual", "hbm_dma", "eager", "library")
             for r in (res[fam] if isinstance(res[fam], list) else [res[fam]])
             for k in r if k.endswith("_gbps")]
    # no stream can beat the memory's own rate: a reading above it is a
    # fault of the timing
    check(all(r is not None and 0 < r <= 1.01 * HBM_BYTES_PER_S / 1e9
              for r in rates),
          f"the probe read a rate that is not positive or is above the data "
          f"sheet's {HBM_BYTES_PER_S / 1e9} GB/s: {rates}")
    log({"roofline": {"probe_s": seconds, "launches": launches,
                      "roof_gbps": res["roof_gbps"], "roof_from": res["roof_from"],
                      "library_copy_gbps": res["library_copy_gbps"]}})
    torch.cuda.empty_cache()
    return res, launches


LIBRARY_CALLS = {"copy": "Tensor.copy_",
                 "read": "torch.sum(x, dtype=float32), the seed's add left out",
                 "triad": "torch.add(a, b, alpha=2)"}


def hbm_roof_rows(res: dict, launches: dict, errs: dict) -> list:
    """K7's rows of the ``kernels`` line from the probe's run: for each
    kernel the best reading of its sweep as ``ms`` (one pass over 1 GiB),
    the eager chain as ``plain_ms`` and one PyTorch call as
    ``library_ms``."""
    from bigdl_tpu_torch.scripts.roofline_hbm import hbm_dma_shape
    total = res["total_bytes"]
    n = total // 2
    ref = "scripts/roofline_pallas.py"
    best = lambda readings, key: max(readings, key=lambda r: r[f"{key}_gbps"])
    dma = best(res["hbm_dma"], "copy")
    dma_rows, lanes = hbm_dma_shape(total, dma["nstreams"])  # trimmed
    entries = []
    for name, reading, key, replaces, nbytes, ops, how in (
            ("hbm_copy", best(res["auto"], "copy"), "copy", f"{ref}:108",
             2 * n * 2, 0,
             "block (threads x 16-byte vectors) {block}, {grid} grid"),
            ("hbm_read", best(res["auto"], "read"), "read", f"{ref}:108",
             n * 2, n, "block {block}, {grid} grid"),
            ("hbm_triad", best(res["auto"], "triad"), "triad", f"{ref}:108",
             3 * n * 2, 2 * n, "block {block}, {grid} grid"),
            ("hbm_staged_copy", best(res["manual"], "copy"), "copy",
             f"{ref}:205", 2 * n * 2, 0, "chunk {block}, nbuf {nbuf}"),
            ("hbm_direct_copy", dma, "copy", f"{ref}:243",
             2 * dma_rows * lanes * 2, 0, "nstreams {nstreams}")):
        entries.append({
            "name": name, "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/hbm_roof.cu", "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": reading[f"{key}_ms"], "plain_ms": res["eager"][f"{key}_ms"],
            **bound(nbytes, ops), "library_ms": res["library"][f"{key}_ms"],
            "gbps": reading[f"{key}_gbps"],
            "work": f"one {key} pass over {total / 2 ** 30:g} GiB of bf16 "
                    f"(n = {n}), the best of the probe's sweep: "
                    + how.format(**reading) + "; plain_ms: eager PyTorch; "
                    "library_ms: " + LIBRARY_CALLS[key]})
    return entries


# ----------------------------------------------------------------- 4. timing
def _time_flash_shape(b: int, s: int, seed: int) -> dict:
    """K1 at one causal bf16 shape (N=12, D=64): checked once more against
    its plain version, then its device time, its plain version's and
    ``scaled_dot_product_attention``'s, and its bound."""
    from bigdl_tpu_torch.ops.flash_attention import (flash_attention_plain,
                                                     flash_attention_with_lse)
    n, d = CONFIG["num_heads"], 64
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = _qkv(gen, b, s, s, n, d, torch.bfloat16)
    o, lse = flash_attention_with_lse(q, k, v, causal=True)
    po, plse = flash_attention_plain(q, k, v, causal=True)
    err, ok = flash_o_close(o, po)
    err_l = (lse - plse).abs().max().item()
    check(ok and err_l <= FLASH_ATOL,
          f"flash at the timed shape B={b} S={s}: |dO|={err} |dLSE|={err_l}")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kernel = lambda: flash_attention_with_lse(q, k, v, causal=True)
    what = f"flash_fwd B={b} S={s}"
    ms = graph_ms(kernel, what, per_graph=50)
    plain_ms = graph_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                        f"{what} plain", per_graph=5)
    library_ms = graph_ms(lambda: sdpa(qt, kt, vt, is_causal=True),
                          f"{what} library", per_graph=50)
    nbytes = 4 * b * s * n * d * 2 + b * n * s * 4   # q, k, v, o; lse f32
    ops = 4 * b * n * d * (s * (s + 1) // 2)         # causal (q, k) pairs
    return {"ms": ms, "plain_ms": plain_ms, **bound(nbytes, ops),
            "library_ms": library_ms, "max_abs_err": err,
            "shape": f"causal bf16 B={b} S={s} N={n} D={d}"}


def time_flash(launches: dict) -> dict:
    """K1's row: the served prefill shape (B=4, S=384) as the row's numbers
    and the training shape (B=8, S=512) beside them as ``train``."""
    served = _time_flash_shape(REQUESTS_PER_LEN, PROMPT_LENS[0], 3)
    train = _time_flash_shape(TRAIN_BATCH, TRAIN_SEQ, 13)
    return {"name": "flash_fwd", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/flash_fwd.cu",
            "replaces": "bigdl_tpu/ops/flash_attention.py:104",
            "launches": launches["flash_fwd"],
            "launches_mma": launches["flash_fwd_mma"],
            "max_abs_err": served["max_abs_err"], "ms": served["ms"],
            "plain_ms": served["plain_ms"],
            **{k: served[k] for k in ("bound_ms", "bound_by", "bytes",
                                      "operations")},
            "library_ms": served["library_ms"], "variant": "mma",
            "work": f"one prefill launch, {served['shape']}; library_ms: "
                    "scaled_dot_product_attention; launches: serving and "
                    f"training runs together; train: {train['shape']}",
            "train": train}


def time_flash_bwd(launches: dict) -> list:
    """K2 and K3 at the training shape (bf16, causal, so their "mma"
    variants, which phase 3b counts): one launch each, its plain version,
    and the backward of ``scaled_dot_product_attention``
    (one call for dQ, dK and dV, so the same number on both rows), timed
    as its forward and backward in one graph less its forward alone."""
    from bigdl_tpu_torch.ops.flash_attention import (
        bwd_delta, flash_attention_with_lse, flash_bwd_dkv,
        flash_bwd_dkv_plain, flash_bwd_dq, flash_bwd_dq_plain)
    b, s, n, d = TRAIN_BATCH, TRAIN_SEQ, CONFIG["num_heads"], 64
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = _qkv(gen, b, s, s, n, d, torch.bfloat16)
    g_o = torch.randn(q.shape, generator=gen, device="cuda").to(torch.bfloat16)
    with torch.no_grad():
        o, lse = flash_attention_with_lse(q, k, v, causal=True)
    args = (q, k, v, g_o, lse, bwd_delta(o, g_o, None), True, 1.0 / d ** 0.5)
    dq, (dk, dv) = flash_bwd_dq(*args), flash_bwd_dkv(*args)
    pdq, (pdk, pdv) = flash_bwd_dq_plain(*args), flash_bwd_dkv_plain(*args)
    errs = {}
    for name, got, ref in (("dq", dq, pdq), ("dk", dk, pdk), ("dv", dv, pdv)):
        errs[name], _, ok = bwd_close(got, ref)
        check(ok, f"flash bwd {name} at the timed shape: |err| {errs[name]}")
    ms_dq = graph_ms(lambda: flash_bwd_dq(*args), "flash_bwd_dq")
    ms_dkv = graph_ms(lambda: flash_bwd_dkv(*args), "flash_bwd_dkv")
    plain_dq = graph_ms(lambda: flash_bwd_dq_plain(*args),
                        "flash_bwd_dq plain", per_graph=3, replays=3)
    plain_dkv = graph_ms(lambda: flash_bwd_dkv_plain(*args),
                         "flash_bwd_dkv plain", per_graph=3, replays=3)
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    g_t = g_o.transpose(1, 2)
    sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True)
    fwd_ms = graph_ms(sdpa, "flash_bwd library forward")
    fwd_bwd_ms = graph_ms(lambda: torch.autograd.grad(sdpa(), (qt, kt, vt),
                                                      g_t),
                          "flash_bwd library forward and backward")
    library_ms = fwd_bwd_ms - fwd_ms
    log({"flash_bwd_library_ms": {"forward": fwd_ms,
                                  "forward_and_backward": fwd_bwd_ms}})
    bsnd, bns = b * s * n * d, b * n * s
    pairs = b * n * s * (s + 1) // 2                 # causal (q, k) pairs
    reads = 4 * bsnd * 2 + 2 * bns * 4               # q, k, v, dO; lse, delta
    dq_bound = bound(reads + bsnd * 2, 3 * 2 * d * pairs)
    dkv_bound = bound(reads + 2 * bsnd * 2, 4 * 2 * d * pairs)
    work = f"one causal backward launch, bf16 B={b} S={s} N={n} D={d}"
    lib_note = ("library_ms: the backward of scaled_dot_product_attention, "
                "one call for dQ, dK and dV (its forward and backward "
                "less its forward)")
    return [{"name": "flash_bwd_dq", "route": "cuda",
             "source": "bigdl_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "bigdl_tpu/ops/flash_attention.py:146",
             "launches": launches["flash_bwd_dq"],
             "launches_mma": launches["flash_bwd_dq_mma"],
             "max_abs_err": errs["dq"],
             "ms": ms_dq, "plain_ms": plain_dq, **dq_bound,
             "library_ms": library_ms, "variant": "mma",
             "work": f"{work}; {lib_note}"},
            {"name": "flash_bwd_dkv", "route": "cuda",
             "source": "bigdl_tpu_torch/csrc/flash_bwd.cu",
             "replaces": "bigdl_tpu/ops/flash_attention.py:186",
             "launches": launches["flash_bwd_dkv"],
             "launches_mma": launches["flash_bwd_dkv_mma"],
             "max_abs_err": max(errs["dk"], errs["dv"]),
             "ms": ms_dkv, "plain_ms": plain_dkv, **dkv_bound,
             "library_ms": library_ms, "variant": "mma",
             "work": f"{work}; {lib_note}"}]


def time_int8(twin, launches: int) -> dict:
    from bigdl_tpu_torch.ops.int8_matmul import (int8_matmul_kernel,
                                                 int8_matmul_plain)
    m = REQUESTS_PER_LEN
    enc = twin[1]
    e, ekv = CONFIG["embed_dim"], twin[1].layer0.self_attn._e_kv
    weights = []
    for i in range(enc.num_layers):
        layer = enc._modules[f"layer{i}"]
        a = layer.self_attn
        wq, sq = a.in_proj_weight_q, a.in_proj_weight_scale
        weights += [(wq[:e], sq[:e]), (wq[e:e + ekv], sq[e:e + ekv]),
                    (wq[e + ekv:], sq[e + ekv:]),
                    (a.out_proj_weight_q, a.out_proj_weight_scale)]
        weights += [(lin.weight_q, lin.weight_scale) for lin in
                    (layer.linear1, layer.linear_gate, layer.linear2)]
    weights.append((twin[0].weight_q, twin[0].weight_scale))
    gen = torch.Generator(device="cuda").manual_seed(4)
    calls = [(torch.randn((m, w.shape[1]), generator=gen, device="cuda")
              .to(torch.bfloat16), w, s.reshape(-1).contiguous())
             for w, s in weights]
    deq = [(w.float() * s[:, None]).to(torch.bfloat16) for _, w, s in calls]
    err = 0.0
    for x, w, s in calls:
        y, ref = int8_matmul_kernel(x, w, s), int8_matmul_plain(x, w, s)
        e, tol = (y - ref).abs().max().item(), INT8_RTOL * ref.abs().max().item()
        check(e <= tol, f"int8 at the served shape M={x.shape[0]} "
                        f"O={w.shape[0]} K={w.shape[1]}: err {e} > {tol}")
        err = max(err, e)

    def kernel():
        for x, w, s in calls:
            int8_matmul_kernel(x, w, s)

    def plain():
        for x, w, s in calls:
            int8_matmul_plain(x, w, s)

    def library():
        for (x, _, _), wd in zip(calls, deq):
            x @ wd.T

    ms = graph_ms(kernel, "int8_matmul")
    plain_ms = graph_ms(plain, "int8_matmul plain", per_graph=3, replays=3)
    library_ms = graph_ms(library, "int8_matmul library")
    nbytes = sum(x.numel() * 2 + w.numel() + s.numel() * 4
                 + x.shape[0] * w.shape[0] * 4 for x, w, s in calls)
    ops = sum(2 * x.shape[0] * w.numel() for x, w, _ in calls)
    shapes = {}
    for (x, w, s), wd in zip(calls, deq):
        key = f"{w.shape[0]}x{w.shape[1]}"
        if key not in shapes:
            one = graph_ms(lambda: int8_matmul_kernel(x, w, s),
                           f"int8_matmul {key}", per_graph=50)
            lib_one = graph_ms(lambda: x @ wd.T, f"int8_matmul {key} library",
                               per_graph=50)
            shapes[key] = {"ms": one, "library_ms": lib_one, "bound_ms": bound(
                w.numel() + x.numel() * 2 + s.numel() * 4
                + x.shape[0] * w.shape[0] * 4,
                2 * x.shape[0] * w.numel())["bound_ms"]}
    log({"int8_shapes_M4": shapes})
    return {"name": "int8_matmul", "route": "cuda",
            "source": "bigdl_tpu_torch/csrc/int8_matmul.cu",
            "replaces": "bigdl_tpu/ops/int8_matmul.py:92",
            "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, **bound(nbytes, ops),
            "library_ms": library_ms,
            "work": f"one int8 decode token: {len(calls)} launches at M={m}, "
                    f"{sum(w.numel() for _, w, _ in calls)} weight bytes"}


def _time_stats_kernel(name, kernel, plain, library, x, w, nbytes, ops):
    """One fused-statistics kernel at one shape: checked once more against
    its plain version, then its device time, its plain version's, and the
    library's product and one fused reduction of the product's two sums
    (``torch.var_mean``: one read of y, the same information), each by
    ``graph_ms``."""
    got, ref = kernel(x, w), plain(x, w)
    torch.cuda.synchronize()
    err, _, ok = y_close(got[0], ref[0])
    _, st_ok = stats_close(got[1:], ref[1:], ref[0])
    check(ok and st_ok, f"{name} at the timed shape: |y err| {err}")
    del got, ref
    y = library(x, w)
    y2d = y.reshape(-1, y.shape[-1])
    ms = graph_ms(lambda: kernel(x, w), name)
    plain_ms = graph_ms(lambda: plain(x, w), f"{name} plain", per_graph=3,
                        replays=3)
    product_ms = graph_ms(lambda: library(x, w), f"{name} library")
    reduce_ms = graph_ms(lambda: torch.var_mean(y2d, dim=0, correction=0),
                         f"{name} library reduction")
    return {"ms": ms, "plain_ms": plain_ms, **bound(nbytes, ops),
            "library_ms": product_ms + reduce_ms,
            "library_product_ms": product_ms,
            "library_reduction_ms": reduce_ms, "max_abs_err": err}


def time_conv_bn(launches: dict) -> list:
    """K5 and K6 in bf16 at B=256: the largest-M shape (stage 1) as the
    entry's numbers and the deepest one (stage 4) beside them. The bound
    counts x, w and y in bf16 and the two f32 sums once each, and
    2 * M * K * N (K6: 2 * N * H * W * 9 * Cin * Cout) operations."""
    from bigdl_tpu_torch.ops.conv3x3_bn import (_conv3x3,
                                                conv3x3_with_stats_kernel,
                                                conv3x3_with_stats_plain)
    from bigdl_tpu_torch.ops.matmul_bn import (matmul_with_stats_kernel,
                                               matmul_with_stats_plain)
    gen = torch.Generator(device="cuda").manual_seed(12)
    bf16 = torch.bfloat16
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    b = RESNET_BATCH
    k5 = {}
    for stage, (m, k, n) in (("stage1", (b * 56 * 56, 64, 256)),
                             ("stage4", (b * 7 * 7, 512, 2048))):
        x, w = rnd(m, k).to(bf16), (rnd(k, n) / k ** 0.5).to(bf16)
        k5[stage] = _time_stats_kernel(
            f"matmul_bn {stage}", matmul_with_stats_kernel,
            matmul_with_stats_plain, lambda x, w: x @ w, x, w,
            2 * (m * k + k * n + m * n) + 8 * n, 2 * m * k * n)
        k5[stage]["shape"] = f"M={m} K={k} N={n} bf16"
    k6 = {}
    for stage, (h, c) in (("stage1", (56, 64)), ("stage4", (7, 512))):
        x, w = rnd(b, h, h, c).to(bf16), (rnd(3, 3, c, c) / (3 * c ** 0.5)
                                          ).to(bf16)
        k6[stage] = _time_stats_kernel(
            f"conv3x3_bn {stage}", conv3x3_with_stats_kernel,
            conv3x3_with_stats_plain, _conv3x3, x, w,
            2 * (2 * b * h * h * c + 9 * c * c) + 8 * c,
            2 * b * h * h * 9 * c * c)
        k6[stage]["shape"] = f"N={b} {h}x{h} {c}->{c} bf16"
    entries = []
    for name, src, ref, per, lib in (
            ("matmul_bn", "matmul_bn.cu", "bigdl_tpu/ops/matmul_bn.py:67", k5,
             "x @ w (cuBLAS) + torch.var_mean of y"),
            ("conv3x3_bn", "conv3x3_bn.cu", "bigdl_tpu/ops/conv3x3_bn.py:68",
             k6, "F.conv2d (cuDNN) + torch.var_mean of y")):
        main = per["stage1"]
        entries.append({
            "name": name, "route": "cuda",
            "source": f"bigdl_tpu_torch/csrc/{src}", "replaces": ref,
            "launches": launches[name], "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            **{k: main[k] for k in ("bound_ms", "bound_by", "bytes",
                                    "operations")},
            "library_ms": main["library_ms"],
            "library_product_ms": main["library_product_ms"],
            "library_reduction_ms": main["library_reduction_ms"],
            "work": f"one launch at the stage-1 shape, {main['shape']}; "
                    f"library_ms: {lib}; launches: the 20-step ResNet-50 "
                    "training run",
            "stage4": per["stage4"]})
    k6_row = entries[1]
    k6_row.update({"launches_mma": launches["conv3x3_bn_mma"],
                   "variant": "mma"})
    log({"conv_bn_timing": {"matmul_bn": k5, "conv3x3_bn": k6}})
    return entries


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--resnet-grad-seeds", type=int, nargs="+", metavar="SEED",
        help="run only the kernels' build and phase 3c's ResNet-50 gradient "
             "check against the f64 reference, once per seed, and print "
             "each seed's readings (no result line)")
    parser.add_argument(
        "--time-kernels-of", metavar="DIR",
        help="import bigdl_tpu_torch from DIR (e.g. an unpacked earlier "
             "commit), build its kernels, time K1, K2, K3, K5 and K6 as "
             "phase 4 does and print the rows (no result line)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if args.time_kernels_of:
        sys.path.insert(0, os.path.abspath(args.time_kernels_of))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    card = environment()
    if args.time_kernels_of:
        import bigdl_tpu_torch
        none = collections.defaultdict(int)
        rows = [time_flash(none), *time_flash_bwd(none), *time_conv_bn(none)]
        for row in rows:  # the counts and the variant describe a main path
            for key in ("launches", "launches_mma", "variant"):
                row.pop(key, None)
        log({"timed_package": os.path.dirname(bigdl_tpu_torch.__file__),
             "card": card, "total_s": time.perf_counter() - t0,
             "kernels_timed": rows})
        return 0
    if args.resnet_grad_seeds:
        failed = []
        for seed in args.resnet_grad_seeds:
            try:
                resnet_grad_check(seed)
            except RuntimeError as e:  # every seed is read; raised below
                log({"seed": seed, "failed": str(e)})
                failed.append(seed)
        log({"total_s": time.perf_counter() - t0, "card": card})
        check(not failed, f"the gradient check failed for seeds {failed}")
        return 0
    check_flash()
    check_flash_bwd()
    check_int8()
    check_conv_bn()
    check_conv_bn_autograd()
    hbm_errs = check_hbm_roof()
    int8_twin, launches = run_slice()
    train_launches = run_training()
    resnet_launches = run_resnet()
    roof, roof_launches = run_roofline()
    kernels = [time_flash({k: launches[k] + train_launches[k]
                           for k in ("flash_fwd", "flash_fwd_mma")}),
               *time_flash_bwd(train_launches),
               time_int8(int8_twin, launches["int8_matmul"]),
               *time_conv_bn(resnet_launches),
               *hbm_roof_rows(roof, roof_launches, hbm_errs)]
    for entry in kernels:
        add_measured_bound(entry, roof["roof_gbps"] * 1e9)
    log({"total_s": time.perf_counter() - t0})
    print(card, flush=True)
    log({"kernels": kernels})
    log({"ok": True, "device": {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
