#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (ferrum_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order, each printing JSON lines:
  env        nvidia-smi name/power limit, torch / CUDA / nvcc versions
  build      nvcc build of every kernel source (seconds)
  kernels    each Hopper kernel against its plain PyTorch version at the
             shapes of the served paths (llama-3.1-8b projections,
             qwen3-30b-a3b projections and expert stacks; the unwired
             w4a8tl_prefill_mcache at the llama prefill shapes, beside
             w4a8tl_prefill on the same weights and activations): exact
             equality for the integer-dot kernels, one bf16 step for the
             two w4a16 ones; kernel / plain / library times (CUDA events)
             and the card's bound for the same work, each decode-size
             w4a16 case with its launch plan; then exact cases of their
             own: one-hot x for the w4a16 kernels at prefill and decode
             sizes (m = 1 .. 64, K = 14336, forced K splits starting
             mid-group; 8 and 256 grouped rows over 3 and 128 experts),
             bf16 and f32 scales, for the two
             two-level prefill kernels ragged m, the qwen3 sites, the
             int32 range at K = 14336 and one-hot xq, for the two two-level
             decode kernels one-hot xq at m = 1 .. 64, the int32 range,
             K = 256, one, three (a split starting mid-group) and the
             most K splits, N = 192 (64-column tiles) and the wrap case
             at one and the most splits, the split-K counters zero after
             each, for the float-scale decode kernel (its timed cases
             with their plans) one-hot xq at m = 1 .. 64, the integer
             range at K = 14336, gpt 1 and 2, forced K splits (more than
             the TPU steps too) and N = 192, bf16 and f32 scales, the
             counters zero after each, for the all-experts bmm one-hot
             xq on shared and on
             each expert's own rows (3 and 128 experts; t = 1 .. 64),
             the int32 range, K = 256 and N = 192, each with its launch
             plan, for the
             grouped two-level kernel at 128-row tiles one-hot xq, one
             expert, four experts, ragged rows and K = 256, and at decode
             sizes (the expert-grid loop, each with its plan) one-hot xq
             at 8 / 120 / 256 rows, experts over BM rows, one expert
             holding all rows and K = 256; kv_append_rows one array and
             K with V in one launch (bf16, f32, int8), the pair timed
             beside an empty kernel's launch, and K with V at a decode
             window's size (lane A at bucket 32 with a 256-token chunk
             riding it: 16384 rows x 2 KiB each), the summary's row
  sampling   sample_step's candidate pick (topk_ids: lower ids first among
             ties, as jax.lax.top_k) at 32 slots x 128256 against a full
             stable sort, timed beside both and torch.topk
  attention  the bf16 decode and prefill attention at the served shapes
             against the same function on the CPU, which takes every
             product and sum in f32 (the JAX package's precision)
Then, for each of five lanes at full width and depth (lane D at 12 of
its 48 layers, for the run's time: see LANES) -- A llama-3.1-8b
and B qwen3-30b-a3b with two-level w4a8 weights (serve, logits;
serve_moe, logits_moe), C llama-3.1-8b float-scale w4a8
(EngineConfig(w4a8_two_level=False); serve_fs, logits_fs, profile_fs),
D qwen3-30b-a3b w4a16 (EngineConfig(w4a8=False); serve_moe_w4a16,
logits_moe_w4a16, profile_moe_w4a16), C and D on the same random weights
with the two-level fields dropped, the form an int4 checkpoint loads as,
and E llama-3.1-8b two-level in the group-dot decode mode
(EngineConfig(w4a8_gd="all"); serve_gd, logits_gd) on A's weights
(B's and E's profile phases are left out to keep the run inside its
time):
  serve      EngineBuilder(model, random int4 weights, seed 0) with
             bench.py's engine settings (lane buckets 1, 8, 32; T = 32 at
             bucket 1, 8 elsewhere; the pipelined loop, mixed prefill and
             refill-first, the defaults), 32 concurrent greedy 256/128
             requests; launch counts of every kernel over that run, each
             of the lane's kernels required, every other kernel required
             to stay at 0; windows by bucket, mixed windows, the most
             windows in flight, kv_append_rows launches a window; E's
             solo request must give A's tokens (its decode kernel
             computes A's function bit for bit). Lane A's run dispatches
             under torch.cuda.set_sync_debug_mode("error"): a host sync
             of the stream inside a window or prefill dispatch fails it
  serve_c1, serve_c4 (A: serve, B: serve_moe)  the same with 1 and 4
             requests: 1- and 8-lane windows (on B the MoE sort route:
             moe_grouped's <= 256-row loop must launch, moe_bmm need not)
  window_check (A)  a T = 8 window through decode_forward's window form
             and one append against 8 per-step calls from the same state
             (8 lanes, 256-token prompts): hidden states within one bf16
             step on 95% of the token rows and 5e-2 of the scale, the
             cache's other rows unchanged, layer 0's window rows equal
  logits     one prefill + 4 decode steps at full width, kernels vs plain
             versions, both on the card; the MoE runs decode two steps
             at 32 lanes (B: all-experts route; D: 256 grouped rows) and
             two at 1 lane (sort + grouped route: 8 rows, so B must
             launch moe_grouped's decode-sized loop); the plain run decodes
             the kernel run's tokens. A, B, E: every logit within 1e-3
             of the logit scale (the kernels are exact). C, D: 99% of the
             token rows within 2e-2 of it at the lane's depth (one-bf16-
             step GEMM differences can move a whole row on random
             weights), also measured at 1, 2, 4 and 8 layers
  profile    (A, C, D) torch.profiler over 32 concurrent 256/32
             requests on the same engine: device time by kernel, device
             busy share

Then the kernel summary line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits nonzero
with no result line; so does a machine without CUDA. Every phase line
carries `t_s`, the seconds since the script started.
"""

from __future__ import annotations

import itertools
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
PAGE = 32
OOB_SENTINEL = 1 << 30
# llama-3.1-8b projection shapes (K, N) with fused q|k|v and gate|up.
GEMM_SHAPES = {"qkv": (4096, 6144), "o": (4096, 4096),
               "gate_up": (4096, 28672), "down": (14336, 4096)}
DECODE_M = (1, 32, 64)
PREFILL_M = (256, 2048, 8192)
SERVE_DECODE_M = 32              # decode lanes of the serve phase
SERVE_PREFILL_M = 2048           # one batched prefill of the serve phase
# qwen3-30b-a3b expert stacks: E experts, (K, N) per projection; gate and
# up read one shared row block, down each expert's own rows.
MOE_E, MOE_TOPK = 128, 8
MOE_SHAPES = {"gate": (2048, 768), "up": (2048, 768), "down": (768, 2048)}
BMM_T = (16, 32, 64)
# t = 1, 15 and 32 decode (the expert-grid loop at <= 256 rows), 256- and
# 2048-token prefill.
GROUPED_A = (8, 120, 256, 2048, 16384)
SERVE_BMM_T = 32                 # decode lanes of the MoE serve phase
SERVE_GROUPED_A = 16384          # one batched MoE prefill: 2048 tokens x 8
KV_PATH = ("kv_append_rows", "kv_append_pages")
LLAMA_PATH = ("w4a8tl_decode", "w4a8tl_prefill") + KV_PATH
MOE_PATH = LLAMA_PATH + ("moe_bmm", "moe_grouped")
# qwen3-30b-a3b dense projections (K, N): fused q|k|v and o.
QWEN_SHAPES = {"qkv": (2048, 5120), "o": (4096, 2048)}
QWEN_M = (1, 32, 64, 2048)
GROUPED_W4A16_A = (8, 256, 2048, 16384)   # decode t=1, t=32; prefills
SERVE_GROUPED_W4A16_A = 16384
# The lanes. `path`: kernels that must launch (every other kernel must
# not). `lanes`: the logits phase's decode lanes.
# `tol`, `min_rows`: the logits check at full depth -- the share of token
# rows whose every logit is within `tol` of the logit scale; `depths`:
# the depths it is also measured at (None = the model's depth).
# `profile`: whether the lane's profile phase runs (B's and E's are left
# out to keep the run inside its time). `small`: the lane also serves 1
# and 4 requests. `sync_check`: its 32-request serve dispatches under
# the no-sync check. `window_check`: the window form is checked against
# the per-step form at its width. `solo_as`: the lane whose
# solo request's tokens this lane's must equal. `layers`: a depth cut
# (the model's first layers): lane D, the slowest lane on a busy host
# (its sort-route decode makes ~1.06M launches per profile window at 48
# layers: 560 of 1043 s of one run on an H100 with a slow host), runs
# 12 of its 48 layers so the run stays well inside its 1200 s.
LANES = (
    dict(name="A llama-3.1-8b w4a8 two-level", model="llama-3.1-8b",
         mode={}, float_scale=False, path=LLAMA_PATH,
         lanes=(1, 1, 1, 1), tol=1e-3, min_rows=1.0, depths=(None,),
         tag="", profile=True, small=True, sync_check=True,
         window_check=True),
    # 32 lanes: the all-experts route; 1 lane: sort + grouped.
    dict(name="B qwen3-30b-a3b w4a8 two-level", model="qwen3-30b-a3b",
         mode={}, float_scale=False, path=MOE_PATH,
         lanes=(32, 32, 1, 1), tol=1e-3, min_rows=1.0, depths=(None,),
         tag="_moe", profile=False, small=True),
    dict(name="C llama-3.1-8b float-scale w4a8", model="llama-3.1-8b",
         mode={"w4a8": True, "w4a8_two_level": False}, float_scale=True,
         path=("w4a8_decode", "w4a16_gemm") + KV_PATH,
         lanes=(1, 1, 1, 1),
         tol=2e-2, min_rows=0.99, depths=(1, 2, 4, 8, None), tag="_fs",
         profile=True),
    # 32 lanes: 256 grouped rows a step; 1 lane: 8.
    dict(name="D qwen3-30b-a3b w4a16", model="qwen3-30b-a3b", layers=12,
         mode={"w4a8": False}, float_scale=True,
         path=("w4a16_gemm", "moe_grouped_w4a16") + KV_PATH,
         lanes=(32, 32, 1, 1),
         tol=2e-2, min_rows=0.99, depths=(1, 2, 4, 8, None),
         tag="_moe_w4a16",
         profile=True),
    dict(name="E llama-3.1-8b w4a8 two-level group-dot",
         model="llama-3.1-8b", mode={"w4a8_gd": "all"}, float_scale=False,
         path=("w4a8tl_gd_decode", "w4a8tl_prefill") + KV_PATH,
         lanes=(1, 1, 1, 1), tol=1e-3, min_rows=1.0, depths=(None,),
         tag="_gd", profile=False,
         solo_as="A llama-3.1-8b w4a8 two-level"),
)
T0 = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of a callable, in device time only: the L2
    cache (50 MB) is flushed before every timed run, as a layer's weights
    are cold when the served path reaches them, and the card then spins
    (~0.5 ms) so the host has enqueued the whole call before the start
    event fires -- else the Python wrapper's host time lands inside the
    events."""

    SPIN_CYCLES = 1_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device="cuda")

    def __call__(self, fn, reps=20, warmup=3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = INT8_OPS_PER_S):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bf16_step_check(got, want):
    """(within, share differing, max abs error): every output within one
    bf16 step of the plain version, |got - want| <= 2^-7 |want| + 2^-12
    max|want| (the f32 sums run in another order than the plain
    version's float64 ones, then round to bf16)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = 2.0 ** -7 * w.abs() + 2.0 ** -12 * w.abs().max()
    return (bool((diff <= tol).all()), (diff > 0).float().mean().item(),
            diff.max().item())


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def make_gemm_weight(torch, k, n, gen, two_level=True):
    """Random float weight with asymmetric per-group offsets, quantized
    asymmetric (bf16 scales) and, with `two_level`, requantized two-level:
    non-uniform scales, zeros (and scales2, chan) -- the uniform bench
    init cannot catch an indexing bug."""
    from ferrum_tpu_torch.ops.quant import (make_quant_linear,
                                            requantize_two_level)
    w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
    shift = (torch.rand(k // 128, 1, n, generator=gen, device="cuda")
             - 0.5) * 0.06
    w = (w.reshape(k // 128, 128, n) + shift).reshape(k, n)
    p = make_quant_linear(w, 128, symmetric=False)
    del w
    return requantize_two_level(p) if two_level else p


def int_mm_weight(torch, p):
    """The two-level int8 weight w8, column-major (torch._int_mm's
    layout): the library call's operand."""
    from ferrum_tpu_torch.ops.quant import two_level_w8
    return two_level_w8(p).to(torch.int8).t().contiguous().t()


def two_level_case(rows, timer, row, fn, plain, p, w8_cm, xq, xs):
    """One case of a two-level GEMM kernel: equal to its plain version,
    again after the timed launches (which also shows that the split-K
    scratch of the decode kernels came back zeroed every time); bound for
    its bytes and int8 ops; `torch._int_mm` on the int8 w8 as the
    library call (it takes m > 16 only)."""
    import torch
    m, k = xq.shape
    n = p.out_features
    nbytes = (p.qweight.nbytes + p.scales2.nbytes + p.zeros.nbytes
              + p.chan_scale.nbytes + xq.nbytes + xs.nbytes + 2 * m * n)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2.0 * m * k * n)
    check_case(rows, row, timer, lambda: fn(xq, xs, p, torch.bfloat16),
               lambda: plain(xq, xs, p, torch.bfloat16),
               (lambda: torch._int_mm(xq, w8_cm)) if m > 16 else None,
               exact=True)


def gemm_rows(torch, timer):
    """The four two-level dense kernels at the llama-3.1-8b projections,
    each pair of one function on the same weight and activations:
    w4a8tl_decode and w4a8tl_gd_decode at decode m, w4a8tl_prefill and
    w4a8tl_prefill_mcache at prefill m."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    pairs = ((DECODE_M, (("w4a8tl_decode", qmm.w4a8tl_decode,
                          qmm.w4a8tl_plain),
                         ("w4a8tl_gd_decode", qmm.w4a8tl_gd_decode,
                          qmm.w4a8tl_gd_plain))),
             (PREFILL_M, (("w4a8tl_prefill", qmm.w4a8tl_prefill,
                           qmm.w4a8tl_plain),
                          ("w4a8tl_prefill_mcache", qmm.w4a8tl_prefill_mcache,
                           qmm.w4a8tl_plain))))
    rows = []
    for site, (k, n) in GEMM_SHAPES.items():
        p = make_gemm_weight(torch, k, n, gen)
        assert p.scales2.unique().numel() > 1 and p.zeros.unique().numel() > 1
        w8_cm = int_mm_weight(torch, p)
        for ms_list, kernels in pairs:
            for m in ms_list:
                x = torch.randn(m, k, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                xq, xs = qmm.quantize_activation_rows(x)
                for kernel, fn, plain in kernels:
                    two_level_case(rows, timer,
                                   {"kernel": kernel, "site": site, "m": m,
                                    "k": k, "n": n},
                                   fn, plain, p, w8_cm, xq, xs)
        del p, w8_cm
        torch.cuda.empty_cache()
    return rows


def group_dot_rows(torch, timer):
    """w4a8tl_gd_decode at the qwen3-30b-a3b dense projections (qkv, o) at
    decode m, and the wrap case: llama's down shape (K = 14336, N = 4096)
    at m = 32 with xq = 127, q = 15, z = 15, scales2 = 127. Every w8 is 0,
    so the result is exactly 0, while sum_g s2 * dot alone would reach
    ~3.5e9 > 2^31 before the zero correction cancels it."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    from ferrum_tpu_torch.ops.quant import QuantLinearParams
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    rows = []

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device="cuda")

    k, n = GEMM_SHAPES["down"]
    g = k // 128
    wrap = QuantLinearParams(
        qweight=full((k // 2, n), 0xFF, torch.uint8),
        scales=full((g, n), 1.0, torch.bfloat16),
        zeros=full((g, n), 15, torch.int8), bias=None, in_features=k,
        out_features=n, group_size=128, scales2=full((g, n), 127, torch.int8),
        chan_scale=torch.rand(1, n, generator=gen, device="cuda") * 1e-3
        + 1e-3)
    cases = [("qwen3-30b-a3b", site, (k, n), DECODE_M)
             for site, (k, n) in QWEN_SHAPES.items()]
    cases.append(("wrap case", "down", (k, n), (32,)))
    for model, site, (k, n), ms_list in cases:
        p = wrap if model == "wrap case" else make_gemm_weight(torch, k, n,
                                                               gen)
        w8_cm = int_mm_weight(torch, p)
        for m in ms_list:
            if model == "wrap case":
                xq = full((m, k), 127, torch.int8)
                xs = torch.rand(m, 1, generator=gen, device="cuda") + 0.5
                if qmm.w4a8tl_gd_plain(xq, xs, p, torch.bfloat16).any():
                    raise AssertionError("the wrap case's exact result is 0")
            else:
                x = torch.randn(m, k, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                xq, xs = qmm.quantize_activation_rows(x)
            two_level_case(rows, timer,
                           {"kernel": "w4a8tl_gd_decode", "model": model,
                            "site": site, "m": m, "k": k, "n": n},
                           qmm.w4a8tl_gd_decode, qmm.w4a8tl_gd_plain, p,
                           w8_cm, xq, xs)
        del p, w8_cm
    del wrap
    torch.cuda.empty_cache()
    return rows


def float_scale_rows(torch, timer):
    """The dense float-scale kernels at the served shapes: w4a8_decode
    (llama projections, decode m) equal to its plain version; w4a16_gemm
    (llama projections at prefill m, qwen3 qkv / o at decode and prefill
    m) within one bf16 step of its plain version."""
    from ferrum_tpu_torch.ops.kernels.quant_matmul import (
        quantize_activation_rows, w4a8_decode, w4a8_decode_plan, w4a8_plain,
        w4a16_decode_plan, w4a16_gemm, w4a16_plain)
    from ferrum_tpu_torch.ops.quant import w4a16_weight
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    rows = []
    cases = [("llama-3.1-8b", site, k, n, "w4a8_decode", DECODE_M)
             for site, (k, n) in GEMM_SHAPES.items()]
    cases += [("llama-3.1-8b", site, k, n, "w4a16_gemm", PREFILL_M)
              for site, (k, n) in GEMM_SHAPES.items()]
    cases += [("qwen3-30b-a3b", site, k, n, "w4a16_gemm", QWEN_M)
              for site, (k, n) in QWEN_SHAPES.items()]
    for model, site, k, n, kernel, ms_list in cases:
        p = make_gemm_weight(torch, k, n, gen, two_level=False)
        assert p.scales.unique().numel() > 1 and p.zeros.unique().numel() > 1
        w_bf16 = w4a16_weight(p)
        for m in ms_list:
            x = torch.randn(m, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            row = {"kernel": kernel, "model": model, "site": site, "m": m,
                   "k": k, "n": n}
            wbytes = p.qweight.nbytes + p.scales.nbytes + p.zeros.nbytes
            if kernel == "w4a8_decode":
                xq, xs = quantize_activation_rows(x)
                fn = lambda: w4a8_decode(  # noqa: E731
                    xq, xs, p, torch.bfloat16)
                plain = lambda: w4a8_plain(  # noqa: E731
                    xq, xs, p, torch.bfloat16)
                library = None   # no one PyTorch call computes it
                row["plan"] = w4a8_decode_plan(m, n, k)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    wbytes + xq.nbytes + xs.nbytes + 2 * m * n,
                    2.0 * m * k * n)
            else:
                fn = lambda: w4a16_gemm(x, p)  # noqa: E731
                plain = lambda: w4a16_plain(x, p)  # noqa: E731
                library = lambda: torch.matmul(x, w_bf16)  # noqa: E731
                if m <= 64:
                    row["plan"] = w4a16_decode_plan(m, n, k)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    wbytes + x.nbytes + 2 * m * n, 2.0 * m * k * n,
                    BF16_FLOPS_PER_S)
            check_case(rows, row, timer, fn, plain, library,
                       exact=kernel == "w4a8_decode")
            if kernel == "w4a8_decode" and not scratch_zero(torch):
                raise AssertionError(f"w4a8_decode {site} m={m}: split-K "
                                     f"counters not zero after the case")
        del p, w_bf16
        torch.cuda.empty_cache()
    return rows


def scratch_zero(torch) -> bool:
    """Whether the current stream's split-K counters are all zero."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    _, scratch = qmm._SCRATCH.get((stream.device_index, stream.cuda_stream),
                                  (0, torch.zeros(1)))
    return not bool(scratch.any().item())


def check_case(rows, row, timer, fn, plain, library, exact, launch=None):
    """Kernel vs plain version (exact, or within one bf16 step and then
    the same bits again: deterministic), timed, and checked once more
    after the timed launches; raises on a miss. `launch`, where given, is
    the kernel's launch alone on inputs `fn` prepares itself (a grouped
    kernel on a tile map built before): it must give `fn`'s bits, and
    `kernel_ms` times it while `call_ms` times the whole call `fn`."""
    import torch
    got = fn()
    want = plain()
    torch.cuda.synchronize()
    if exact:
        ok = bool(torch.equal(got, want))
        row["equal"] = ok
        row["max_abs_err"] = (got.float() - want.float()).abs().max().item()
    else:
        ok, row["share_differing"], row["max_abs_err"] = bf16_step_check(
            got, want)
        row["tolerance"] = "2^-7 |want| + 2^-12 max|want|"
    row["kernel_ms"] = timer(launch or fn)
    if launch is not None:
        row["call_ms"] = timer(fn)
        ok &= bool(torch.equal(launch(), got))
    again = fn()
    ok &= bool(torch.equal(again, want)) if exact \
        else bf16_step_check(again, want)[0] and bool(torch.equal(again, got))
    row["ok"] = ok
    row["plain_ms"] = timer(plain, reps=3, warmup=1)
    row["library_ms"] = None if library is None else timer(library)
    rows.append(row)
    emit({"phase": "kernel_case", **row})
    if not ok:
        raise AssertionError(f"{row['kernel']} {row.get('site')}: kernel "
                             f"differs from plain by {row['max_abs_err']}")


def make_moe_stack(torch, k, n, gen, two_level=True):
    """An expert stack [MOE_E, ...] of non-uniform weights (each expert as
    make_gemm_weight makes one)."""
    import dataclasses
    parts = [make_gemm_weight(torch, k, n, gen, two_level)
             for _ in range(MOE_E)]
    fields = ("qweight", "scales", "zeros") + (
        ("scales2", "chan_scale") if two_level else ())
    stacked = {f: torch.stack([getattr(p, f) for p in parts])
               for f in fields}
    return dataclasses.replace(parts[0], **stacked)


def routed_sizes(torch, gen, a):
    """Expert group sizes of `a` rows (a / 8 tokens at top-8) routed by a
    random router over MOE_E experts."""
    from ferrum_tpu_torch.ops.moe import route_topk
    logits = torch.randn(a // MOE_TOPK, MOE_E, generator=gen, device="cuda"
                         ).to(torch.bfloat16)
    _, ids = route_topk(logits, MOE_TOPK, True)
    return torch.bincount(ids.reshape(-1), minlength=MOE_E)


def stack_bytes(p, experts):
    """Bytes of `experts` experts' packed weight, scales2, zeros and chan."""
    per = (p.qweight[0].nbytes + p.scales2[0].nbytes + p.zeros[0].nbytes
           + p.chan_scale[0].nbytes)
    return experts * per


def moe_cases(torch, timer):
    """The two MoE kernels at the qwen3-30b-a3b expert shapes against
    their plain versions (exact equality), with their times."""
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (
        bmm_plain, grouped_bm, grouped_map, grouped_plain, grouped_plan,
        grouped_w4a8tl, grouped_w4a8tl_on_map, moe_bmm_plan,
        quant_bmm_all_experts)
    from ferrum_tpu_torch.ops.kernels.quant_matmul import (
        quantize_activation_rows)
    from ferrum_tpu_torch.ops.quant import dequantize
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    rows = []

    for site, (k, n) in MOE_SHAPES.items():
        p = make_moe_stack(torch, k, n, gen)
        assert p.scales2.unique().numel() > 1 and p.zeros.unique().numel() > 1
        w_bf16 = dequantize(p, torch.bfloat16)            # [E, K, N]
        bx = 1 if site != "down" else MOE_E
        for t in BMM_T:
            x = torch.randn(bx, t, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            xq, xs = quantize_activation_rows(x.reshape(bx * t, k))
            xq3, xs3 = xq.reshape(bx, t, k), xs.reshape(bx, t, 1)
            row = {"kernel": "moe_bmm", "site": site, "t": t, "k": k,
                   "n": n, "experts": MOE_E, "shared_rows": bx == 1,
                   "plan": moe_bmm_plan(t, n, k, MOE_E)}
            row["bound_ms"], row["bound_by"] = bound_ms(
                stack_bytes(p, MOE_E) + xq3.nbytes + xs3.nbytes
                + 2 * MOE_E * t * n, 2.0 * MOE_E * t * k * n)
            xb = x.expand(MOE_E, t, k)
            check_case(rows, row, timer,
                       lambda: quant_bmm_all_experts(
                           xq3, xs3, p, torch.bfloat16),
                       lambda: bmm_plain(xq3, xs3, p, torch.bfloat16),
                       lambda: torch.bmm(xb, w_bf16), exact=True)
        for a in GROUPED_A:
            sizes = routed_sizes(torch, gen, a)
            gs = sizes.to(torch.int32)
            x = torch.randn(a, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            xq, xs = quantize_activation_rows(x)
            active = int((sizes > 0).sum().item())
            row = {"kernel": "moe_grouped", "site": site, "rows": a, "k": k,
                   "n": n, "experts": MOE_E, "active_experts": active,
                   "empty_experts": MOE_E - active,
                   "library": "torch._grouped_mm (bf16)"
                   if grouped_mm is not None else None}
            if grouped_bm(a) == 16:
                row["plan"] = grouped_plan(a, n, k, MOE_E)
            row["bound_ms"], row["bound_by"] = bound_ms(
                stack_bytes(p, active) + xq.nbytes + xs.nbytes + 2 * a * n,
                2.0 * a * k * n)
            offs = torch.cumsum(sizes, 0).to(torch.int32)
            tmap = grouped_map(gs, a)
            check_case(rows, row, timer,
                       lambda: grouped_w4a8tl(xq, xs, p, gs, torch.bfloat16),
                       lambda: grouped_plain(xq, xs, p, gs, torch.bfloat16),
                       None if grouped_mm is None
                       else lambda: grouped_mm(x, w_bf16, offs=offs),
                       exact=True,
                       launch=lambda: grouped_w4a8tl_on_map(
                           xq, xs, p, tmap, torch.bfloat16))
        del p, w_bf16
        torch.cuda.empty_cache()
        grouped_w4a16_cases(torch, timer, site, k, n, gen, rows)
    return rows


def grouped_w4a16_cases(torch, timer, site, k, n, gen, rows):
    """The w4a16 grouped kernel on a float-scale stack, within one bf16
    step of its plain version, at the rows of lane D's decode step (256)
    and prefills, and the single-slot decode (8)."""
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (
        grouped_bm, grouped_map, grouped_w4a16, grouped_w4a16_on_map,
        grouped_w4a16_plain, grouped_w4a16_plan)
    from ferrum_tpu_torch.ops.quant import w4a16_weight
    grouped_mm = getattr(torch, "_grouped_mm", None)
    p = make_moe_stack(torch, k, n, gen, two_level=False)
    assert p.scales.unique().numel() > 1 and p.zeros.unique().numel() > 1
    w_bf16 = w4a16_weight(p)                              # [E, K, N]
    for a in GROUPED_W4A16_A:
        sizes = routed_sizes(torch, gen, a)
        gs = sizes.to(torch.int32)
        x = torch.randn(a, k, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        active = int((sizes > 0).sum().item())
        row = {"kernel": "moe_grouped_w4a16", "site": site, "rows": a,
               "k": k, "n": n, "experts": MOE_E, "active_experts": active,
               "library": "torch._grouped_mm (bf16)"
               if grouped_mm is not None else None}
        if grouped_bm(a) == 16:
            row["plan"] = grouped_w4a16_plan(a, n, k, MOE_E)
        per = p.qweight[0].nbytes + p.scales[0].nbytes + p.zeros[0].nbytes
        row["bound_ms"], row["bound_by"] = bound_ms(
            active * per + x.nbytes + 2 * a * n, 2.0 * a * k * n,
            BF16_FLOPS_PER_S)
        offs = torch.cumsum(sizes, 0).to(torch.int32)
        tmap = grouped_map(gs, a)
        check_case(rows, row, timer,
                   lambda: grouped_w4a16(x, p, gs),
                   lambda: grouped_w4a16_plain(x, p, gs),
                   None if grouped_mm is None
                   else lambda: grouped_mm(x, w_bf16, offs=offs),
                   exact=False,
                   launch=lambda: grouped_w4a16_on_map(x, p, tmap))
    del p, w_bf16
    torch.cuda.empty_cache()


# The exact dequant cases: (m, K, N) dense and (rows, K, N) grouped, each
# with bf16 and with f32 scales. m = 256 takes 128-column tiles, m = 2048
# at N = 6144 256-column ones; grouped N = 768 256-column, N = 640 128.
ONEHOT_DENSE = ((256, 4096, 768), (256, 4096, 6144), (2048, 4096, 6144))
ONEHOT_GROUPED = ((2048, 2048, 768), (2048, 2048, 640))
# ... and at decode sizes, on the streamed decode loop in bf16
# (csrc/w4a16_stream.cuh). Dense (m, K, N, splits; 0: the launcher's
# count): every BM (m = 1 / 32 / 64) at the qwen3-30b-a3b qkv and o
# sites, K = 14336 (llama down), and forced splits of 3 steps and of 1
# (every other split starting mid-group). Grouped (rows, experts, K, N,
# group sizes; None: routed): 8 and 256 rows over the 128 experts at the
# qwen3 gate / up and down sites, and over 3 experts with an empty group
# and groups spanning 16-row tiles.
ONEHOT_DECODE_DENSE = tuple((m, k, n, 0) for m in (1, 32, 64)
                            for k, n in QWEN_SHAPES.values()) + (
    (32, 14336, 4096, 0), (32, 2048, 5120, 6), (1, 4096, 2048, 32))
ONEHOT_DECODE_GROUPED = ((8, MOE_E, 2048, 768, None),
                         (256, MOE_E, 2048, 768, None),
                         (256, MOE_E, 768, 2048, None),
                         (8, 3, 768, 2048, (1, 0, 7)),
                         (256, 3, 2048, 768, (10, 200, 46)),
                         (256, 3, 768, 2048, (0, 17, 239)))


def onehot_weight(torch, k, n, gen, experts, f32_scales):
    """A float-scale weight ([experts, ...] when experts > 0) built so a
    one-hot x reads its dequant exactly: across each group's columns
    every (q, z) pair in 0..15 x 0..15 (q = (n + k + e) % 16, z = (n / 16
    + g + e) % 16), the last group of each nibble half with zeros across
    all of int8, and scales 2^t (1 + u), t sweeping -133 .. 119 over
    the columns (below 2^-126 the bf16 scale is subnormal), u random (f32
    scales then round to bf16 in the kernel)."""
    from ferrum_tpu_torch.ops.quant import QuantLinearParams
    dev = "cuda"
    g = k // 128
    e = max(experts, 1)
    ei = torch.arange(e, device=dev)[:, None, None]
    kk = torch.arange(k, device=dev)[None, :, None]
    nn = torch.arange(n, device=dev)[None, None, :]
    gg = torch.arange(g, device=dev)[None, :, None]
    q = (nn + kk + ei) % 16                                      # [E, K, N]
    z = (nn // 16 + gg + ei) % 16                                # [E, G, N]
    wide = (nn * 37 + ei * 11) % 256 - 128
    z[:, [g // 2 - 1, g - 1], :] = wide.expand(e, 2, n)
    t = (nn * 11 + gg * 5 + ei) % 253 - 133
    u = torch.rand((e, g, n), generator=gen, device=dev)
    s = (1 + u) * torch.pow(2.0, t.to(torch.float32))
    qw = (q[:, :k // 2] | (q[:, k // 2:] << 4)).to(torch.uint8)
    fields = dict(qweight=qw, scales=s if f32_scales else s.to(torch.bfloat16),
                  zeros=z.to(torch.int8))
    if not experts:
        fields = {f: v[0].contiguous() for f, v in fields.items()}
    return QuantLinearParams(**fields, bias=None, in_features=k,
                             out_features=n, group_size=128)


def onehot_x(torch, m, k, gen):
    """bf16 [m, K], row i one-hot at k_i: the first and the last k of
    every group (both nibble halves' groups), then random k; with fewer
    rows than that, m of those first and last k at random."""
    need = torch.stack([torch.arange(0, k, 128, device="cuda"),
                        torch.arange(127, k, 128, device="cuda")], 1)
    if m < need.numel():
        ks = need.reshape(-1)[torch.randperm(
            need.numel(), generator=gen, device="cuda")[:m]]
    else:
        ks = torch.cat([need.reshape(-1), torch.randint(
            0, k, (m - need.numel(),), generator=gen, device="cuda")])
    x = torch.zeros(m, k, dtype=torch.bfloat16, device="cuda")
    x[torch.arange(m, device="cuda"), ks] = 1.0
    return x


def onehot_cases(torch):
    """Both w4a16 kernels on one-hot x, at prefill sizes (ONEHOT_DENSE,
    ONEHOT_GROUPED) and decode sizes (onehot_decode_cases): y is rows of
    the dequantized weight, so the kernel must equal its plain version
    bit for bit -- the check a dequant, layout, swizzle, fragment, split
    or proxy-fence fault cannot pass."""
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (grouped_w4a16,
                                                       grouped_w4a16_plain)
    from ferrum_tpu_torch.ops.kernels.quant_matmul import (w4a16_gemm,
                                                           w4a16_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    rows = []
    cases = [("w4a16_gemm", shape) for shape in ONEHOT_DENSE] \
        + [("moe_grouped_w4a16", shape) for shape in ONEHOT_GROUPED]
    for kernel, (m, k, n) in cases:
        x = onehot_x(torch, m, k, gen)
        for f32 in (False, True):
            row = {"kernel": kernel, "case": "one-hot dequant", "m": m,
                   "k": k, "n": n, "scales": "f32" if f32 else "bf16"}
            if kernel == "w4a16_gemm":
                p = onehot_weight(torch, k, n, gen, 0, f32)
                got, want = w4a16_gemm(x, p), w4a16_plain(x, p)
            else:
                sizes = routed_sizes(torch, gen, m)
                offs = torch.cumsum(sizes, 0)
                row["boundary_inside_64_rows"] = bool(
                    (offs[:-1] % 64 != 0).any().item())
                gs = sizes.to(torch.int32)
                p = onehot_weight(torch, k, n, gen, MOE_E, f32)
                got, want = grouped_w4a16(x, p, gs), \
                    grouped_w4a16_plain(x, p, gs)
            onehot_row(torch, rows, row, got, want)
            del p, got, want
        torch.cuda.empty_cache()
    return rows + onehot_decode_cases(torch, gen)


def onehot_row(torch, rows, row, got, want):
    """Finish and emit one one-hot case's row: equal bit for bit, else
    raise."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    row["equal"] = bool(torch.equal(got, want))
    row["outputs_differing"] = int((diff > 0).sum().item())
    row["subnormal_weights"] = int(
        ((want != 0) & (want.float().abs() < 2.0 ** -126)).sum().item())
    rows.append(row)
    emit({"phase": "kernel_case", **row})
    if not row["equal"] or not row.get("boundary_inside_64_rows", True) \
            or not row.get("group_spans_16_row_tiles", True) \
            or not row.get("scratch_zero", True):
        raise AssertionError(f"{row['kernel']} one-hot: {row}")


def onehot_decode_cases(torch, gen):
    """Both w4a16 kernels' decode sizes on one-hot x (ONEHOT_DECODE_*),
    bf16 and f32 scales: equal to the plain version bit for bit, each row
    with its launch plan; the dense kernel's split-K counters zero after
    each case; some group of each grouped case spans two 16-row tiles
    (at 256 rows)."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (grouped_w4a16,
                                                       grouped_w4a16_plain,
                                                       grouped_w4a16_plan)
    rows = []
    for m, k, n, splits in ONEHOT_DECODE_DENSE:
        x = onehot_x(torch, m, k, gen)
        for f32 in (False, True):
            p = onehot_weight(torch, k, n, gen, 0, f32)
            got = qmm.w4a16_gemm(x, p, splits=splits)
            row = {"kernel": "w4a16_gemm", "case": "one-hot decode", "m": m,
                   "k": k, "n": n, "scales": "f32" if f32 else "bf16",
                   "plan": qmm.w4a16_decode_plan(m, n, k, splits),
                   "scratch_zero": scratch_zero(torch)}
            onehot_row(torch, rows, row, got, qmm.w4a16_plain(x, p))
            del p, got
        torch.cuda.empty_cache()
    for a, e, k, n, sizes in ONEHOT_DECODE_GROUPED:
        x = onehot_x(torch, a, k, gen)
        if sizes is None:
            gs = routed_sizes(torch, gen, a).to(torch.int32)
        else:
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        offs = torch.cumsum(gs, 0).tolist()
        spans = any(lo // 16 != (hi - 1) // 16
                    for lo, hi in zip([0] + offs[:-1], offs) if hi > lo)
        for f32 in (False, True):
            p = onehot_weight(torch, k, n, gen, e, f32)
            row = {"kernel": "moe_grouped_w4a16", "case": "one-hot decode",
                   "rows": a, "experts": e, "k": k, "n": n,
                   "scales": "f32" if f32 else "bf16",
                   "plan": grouped_w4a16_plan(a, n, k, e)}
            if a > 16:
                row["group_spans_16_row_tiles"] = spans
            onehot_row(torch, rows, row, grouped_w4a16(x, p, gs),
                       grouped_w4a16_plain(x, p, gs))
            del p
        torch.cuda.empty_cache()
    return rows


# The exact cases of the two two-level prefill kernels beyond the timed
# llama shapes, (m, K, N): ragged m (the engine's batched prefill gives
# m = b * t_pad), the qwen3-30b-a3b dense sites (N = 5120 and 2048), the
# int32 range at K = 14336 (every |xq| and |w8| 127), and one-hot xq.
# m <= 256 and N = 2048 take 128-column tiles in w4a8tl_prefill, m = 2048
# at N = 4096 / 5120 / 6144 256-column ones.
PREFILL_RAGGED = tuple((m, 4096, 4096) for m in (65, 100, 257, 2047))
PREFILL_QWEN = tuple((m, k, n) for k, n in QWEN_SHAPES.values()
                     for m in (256, 2048))
PREFILL_EXTREME = ((256, 14336, 512), (2048, 14336, 4096))
PREFILL_ONEHOT = ((256, 4096, 768), (2048, 4096, 6144))


def two_level_weight(torch, k, n, gen, kind, experts=0):
    """A two-level weight ([experts, ...] when experts > 0) built for an
    exact case. "extreme": q in {6, 8}, z = 7, scales2 = 127, so every w8
    is +-127 (random signs). "onehot": across each group's columns every
    (q, z) in 0..15 x 0..15 (q = (n + k + e) % 16, z = (n / 16 + g + e) %
    16), scales2 from 1 up to the cap 127 // max(z, 15 - z) that keeps
    |w8| <= 127. "random": q and z uniform over 0..15, scales2 uniform
    over 1 .. the cap. "wrap": q = z = 15, scales2 = 127, so every w8 is
    0, while sum_g s2 * (xq . q) alone passes 2^31 at K = 14336 with xq =
    127."""
    from ferrum_tpu_torch.ops.quant import QuantLinearParams
    dev = "cuda"
    g = k // 128
    e = max(experts, 1)
    ei = torch.arange(e, device=dev)[:, None, None]
    kk = torch.arange(k, device=dev)[None, :, None]
    nn = torch.arange(n, device=dev)[None, None, :]
    gg = torch.arange(g, device=dev)[None, :, None]
    if kind == "extreme":
        q = torch.where(torch.rand(e, k, n, generator=gen, device=dev) < 0.5,
                        6, 8)
        z = torch.full((e, g, n), 7, device=dev)
        s2 = torch.full((e, g, n), 127, device=dev)
    elif kind == "wrap":
        q = torch.full((e, k, n), 15, device=dev)
        z = torch.full((e, g, n), 15, device=dev)
        s2 = torch.full((e, g, n), 127, device=dev)
    elif kind == "onehot":
        q = (nn + kk + ei) % 16
        z = (nn // 16 + gg + ei) % 16
        s2 = 1 + (nn * 7 + gg * 3 + ei) % (127 // torch.maximum(z, 15 - z))
    else:
        q = torch.randint(0, 16, (e, k, n), generator=gen, device=dev)
        z = torch.randint(0, 16, (e, g, n), generator=gen, device=dev)
        s2 = 1 + (torch.rand(e, g, n, generator=gen, device=dev)
                  * (127 // torch.maximum(z, 15 - z))).long()
    fields = dict(
        qweight=(q[:, :k // 2] | (q[:, k // 2:] << 4)).to(torch.uint8),
        scales=torch.ones(e, g, n, dtype=torch.bfloat16, device=dev),
        zeros=z.to(torch.int8), scales2=s2.to(torch.int8),
        chan_scale=torch.rand(e, 1, n, generator=gen, device=dev) * 1e-3
        + 1e-3)
    if not experts:
        fields = {f: v[0] for f, v in fields.items()}
    return QuantLinearParams(**fields, bias=None, in_features=k,
                             out_features=n, group_size=128)


def prefill_exact_cases(torch):
    """w4a8tl_prefill and w4a8tl_prefill_mcache equal to w4a8tl_plain bit
    for bit on the PREFILL_* cases: ragged m and the qwen3 sites on random
    non-uniform weights; the extreme case, where each row m meets the
    largest sum 127 * 127 * K at column m % N; one-hot xq, where every
    output is one w8 row times xs and chan, in bf16 and in f32 -- the
    check a dequant, transpose, swizzle or proxy-fence fault cannot
    pass."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    from ferrum_tpu_torch.ops.quant import two_level_w8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    cases = [("ragged m", s) for s in PREFILL_RAGGED] \
        + [("qwen3-30b-a3b", s) for s in PREFILL_QWEN] \
        + [("extreme", s) for s in PREFILL_EXTREME] \
        + [("one-hot", s) for s in PREFILL_ONEHOT]
    rows = []
    for case, (m, k, n) in cases:
        xs = torch.rand(m, 1, generator=gen, device="cuda") + 0.5
        if case == "extreme":
            p = two_level_weight(torch, k, n, gen, "extreme")
            sign = torch.where(two_level_w8(p) > 0, 1, -1)       # [K, N]
            flip = torch.where(torch.rand(m, 1, generator=gen,
                                          device="cuda") < 0.5, 1, -1)
            cols = torch.arange(m, device="cuda") % n
            xq = (127 * sign[:, cols].t() * flip).to(torch.int8)
            xq = xq.contiguous()
            top = (xq.double() @ two_level_w8(p).double()).abs().max()
            if top.item() != 127 * 127 * k:
                raise AssertionError(f"extreme case peaks at {top.item()}")
        elif case == "one-hot":
            p = two_level_weight(torch, k, n, gen, "onehot")
            xq = onehot_x(torch, m, k, gen).to(torch.int8)
        else:
            p = make_gemm_weight(torch, k, n, gen)
            x = torch.randn(m, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            xq, xs = qmm.quantize_activation_rows(x)
        outs = (torch.bfloat16, torch.float32) if case == "one-hot" \
            else (torch.bfloat16,)
        for out_dtype in outs:
            want = qmm.w4a8tl_plain(xq, xs, p, out_dtype)
            for kernel in ("w4a8tl_prefill", "w4a8tl_prefill_mcache"):
                got = getattr(qmm, kernel)(xq, xs, p, out_dtype)
                torch.cuda.synchronize()
                row = {"kernel": kernel, "case": case, "m": m, "k": k,
                       "n": n, "out": str(out_dtype).split(".")[-1],
                       "equal": bool(torch.equal(got, want)),
                       "outputs_differing": int((got != want).sum().item())}
                rows.append(row)
                emit({"phase": "kernel_case", **row})
                if not row["equal"]:
                    raise AssertionError(f"{kernel} {case} {m}x{k}x{n}: "
                                         f"{row}")
        del p, xq, xs, want, got
    torch.cuda.empty_cache()
    return rows


# The exact cases of the two-level decode kernels beyond the timed sites,
# (case, m, K, N, K splits; 0: the launcher's rule): one-hot xq at every
# BM (16 / 32 / 64) and its edges, the int32 range at K = 14336, K = 256
# (two K steps of 64 packed rows, fewer than the ring's 3 loads ahead),
# one split and one per K step, 3 splits of 32 steps (steps 0, 11, 22:
# one split starts mid-group), N = 192 (64-column tiles), and the wrap
# case at K = 14336 (exact result 0) at one split and one per K step.
DECODE_EXACT = tuple(("one-hot", m, 4096, 6144, 0)
                     for m in (1, 5, 16, 17, 32, 33, 64)) + (
    ("extreme", 64, 14336, 4096, 0), ("random", 32, 256, 768, 0),
    ("random", 32, 4096, 4096, 1), ("random", 32, 4096, 4096, 32),
    ("random", 32, 4096, 4096, 3), ("random", 17, 4096, 192, 0),
    ("wrap", 32, 14336, 4096, 1), ("wrap", 32, 14336, 4096, 112))


def decode_exact_cases(torch, timer):
    """Both two-level decode kernels, w4a8tl_decode (the w8 form) and
    w4a8tl_gd_decode (the group-dot form), each equal to its own plain
    version (w4a8tl_plain, w4a8tl_gd_plain) bit for bit on the
    DECODE_EXACT cases, in bf16 and f32 out, before and after its timed
    launches, with the stream's split-K counters all zero after each --
    the check a chunk placement, dequant or unpack, fragment, rescale,
    ring, split or epilogue fault cannot pass."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    from ferrum_tpu_torch.ops.quant import two_level_w8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    kernels = (("w4a8tl_decode", qmm.w4a8tl_decode, qmm.w4a8tl_plain,
                qmm.w4a8tl_decode_plan),
               ("w4a8tl_gd_decode", qmm.w4a8tl_gd_decode,
                qmm.w4a8tl_gd_plain, qmm.w4a8tl_gd_decode_plan))
    rows = []
    for case, m, k, n, splits in DECODE_EXACT:
        xs = torch.rand(m, 1, generator=gen, device="cuda") + 0.5
        if case == "wrap":
            p = two_level_weight(torch, k, n, gen, "wrap")
            xq = torch.full((m, k), 127, dtype=torch.int8, device="cuda")
            if qmm.w4a8tl_gd_plain(xq, xs, p, torch.float32).any():
                raise AssertionError("the wrap case's exact result is 0")
        elif case == "extreme":
            p = two_level_weight(torch, k, n, gen, "extreme")
            sign = torch.where(two_level_w8(p) > 0, 1, -1)       # [K, N]
            cols = torch.arange(m, device="cuda") % n
            xq = (127 * sign[:, cols].t()).to(torch.int8).contiguous()
            top = (xq.double() @ two_level_w8(p).double()).abs().max()
            if top.item() != 127 * 127 * k:
                raise AssertionError(f"extreme case peaks at {top.item()}")
        elif case == "one-hot":
            p = two_level_weight(torch, k, n, gen, "onehot")
            xq = onehot_x(torch, m, k, gen).to(torch.int8)
        else:
            p = two_level_weight(torch, k, n, gen, "random")
            xq = torch.randint(-127, 128, (m, k), generator=gen,
                               device="cuda").to(torch.int8)
        for (kernel, fn, plain, plan), out_dtype in itertools.product(
                kernels, (torch.bfloat16, torch.float32)):
            def launch():
                return fn(xq, xs, p, out_dtype, splits=splits)
            want = plain(xq, xs, p, out_dtype)
            got = launch()
            ms_ = timer(launch)
            again = launch()
            row = {"kernel": kernel, "case": case, "m": m, "k": k, "n": n,
                   "out": str(out_dtype).split(".")[-1],
                   "plan": plan(m, n, k, splits), "kernel_ms": ms_,
                   "equal": bool(torch.equal(got, want))
                   and bool(torch.equal(again, want)),
                   "outputs_differing": int((got != want).sum().item()),
                   "scratch_zero": scratch_zero(torch)}
            rows.append(row)
            emit({"phase": "kernel_case", **row})
            if not row["equal"] or not row["scratch_zero"]:
                raise AssertionError(f"{kernel} {case} {m}x{k}x{n}: {row}")
        del p, xq, xs, want, got, again
    torch.cuda.empty_cache()
    return rows


# The exact cases of the float-scale decode kernel beyond the timed llama
# sites, (case, m, K, N, K splits -- 0: the launcher's rule --, f32
# scales): one-hot xq at every row tile's edge (each output one scaled
# group term; bf16-subnormal scales, zeros across int8), the integer
# range at K = 14336 (|xq| = 127, |q - z| = 15), gpt 1 (K = 256: one TPU
# step; 768: three) and 2 (K = 1536), forced splits (4 of 14 TPU steps:
# 4, 4, 4, 2; one a TPU step; 8 of 3), N = 192 (three 64-column tiles).
FS_EXACT = tuple(("one-hot", m, 4096, 768, 0, m % 2 == 1)
                 for m in (1, 17, 33, 64)) + (
    ("extreme", 64, 14336, 256, 0, False), ("extreme", 17, 14336, 256, 3, True),
    ("random", 32, 256, 768, 0, True), ("random", 32, 768, 768, 0, False),
    ("random", 33, 1536, 768, 0, True), ("random", 32, 14336, 4096, 4, False),
    ("random", 1, 14336, 4096, 14, True), ("random", 64, 768, 768, 8, False),
    ("random", 17, 4096, 192, 0, True), ("random", 64, 4096, 192, 2, False))


def float_scale_weight(torch, k, n, gen, kind, f32_scales):
    """A float-scale weight for an exact case. Scales of random sign and
    mantissa, 2^-12 .. 2^1. "extreme": z in {0, 15}, q = 15 - z, so every
    |q - z| is 15; "random": q and z uniform over 0..15."""
    from ferrum_tpu_torch.ops.quant import QuantLinearParams
    dev = "cuda"
    g = k // 128
    if kind == "extreme":
        z = torch.where(torch.rand(g, n, generator=gen, device=dev) < 0.5,
                        0, 15)
        q = 15 - z.repeat_interleave(128, 0)
    else:
        q = torch.randint(0, 16, (k, n), generator=gen, device=dev)
        z = torch.randint(0, 16, (g, n), generator=gen, device=dev)
    sign = torch.where(torch.rand(g, n, generator=gen, device=dev) < 0.5,
                       -1.0, 1.0)
    s = sign * (1 + torch.rand(g, n, generator=gen, device=dev)) * torch.pow(
        2.0, torch.randint(-12, 2, (g, n), generator=gen, device=dev).float())
    return QuantLinearParams(
        qweight=(q[:k // 2] | (q[k // 2:] << 4)).to(torch.uint8),
        scales=s if f32_scales else s.to(torch.bfloat16),
        zeros=z.to(torch.int8), bias=None, in_features=k, out_features=n,
        group_size=128)


def float_scale_exact_cases(torch, timer):
    """w4a8_decode equal to w4a8_plain bit for bit on the FS_EXACT cases,
    in bf16 and f32 out, before and after its timed launches, with the
    stream's split-K counters all zero after each, each row with its
    plan -- the check a ring, unpack, row-sum, scale-slot, fold-order,
    row-tile, split-plane or epilogue fault cannot pass."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    rows = []
    for case, m, k, n, splits, f32 in FS_EXACT:
        xs = torch.rand(m, 1, generator=gen, device="cuda") + 0.5
        if case == "one-hot":
            p = onehot_weight(torch, k, n, gen, 0, f32)
            xq = onehot_x(torch, m, k, gen).to(torch.int8)
        elif case == "extreme":
            p = float_scale_weight(torch, k, n, gen, "extreme", f32)
            sign = torch.where(torch.rand(m, k // 128, generator=gen,
                                          device="cuda") < 0.5, -127, 127)
            xq = sign.repeat_interleave(128, 1).to(torch.int8).contiguous()
        else:
            p = float_scale_weight(torch, k, n, gen, "random", f32)
            xq = torch.randint(-127, 128, (m, k), generator=gen,
                               device="cuda").to(torch.int8)
        for out_dtype in (torch.bfloat16, torch.float32):
            def launch():
                return qmm.w4a8_decode(xq, xs, p, out_dtype, splits=splits)
            want = qmm.w4a8_plain(xq, xs, p, out_dtype)
            got = launch()
            zero_before = scratch_zero(torch)
            ms_ = timer(launch)
            again = launch()
            row = {"kernel": "w4a8_decode", "case": case, "m": m, "k": k,
                   "n": n, "scales": "f32" if f32 else "bf16",
                   "out": str(out_dtype).split(".")[-1],
                   "plan": qmm.w4a8_decode_plan(m, n, k, splits),
                   "kernel_ms": ms_,
                   "equal": bool(torch.equal(got, want))
                   and bool(torch.equal(again, want)),
                   "outputs_differing": int((got != want).sum().item()),
                   "scratch_zero": zero_before and scratch_zero(torch)}
            rows.append(row)
            emit({"phase": "kernel_case", **row})
            if not row["equal"] or not row["scratch_zero"]:
                raise AssertionError(f"w4a8_decode {case} {m}x{k}x{n}: {row}")
        del p, xq, xs, want, got, again
    torch.cuda.empty_cache()
    return rows


# The exact cases of the all-experts bmm beyond the timed ones, (case,
# experts, t, K, N, shared rows): one-hot xq at the qwen3 gate / up site
# on shared rows and at the down site on each expert's own rows (128
# experts), at every BM (t = 1, 17, 33, 64) on 3 experts; the int32 range
# at K = 14336 on each expert's own rows; K = 256 (2 K steps, fewer than
# the ring's 3 prologue loads); N = 192 (64-column tiles) on 3 and 128
# experts.
BMM_EXACT = (("one-hot", 128, 32, 2048, 768, True),
             ("one-hot", 128, 32, 768, 2048, False),
             ("one-hot", 3, 1, 2048, 768, True),
             ("one-hot", 3, 17, 2048, 768, False),
             ("one-hot", 3, 33, 768, 2048, True),
             ("one-hot", 3, 64, 768, 2048, False),
             ("extreme", 3, 64, 14336, 256, False),
             ("random", 3, 17, 256, 768, True),
             ("random", 3, 33, 256, 768, False),
             ("random", 3, 16, 2048, 192, True),
             ("random", 128, 64, 2048, 192, False))


def bmm_exact_cases(torch, timer):
    """moe_bmm equal to bmm_plain bit for bit on the BMM_EXACT cases, in
    bf16 and f32 out, before and after its timed launches, each row with
    the launch's plan (moe_bmm_plan). One-hot xq makes every output one
    w8 row of its expert times xs and chan, on stacks whose experts
    differ (q, z and scales2 depend on the expert); on per-expert rows
    each expert's row i is hot at its own k (k_i + 129 e mod K), so a
    fault in an expert's weight, scale, chan, row or output offset
    cannot pass. The extreme case: each expert's row m meets the largest
    sum 127 * 127 * K at column m % N."""
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (bmm_plain,
                                                       moe_bmm_plan,
                                                       quant_bmm_all_experts)
    from ferrum_tpu_torch.ops.quant import two_level_w8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rows = []
    for case, e, t, k, n, shared in BMM_EXACT:
        bx = 1 if shared else e
        p = two_level_weight(torch, k, n, gen,
                             "onehot" if case == "one-hot" else case,
                             experts=e)
        xs3 = torch.rand(bx, t, 1, generator=gen, device="cuda") + 0.5
        if case == "one-hot":
            hot = onehot_x(torch, t, k, gen).argmax(-1)           # [t]
            shift = 129 * torch.arange(bx, device="cuda")[:, None]
            xq3 = torch.zeros(bx, t, k, dtype=torch.int8, device="cuda")
            xq3.scatter_(2, ((hot[None] + shift) % k)[..., None], 1)
        elif case == "extreme":
            w8 = two_level_w8(p)                                  # [E, K, N]
            cols = torch.arange(t, device="cuda") % n
            xq3 = (127 * torch.where(w8[:, :, cols] > 0, 1, -1)
                   .transpose(1, 2)).to(torch.int8).contiguous()
            top = (xq3.double() @ w8.double()).abs().amax((1, 2))
            if (top != 127 * 127 * k).any():
                raise AssertionError(f"extreme case peaks at {top}")
            del w8
        else:
            xq3 = torch.randint(-127, 128, (bx, t, k), generator=gen,
                                device="cuda").to(torch.int8)
        for out_dtype in (torch.bfloat16, torch.float32):
            def launch():
                return quant_bmm_all_experts(xq3, xs3, p, out_dtype)
            want = bmm_plain(xq3, xs3, p, out_dtype)
            got = launch()
            ms_ = timer(launch, reps=5, warmup=1)
            again = launch()
            torch.cuda.synchronize()
            row = {"kernel": "moe_bmm", "case": case, "experts": e, "t": t,
                   "k": k, "n": n, "shared_rows": shared,
                   "out": str(out_dtype).split(".")[-1],
                   "plan": moe_bmm_plan(t, n, k, e), "kernel_ms": ms_,
                   "equal": bool(torch.equal(got, want))
                   and bool(torch.equal(again, want)),
                   "outputs_differing": int((got != want).sum().item())}
            rows.append(row)
            emit({"phase": "kernel_case", **row})
            if not row["equal"]:
                raise AssertionError(f"moe_bmm {case} E={e} t={t} "
                                     f"{k}x{n}: {row}")
            del want, got, again
        del p, xq3, xs3
    torch.cuda.empty_cache()
    return rows


# The exact cases of the grouped two-level kernel beyond the timed routed
# ones, (case, rows, K, N) over MOE_E experts. At 128-row tiles: one-hot
# xq at the qwen3 gate / up and down sites, every row to one expert, four
# experts active, ragged row counts (no multiple of top-k), K = 256 (2 K
# steps, fewer than the ring's 3 prologue loads). At decode sizes (<= 256
# rows, the expert-grid loop): one-hot xq at 8 / 120 / 256 rows, experts
# over BM rows (chunks), every row to one expert, K = 256.
GROUPED_EXACT = (("one-hot", 2048, 2048, 768), ("one-hot", 2048, 768, 2048),
                 ("one expert", 2048, 2048, 768),
                 ("four experts", 2048, 768, 2048),
                 ("ragged", 257, 2048, 768), ("ragged", 1000, 768, 2048),
                 ("K = 256", 2048, 256, 768),
                 ("one-hot", 8, 2048, 768), ("one-hot", 8, 768, 2048),
                 ("one-hot", 120, 2048, 768), ("one-hot", 120, 768, 2048),
                 ("one-hot", 256, 2048, 768), ("one-hot", 256, 768, 2048),
                 ("experts over BM rows", 256, 768, 2048),
                 ("one expert", 120, 2048, 768),
                 ("K = 256", 120, 256, 768))


def grouped_exact_cases(torch, timer):
    """moe_grouped equal to grouped_plain bit for bit on the GROUPED_EXACT
    cases, in bf16 and f32 out, before and after its timed launches:
    one-hot xq, where every output is one w8 row of the row's expert
    times chan and xs (at 128-row tiles some expert boundary must lie
    inside a 64-row slice, so a warpgroup's rows span two experts);
    random stacks and activations otherwise -- the check a window, chunk,
    expert offset, epilogue order, dequant or short-K ring fault cannot
    pass. Decode-sized rows carry their launch's plan."""
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (grouped_bm,
                                                       grouped_map,
                                                       grouped_plain,
                                                       grouped_plan,
                                                       grouped_w4a8tl,
                                                       grouped_w4a8tl_on_map)
    from ferrum_tpu_torch.ops.kernels.quant_matmul import (
        quantize_activation_rows)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    rows = []
    for case, a, k, n in GROUPED_EXACT:
        if case in ("one-hot", "K = 256"):
            sizes = routed_sizes(torch, gen, a)
        elif case == "ragged":
            sizes = torch.bincount(torch.randint(
                0, MOE_E, (a,), generator=gen, device="cuda"),
                minlength=MOE_E)
        else:
            sizes = torch.zeros(MOE_E, dtype=torch.int64, device="cuda")
            if case == "one expert":
                sizes[77] = a
            elif case == "four experts":
                sizes[torch.tensor([3, 40, 41, 127], device="cuda")] = \
                    torch.tensor([1000, 600, 300, 148], device="cuda")
            else:                           # experts over BM rows
                sizes[torch.tensor([3, 77, 127], device="cuda")] = \
                    torch.tensor([40, 100, 116], device="cuda")
        gs = sizes.to(torch.int32)
        offs = torch.cumsum(sizes, 0)
        p = two_level_weight(torch, k, n, gen,
                             "onehot" if case == "one-hot" else "random",
                             experts=MOE_E)
        if case == "one-hot":
            xq = onehot_x(torch, a, k, gen).to(torch.int8)
            xs = torch.rand(a, 1, generator=gen, device="cuda") + 0.5
        else:
            xq, xs = quantize_activation_rows(torch.randn(
                a, k, generator=gen, device="cuda", dtype=torch.bfloat16))
        tmap = grouped_map(gs, a)
        tiles = grouped_bm(a)
        for out_dtype in (torch.bfloat16, torch.float32):
            want = grouped_plain(xq, xs, p, gs, out_dtype)
            got = grouped_w4a8tl(xq, xs, p, gs, out_dtype)
            ms = timer(lambda: grouped_w4a8tl_on_map(xq, xs, p, tmap,
                                                     out_dtype), reps=5,
                       warmup=1)
            again = grouped_w4a8tl_on_map(xq, xs, p, tmap, out_dtype)
            torch.cuda.synchronize()
            row = {"kernel": "moe_grouped", "case": case, "rows": a, "k": k,
                   "n": n, "out": str(out_dtype).split(".")[-1],
                   "active_experts": int((sizes > 0).sum().item()),
                   "most_rows_an_expert": int(sizes.max().item()),
                   "kernel_ms": ms,
                   "equal": bool(torch.equal(got, want))
                   and bool(torch.equal(again, want)),
                   "outputs_differing": int((got != want).sum().item())}
            if tiles == 128:
                row["boundary_inside_64_rows"] = bool(
                    (offs[:-1] % 64 != 0).any().item())
            else:
                row["plan"] = grouped_plan(a, n, k, MOE_E)
            rows.append(row)
            emit({"phase": "kernel_case", **row})
            # The case must reach what it is for: a warpgroup's rows over
            # two experts (one-hot at 128-row tiles), an expert in several
            # chunks (decode sizes, one expert or experts over BM rows).
            reached = row["boundary_inside_64_rows"] if tiles == 128 \
                else row["most_rows_an_expert"] > row["plan"]["bm"]
            if not row["equal"] or not reached and (
                    case == "one-hot" if tiles == 128
                    else case in ("one expert", "experts over BM rows")):
                raise AssertionError(f"moe_grouped {case} {a}x{k}x{n}: "
                                     f"{row}")
            del want, got, again
        del p, xq, xs
    torch.cuda.empty_cache()
    return rows


def kv_ids(torch, layers, slots, blocks_per_slot, pos, inactive):
    """Decode append ids for `layers` x `slots` rows at per-slot positions
    `pos` (the model's layer-merged block ids); `inactive` slots carry the
    OOB sentinel."""
    nb = slots * blocks_per_slot
    blk = (torch.arange(slots, device="cuda") * blocks_per_slot
           + pos // PAGE)
    blk = (torch.arange(layers, device="cuda")[:, None] * nb + blk[None, :])
    blk[:, inactive] = OOB_SENTINEL
    off = (pos % PAGE)[None, :].expand(layers, slots)
    return (blk.reshape(-1).to(torch.int32).contiguous(),
            off.reshape(-1).to(torch.int32).contiguous())


def kv_rows_cases(torch, timer):
    """kv_append_rows at the llama-3.1-8b decode step's shape (32 layers x
    32 slots, two inactive slots and one id exactly B dropped), one array
    (append_rows) and K with V in one launch (append_rows_pairs, as
    decode_forward calls it), each equal to its plain version bit for bit
    in bf16, f32 and int8. The bf16 cases are timed beside index_copy_
    (one per array), and the pair beside an empty kernel's launch
    (`floor_ms`, torch.cuda._sleep(0)) with the same Timer."""
    from ferrum_tpu_torch.ops.kernels.kv_append import (
        append_rows_pairs, append_rows_pairs_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    layers, slots, bps = 32, 32, 1024 // PAGE
    b = layers * slots * bps
    pos = torch.randint(0, 1024, (slots,), generator=gen, device="cuda")
    blk, off = kv_ids(torch, layers, slots, bps, pos, inactive=[3, 17])
    blk[5] = b                                   # exactly B: dropped
    valid = (blk < b)
    n_valid = int(valid.sum().item())
    rows = []
    for dt, f in ((torch.bfloat16, 1024), (torch.float32, 8),
                  (torch.int8, 1024)):
        for arrays in (1, 2):
            pairs = []
            for _ in range(arrays):
                if dt == torch.int8:
                    cache = torch.randint(-127, 128, (b, PAGE, f),
                                          generator=gen, device="cuda",
                                          dtype=torch.int8)
                    new = torch.randint(-127, 128, (blk.numel(), f),
                                        generator=gen, device="cuda",
                                        dtype=torch.int8)
                else:
                    cache = torch.randn(b, PAGE, f, generator=gen,
                                        device="cuda").to(dt)
                    new = torch.randn(blk.numel(), f, generator=gen,
                                      device="cuda").to(dt)
                pairs.append((cache, new))
            ref = append_rows_pairs_plain([(c.clone(), r) for c, r in pairs],
                                          blk, off)
            append_rows_pairs(pairs, blk, off)
            torch.cuda.synchronize()
            err = max((c.float() - w.float()).abs().max().item()
                      for (c, _), w in zip(pairs, ref))
            row = {"kernel": "kv_append_rows",
                   "dtype": str(dt).split(".")[-1], "arrays": arrays,
                   "rows": blk.numel(), "f": f,
                   "equal": all(bool(torch.equal(c, w))
                                for (c, _), w in zip(pairs, ref)),
                   "max_abs_err": err}
            del ref
            row["bound_ms"], row["bound_by"] = bound_ms(
                arrays * 2 * n_valid * f * pairs[0][0].element_size()
                + 2 * blk.nbytes, 0)
            if dt == torch.bfloat16:
                row["kernel_ms"] = timer(
                    lambda: append_rows_pairs(pairs, blk, off))
                row["plain_ms"] = timer(
                    lambda: append_rows_pairs_plain(pairs, blk, off), reps=10)
                idx = (blk.long() * PAGE + off.long())[valid]
                copies = [(c.view(-1, f), r[valid]) for c, r in pairs]
                row["library_ms"] = timer(lambda: [
                    flat.index_copy_(0, idx, src) for flat, src in copies])
                if arrays == 2:
                    row["floor_ms"] = timer(lambda: torch.cuda._sleep(0))
            rows.append(row)
            emit({"phase": "kernel_case", **row})
            if not row["equal"]:
                raise AssertionError(f"kv_append_rows {dt} x {arrays}: "
                                     f"differs by {err}")
            del pairs
    return rows


# A decode window's append on lane A at bucket 32 with a mixed-prefill
# block: T = 8 steps of 32 lanes and P = 32 chunk rows (a 256-token
# chunk), 32 layers: 32 x 8 x 64 = 16384 rows of K and of V, F = 1024.
WIN_T, WIN_LANES, WIN_P = 8, 32, 32


def kv_window_case(torch, timer):
    """kv_append_rows at the window size append_window_kv gives it: K and
    V of one window in one launch, ids laid out as the model lays them
    (layer-major, then step, then lane, then chunk row): 31 decoding
    lanes at seeded positions, slot 5's lane a pad (dropped) while its
    256-token chunk rides the window's rows. Equal to its plain version
    bit for bit; timed beside two index_copy_ (one per array)."""
    from ferrum_tpu_torch.ops.kernels.kv_append import (
        append_rows_pairs, append_rows_pairs_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    layers, bps, f = 32, 1024 // PAGE, 1024
    nb = WIN_LANES * bps
    b = layers * nb
    pos = torch.randint(256, 1024 - WIN_T, (WIN_LANES,), generator=gen,
                        device="cuda")
    steps = torch.arange(WIN_T, device="cuda")[:, None]
    lane_flat = torch.arange(WIN_LANES, device="cuda") * 1024 + pos + steps
    lane_flat[:, 5] = OOB_SENTINEL                     # the pad lane
    chunk = 5 * 1024 + torch.arange(WIN_T * WIN_P, device="cuda")
    flat = torch.cat([lane_flat, chunk.view(WIN_T, WIN_P)], 1).reshape(-1)
    ok = flat < OOB_SENTINEL
    blk = torch.where(ok[None], torch.arange(layers, device="cuda")[:, None]
                      * nb + (flat // PAGE)[None],
                      torch.full((layers, 1), OOB_SENTINEL, device="cuda"))
    blk = blk.reshape(-1).to(torch.int32).contiguous()
    off = (flat % PAGE).repeat(layers).to(torch.int32).contiguous()
    n = blk.numel()
    pairs = [(torch.randn(b, PAGE, f, generator=gen, device="cuda")
              .to(torch.bfloat16),
              torch.randn(n, f, generator=gen, device="cuda")
              .to(torch.bfloat16)) for _ in range(2)]
    ref = append_rows_pairs_plain([(c.clone(), r) for c, r in pairs],
                                  blk, off)
    append_rows_pairs(pairs, blk, off)
    torch.cuda.synchronize()
    row = {"kernel": "kv_append_rows", "dtype": "bfloat16", "arrays": 2,
           "rows": n, "f": f, "window": True,
           "at": f"one window: {layers} layers x T={WIN_T} x "
                 f"({WIN_LANES} lanes + {WIN_P} chunk rows)",
           "equal": all(bool(torch.equal(c, w))
                        for (c, _), w in zip(pairs, ref)),
           "max_abs_err": max((c.float() - w.float()).abs().max().item()
                              for (c, _), w in zip(pairs, ref))}
    del ref
    valid = blk < b
    n_valid = int(valid.sum().item())
    row["bound_ms"], row["bound_by"] = bound_ms(
        2 * 2 * n_valid * f * 2 + blk.nbytes + off.nbytes, 0)
    row["kernel_ms"] = timer(lambda: append_rows_pairs(pairs, blk, off))
    row["plain_ms"] = timer(
        lambda: append_rows_pairs_plain(pairs, blk, off), reps=10)
    idx = (blk.long() * PAGE + off.long())[valid]
    copies = [(c.view(-1, f), r[valid]) for c, r in pairs]
    row["library_ms"] = timer(lambda: [
        flat_c.index_copy_(0, idx, src) for flat_c, src in copies])
    emit({"phase": "kernel_case", **row})
    if not row["equal"]:
        raise AssertionError(f"kv_append_rows at window size differs by "
                             f"{row['max_abs_err']}")
    del pairs, copies
    torch.cuda.empty_cache()
    return [row]


def kv_pages_cases(torch, timer):
    from ferrum_tpu_torch.ops.kernels.kv_append import (append_pages,
                                                        append_pages_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    layers, slots, bps = 32, 32, 1024 // PAGE
    nb = slots * bps
    b = layers * nb
    seqs, t = 32, 256                     # one 256-token prefill of 32 seqs
    n_pg = t // PAGE
    blk_seq = (torch.arange(seqs, device="cuda")[:, None] * bps
               + torch.arange(n_pg, device="cuda")[None, :])   # [seqs, n_pg]
    blk_seq[7, 4:] = OOB_SENTINEL         # a short chunk: pad pages dropped
    blk_seq[21, :] = OOB_SENTINEL         # a pad row
    blk = (torch.arange(layers, device="cuda")[:, None] * nb
           + blk_seq.reshape(1, -1))
    blk = torch.where(blk_seq.reshape(1, -1) >= OOB_SENTINEL,
                      torch.full_like(blk, OOB_SENTINEL), blk)
    blk = blk.reshape(-1).to(torch.int32).contiguous()
    blk[1] = b                            # exactly B: dropped
    rows = []
    cases = ((torch.bfloat16, 1024, blk), (torch.float32, 8, blk),
             (torch.int8, 1024, blk))
    for dt, f, ids in cases:
        p = ids.numel()
        if dt == torch.int8:
            cache = torch.randint(-127, 128, (b, PAGE, f), generator=gen,
                                  device="cuda", dtype=torch.int8)
            pages = torch.randint(-127, 128, (p, PAGE, f), generator=gen,
                                  device="cuda", dtype=torch.int8)
        else:
            cache = torch.randn(b, PAGE, f, generator=gen, device="cuda"
                                ).to(dt)
            pages = torch.randn(p, PAGE, f, generator=gen,
                                device="cuda").to(dt)
        ref = append_pages_plain(cache.clone(), pages, ids)
        append_pages(cache, pages, ids)
        torch.cuda.synchronize()
        err = (cache.float() - ref.float()).abs().max().item()
        row = {"kernel": "kv_append_pages", "dtype": str(dt).split(".")[-1],
               "pages": p, "f": f, "equal": bool(torch.equal(cache, ref)),
               "max_abs_err": err}
        del ref
        valid = ids < b
        n_valid = int(valid.sum().item())
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * n_valid * PAGE * f * cache.element_size() + ids.nbytes, 0)
        if dt == torch.bfloat16:
            row["kernel_ms"] = timer(lambda: append_pages(cache, pages, ids))
            row["plain_ms"] = timer(
                lambda: append_pages_plain(cache, pages, ids), reps=10)
            idx = ids.long()[valid]
            src = pages[valid]
            row["library_ms"] = timer(lambda: cache.index_copy_(0, idx, src))
        rows.append(row)
        emit({"phase": "kernel_case", **row})
        if not row["equal"]:
            raise AssertionError(f"kv_append_pages {dt}: differs by {err}")
        del cache, pages
        torch.cuda.empty_cache()
    return rows


def _summed(sel, at):
    """One summary entry: the cases' times and bounds summed (None where
    a case lacks the number)."""
    def tot(key):
        vals = [c.get(key) for c in sel]
        return None if any(v is None for v in vals) else sum(vals)
    tb = sum(c["bound_ms"] for c in sel if c["bound_by"] == "bytes")
    to = sum(c["bound_ms"] for c in sel if c["bound_by"] != "bytes")
    return {"ms": tot("kernel_ms"), "plain_ms": tot("plain_ms"),
            "library_ms": tot("library_ms"), "bound_ms": tot("bound_ms"),
            "bound_by": "bytes" if tb >= to else "operations",
            "at": f"{at}, sum over {[c['site'] for c in sel]}"}


def summarize(cases):
    """One entry per kernel: the GEMMs summed over a layer's projections
    at the serve phases' shapes, the appends at their bf16 case."""
    out = {}
    for name, key, at in (("w4a8tl_decode", "m", SERVE_DECODE_M),
                          ("w4a8tl_prefill", "m", SERVE_PREFILL_M),
                          ("w4a8tl_gd_decode", "m", SERVE_DECODE_M),
                          ("w4a8tl_prefill_mcache", "m", SERVE_PREFILL_M),
                          ("moe_bmm", "t", SERVE_BMM_T),
                          ("moe_grouped", "rows", SERVE_GROUPED_A),
                          ("w4a8_decode", "m", SERVE_DECODE_M),
                          ("w4a16_gemm", "m", SERVE_PREFILL_M),
                          ("moe_grouped_w4a16", "rows",
                           SERVE_GROUPED_W4A16_A)):
        # The dense GEMMs: a llama-3.1-8b layer's four projections.
        out[name] = _summed([c for c in cases if c["kernel"] == name
                             and c[key] == at
                             and c.get("model", "llama-3.1-8b")
                             == "llama-3.1-8b"], f"{key}={at}")
    # The appends: a decode window's K and V in one launch (the served
    # path's size), a prefill's pages of one array.
    for name in ("kv_append_rows", "kv_append_pages"):
        c = next(c for c in cases
                 if c["kernel"] == name and c["dtype"] == "bfloat16"
                 and c.get("arrays", 2) == 2
                 and c.get("window", name != "kv_append_rows"))
        out[name] = {k: c.get(k) for k in ("plain_ms", "library_ms",
                                           "bound_ms", "bound_by")}
        out[name]["ms"] = c.get("kernel_ms")
        out[name]["at"] = (f"{c.get('rows', c.get('pages'))} "
                           f"{'rows' if 'rows' in c else 'pages'}, F={c['f']}"
                           + (", K and V" if "arrays" in c else ""))
    for name in out:
        errs = [c["max_abs_err"] for c in cases if c["kernel"] == name]
        out[name]["max_abs_err"] = max(errs) if errs else None
    return out


# ---------------------------------------------------------------------------
# attention precision
# ---------------------------------------------------------------------------

# Largest share of bf16 outputs that may differ from the f32-product
# computation, each by at most one bf16 step at the output's scale
# (2^-7 of max |out|): the card's exp and f32 sums, taken in another
# order, can move a bf16 rounding of a probability or an output. Scores
# rounded to bf16 before the softmax change 30-80% of the outputs
# (measured on the CPU, tests/test_torch_ops.py).
ATTN_DIFF_SHARE = 0.02


def attention_phase(torch, device):
    """The served path's bf16 attention at the llama-3.1-8b decode and
    prefill shapes (Hq=32, Hkv=8, D=128) on `device`, against the same
    function on CPU copies of the inputs: the CPU route widens bf16 to
    f32 before every product, so it keeps the scores and the PV sums in
    f32 as the JAX package does. q is scaled so the scores spread ~6 and
    reach ~25, where bf16's spacing is 0.125."""
    from ferrum_tpu_torch.ops.attention import (flat_decode_attention,
                                                flat_prefill_attention)
    hq, hkv, d = 32, 8, 128
    f, scale = hkv * d, d ** -0.5
    gen = torch.Generator(device="cpu")
    gen.manual_seed(4)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(torch.bfloat16)

    s, c = SERVE_REQUESTS, 512                   # decode: 32 slots, bucket
    dec = [rnd(s, hq, d, std=6.0), rnd(s, c, f), rnd(s, c, f),
           torch.randint(1, c + 1, (s,), generator=gen),
           rnd(s, hkv, d), rnd(s, hkv, d)]
    b, t = 4, PROMPT_LEN                          # prefill: 4 chunks
    pos = torch.arange(t)[None] + torch.tensor([0, 256, 100, 0])[:, None]
    pos[3, 200:] = 1 << 20                        # pad rows past the end
    total = torch.tensor([256, 512, 356, 200])
    pre = [rnd(b, t, hq, d, std=6.0), rnd(b, 256, f), rnd(b, 256, f), pos,
           total, rnd(b, t, hkv, d), rnd(b, t, hkv, d)]
    out = {"phase": "attention", "card": smi_line(),
           "tolerance": f"<= {ATTN_DIFF_SHARE} of outputs differ, each by "
                        f"<= 2^-7 of max |out|"}
    for name, fn, args in (("decode", flat_decode_attention, dec),
                           ("prefill", flat_prefill_attention, pre)):
        want = fn(*args, hkv=hkv, scale=scale).float()
        got = fn(*[a.to(device) for a in args], hkv=hkv,
                 scale=scale).float().cpu()
        if name == "prefill":
            real = pos < total[:, None]
            got, want = got[real], want[real]
        diff = (got - want).abs()
        share = (diff > 0).float().mean().item()
        worst = diff.max().item() / want.abs().max().item()
        out[name] = {"share_differing": share,
                     "max_abs_diff_over_max_out": worst,
                     "max_abs_diff": diff.max().item()}
        if share > ATTN_DIFF_SHARE or worst > 2 ** -7:
            emit(out)
            raise AssertionError(f"{name} attention on {device} is not "
                                 f"the f32-product computation: {out[name]}")
    emit(out)


def sampling_phase(torch, timer):
    """sample_step's candidate pick at the serve shape (32 slots x the
    llama-3.1-8b vocabulary, 128256, k_cap 256) on logits rounded to 1/8,
    so ties straddle the cut: topk_ids (jax.lax.top_k's order, lower id
    first among ties) must give the ids of a full stable descending
    sort; CUDA-event times of both beside torch.topk (no tie order)."""
    from ferrum_tpu_torch.sampling.device import TOPK_CAP, topk_ids
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    x = torch.randn(SERVE_REQUESTS, 128256, generator=gen, device="cuda")
    x = torch.round(x * 8) / 8 + 0.0          # no -0.0: sort ranks it 0.0
    k = TOPK_CAP
    want = torch.sort(x, dim=-1, descending=True,
                      stable=True).indices[:, :k]
    got = topk_ids(x, k)
    cut = torch.sort(x, dim=-1, descending=True).values[:, k - 1:k]
    out = {"phase": "sampling", "slots": x.shape[0], "vocab": x.shape[1],
           "k_cap": k, "equal_to_stable_sort": bool(torch.equal(got, want)),
           "ties_at_cut": int((x == cut).sum().item()),
           "topk_ids_ms": timer(lambda: topk_ids(x, k)),
           "stable_sort_ms": timer(lambda: torch.sort(
               x, dim=-1, descending=True, stable=True)),
           "torch_topk_ms": timer(lambda: torch.topk(x, k, dim=-1)),
           "card": smi_line()}
    emit(out)
    if not out["equal_to_stable_sort"]:
        raise AssertionError("topk_ids is not the stable descending order")


# ---------------------------------------------------------------------------
# serve + logits
# ---------------------------------------------------------------------------

SERVE_REQUESTS, PROMPT_LEN, OUTPUT_LEN = 32, 256, 128


def drop_two_level(params) -> None:
    """Drop every int4 linear's two-level fields in place: the float-scale
    form an int4 checkpoint loads as (scales, zeros only)."""
    import dataclasses

    from ferrum_tpu_torch.ops.quant import QuantLinearParams
    for lp in params.layers:
        for obj in (lp, lp.moe) if lp.moe is not None else (lp,):
            for f in dataclasses.fields(obj):
                lin = getattr(obj, f.name)
                if isinstance(lin, QuantLinearParams):
                    lin.scales2, lin.chan_scale = None, None


def build_engine(model, mode, float_scale, layers=None):
    import dataclasses

    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.quantize import init_random_quant_params

    mc = preset(model)
    if layers is not None:
        mc = dataclasses.replace(mc, num_layers=layers)
    params = init_random_quant_params(mc, seed=0)
    if float_scale:
        drop_two_level(params)
    # bench.py's engine settings: lane buckets 1, 8 and the top, T = 32
    # at bucket 1 and 8 elsewhere; the pipelined loop with mixed
    # prefill-in-window and refill-first are the defaults.
    cfg = EngineConfig(
        max_num_seqs=SERVE_REQUESTS, max_model_len=1024,
        prefill_chunk_size=PROMPT_LEN, max_num_batched_tokens=2048,
        kv_block_size=PAGE, kv_dtype="bf16", decode_multi_step=8, seed=0,
        decode_bucket_spec="1,8", decode_t_spec="1:32", **mode)
    return mc, EngineBuilder(cfg).with_model(mc, params).build()


def request(tokens, max_tokens=OUTPUT_LEN):
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    return InferenceRequest(
        prompt_token_ids=[int(t) for t in tokens],
        sampling=SamplingParams(max_tokens=max_tokens, ignore_eos=True))


# The counts' key of moe_grouped's launches at <= 256 rows (the
# expert-grid loop), a part of its launches.
GROUPED_DECODE = "moe_grouped at <= 256 rows"


def counts(K):
    """Every kernel's launches since the last reset, and GROUPED_DECODE."""
    return {**K.launch_counts(),
            GROUPED_DECODE: K.MOE_GROUPED.decode_launches}


def off_path(lane):
    """The kernels a lane's runs must not launch: all but its path's."""
    from ferrum_tpu_torch.ops import kernels as K
    return [k.name for k in K.KERNELS if k.name not in lane["path"]]


def serve_run(torch, engine, mc, lane, prompts, path, sync_check=False):
    """len(prompts) concurrent greedy 256/128 requests (all at once)
    through the engine, the launch counts
    set to 0 just before and read just after. Every kernel of `path`
    must launch and no kernel off the lane's path. sync_check: the
    engine's dispatches run under torch.cuda.set_sync_debug_mode
    ("error"), so any host sync of the stream inside one fails the run.
    Returns (launches, responses, the emitted line)."""
    from concurrent.futures import ThreadPoolExecutor

    from ferrum_tpu_torch.ops import kernels as K

    runner = engine.runner
    conc = len(prompts)
    buckets0 = dict(runner.windows_by_bucket)
    mixed0 = runner.mixed_windows
    engine.max_inflight = 0
    runner.sync_debug = "error" if sync_check else None
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(conc) as ex:
            resps = list(ex.map(engine.infer, [request(p) for p in prompts]))
        torch.cuda.synchronize()
    finally:
        runner.sync_debug = None
    wall = time.perf_counter() - t0
    launches = counts(K)
    peak = torch.cuda.max_memory_allocated()
    for r in resps:
        if len(r.token_ids) != OUTPUT_LEN or r.completion_tokens != OUTPUT_LEN:
            raise AssertionError(f"{r.request_id}: {len(r.token_ids)} tokens")
        if not all(0 <= t < mc.vocab_size for t in r.token_ids):
            raise AssertionError(f"{r.request_id}: token out of vocab")
    name = lane["name"]
    idle = [k for k in path if launches[k] == 0]
    if idle:
        raise AssertionError(f"{name} c={conc}: kernels the served path "
                             f"never launched: {idle}")
    stray = [k for k in off_path(lane) if launches[k] != 0]
    if stray:
        raise AssertionError(f"{name} c={conc}: kernels of another route "
                             f"launched: {stray}")
    windows = {b: n - buckets0.get(b, 0)
               for b, n in sorted(runner.windows_by_bucket.items())
               if n - buckets0.get(b, 0)}
    n_windows = sum(windows.values())
    ttft = [r.ttft for r in resps]
    tpot = [(r.e2e_latency - r.ttft) / (OUTPUT_LEN - 1) for r in resps]
    line = {"phase": f"serve{lane['tag']}" + ("" if conc == SERVE_REQUESTS
                                              else f"_c{conc}"),
            "lane": name, "mode": lane["mode"], "model": lane["model"],
            "layers": mc.num_layers, "requests": conc,
            "prompt_len": PROMPT_LEN, "output_len": OUTPUT_LEN,
            "wall_s": wall, "output_tok_s": conc * OUTPUT_LEN / wall,
            "ttft_p50_ms": statistics.median(ttft) * 1e3,
            "ttft_max_ms": max(ttft) * 1e3,
            "tpot_p50_ms": statistics.median(tpot) * 1e3,
            "windows_by_bucket": windows, "mixed_windows":
            runner.mixed_windows - mixed0,
            "max_windows_in_flight": engine.max_inflight,
            "kv_append_rows_per_window":
            launches["kv_append_rows"] / max(n_windows, 1),
            "no_sync_checked": sync_check,
            "max_memory_allocated_gib": peak / 2**30,
            "launches": launches, "card": smi_line()}
    return launches, resps, line


def sync_canary(torch, runner):
    """The no-sync check can fail: under the runner's guard at "error", a
    host sync (`.item()`) raises in this torch build."""
    runner.sync_debug = "error"
    try:
        with runner.sync_guard():
            torch.ones(1, device="cuda").item()
    except RuntimeError:
        return
    finally:
        runner.sync_debug = None
    raise AssertionError("set_sync_debug_mode('error') let a sync through")


def serve_phase(torch, lane, want_solo=None):
    """The lane's serve runs on its model and mode: 32 concurrent greedy
    256/128 requests (every kernel of its path must launch and no
    other), then for lanes with `small` 1 and 4 concurrent ones (their
    path without moe_bmm: 1- and 8-lane windows take the MoE sort
    route, so moe_grouped must launch its <= 256-row loop). The prompt
    of request 0 alone, before and after the 32, must give the same
    tokens, and `want_solo` where given. Returns (launch counts by run,
    model config, engine, the solo request's tokens)."""
    import numpy as np

    name, path = lane["name"], lane["path"]
    t0 = time.perf_counter()
    mc, engine = build_engine(lane["model"], lane["mode"],
                              lane["float_scale"], lane.get("layers"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(
        0, mc.vocab_size, (SERVE_REQUESTS, PROMPT_LEN))
    # The same request alone before and after the loaded run: identical
    # tokens (deterministic, no state left behind by the run).
    solo = engine.infer(request(prompts[0])).token_ids

    if lane.get("sync_check"):
        sync_canary(torch, engine.runner)
    launches, resps, line = serve_run(torch, engine, mc, lane, prompts,
                                      path, lane.get("sync_check", False))
    repeat = engine.infer(request(prompts[0])).token_ids
    if repeat != solo:
        raise AssertionError("a repeated request gave other tokens")
    if want_solo is not None and solo != want_solo:
        raise AssertionError(f"{name}: the solo request's tokens differ "
                             f"from lane {lane['solo_as']}'s")
    emit({**line, "engine_build_s": build_s, "repeat_identical": True,
          **({"solo_tokens_equal_to": lane["solo_as"]}
             if want_solo is not None else {}),
          "batched_vs_solo_same_tokens": sum(
              a == b for a, b in zip(resps[0].token_ids, solo)) / OUTPUT_LEN})
    by_run = {name: launches}
    if lane.get("small"):
        small_path = tuple(k for k in path if k != "moe_bmm") + (
            (GROUPED_DECODE,) if "moe_grouped" in path else ())
        for conc in (1, 4):
            launches, _, line = serve_run(
                torch, engine, mc, lane, np.random.default_rng(conc).integers(
                    0, mc.vocab_size, (conc, PROMPT_LEN)), small_path)
            emit(line)
            by_run[f"{name} c={conc}"] = launches
    return by_run, mc, engine, solo


# The window check's frame: 8 lanes (bucket 8) at 256-token prompts.
WCHECK_LANES = 8
# Its tolerance on the hidden states (bf16): the share of token rows
# whose every value is within one bf16 step of the per-step form's
# (bf16_step_check's bound), and the largest difference over the scale.
WCHECK_MIN_ROWS, WCHECK_MAX_REL = 0.95, 5e-2


def window_check(torch, mc, engine):
    """From one state (8 lanes, each with its 256-token prompt prefilled),
    a T = 8 decode window through decode_forward's window form with one
    append_window_kv, against 8 per-step decode_forward calls on the same
    tokens, at the lane's full width. The window form computes the same
    attention over the frozen cache and the window's earlier steps (not
    cached yet), so its f32 sums run in another order: the hidden
    states must agree within WCHECK_MIN_ROWS /
    WCHECK_MAX_REL, layer 0's window rows of the cache bit for bit (their
    K/V precede any attention), the rest of the window rows within the
    same bound, and every other cache row stays as it was."""
    import numpy as np

    from ferrum_tpu_torch.models import llama_family as lf

    params, dev = engine.runner.params, torch.device("cuda")
    s, t, max_len = WCHECK_LANES, WIN_T, 512
    bps = max_len // PAGE
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, mc.vocab_size,
                                         (s, PROMPT_LEN))).to(dev)
    fed = torch.from_numpy(rng.integers(0, mc.vocab_size, (t, s))).to(dev)
    tables = (torch.arange(s, device=dev)[:, None] * bps
              + torch.arange(bps, device=dev)[None])
    kv = lf.PagedKvCache.create(mc, s * bps, PAGE, dtype=torch.bfloat16,
                                device=dev)
    pos = torch.arange(PROMPT_LEN, device=dev)[None].expand(s, -1)
    lf.prefill_forward_batched(
        params, mc, kv, toks, pos, tables,
        torch.full((s,), PROMPT_LEN, device=dev),
        tables[:, :1] * PAGE + pos, ctx_pad=PROMPT_LEN)
    state = (kv.k.clone(), kv.v.clone())
    p0 = torch.full((s,), PROMPT_LEN, device=dev)
    flat = [torch.arange(s, device=dev) * max_len + PROMPT_LEN + i
            for i in range(t)]
    per_step = []
    for i in range(t):
        h, _ = lf.decode_forward(params, mc, kv, fed[i], p0 + i, tables,
                                 p0 + i + 1, flat[i], ctx_pad=max_len)
        per_step.append(h)
    want_k, want_v = kv.k.clone(), kv.v.clone()
    kv.k.copy_(state[0])
    kv.v.copy_(state[1])
    f = kv.kv_heads * kv.head_dim
    win = {"k": torch.zeros((mc.num_layers, t, s, kv.kv_heads, kv.head_dim),
                            dtype=kv.k.dtype, device=dev),
           "cache_len": p0 + 1,
           "k_lins": [kv.k[li].view(s, -1, f)[:, :max_len]
                      for li in range(mc.num_layers)],
           "v_lins": [kv.v[li].view(s, -1, f)[:, :max_len]
                      for li in range(mc.num_layers)]}
    win["v"] = torch.zeros_like(win["k"])
    windowed = []
    for i in range(t):
        win["step"] = i
        win["valid"] = (torch.arange(t, device=dev) < i)[None].expand(s, t)
        h, win = lf.decode_forward(params, mc, kv, fed[i], p0 + i, None,
                                   p0 + i + 1, None, ctx_pad=max_len,
                                   win=win)
        windowed.append(h)
    lf.append_window_kv(kv, win["k"], win["v"], torch.stack(flat))
    torch.cuda.synchronize()
    got, want = torch.stack(windowed), torch.stack(per_step)
    scale = want.float().abs().max().item()
    rows = torch.cat([((g.float() - w.float()).abs()
                       <= 2.0 ** -7 * w.float().abs() + 2.0 ** -12 * scale
                       ).all(-1) for g, w in zip(got, want)])
    h_rel = (got.float() - want.float()).abs().max().item() / scale
    written = torch.zeros(s * bps * PAGE, dtype=torch.bool, device=dev)
    written[torch.stack(flat).reshape(-1)] = True
    written = written.view(s * bps, PAGE)
    cache = {}
    for name, a, w, s0 in (("k", kv.k, want_k, state[0]),
                           ("v", kv.v, want_v, state[1])):
        cache[name] = {
            "others_unchanged": bool(torch.equal(a[:, ~written],
                                                 s0[:, ~written])),
            "layer0_window_rows_equal": bool(torch.equal(
                a[0][written], w[0][written])),
            "window_rows_max_rel": ((a[:, written].float()
                                     - w[:, written].float()).abs().max()
                                    / w[:, written].float().abs().max()
                                    ).item()}
    ok = (rows.float().mean().item() >= WCHECK_MIN_ROWS
          and h_rel <= WCHECK_MAX_REL
          and all(c["others_unchanged"] and c["layer0_window_rows_equal"]
                  and c["window_rows_max_rel"] <= WCHECK_MAX_REL
                  for c in cache.values()))
    line = {"phase": "window_check", "lanes": s, "steps": t,
            "prompt_len": PROMPT_LEN,
            "tolerance": f">= {WCHECK_MIN_ROWS} of token rows within one "
                         f"bf16 step, every value within {WCHECK_MAX_REL} "
                         f"of the scale",
            "rows_within_bf16_step": rows.float().mean().item(),
            "hidden_max_rel_diff": h_rel, "hidden_scale": scale,
            "identical": bool(torch.equal(got, want)), "cache": cache,
            "ok": ok}
    emit(line)
    del kv, state, want_k, want_v, win
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"window form differs from the per-step form: "
                             f"{line}")


def logits_phase(torch, mc, engine, lane):
    """One 256-token prefill + one decode step per entry of lane["lanes"]
    of one prompt at full width, through the kernels and then through
    their plain versions (both on the card, on the serve phase's weights),
    at each depth of lane["depths"] (the model's first d layers). A step
    with n > 1 lanes runs n rows: the prompt's token in lane 0 and seeded
    random tokens in the others, every lane reading the prompt's cache and
    only lane 0 writing it (as the runner's inactive lanes). Returns the
    launch counts of the full-depth kernel run."""
    import dataclasses

    import numpy as np

    from ferrum_tpu_torch.models import llama_family as lf
    from ferrum_tpu_torch.ops import kernels as K
    from ferrum_tpu_torch.ops import moe
    from ferrum_tpu_torch.ops.kernels import kv_append, moe_gemm
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm

    lanes, tol = lane["lanes"], lane["tol"]
    max_len = 1024
    n_blocks = max_len // PAGE
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, mc.vocab_size, PROMPT_LEN)
                              ).to(dev)[None]
    others = torch.from_numpy(rng.integers(
        0, mc.vocab_size, (len(lanes), max(lanes)))).to(dev)
    tables = torch.arange(n_blocks, device=dev)[None]

    def run(params, cfg, fed=None):
        """Logits of every step; decode steps take the argmax of the
        previous step's logits, or the tokens `fed` (the kernel run's:
        bf16 logits tie often over a 100k+ vocabulary, and an argmax
        flipped by one ulp would feed the two runs different tokens)."""
        kv = lf.PagedKvCache.create(cfg, n_blocks, PAGE,
                                    dtype=torch.bfloat16, device=dev)
        pos = torch.arange(PROMPT_LEN, device=dev)[None]
        h, kv = lf.prefill_forward_batched(
            params, cfg, kv, prompt, pos, tables,
            torch.tensor([PROMPT_LEN], device=dev), pos, ctx_pad=256)
        out = [lf.logits_from_hidden(params, cfg, h[0])]
        toks_fed = []
        tok = out[0][-1:].argmax(-1)
        for step, n in enumerate(lanes):
            tok = tok if fed is None else fed[step]
            toks_fed.append(tok)
            p = torch.full((n,), PROMPT_LEN + step, device=dev)
            toks = torch.cat([tok, others[step, 1:n]])
            flat = torch.full_like(p, lf.OOB_SENTINEL)
            flat[0] = PROMPT_LEN + step
            h, kv = lf.decode_forward(params, cfg, kv, toks, p,
                                      tables.expand(n, -1), p + 1, flat,
                                      ctx_pad=512)
            out.append(lf.logits_from_hidden(params, cfg, h))
            tok = out[-1][:1].argmax(-1)
        torch.cuda.synchronize()
        return out, toks_fed

    # The plain versions, swapped in by name for the comparison runs only.
    swaps = [(qmm, "w4a8tl_decode", qmm.w4a8tl_plain),
             (qmm, "w4a8tl_gd_decode", qmm.w4a8tl_gd_plain),
             (qmm, "w4a8tl_prefill", qmm.w4a8tl_plain),
             (qmm, "w4a8_decode", qmm.w4a8_plain),
             (qmm, "w4a16_gemm", qmm.w4a16_plain),
             (lf, "append_rows_pairs", kv_append.append_rows_pairs_plain),
             (lf, "append_pages", kv_append.append_pages_plain),
             (moe, "quant_bmm_all_experts", moe_gemm.bmm_plain),
             (moe_gemm, "grouped_w4a8tl", moe_gemm.grouped_plain),
             (moe_gemm, "grouped_w4a16", moe_gemm.grouped_w4a16_plain)]
    full = engine.runner.params
    by_depth, launches = [], None
    for depth in [d for d in lane["depths"]
                  if d is None or d < mc.num_layers]:
        d = mc.num_layers if depth is None else depth
        cfg = dataclasses.replace(mc, num_layers=d)
        params = dataclasses.replace(full, layers=full.layers[:d])
        K.reset_launch_counts()
        with_kernels, fed = run(params, cfg)
        if depth is None:
            launches = counts(K)
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        try:
            plain, _ = run(params, cfg, fed)
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
        diff = max((a - b).abs().max().item()
                   for a, b in zip(with_kernels, plain))
        scale = max(b.abs().max().item() for b in plain)
        finite = all(bool(torch.isfinite(a).all()) for a in with_kernels)
        # Share of token rows (of every step) whose every logit is within
        # the tolerance.
        rows_ok = torch.cat([((a - b).abs() <= tol * scale).all(-1)
                             for a, b in zip(with_kernels, plain)])
        by_depth.append({"layers": d, "max_abs_diff": diff,
                         "max_rel_diff": diff / scale, "logit_scale": scale,
                         "rows_within_tol": rows_ok.float().mean().item(),
                         "finite": finite, "identical": diff == 0.0})
    # Lanes A, B: the kernels match their plain versions bit for bit, so
    # both runs do the same arithmetic: every logit within 1e-3 of the
    # logit scale only leaves room for library reductions that are not
    # run-to-run stable. Lanes C, D: the w4a16 kernels' f32 sums run in
    # another order than the plain versions' float64 ones, one bf16 step
    # apart on ~0.2% of outputs. On these random weights a token's hidden
    # state is dominated by a few huge components, and such a step can
    # flip a router's top-k or the sign of a cancelling one, which moves
    # that token's whole row: 99% of the token rows (measured 99.6-100%)
    # must have every logit within 2e-2 of the logit scale.
    last = by_depth[-1]
    ok = all(r["finite"] for r in by_depth) \
        and last["rows_within_tol"] >= lane["min_rows"]
    emit({"phase": f"logits{lane['tag']}",
          "steps": f"prefill {PROMPT_LEN} + decode at lanes {list(lanes)}",
          "tolerance_rel": tol, "min_rows_within_tol": lane["min_rows"],
          **{k: v for k, v in last.items() if k != "layers"},
          "by_depth": by_depth, "launches": launches})
    if not ok:
        raise AssertionError(f"logits differ: {by_depth}")
    return launches


def profile_phase(torch, mc, engine, tag, output_len=32):
    """torch.profiler over 32 concurrent 256/`output_len` requests on the
    served engine; device time by kernel and the device's busy share of
    the wall time (the profiler's own host cost inflates the wall time,
    so the busy share is a lower bound)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    prompts = np.random.default_rng(2).integers(
        0, mc.vocab_size, (SERVE_REQUESTS, PROMPT_LEN))
    reqs = [request(p, output_len) for p in prompts]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_REQUESTS) as ex:
            list(ex.map(engine.infer, reqs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type.name == "CUDA":
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    emit({"phase": f"profile{tag}",
          "requests": SERVE_REQUESTS,
          "prompt_len": PROMPT_LEN, "output_len": output_len,
          "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / (wall * 1e3),
          "launches": sum(r[1] for r in rows),
          "top": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                  for us, n, k in rows[:20]],
          "card": smi_line()})


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ferrum_tpu_torch.ops import kernels as K
    from ferrum_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    emit({"phase": "env", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.strip().splitlines()[-1],
          "device": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    timer = Timer(torch)
    cases = (gemm_rows(torch, timer) + group_dot_rows(torch, timer)
             + float_scale_rows(torch, timer)
             + kv_rows_cases(torch, timer) + kv_window_case(torch, timer)
             + kv_pages_cases(torch, timer)
             + moe_cases(torch, timer))
    onehot_cases(torch)
    prefill_exact_cases(torch)
    decode_exact_cases(torch, timer)
    float_scale_exact_cases(torch, timer)
    bmm_exact_cases(torch, timer)
    grouped_exact_cases(torch, timer)
    summary = summarize(cases)
    emit({"phase": "kernels", "card": smi, "summary": summary})
    sampling_phase(torch, timer)
    del timer
    torch.cuda.empty_cache()
    attention_phase(torch, "cuda")

    # Each served path: its kernels' counts from 0 over its serve run.
    by_path, solos = {}, {}
    for lane in LANES:
        by_run, mc, engine, solos[lane["name"]] = serve_phase(
            torch, lane, solos.get(lane.get("solo_as")))
        by_path.update(by_run)
        if lane.get("window_check"):
            window_check(torch, mc, engine)
        routes = logits_phase(torch, mc, engine, lane)
        # A 1-lane MoE decode step takes the sort route: 8 rows through
        # moe_grouped's decode-sized loop.
        missed = [k for k in lane["path"]
                  + ((GROUPED_DECODE,) if "moe_grouped" in lane["path"]
                     else ()) if routes[k] == 0]
        stray = [k for k in off_path(lane) if routes[k] != 0]
        if missed or stray:
            raise AssertionError(f"{lane['name']} logits run: never "
                                 f"launched {missed}, launched {stray}")
        if lane["profile"]:
            profile_phase(torch, mc, engine, lane["tag"])
        engine.stop()
        del engine, mc
        torch.cuda.empty_cache()

    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces,
         "launches": sum(c[k.name] for c in by_path.values()),
         "launches_by_path": {m: c[k.name] for m, c in by_path.items()},
         **({"launches_at_most_256_rows_by_path": {
             m: c[GROUPED_DECODE] for m, c in by_path.items()}}
            if k.name == "moe_grouped" else {}),
         "max_abs_err": summary[k.name]["max_abs_err"],
         "ms": summary[k.name]["ms"],
         "plain_ms": summary[k.name]["plain_ms"],
         "bound_ms": summary[k.name]["bound_ms"],
         "bound_by": summary[k.name]["bound_by"],
         "library_ms": summary[k.name]["library_ms"]}
        for k in K.KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
