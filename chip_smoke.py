#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (ferrum_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order, each printing JSON lines:
  env        nvidia-smi name/power limit, torch / CUDA / nvcc versions
  build      nvcc build of every kernel source (seconds)
  kernels    each Hopper kernel against its plain PyTorch version at the
             shapes of the served paths (llama-3.1-8b projections,
             qwen3-30b-a3b expert stacks): exact equality required;
             kernel / plain / library times (CUDA events) and the card's
             bound for the same work
  attention  the bf16 decode and prefill attention at the served shapes
             against the same function on the CPU, which takes every
             product and sum in f32 (the JAX package's precision)
Then for llama-3.1-8b (serve, logits, profile) and for qwen3-30b-a3b at
its full 48 layers (serve_moe, logits_moe, profile_moe):
  serve      EngineBuilder(model, random int4 weights, seed 0), 32
             concurrent greedy 256/128 requests through the engine;
             launch counts of every kernel over that run, each of the
             path's kernels required
  logits     one prefill + 4 decode steps at full width, kernels vs plain
             versions, both on the card; the MoE run decodes two steps
             at 32 lanes (all-experts route) and two at 1 lane (sort +
             grouped route)
  profile    torch.profiler over 32 concurrent 256/32 requests on the
             same engine: device time by kernel, device busy share

Then the kernel summary line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits nonzero
with no result line; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
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
GROUPED_A = (8, 2048, 16384)     # t = 1 decode, 256- and 2048-token prefill
SERVE_BMM_T = 32                 # decode lanes of the MoE serve phase
SERVE_GROUPED_A = 16384          # one batched MoE prefill: 2048 tokens x 8
LLAMA_PATH = ("w4a8tl_decode", "w4a8tl_prefill", "kv_append_rows",
              "kv_append_pages")
MOE_PATH = LLAMA_PATH + ("moe_bmm", "moe_grouped")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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


def bound_ms(nbytes: float, ops: float):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / INT8_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def make_gemm_weight(torch, k, n, gen):
    """Random float weight with asymmetric per-group offsets, quantized
    asymmetric and requantized two-level: non-uniform scales2, zeros and
    chan (the uniform bench init cannot catch an indexing bug)."""
    from ferrum_tpu_torch.ops.quant import (make_quant_linear,
                                            requantize_two_level)
    w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
    shift = (torch.rand(k // 128, 1, n, generator=gen, device="cuda")
             - 0.5) * 0.06
    w = (w.reshape(k // 128, 128, n) + shift).reshape(k, n)
    p = requantize_two_level(make_quant_linear(w, 128, symmetric=False))
    del w
    return p


def gemm_rows(torch, timer):
    from ferrum_tpu_torch.ops.kernels.quant_matmul import (
        quantize_activation_rows, w4a8tl_decode, w4a8tl_plain,
        w4a8tl_prefill)
    from ferrum_tpu_torch.ops.quant import two_level_w8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    rows = []
    for site, (k, n) in GEMM_SHAPES.items():
        p = make_gemm_weight(torch, k, n, gen)
        assert p.scales2.unique().numel() > 1 and p.zeros.unique().numel() > 1
        w8 = two_level_w8(p).to(torch.int8)
        w8_cm = w8.t().contiguous().t()          # column-major for _int_mm
        for kernel, ms_list in (("w4a8tl_decode", DECODE_M),
                                ("w4a8tl_prefill", PREFILL_M)):
            fn = w4a8tl_decode if kernel == "w4a8tl_decode" \
                else w4a8tl_prefill
            for m in ms_list:
                x = torch.randn(m, k, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                xq, xs = quantize_activation_rows(x)
                got = fn(xq, xs, p, torch.bfloat16)
                want = w4a8tl_plain(xq, xs, p, torch.bfloat16)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs().max().item()
                row = {"kernel": kernel, "site": site, "m": m, "k": k,
                       "n": n, "equal": bool(torch.equal(got, want)),
                       "max_abs_err": err}
                nbytes = (p.qweight.nbytes + p.scales2.nbytes
                          + p.zeros.nbytes + p.chan_scale.nbytes
                          + xq.nbytes + xs.nbytes + got.nbytes)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    nbytes, 2.0 * m * k * n)
                row["kernel_ms"] = timer(
                    lambda: fn(xq, xs, p, torch.bfloat16))
                # After 23 timed launches: the split-K scratch came back
                # zeroed every time, or this result would differ.
                row["equal"] &= bool(torch.equal(
                    fn(xq, xs, p, torch.bfloat16), want))
                row["plain_ms"] = timer(
                    lambda: w4a8tl_plain(xq, xs, p, torch.bfloat16),
                    reps=3, warmup=1)
                row["library_ms"] = None
                if m > 16:   # torch._int_mm takes m > 16 only
                    row["library_ms"] = timer(
                        lambda: torch._int_mm(xq, w8_cm))
                rows.append(row)
                emit({"phase": "kernel_case", **row})
                if not row["equal"]:
                    raise AssertionError(f"{kernel} {site} m={m}: kernel "
                                         f"differs from plain by {err}")
        del p, w8, w8_cm
        torch.cuda.empty_cache()
    return rows


def make_moe_stack(torch, k, n, gen):
    """An expert stack [MOE_E, ...] of non-uniform two-level weights (each
    expert as make_gemm_weight makes one)."""
    import dataclasses
    parts = [make_gemm_weight(torch, k, n, gen) for _ in range(MOE_E)]
    stacked = {f: torch.stack([getattr(p, f) for p in parts])
               for f in ("qweight", "scales", "zeros", "scales2",
                         "chan_scale")}
    return dataclasses.replace(parts[0], **stacked)


def stack_bytes(p, experts):
    """Bytes of `experts` experts' packed weight, scales2, zeros and chan."""
    per = (p.qweight[0].nbytes + p.scales2[0].nbytes + p.zeros[0].nbytes
           + p.chan_scale[0].nbytes)
    return experts * per


def moe_cases(torch, timer):
    """The two MoE kernels at the qwen3-30b-a3b expert shapes against
    their plain versions (exact equality), with their times."""
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (
        bmm_plain, grouped_plain, grouped_w4a8tl, quant_bmm_all_experts)
    from ferrum_tpu_torch.ops.kernels.quant_matmul import (
        quantize_activation_rows)
    from ferrum_tpu_torch.ops.moe import route_topk
    from ferrum_tpu_torch.ops.quant import dequantize
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    rows = []

    def finish(row, got, want, fn, plain, library):
        torch.cuda.synchronize()
        row["equal"] = bool(torch.equal(got, want))
        row["max_abs_err"] = (got.float() - want.float()).abs().max().item()
        row["kernel_ms"] = timer(fn)
        row["equal"] &= bool(torch.equal(fn(), want))
        row["plain_ms"] = timer(plain, reps=3, warmup=1)
        row["library_ms"] = None if library is None else timer(library)
        rows.append(row)
        emit({"phase": "kernel_case", **row})
        if not row["equal"]:
            raise AssertionError(f"{row['kernel']} {row['site']}: kernel "
                                 f"differs from plain by "
                                 f"{row['max_abs_err']}")

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
            fn = lambda: quant_bmm_all_experts(  # noqa: E731
                xq3, xs3, p, torch.bfloat16)
            got = fn()
            want = bmm_plain(xq3, xs3, p, torch.bfloat16)
            row = {"kernel": "moe_bmm", "site": site, "t": t, "k": k,
                   "n": n, "experts": MOE_E, "shared_rows": bx == 1}
            row["bound_ms"], row["bound_by"] = bound_ms(
                stack_bytes(p, MOE_E) + xq3.nbytes + xs3.nbytes
                + got.nbytes, 2.0 * MOE_E * t * k * n)
            xb = x.expand(MOE_E, t, k)
            finish(row, got, want, fn,
                   lambda: bmm_plain(xq3, xs3, p, torch.bfloat16),
                   lambda: torch.bmm(xb, w_bf16))
        for a in GROUPED_A:
            t = a // MOE_TOPK
            logits = torch.randn(t, MOE_E, generator=gen, device="cuda"
                                 ).to(torch.bfloat16)
            _, ids = route_topk(logits, MOE_TOPK, True)
            sizes = torch.bincount(ids.reshape(-1), minlength=MOE_E)
            gs = sizes.to(torch.int32)
            x = torch.randn(a, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            xq, xs = quantize_activation_rows(x)
            fn = lambda: grouped_w4a8tl(  # noqa: E731
                xq, xs, p, gs, torch.bfloat16)
            got = fn()
            want = grouped_plain(xq, xs, p, gs, torch.bfloat16)
            active = int((sizes > 0).sum().item())
            row = {"kernel": "moe_grouped", "site": site, "rows": a, "k": k,
                   "n": n, "experts": MOE_E, "active_experts": active,
                   "empty_experts": MOE_E - active,
                   "library": "torch._grouped_mm (bf16)"
                   if grouped_mm is not None else None}
            row["bound_ms"], row["bound_by"] = bound_ms(
                stack_bytes(p, active) + xq.nbytes + xs.nbytes + got.nbytes,
                2.0 * a * k * n)
            offs = torch.cumsum(sizes, 0).to(torch.int32)
            finish(row, got, want, fn,
                   lambda: grouped_plain(xq, xs, p, gs, torch.bfloat16),
                   None if grouped_mm is None
                   else lambda: grouped_mm(x, w_bf16, offs=offs))
        del p, w_bf16
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
    from ferrum_tpu_torch.ops.kernels.kv_append import (append_rows,
                                                        append_rows_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    layers, slots, bps = 32, 32, 1024 // PAGE
    b = layers * slots * bps
    pos = torch.randint(0, 1024, (slots,), generator=gen, device="cuda")
    blk, off = kv_ids(torch, layers, slots, bps, pos, inactive=[3, 17])
    blk[5] = b                                   # exactly B: dropped
    rows = []
    for dt, f in ((torch.bfloat16, 1024), (torch.float32, 8),
                  (torch.int8, 1024)):
        if dt == torch.int8:
            cache = torch.randint(-127, 128, (b, PAGE, f), generator=gen,
                                  device="cuda", dtype=torch.int8)
            new = torch.randint(-127, 128, (blk.numel(), f), generator=gen,
                                device="cuda", dtype=torch.int8)
        else:
            cache = torch.randn(b, PAGE, f, generator=gen, device="cuda"
                                ).to(dt)
            new = torch.randn(blk.numel(), f, generator=gen,
                              device="cuda").to(dt)
        ref = append_rows_plain(cache.clone(), new, blk, off)
        append_rows(cache, new, blk, off)
        torch.cuda.synchronize()
        err = (cache.float() - ref.float()).abs().max().item()
        row = {"kernel": "kv_append_rows", "dtype": str(dt).split(".")[-1],
               "rows": blk.numel(), "f": f,
               "equal": bool(torch.equal(cache, ref)), "max_abs_err": err}
        del ref
        valid = (blk < b)
        n_valid = int(valid.sum().item())
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * n_valid * f * cache.element_size() + 2 * blk.nbytes, 0)
        if dt == torch.bfloat16:
            row["kernel_ms"] = timer(
                lambda: append_rows(cache, new, blk, off))
            row["plain_ms"] = timer(
                lambda: append_rows_plain(cache, new, blk, off), reps=10)
            flat = cache.view(-1, f)
            idx = (blk.long() * PAGE + off.long())[valid]
            src = new[valid]
            row["library_ms"] = timer(lambda: flat.index_copy_(0, idx, src))
        rows.append(row)
        emit({"phase": "kernel_case", **row})
        if not row["equal"]:
            raise AssertionError(f"kv_append_rows {dt}: differs by {err}")
        del cache, new
    return rows


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
                          ("moe_bmm", "t", SERVE_BMM_T),
                          ("moe_grouped", "rows", SERVE_GROUPED_A)):
        out[name] = _summed([c for c in cases if c["kernel"] == name
                             and c[key] == at], f"{key}={at}")
    for name in ("kv_append_rows", "kv_append_pages"):
        c = next(c for c in cases
                 if c["kernel"] == name and c["dtype"] == "bfloat16")
        out[name] = {k: c.get(k) for k in ("plain_ms", "library_ms",
                                           "bound_ms", "bound_by")}
        out[name]["ms"] = c.get("kernel_ms")
        out[name]["at"] = (f"{c.get('rows', c.get('pages'))} "
                           f"{'rows' if 'rows' in c else 'pages'}, F={c['f']}")
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


# ---------------------------------------------------------------------------
# serve + logits
# ---------------------------------------------------------------------------

SERVE_REQUESTS, PROMPT_LEN, OUTPUT_LEN = 32, 256, 128


def build_engine(model):
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.quantize import init_random_quant_params

    mc = preset(model)
    params = init_random_quant_params(mc, seed=0)
    cfg = EngineConfig(
        max_num_seqs=SERVE_REQUESTS, max_model_len=1024,
        prefill_chunk_size=PROMPT_LEN, max_num_batched_tokens=2048,
        kv_block_size=PAGE, kv_dtype="bf16", decode_multi_step=8, seed=0)
    return mc, EngineBuilder(cfg).with_model(mc, params).build()


def request(tokens, max_tokens=OUTPUT_LEN):
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    return InferenceRequest(
        prompt_token_ids=[int(t) for t in tokens],
        sampling=SamplingParams(max_tokens=max_tokens, ignore_eos=True))


def serve_phase(torch, model, path):
    """32 concurrent greedy 256/128 requests on `model`; every kernel of
    `path` must launch. Returns (launch counts, model config, engine)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ferrum_tpu_torch.ops import kernels as K

    t0 = time.perf_counter()
    mc, engine = build_engine(model)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, mc.vocab_size, (SERVE_REQUESTS, PROMPT_LEN))
    # The same request alone before and after the loaded run: identical
    # tokens (deterministic, no state left behind by the run).
    solo = engine.infer(request(prompts[0])).token_ids

    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(SERVE_REQUESTS) as ex:
        resps = list(ex.map(engine.infer, [request(p) for p in prompts]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = K.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    for r in resps:
        if len(r.token_ids) != OUTPUT_LEN or r.completion_tokens != OUTPUT_LEN:
            raise AssertionError(f"{r.request_id}: {len(r.token_ids)} tokens")
        if not all(0 <= t < mc.vocab_size for t in r.token_ids):
            raise AssertionError(f"{r.request_id}: token out of vocab")
    repeat = engine.infer(request(prompts[0])).token_ids
    if repeat != solo:
        raise AssertionError("a repeated request gave other tokens")
    idle = [k for k in path if launches[k] == 0]
    if idle:
        raise AssertionError(f"kernels the served path never launched: "
                             f"{idle}")
    ttft = [r.ttft for r in resps]
    tpot = [(r.e2e_latency - r.ttft) / (OUTPUT_LEN - 1) for r in resps]
    emit({"phase": "serve" if model == "llama-3.1-8b" else "serve_moe",
          "model": model, "layers": mc.num_layers,
          "requests": SERVE_REQUESTS, "prompt_len": PROMPT_LEN,
          "output_len": OUTPUT_LEN, "engine_build_s": build_s,
          "wall_s": wall,
          "output_tok_s": SERVE_REQUESTS * OUTPUT_LEN / wall,
          "ttft_p50_ms": statistics.median(ttft) * 1e3,
          "ttft_max_ms": max(ttft) * 1e3,
          "tpot_p50_ms": statistics.median(tpot) * 1e3,
          "max_memory_allocated_gib": peak / 2**30,
          "repeat_identical": True,
          "batched_vs_solo_same_tokens": sum(
              a == b for a, b in zip(resps[0].token_ids, solo)) / OUTPUT_LEN,
          "launches": launches, "card": smi_line()})
    return launches, mc, engine


def logits_phase(torch, mc, engine, lanes=(1, 1, 1, 1)):
    """One 256-token prefill + one decode step per entry of `lanes` of
    one prompt at full width, through the kernels and then through their
    plain versions (both on the card, on the serve phase's weights). A
    step with n > 1 lanes runs n rows: the prompt's token in lane 0 and
    seeded random tokens in the others, every lane reading the prompt's
    cache and only lane 0 writing it (as the runner's inactive lanes).
    Returns the launch counts of the kernel run."""
    import numpy as np

    from ferrum_tpu_torch.models import llama_family as lf
    from ferrum_tpu_torch.ops import kernels as K
    from ferrum_tpu_torch.ops import moe
    from ferrum_tpu_torch.ops.kernels import kv_append, moe_gemm
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm

    params = engine.runner.params
    max_len = 1024
    n_blocks = max_len // PAGE
    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, mc.vocab_size, PROMPT_LEN)
                              ).to(dev)[None]
    others = torch.from_numpy(rng.integers(
        0, mc.vocab_size, (len(lanes), max(lanes)))).to(dev)
    tables = torch.arange(n_blocks, device=dev)[None]

    def run():
        kv = lf.PagedKvCache.create(mc, n_blocks, PAGE, dtype=torch.bfloat16,
                                    device=dev)
        pos = torch.arange(PROMPT_LEN, device=dev)[None]
        h, kv = lf.prefill_forward_batched(
            params, mc, kv, prompt, pos, tables,
            torch.tensor([PROMPT_LEN], device=dev), pos, ctx_pad=256)
        out = [lf.logits_from_hidden(params, mc, h[0])]
        tok = out[0][-1:].argmax(-1)
        for step, n in enumerate(lanes):
            p = torch.full((n,), PROMPT_LEN + step, device=dev)
            toks = torch.cat([tok, others[step, 1:n]])
            flat = torch.full_like(p, lf.OOB_SENTINEL)
            flat[0] = PROMPT_LEN + step
            h, kv = lf.decode_forward(params, mc, kv, toks, p,
                                      tables.expand(n, -1), p + 1, flat,
                                      ctx_pad=512)
            out.append(lf.logits_from_hidden(params, mc, h))
            tok = out[-1][:1].argmax(-1)
        torch.cuda.synchronize()
        return out

    K.reset_launch_counts()
    with_kernels = run()
    launches = K.launch_counts()
    # The plain versions, swapped in by name for this comparison only.
    swaps = [(qmm, "w4a8tl_decode", qmm.w4a8tl_plain),
             (qmm, "w4a8tl_prefill", qmm.w4a8tl_plain),
             (lf, "append_rows", kv_append.append_rows_plain),
             (lf, "append_pages", kv_append.append_pages_plain),
             (moe, "quant_bmm_all_experts", moe_gemm.bmm_plain),
             (moe_gemm, "grouped_w4a8tl", moe_gemm.grouped_plain)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        plain = run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    diff = max((a - b).abs().max().item() for a, b in zip(with_kernels, plain))
    scale = max(b.abs().max().item() for b in plain)
    finite = all(bool(torch.isfinite(a).all()) for a in with_kernels)
    # The kernels match their plain versions bit for bit, so both runs do
    # the same arithmetic: the tolerance (1e-3 of the logit scale) only
    # leaves room for library reductions that are not run-to-run stable.
    ok = finite and diff <= 1e-3 * scale
    emit({"phase": "logits" if mc.moe is None else "logits_moe",
          "steps": f"prefill {PROMPT_LEN} + decode at lanes {list(lanes)}",
          "max_abs_diff": diff, "max_rel_diff": diff / scale,
          "logit_scale": scale, "finite": finite,
          "identical": diff == 0.0, "tolerance_rel": 1e-3,
          "launches": launches})
    if not ok:
        raise AssertionError(f"logits differ: {diff} (scale {scale})")
    return launches


def profile_phase(torch, mc, engine, output_len=32):
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
    emit({"phase": "profile" if mc.moe is None else "profile_moe",
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
    cases = (gemm_rows(torch, timer) + kv_rows_cases(torch, timer)
             + kv_pages_cases(torch, timer) + moe_cases(torch, timer))
    summary = summarize(cases)
    emit({"phase": "kernels", "card": smi, "summary": summary})
    del timer
    torch.cuda.empty_cache()
    attention_phase(torch, "cuda")

    # Each served path: its kernels' counts from 0 over its serve run.
    by_path = {}
    for model, path, lanes in (
            ("llama-3.1-8b", LLAMA_PATH, (1, 1, 1, 1)),
            # 32 lanes: the all-experts route; 1 lane: sort + grouped.
            ("qwen3-30b-a3b", MOE_PATH, (SERVE_REQUESTS, SERVE_REQUESTS,
                                         1, 1))):
        launches, mc, engine = serve_phase(torch, model, path)
        by_path[model] = launches
        routes = logits_phase(torch, mc, engine, lanes)
        missed = [k for k in path if routes[k] == 0]
        if missed:
            raise AssertionError(f"{model} logits run never launched "
                                 f"{missed}")
        profile_phase(torch, mc, engine)
        engine.stop()
        del engine
        torch.cuda.empty_cache()

    emit({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces,
         "launches": sum(c[k.name] for c in by_path.values()),
         "launches_by_path": {m: c[k.name] for m, c in by_path.items()},
         "max_abs_err": summary[k.name]["max_abs_err"],
         "ms": summary[k.name]["ms"],
         "plain_ms": summary[k.name]["plain_ms"],
         "bound_ms": summary[k.name]["bound_ms"],
         "bound_by": summary[k.name]["bound_by"],
         "library_ms": summary[k.name]["library_ms"]}
        for k in K.KERNELS]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
