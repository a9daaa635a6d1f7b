#!/usr/bin/env python3
"""Time the PyTorch port's two-level w4a8 GEMMs of one source tree on a card.

    python3 tools/torch_w4a8tl_ab.py --tree DIR --label NAME
        [--only KERNEL ...] [--sweep-splits S,S,...]
        [--probe bn128|bn256|stages3|stages6|threads128|threads256|
                 decode_bn64|decode_bn128|no_mma|no_dequant|
                 gd_no_unpack|gd_no_rescale|bmm_bn64|bmm_bn128|
                 bmm_threads128|bmm_threads256|bmm_stages3|bmm_stages4|
                 bmm_stages6|bmm_no_mma|bmm_no_dequant|fs_rows|
                 fs_no_rows|fs_bn64|fs_bn128|fs_stages3|fs_stages6|
                 fs_threads128|fs_caps_off|fs_no_unpack|fs_no_fold|
                 gdec_bn<64|128>_s<3|4|6|8>_t<128|256>|gdec_bm32|
                 kv_chunks1|kv_chunks2|kv_chunks8|kv_chunks16|
                 kv_page_select ...]
        [--ptxas]
        [--out FILE]

Imports `ferrum_tpu_torch` from DIR -- this checkout, or an older one
unpacked with `git archive <commit> | tar -x -C build/<name>` (build/ is
git-ignored) -- builds its kernels there, and times, on weights and
activations made from fixed seeds (so two trees see the same inputs):

  w4a8tl_prefill,         llama-3.1-8b projections at m = 256 / 2048 /
  w4a8tl_prefill_mcache   8192, qwen3-30b-a3b qkv / o at m = 2048
  w4a8tl_decode,          llama-3.1-8b projections and qwen3-30b-a3b qkv /
  w4a8tl_gd_decode        o at m = 1 / 32 / 64 (32: the serve phase's
                          decode batch)
  moe_grouped             qwen3-30b-a3b gate / up / down expert stacks at
                          8 / 120 / 256 routed rows (t = 1, 15 and 32
                          decode; on a tree that has grouped_plan each
                          with its launch `plan`) and 2048 / 16384
                          (128-row tiles): the launch alone, on a tile map
                          built before the timed window (`ms`), and the
                          whole call, map included (`call_ms`)

each required equal to its plain version (torch.equal), beside the
card's bound and the library call (`torch._int_mm` on the int8 w8, which
takes m > 16 only; `torch._grouped_mm` on the bf16 stack). Times are
CUDA-event medians with the L2 flushed (chip_smoke.Timer). After the
cases, one `layer` line per (kernel, m) sums the four llama projections,
and one per row count sums the qwen3 layer's gate, up and down. To
compare trees, run them alternately on one machine (A B B A).

--only KERNEL (repeatable) times that kernel's cases alone, skipping the
others' and their plain versions; it also admits kernels the default run
leaves out: moe_bmm (qwen3-30b-a3b gate / up / down over its 128
experts at t = 16 / 32 / 64, beside `torch.bmm` on the bf16 stack, each
case with the launch its launcher's rule makes, `plan`, on a tree that
has moe_bmm_plan; a `layer` line at each t), and the decode kernels'
neighbours that share no code with the two-level ones but are held to
their parent's times: w4a8_decode (llama at m = 1 / 32 / 64, on a tree
that has w4a8_decode_plan each case with its `plan` and the f32
`plane_bytes` its K splits write; with `--only w4a8tl_gd_decode` too,
row 7's layer lines on the same shapes beside it) and w4a16_gemm (llama
at m = 32 and 2048; within one bf16 step of its plain version), and
kv_append_rows: a decode step's K and V appends at the llama-3.1-8b (32
layers x 32 slots, 2 KiB rows) and qwen3-30b-a3b (48 x 32, 1 KiB rows)
shapes, in bf16, as the tree's decode_forward makes them -- one launch
(append_rows_pairs) where the tree has it, else two (append_rows each)
-- (`ms`), one array alone (`single_ms`), two index_copy_ calls
(`library_ms`) and an empty kernel's launch (`floor_ms`,
torch.cuda._sleep(0)) with the same timer; and kv_append_pages: a
llama-3.1-8b batched prefill's pages (2048 rows, scattered blocks) as
bf16 K and V and as int8 K, V and their scale planes, and row 4's
8192-page one-array case -- one launch (append_pages_pairs) where the
tree has it, else one a array -- beside one array alone (`single_ms`).
--sweep-splits adds to each w4a8tl_decode, w4a8tl_gd_decode and
w4a8_decode case `sweep`, its time at each given K split count (a tree
whose wrapper takes `splits`: one with the kernel's `<kernel>_plan`;
w4a8_decode's counts are of TPU K steps). The decode cases of such a
tree carry `plan`, the launch its launcher's rule makes.

--probe bn128 / bn256 adds `ms_<probe>` to the moe_grouped cases at
128-row tiles: the launch on a copy of the tree's moe_gemm.cu built with
its column-tile rule forced to 128 / 256 columns (where N allows).
--probe stages3 / stages6 / threads128 / threads256 / decode_bn64 /
decode_bn128 adds `ms_<probe>` to the w4a8tl_decode cases: w4a8tl_gemm.cu
built on a copy of the streamed loop's header (w4a8tl_stream.cuh, where
the launcher's rules live) with the decode ring's depth set to 3 / 6
stages, 128 or 256 threads a block everywhere, or its column tiles
forced to 64, or to 128 where N allows; no_mma / no_dequant times the
loop with that part cut from every step but one (wrong results, not
compared). gd_no_unpack / gd_no_rescale adds `ms_<probe>` to the
w4a8tl_gd_decode cases: w4a8tl_gd.cu with the group-dot form's unpack
cut from every step but the first, or its rescale's multiply-adds (so
the column scales and row sums go unused) cut, the dots added unscaled
(wrong results, not compared); gd_per_group_all / gd_per_step set the
group-dot form's rule (w4a8tl_stream.cuh: kGdPerGroupMinBN 64 or 256),
and gd_stages3 .. gd_decode_bn128 the launcher's rules above, on
w4a8tl_gd.cu. bmm_bn64 / bmm_bn128 / bmm_threads128 / bmm_threads256 /
bmm_stages3 / bmm_stages4 / bmm_stages6 adds `ms_<probe>` to the moe_bmm
cases: moe_gemm.cu built with the bmm launcher's column tiles forced to
64, or to 128 where N allows, 128 or 256 threads a block everywhere, or
its ring 3, 4 or 6 stages deep at every BM; bmm_no_mma / bmm_no_dequant
the bmm on a copy of the streamed loop's header with that part cut from
every step but one (wrong results, not compared). fs_rows / fs_no_rows /
fs_bn64 / fs_bn128 / fs_stages3 / fs_stages6 / fs_threads128 /
fs_caps_off adds `ms_<probe>` (and `plan_<probe>`) to the w4a8_decode
cases: w4a8_gemm.cu built with its launcher's row tiles forced to 16
rows or to none (all of m a block, up to the largest tile that fits),
its column tiles forced to 64, or to 128 where N allows, its ring 3 or
6 stages deep, 128 threads a block, or no register caps; fs_no_unpack /
fs_no_fold its loop without the unpack on all steps but the first, or
without the group terms and the TPU-step fold on all groups but the
last (wrong results, not compared). gdec_bn<BN>_s<S>_t<T> (BN 64 or
128, S 3 / 4 / 6 / 8, T 128 or 256) / gdec_bm32 adds `ms_<probe>` (and
`plan_<probe>`) to the moe_grouped cases at <= 256 rows: moe_gemm.cu
built with the decode-sized grouped launcher launching BN columns, an S
stage ring and T threads a block everywhere, or 32-row chunks.
kv_chunks1 / kv_chunks2 / kv_chunks8 / kv_chunks16 adds `ms_<probe>` to
the kv_append_rows cases: kv_append.cu built with that many 16-byte
chunks a thread; kv_page_select likewise to the kv_append_pages cases:
the array's fields picked by blockIdx.y before one copy loop (the form
first written) instead of one loop per array. A probe launches with
the K split count
the tree's own rule picks; --ptxas prints each probe build's registers
too.
--ptxas compiles the sources on the int8 wgmma main loop and the three
decode sources with `-Xptxas -v` and prints each kernel's registers and
spills, and fails on a C7518 (ptxas serialized a kernel's wgmma).

Prints one JSON line per case and appends each to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
         "down": (14336, 4096)}
PREFILL_M = (256, 2048, 8192)
DECODE_MS = (1, 32, 64)
QWEN = {"qkv": (2048, 5120), "o": (4096, 2048)}
QWEN_M = 2048
MOE = {"gate": (2048, 768), "up": (2048, 768), "down": (768, 2048)}
GROUPED_A = (8, 120, 256, 2048, 16384)
BMM_T = (16, 32, 64)
PREFILL = ("w4a8tl_prefill", "w4a8tl_prefill_mcache")
DECODE = ("w4a8tl_decode", "w4a8tl_gd_decode")
DEFAULT = PREFILL + DECODE + ("moe_grouped",)
NEIGHBOURS = ("moe_bmm", "w4a8_decode", "w4a16_gemm", "kv_append_rows",
              "kv_append_pages")
# kv_append_rows: (layers, F) of a decode step's appends, 32 slots, bf16.
KV_SHAPES = {"llama-3.1-8b": (32, 1024), "qwen3-30b-a3b": (48, 512)}
# --probe: (library, file of csrc/ edited, the rule replaced, its
# replacement -- or None, the rule then a tuple of (rule, replacement)
# pairs --, kernel timed, whether the probe computes the function).
STREAM = "w4a8tl_stream.cuh"
PROBES = {
    "bn128": ("moe_gemm", "moe_gemm.cu", r"const bool wide = [^;]*;",
              "const bool wide = false;", "moe_grouped", True),
    "bn256": ("moe_gemm", "moe_gemm.cu", r"const bool wide = [^;]*;",
              "const bool wide = N % 256 == 0;", "moe_grouped", True),
    "stages3": ("w4a8tl_gemm", STREAM,
                r"constexpr int kDecodeStages = \d+;",
                "constexpr int kDecodeStages = 3;", "w4a8tl_decode", True),
    "stages6": ("w4a8tl_gemm", STREAM,
                r"constexpr int kDecodeStages = \d+;",
                "constexpr int kDecodeStages = 6;", "w4a8tl_decode", True),
    "threads128": ("w4a8tl_gemm", STREAM,
                   r"const bool few = [^;]*;", "const bool few = true;",
                   "w4a8tl_decode", True),
    "threads256": ("w4a8tl_gemm", STREAM,
                   r"const bool few = [^;]*;", "const bool few = false;",
                   "w4a8tl_decode", True),
    "decode_bn64": ("w4a8tl_gemm", STREAM,
                    r"const bool narrow = [^;]*;", "const bool narrow = true;",
                    "w4a8tl_decode", True),
    "decode_bn128": ("w4a8tl_gemm", STREAM,
                     r"const bool narrow = [^;]*;",
                     "const bool narrow = a.N % 128 != 0;", "w4a8tl_decode",
                     True),
    # Cuts (wrong results, timed only): the decode loop without its
    # mma, or without its dequant, on all steps but the first / last.
    "no_mma": ("w4a8tl_gemm", STREAM,
               r"\n        mma\(acc, stage\(j\), w8\[j & 1\]\);", "",
               "w4a8tl_decode", False),
    "no_dequant": ("w4a8tl_gemm", STREAM,
                   r"\n        dequant\(stage\(j \+ 1\), w8\[\(j \+ 1\) "
                   r"& 1\], sc\);", "", "w4a8tl_decode", False),
    # Cuts of the group-dot form (wrong results, timed only): without its
    # unpack on all steps but the first, or with the dot added unscaled
    # (no column scales, sx or multiply-adds).
    # The group-dot form's rule: the dot rescaled once a group at every
    # BN, or at none.
    "gd_per_group_all": ("w4a8tl_gd", STREAM,
                         r"constexpr int kGdPerGroupMinBN = \d+;",
                         "constexpr int kGdPerGroupMinBN = 64;",
                         "w4a8tl_gd_decode", True),
    "gd_per_step": ("w4a8tl_gd", STREAM,
                    r"constexpr int kGdPerGroupMinBN = \d+;",
                    "constexpr int kGdPerGroupMinBN = 256;",
                    "w4a8tl_gd_decode", True),
    # Cuts of the group-dot form (wrong results, timed only): without its
    # unpack on all steps but the first, or with the dots added unscaled
    # and uncorrected (no multiply-adds; the column scales and row sums
    # then unused).
    "gd_no_unpack": ("w4a8tl_gd", STREAM,
                     r"\n        unpack\(stage\(j \+ 1\), w8\[\(j \+ 1\) "
                     r"& 1\]\);", "", "w4a8tl_gd_decode", False),
    "gd_no_rescale": ("w4a8tl_gd", STREAM,
                      ((r" \* cs\.s2\[h\]\[j\]\[e & 1\]\);", ");"),
                       (r"\s*- \(uint32_t\)sx\[i\]\[e >> 1\] \* "
                        r"cs\.s2z\[h\]\[j\]\[e & 1\]\);", ");")), None,
                      "w4a8tl_gd_decode", False),
}
# The bmm launcher's rules (moe_gemm.cu) and cuts of its main loop.
PROBES.update({
    "bmm_bn64": ("moe_gemm", "moe_gemm.cu", r"const bool bmm_wide =[^;]*;",
                 "const bool bmm_wide = false;", "moe_bmm", True),
    "bmm_bn128": ("moe_gemm", "moe_gemm.cu", r"const bool bmm_wide =[^;]*;",
                  "const bool bmm_wide = a.N % 128 == 0;", "moe_bmm", True),
    "bmm_threads128": ("moe_gemm", "moe_gemm.cu",
                       r"const bool bmm_few = [^;]*;",
                       "const bool bmm_few = true;", "moe_bmm", True),
    "bmm_threads256": ("moe_gemm", "moe_gemm.cu",
                       r"const bool bmm_few = [^;]*;",
                       "const bool bmm_few = false;", "moe_bmm", True),
    **{f"bmm_stages{d}": ("moe_gemm", "moe_gemm.cu",
                          r"constexpr int kBmmStages = [^;]*;",
                          f"constexpr int kBmmStages = {d};", "moe_bmm", True)
       for d in (3, 4, 6)},
    "bmm_no_mma": ("moe_gemm",) + PROBES["no_mma"][1:4] + ("moe_bmm", False),
    "bmm_no_dequant": ("moe_gemm",) + PROBES["no_dequant"][1:4]
    + ("moe_bmm", False),
})
# The float-scale decode kernel (w4a8_gemm.cu's launcher, the float-scale
# form of the streamed loop's header): row tiles forced to 16 rows, or
# none (all of m a block, up to the largest tile that fits); 64 columns
# everywhere, or 128 wherever N allows; its ring 3 or 6 stages deep; 128
# threads; no register caps (ptxas's own count); and its loop without the
# unpack on all steps but the first, or without the terms and fold on
# all groups but the last.
FS = ("w4a8_gemm", "w4a8_gemm.cu")
PROBES.update({
    "fs_rows": FS + (r"constexpr int kFsMaxBM = \d+;",
                     "constexpr int kFsMaxBM = 16;", "w4a8_decode", True),
    "fs_no_rows": FS + (r"constexpr int kFsMinBM = \d+;",
                        "constexpr int kFsMinBM = 64;", "w4a8_decode", True),
    "fs_bn64": FS + (r"const bool fs_narrow = [^;]*;",
                     "const bool fs_narrow = true;", "w4a8_decode", True),
    "fs_bn128": FS + (r"const bool fs_narrow = [^;]*;",
                      "const bool fs_narrow = a.N % 128 != 0;",
                      "w4a8_decode", True),
    **{f"fs_stages{d}": FS + (r"constexpr int kFsStages = \d+;",
                              f"constexpr int kFsStages = {d};",
                              "w4a8_decode", True) for d in (3, 6)},
    "fs_threads128": FS + (r"constexpr int kFsThreads = \d+;",
                           "constexpr int kFsThreads = 128;", "w4a8_decode",
                           True),
    "fs_caps_off": FS + (r"if \(kThreads == 256\) return [^;]*;\n"
                         r"  return [^;]*;", "return 1;", "w4a8_decode",
                         True),
    "fs_no_unpack": ("w4a8_gemm", STREAM,
                     r"\n      L::unpack\(stage\(j \+ 1\), nib\[\(j \+ 1\) "
                     r"& 1\]\);", "", "w4a8_decode", False),
    "fs_no_fold": ("w4a8_gemm", STREAM, r"\n      if \(j & 1\) group_end\(j\);",
                   "", "w4a8_decode", False),
})
# The decode-sized grouped launcher's configurations (moe_gemm.cu),
# applied at <= 256 rows, and the rows append's chunks a thread
# (kv_append.cu).
MG = ("moe_gemm", "moe_gemm.cu")
PROBES.update({
    # One configuration everywhere: BN, ring stages, threads.
    **{f"gdec_bn{bn}_s{d}_t{t}": MG + (
        r"return grouped_wide \? grouped_bn<128>\(a\) : grouped_bn<64>\(a\);",
        f"return grouped<{bn}, {d}, {t}>(a);", "moe_grouped", True)
       for bn in (64, 128) for d in (3, 4, 6, 8) for t in (128, 256)},
    "gdec_bm32": MG + (r"constexpr int kGroupedBM = \d+;",
                       "constexpr int kGroupedBM = 32;", "moe_grouped",
                       True),
    **{f"kv_chunks{c}": ("kv_append", "kv_append.cu",
                         r"constexpr int kRowChunks = \d+;",
                         f"constexpr int kRowChunks = {c};",
                         "kv_append_rows", True) for c in (1, 2, 8, 16)},
    # The page kernel as first written: the array's fields picked by
    # blockIdx.y, then one copy loop.
    "kv_page_select": ("kv_append", "kv_append.cu", re.escape(
        "  switch (blockIdx.y) {\n"
        "    case 0: copy_array_page<0>(pa, b, p); break;\n"
        "    case 1: copy_array_page<1>(pa, b, p); break;\n"
        "    case 2: copy_array_page<2>(pa, b, p); break;\n"
        "    default: copy_array_page<3>(pa, b, p); break;\n"
        "  }"),
        "  uint8_t* cache = pa.cache[0];\n"
        "  const uint8_t* pages = pa.pages[0];\n"
        "  long long page_bytes = pa.page_bytes[0];\n"
        "  int vec16 = pa.vec16[0];\n"
        "#pragma unroll\n"
        "  for (int i = 1; i < kMaxPairs; ++i) {\n"
        "    if ((int)blockIdx.y == i) {\n"
        "      cache = pa.cache[i]; pages = pa.pages[i];\n"
        "      page_bytes = pa.page_bytes[i]; vec16 = pa.vec16[i];\n"
        "    }\n"
        "  }\n"
        "  copy_bytes(cache + b * page_bytes,\n"
        "             pages + (long long)p * page_bytes, page_bytes, vec16,\n"
        "             threadIdx.x, blockDim.x);",
        "kv_append_pages", True),
})
# The launcher's rules probed on the group-dot kernel: gd_stages3 .. .
PROBES.update({
    f"gd_{name}": ("w4a8tl_gd", STREAM, rule, repl, "w4a8tl_gd_decode", True)
    for name, (_, _, rule, repl, _, _) in list(PROBES.items())
    if name in ("stages3", "stages6", "threads128", "threads256",
                "decode_bn64", "decode_bn128")})
PTXAS_SOURCES = ("w4a8tl_gemm", "w4a8tl_mcache", "moe_gemm", "w4a8tl_gd",
                 "w4a8_gemm", "kv_append")


def load_smoke():
    """chip_smoke.py of this checkout, for its Timer and input makers
    (they import ferrum_tpu_torch lazily: the tree under test's)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def emit(out, row):
    line = json.dumps(row)
    print(line, flush=True)
    if out:
        with open(out, "a") as f:
            f.write(line + "\n")


def dense_rows(torch, smoke, timer, args, probe_libs):
    """The selected dense two-level kernels, each case on one weight and
    one activation shared by the kernels of its m; returns the rows."""
    from ferrum_tpu_torch.ops.kernels import build
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    cases = [("llama-3.1-8b", site, kn, DECODE_MS + PREFILL_M)
             for site, kn in LLAMA.items()]
    cases += [("qwen3-30b-a3b", site, kn, DECODE_MS + (QWEN_M,))
              for site, kn in QWEN.items()]
    rows = []
    for model, site, (k, n), ms in cases:
        if not any(args.selected(kn) for kn in PREFILL + DECODE):
            break
        p = smoke.make_gemm_weight(torch, k, n, gen)
        w8_cm = smoke.int_mm_weight(torch, p)
        wbytes = (p.qweight.nbytes + p.scales2.nbytes + p.zeros.nbytes
                  + p.chan_scale.nbytes)
        for m in ms:
            x = torch.randn(m, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            kernels = [kn for kn in (DECODE if m <= 64 else PREFILL)
                       if args.selected(kn)]
            if not kernels:
                continue
            xq, xs = qmm.quantize_activation_rows(x)
            want = qmm.w4a8tl_plain(xq, xs, p, torch.bfloat16)
            bound, by = smoke.bound_ms(
                wbytes + xq.nbytes + xs.nbytes + 2 * m * n, 2.0 * m * k * n)
            library_ms = timer(lambda: torch._int_mm(xq, w8_cm)) \
                if m > 16 else None
            for kernel in kernels:
                fn = getattr(qmm, kernel)
                got = fn(xq, xs, p, torch.bfloat16)
                ms_ = timer(lambda: fn(xq, xs, p, torch.bfloat16))
                row = {"tree": args.label, "kernel": kernel, "model": model,
                       "site": site, "m": m, "k": k, "n": n, "ms": ms_,
                       "library_ms": library_ms, "bound_ms": bound,
                       "bound_by": by}
                ok = bool(torch.equal(got, want))
                plan = getattr(qmm, f"{kernel}_plan", None) \
                    if kernel in DECODE else None
                if plan is not None:
                    row["plan"] = plan(m, n, k)
                if plan is not None and args.sweep_splits:
                    row["sweep"] = {}
                    for sp in args.sweep_splits:
                        def call():
                            return fn(xq, xs, p, torch.bfloat16, splits=sp)
                        ok &= bool(torch.equal(call(), want))
                        row["sweep"][sp] = timer(call)
                for probe, lib in probe_libs.items():
                    source, _, _, _, probed, computes = PROBES[probe]
                    if probed != kernel:
                        continue
                    saved = build._libs.get(source)
                    build._libs[source] = lib
                    if computes:
                        ok &= bool(torch.equal(
                            fn(xq, xs, p, torch.bfloat16), want))
                    row[f"ms_{probe}"] = timer(
                        lambda: fn(xq, xs, p, torch.bfloat16))
                    build._libs[source] = saved
                again = fn(xq, xs, p, torch.bfloat16)
                row["equal"] = ok and bool(torch.equal(again, want))
                emit(args.out, row)
                rows.append(row)
                if not row["equal"]:
                    raise AssertionError(f"{kernel} {site} m={m} differs")
        del p, w8_cm
        torch.cuda.empty_cache()
    return rows


def neighbour_rows(torch, smoke, timer, args, probe_libs):
    """moe_bmm, w4a8_decode and w4a16_gemm where --only names them; each
    against its plain version (w4a16_gemm within one bf16 step)."""
    from ferrum_tpu_torch.ops.kernels import build
    from ferrum_tpu_torch.ops.kernels import moe_gemm
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    from ferrum_tpu_torch.ops.quant import dequantize
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    rows = []
    fs_plan = getattr(qmm, "w4a8_decode_plan", None)

    def case(kernel, site, shape, fn, plain, exact, bound, extra=None,
             sweep=None):
        got, want = fn(), plain()
        row = {"tree": args.label, "kernel": kernel, "site": site, **shape,
               "ms": timer(fn), "bound_ms": bound[0], "bound_by": bound[1],
               **(extra or {})}
        ok = True
        if sweep is not None and args.sweep_splits:
            row["sweep"] = {}
            for sp in args.sweep_splits:
                ok &= bool(torch.equal(sweep(sp), want))
                row["sweep"][sp] = timer(lambda: sweep(sp))
        for probe, lib in probe_libs.items():
            source, _, _, _, probed, computes = PROBES[probe]
            if probed != kernel:
                continue
            saved = build._libs.get(source)
            build._libs[source] = lib
            qmm._DECODE_PLANS.clear()      # the probe's launcher plans
            if computes:
                ok &= bool(torch.equal(fn(), want))
            row[f"ms_{probe}"] = timer(fn)
            if kernel == "w4a8_decode" and fs_plan is not None:
                row[f"plan_{probe}"] = fs_plan(shape["m"], shape["n"],
                                               shape["k"])
            build._libs[source] = saved
            qmm._DECODE_PLANS.clear()
        again = fn()
        if exact:
            ok &= bool(torch.equal(got, want)) and bool(torch.equal(again,
                                                                    want))
        else:
            ok &= smoke.bf16_step_check(got, want)[0] \
                and bool(torch.equal(again, got))
        row["equal" if exact else "within_bf16_step"] = ok
        emit(args.out, row)
        rows.append(row)
        if not ok:
            raise AssertionError(f"{kernel} {site} {shape} differs")

    if args.selected("moe_bmm"):
        plan = getattr(moe_gemm, "moe_bmm_plan", None)
        for site, (k, n) in MOE.items():
            p = smoke.make_moe_stack(torch, k, n, gen)
            w_bf16 = dequantize(p, torch.bfloat16)            # [E, K, N]
            bx = 1 if site != "down" else smoke.MOE_E
            for t in BMM_T:
                x = torch.randn(bx, t, k, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                xq, xs = qmm.quantize_activation_rows(x.reshape(bx * t, k))
                xq3, xs3 = xq.reshape(bx, t, k), xs.reshape(bx, t, 1)
                xb = x.expand(smoke.MOE_E, t, k)
                extra = {"library_ms": timer(lambda: torch.bmm(xb, w_bf16))}
                if plan is not None:
                    extra["plan"] = plan(t, n, k, smoke.MOE_E)
                case("moe_bmm", site, {"t": t, "k": k, "n": n},
                     lambda: moe_gemm.quant_bmm_all_experts(
                         xq3, xs3, p, torch.bfloat16),
                     lambda: moe_gemm.bmm_plain(xq3, xs3, p, torch.bfloat16),
                     True, smoke.bound_ms(
                         smoke.stack_bytes(p, smoke.MOE_E) + xq3.nbytes
                         + xs3.nbytes + 2 * smoke.MOE_E * t * n,
                         2.0 * smoke.MOE_E * t * k * n), extra)
            del p, w_bf16
            torch.cuda.empty_cache()
    for kernel, ms in (("w4a8_decode", DECODE_MS),
                       ("w4a16_gemm", (32, 2048))):
        if not args.selected(kernel):
            continue
        for site, (k, n) in LLAMA.items():
            p = smoke.make_gemm_weight(torch, k, n, gen, two_level=False)
            wbytes = p.qweight.nbytes + p.scales.nbytes + p.zeros.nbytes
            for m in ms:
                x = torch.randn(m, k, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                if kernel == "w4a8_decode":
                    xq, xs = qmm.quantize_activation_rows(x)
                    extra, sweep = {}, None
                    if fs_plan is not None:
                        extra["plan"] = fs_plan(m, n, k)
                        extra["plane_bytes"] = 4 * m * n \
                            * extra["plan"]["planes"]

                        def sweep(sp):
                            return qmm.w4a8_decode(xq, xs, p, torch.bfloat16,
                                                   splits=sp)
                    case(kernel, site, {"m": m, "k": k, "n": n},
                         lambda: qmm.w4a8_decode(xq, xs, p, torch.bfloat16),
                         lambda: qmm.w4a8_plain(xq, xs, p, torch.bfloat16),
                         True, smoke.bound_ms(
                             wbytes + xq.nbytes + xs.nbytes + 2 * m * n,
                             2.0 * m * k * n), extra, sweep)
                else:
                    case(kernel, site, {"m": m, "k": k, "n": n},
                         lambda: qmm.w4a16_gemm(x, p),
                         lambda: qmm.w4a16_plain(x, p), False,
                         smoke.bound_ms(wbytes + x.nbytes + 2 * m * n,
                                        2.0 * m * k * n,
                                        smoke.BF16_FLOPS_PER_S))
            del p
            torch.cuda.empty_cache()
    return rows


def probe_libraries(build, probes, args):
    """{probe: the tree's library of PROBES[probe]'s source, built from a
    copy of its sources with the probe's rule replaced}, one nvcc process
    a probe, all started together; with --ptxas, each build's registers
    and spills too."""
    procs = {}
    for probe in probes:
        source, fname, rule, repl = PROBES[probe][:4]
        root = os.path.join(build.BUILD_ROOT, "probe", probe)
        shutil.rmtree(root, ignore_errors=True)
        csrc = os.path.join(root, "csrc")
        shutil.copytree(build.CSRC, csrc)
        path = os.path.join(csrc, fname)
        with open(path) as f:
            text = f.read()
        for rule_, repl_ in (rule if repl is None else ((rule, repl),)):
            text, n = re.subn(rule_, repl_, text, count=1)
            if n != 1:
                raise RuntimeError(f"{probe}: no rule {rule_!r} in {path}")
        with open(path, "w") as f:
            f.write(text)
        so = os.path.join(root, f"lib{source}.so")
        verbose = ["-Xptxas", "-v"] if args.ptxas else []
        procs[probe] = (so, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *verbose, "-o", so,
             os.path.join(csrc, f"{source}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for probe, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{probe}: nvcc exit {proc.returncode}\n{log}")
        if args.ptxas:
            ptxas_rows(args, f"{PROBES[probe][0]}:{probe}", log)
        lib = ctypes.CDLL(so)
        for fn, argtypes in build.SIGNATURES[PROBES[probe][0]].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[probe] = lib
    return libs


def ptxas_report(build, args):
    """Registers and spills of every kernel of the sources on the int8
    wgmma main loop and the two decode sources (`nvcc -Xptxas -v`, one
    process a source, in parallel); raises on a C7518."""
    root = os.path.join(build.BUILD_ROOT, "ptxas")
    os.makedirs(root, exist_ok=True)
    procs = [(name, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(root, f"lib{name}.so"),
         os.path.join(build.CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name in PTXAS_SOURCES]
    serialized = []
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}: exit {proc.returncode}\n{log}")
        serialized += ptxas_rows(args, name, log)
    if serialized:
        raise AssertionError(f"ptxas serialized wgmma: {serialized}")


def ptxas_rows(args, name, log):
    """Emit each kernel's registers and spills from `nvcc -Xptxas -v`'s
    log of source `name`; returns its C7518 lines."""
    serialized = []
    fn = spills = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn, spills = m.group(1), None
        elif "C7518" in line:
            serialized.append(line.strip())
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if m and fn:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            emit(args.out, {"tree": args.label, "ptxas": name,
                            "kernel": fn, "registers": int(m.group(1)),
                            "spill_stores_loads": spills})
            fn = None
    return serialized


def tile_windows(tile_map, bm):
    """Rows of its expert in each valid logical tile of a tile map (the
    rows the kernel's block for that tile computes for real)."""
    gid, mtid, offsets, valid = (t.tolist() for t in tile_map)
    wins = [min(offsets[e + 1], mt * bm + bm) - max(offsets[e], mt * bm)
            for e, mt, v in zip(gid, mtid, valid) if v]
    return [w for w in wins if w > 0]


def grouped_rows(torch, smoke, timer, args, probe_libs):
    """moe_grouped at the qwen3 expert sites; returns the rows."""
    from ferrum_tpu_torch.ops.kernels import build, moe_gemm
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (grouped_bm,
                                                       grouped_map,
                                                       grouped_plain,
                                                       grouped_w4a8tl,
                                                       grouped_w4a8tl_on_map)
    from ferrum_tpu_torch.ops.kernels.quant_matmul import (
        quantize_activation_rows)
    from ferrum_tpu_torch.ops.quant import dequantize
    gen = torch.Generator(device="cuda")
    gen.manual_seed(14)
    rows = []
    if not args.selected("moe_grouped"):
        return rows
    for site, (k, n) in MOE.items():
        p = smoke.make_moe_stack(torch, k, n, gen)
        w_bf16 = dequantize(p, torch.bfloat16)
        for a in GROUPED_A:
            sizes = smoke.routed_sizes(torch, gen, a)
            gs = sizes.to(torch.int32)
            x = torch.randn(a, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            xq, xs = quantize_activation_rows(x)
            tmap = grouped_map(gs, a)
            active = int((sizes > 0).sum().item())
            bound, by = smoke.bound_ms(
                smoke.stack_bytes(p, active) + xq.nbytes + xs.nbytes
                + 2 * a * n, 2.0 * a * k * n)
            offs = torch.cumsum(sizes, 0).to(torch.int32)
            grouped_mm = getattr(torch, "_grouped_mm", None)

            def launch():
                return grouped_w4a8tl_on_map(xq, xs, p, tmap, torch.bfloat16)
            want = grouped_plain(xq, xs, p, gs, torch.bfloat16)
            ok = bool(torch.equal(launch(), want))
            wins = tile_windows(tmap, grouped_bm(a))
            plan = getattr(moe_gemm, "grouped_plan", None)
            row = {"tree": args.label, "kernel": "moe_grouped",
                   "site": site, "rows": a, "bm": grouped_bm(a), "k": k,
                   "n": n, "active_experts": active,
                   "valid_tiles": len(wins),
                   "rows_per_valid_tile": a / len(wins),
                   "valid_tiles_at_most_64_rows": sum(w <= 64 for w in wins),
                   "ms": timer(launch),
                   "call_ms": timer(lambda: grouped_w4a8tl(
                       xq, xs, p, gs, torch.bfloat16)),
                   "library_ms": None if grouped_mm is None else timer(
                       lambda: grouped_mm(x, w_bf16, offs=offs)),
                   "bound_ms": bound, "bound_by": by}
            if row["bm"] == 16 and plan is not None:
                row["plan"] = plan(a, n, k, smoke.MOE_E)
            saved = build._libs.get("moe_gemm")
            for probe, lib in probe_libs.items():
                # gdec_* probes at decode sizes, the others at 128-row
                # tiles.
                if PROBES[probe][4] != "moe_grouped" or (
                        probe.startswith("gdec_") != (row["bm"] == 16)):
                    continue
                build._libs["moe_gemm"] = lib
                ok &= bool(torch.equal(launch(), want))
                row[f"ms_{probe}"] = timer(launch)
                if row["bm"] == 16:
                    row[f"plan_{probe}"] = plan(a, n, k, smoke.MOE_E)
            build._libs["moe_gemm"] = saved
            row["equal"] = ok and bool(torch.equal(launch(), want))
            emit(args.out, row)
            rows.append(row)
            if not row["equal"]:
                raise AssertionError(f"moe_grouped {site} {a} differs")
        del p, w_bf16
        torch.cuda.empty_cache()
    return rows


def kv_rows(torch, smoke, timer, args, probe_libs):
    """kv_append_rows at a decode step's K and V shapes (KV_SHAPES), as
    the tree's decode_forward appends them, equal to the plain appends;
    returns the rows."""
    from ferrum_tpu_torch.ops.kernels import build
    from ferrum_tpu_torch.ops.kernels import kv_append as kva
    rows = []
    if not args.selected("kv_append_rows"):
        return rows
    pairs_fn = getattr(kva, "append_rows_pairs", None)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    slots, bps = 32, 1024 // smoke.PAGE
    for model, (layers, f) in KV_SHAPES.items():
        b = layers * slots * bps
        pos = torch.randint(0, 1024, (slots,), generator=gen, device="cuda")
        blk, off = smoke.kv_ids(torch, layers, slots, bps, pos,
                                inactive=[3, 17])
        caches = [torch.randn(b, smoke.PAGE, f, generator=gen,
                              device="cuda").to(torch.bfloat16)
                  for _ in range(2)]
        news = [torch.randn(blk.numel(), f, generator=gen, device="cuda"
                            ).to(torch.bfloat16) for _ in range(2)]
        want = [kva.append_rows_plain(c.clone(), r, blk, off)
                for c, r in zip(caches, news)]
        if pairs_fn is not None:
            def call():
                pairs_fn(list(zip(caches, news)), blk, off)
        else:
            def call():
                for c, r in zip(caches, news):
                    kva.append_rows(c, r, blk, off)
        call()
        ok = all(bool(torch.equal(c, w)) for c, w in zip(caches, want))
        valid = blk < b
        idx = (blk.long() * smoke.PAGE + off.long())[valid]
        copies = [(c.view(-1, f), r[valid]) for c, r in zip(caches, news)]
        bound, by = smoke.bound_ms(
            2 * 2 * int(valid.sum().item()) * f * 2 + 2 * blk.nbytes, 0)
        row = {"tree": args.label, "kernel": "kv_append_rows",
               "model": model, "rows": blk.numel(), "f": f, "arrays": 2,
               "launches": 1 if pairs_fn is not None else 2,
               "ms": timer(call),
               "single_ms": timer(lambda: kva.append_rows(
                   caches[0], news[0], blk, off)),
               "floor_ms": timer(lambda: torch.cuda._sleep(0)),
               "library_ms": timer(lambda: [
                   flat.index_copy_(0, idx, src) for flat, src in copies]),
               "bound_ms": bound, "bound_by": by}
        saved = build._libs.get("kv_append")
        for probe, lib in probe_libs.items():
            if PROBES[probe][4] != "kv_append_rows":
                continue
            build._libs["kv_append"] = lib
            row[f"ms_{probe}"] = timer(call)
            ok &= all(bool(torch.equal(c, w)) for c, w in zip(caches, want))
        build._libs["kv_append"] = saved
        row["equal"] = ok and all(bool(torch.equal(c, w))
                                  for c, w in zip(caches, want))
        emit(args.out, row)
        rows.append(row)
        if not row["equal"]:
            raise AssertionError(f"kv_append_rows {model} differs")
        del caches, news, want, copies
        torch.cuda.empty_cache()
    return rows


def kv_pages(torch, smoke, timer, args, probe_libs):
    """kv_append_pages as the tree's batched prefill appends its pages:
    one llama-3.1-8b prefill of 2048 rows (64 pages a layer at
    scattered blocks, 32 layers; a short chunk's pad pages dropped) as
    bf16 K and V, and as int8 K and V with their f32 scale planes; and
    row 4's one-array case of 8192 pages. `ms`: one launch
    (append_pages_pairs) where the tree has it, else one append_pages a
    array (`launches`); `single_ms` one array alone; each equal to the
    plain appends; `ms_<probe>` for the kv_page_select probe."""
    from ferrum_tpu_torch.ops.kernels import build
    from ferrum_tpu_torch.ops.kernels import kv_append as kva
    if not args.selected("kv_append_pages"):
        return
    pairs_fn = getattr(kva, "append_pages_pairs", None)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(17)
    page, layers, nb_layer = smoke.PAGE, 32, 1024
    b = layers * nb_layer
    n_pg = smoke.PREFILL_ROWS // page if hasattr(smoke, "PREFILL_ROWS") \
        else 64
    perm = torch.randperm(nb_layer, generator=gen, device="cuda")[:n_pg]
    perm[44:] = smoke.OOB_SENTINEL
    ids = torch.where(perm[None] >= smoke.OOB_SENTINEL,
                      torch.full((layers, 1), smoke.OOB_SENTINEL,
                                 device="cuda"),
                      torch.arange(layers, device="cuda")[:, None]
                      * nb_layer + perm[None])
    ids = ids.reshape(-1).to(torch.int32).contiguous()
    row4 = torch.arange(8192, device="cuda", dtype=torch.int32) * 4

    def arr(dt, w, n):
        if dt == torch.int8:
            return torch.randint(-127, 128, (n, page, w), generator=gen,
                                 device="cuda", dtype=torch.int8)
        return torch.randn(n, page, w, generator=gen, device="cuda").to(dt)

    for label, kinds, blk in (
            ("bf16 K, V", [(torch.bfloat16, 1024)] * 2, ids),
            ("int8 K, V, K scales, V scales",
             [(torch.int8, 1024)] * 2 + [(torch.float32, 8)] * 2, ids),
            ("bf16 K (row 4's case)", [(torch.bfloat16, 1024)], row4)):
        pairs = [(arr(dt, w, b), arr(dt, w, blk.numel())) for dt, w in kinds]
        want = [kva.append_pages_plain(c.clone(), q, blk) for c, q in pairs]
        if pairs_fn is not None:
            def call():
                pairs_fn(pairs, blk)
        else:
            def call():
                for c, q in pairs:
                    kva.append_pages(c, q, blk)
        call()
        ok = all(bool(torch.equal(c, w)) for (c, _), w in zip(pairs, want))
        n_valid = int((blk < b).sum().item())
        bound, by = smoke.bound_ms(
            sum(2 * n_valid * q[0].nbytes for _, q in pairs) + blk.nbytes, 0)
        row = {"tree": args.label, "kernel": "kv_append_pages",
               "arrays": label, "pages": blk.numel(), "valid": n_valid,
               "launches": 1 if pairs_fn is not None else len(pairs),
               "ms": timer(call),
               "single_ms": timer(lambda: kva.append_pages(
                   pairs[0][0], pairs[0][1], blk)),
               "bound_ms": bound, "bound_by": by}
        saved = build._libs.get("kv_append")
        for probe, lib in probe_libs.items():
            if PROBES[probe][4] != "kv_append_pages":
                continue
            build._libs["kv_append"] = lib
            row[f"ms_{probe}"] = timer(call)
            if PROBES[probe][5]:
                ok &= all(bool(torch.equal(c, w))
                          for (c, _), w in zip(pairs, want))
        build._libs["kv_append"] = saved
        # The probes that compute another function wrote into the caches.
        call()
        row["equal"] = ok and all(bool(torch.equal(c, w))
                                  for (c, _), w in zip(pairs, want))
        emit(args.out, row)
        if not ok:
            raise AssertionError(f"kv_append_pages {label} differs")
        del pairs, want
        torch.cuda.empty_cache()


def layer_lines(args, rows, kernel, key, at, sites):
    """One `layer` line: the rows of `kernel` at `key` == `at` over
    `sites` (the dense kernels' llama-3.1-8b ones), their times and
    bounds summed."""
    sel = [r for r in rows if r["kernel"] == kernel and r[key] == at
           and r["site"] in sites
           and r.get("model", "llama-3.1-8b") == "llama-3.1-8b"]
    if len(sel) != len(sites):
        return
    keys = [key_ for key_ in sel[0] if key_.endswith("ms")]
    emit(args.out, {"tree": args.label, "layer": kernel, key: at,
                    **{key_: None if any(r[key_] is None for r in sel)
                       else sum(r[key_] for r in sel) for key_ in keys}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--only", action="append", default=[],
                    choices=DEFAULT + NEIGHBOURS)
    ap.add_argument("--sweep-splits", default="",
                    type=lambda v: [int(s) for s in v.split(",") if s])
    ap.add_argument("--probe", action="append", default=[],
                    choices=sorted(PROBES))
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    args.selected = lambda kernel: kernel in (args.only or DEFAULT)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("torch_w4a8tl_ab: no CUDA device", file=sys.stderr)
        return 2
    from ferrum_tpu_torch.ops.kernels import build
    if not os.path.abspath(build.__file__).startswith(
            os.path.abspath(args.tree)):
        raise RuntimeError(f"imported {build.__file__}, not {args.tree}")
    smoke = load_smoke()
    build_s = build.build_all()
    emit(args.out, {"tree": args.label, "build_s": build_s,
                    "card": smoke.smi_line()})
    if args.ptxas:
        ptxas_report(build, args)
    probe_libs = probe_libraries(build, [p for p in args.probe
                                         if args.selected(PROBES[p][4])],
                                 args)
    timer = smoke.Timer(torch)
    rows = dense_rows(torch, smoke, timer, args, probe_libs)
    for kernel in PREFILL + DECODE:
        for m in DECODE_MS + PREFILL_M:
            layer_lines(args, rows, kernel, "m", m, tuple(LLAMA))
    rows = grouped_rows(torch, smoke, timer, args, probe_libs)
    for a in GROUPED_A:
        layer_lines(args, rows, "moe_grouped", "rows", a, tuple(MOE))
    kv_rows(torch, smoke, timer, args, probe_libs)
    kv_pages(torch, smoke, timer, args, probe_libs)
    rows = neighbour_rows(torch, smoke, timer, args, probe_libs)
    for kernel, key, at, sites in (
            *(("moe_bmm", "t", t, tuple(MOE)) for t in BMM_T),
            *(("w4a8_decode", "m", m, tuple(LLAMA)) for m in DECODE_MS),
            ("w4a16_gemm", "m", 32, tuple(LLAMA)),
            ("w4a16_gemm", "m", 2048, tuple(LLAMA))):
        layer_lines(args, rows, kernel, key, at, sites)
    return 0


if __name__ == "__main__":
    sys.exit(main())
