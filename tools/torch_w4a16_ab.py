#!/usr/bin/env python3
"""Time the PyTorch port's two w4a16 GEMMs of one source tree on a card.

    python3 tools/torch_w4a16_ab.py --tree DIR --label NAME [--decode]
        [--sweep-splits S,S,...] [--probe NAME ...] [--ptxas] [--out FILE]

Imports `ferrum_tpu_torch` from DIR -- this checkout, or an older one
unpacked with `git archive <commit> | tar -x -C build/<name>` (build/ is
git-ignored) -- builds its kernels there, and times, on weights and
activations made from fixed seeds (so two trees see the same inputs):

  w4a16_gemm         llama-3.1-8b projections at m = 256 / 2048 / 8192,
                     qwen3-30b-a3b qkv / o at m = 1 / 32 / 64 / 2048
  moe_grouped_w4a16  qwen3-30b-a3b gate / up / down expert stacks at
                     8 / 256 / 2048 / 16384 routed rows: the C entry
                     alone, on a tile map built before the timed window

each held within one bf16 step of its plain version, beside the card's
bound and `torch.matmul` / `torch._grouped_mm` on the bf16 weight. Times
are CUDA-event medians with the L2 flushed (chip_smoke.Timer). To
compare trees, run them alternately on one machine (A B B A).

--decode times the decode sizes instead, those the streamed decode loop
(csrc/w4a16_stream.cuh) runs: w4a16_gemm at the qwen3-30b-a3b qkv / o
sites at m = 1 / 32 / 64 and the four llama-3.1-8b projections at m = 32
(the route of EngineConfig(w4a8=False) on llama), and moe_grouped_w4a16
at the qwen3 expert sites at 8 / 256 routed rows, the launch alone on a
map built before the timed window (`ms`) and the whole call, map
included (`call_ms`); each case with its launch plan (`plan`, on a tree
that has the plan entries) and a `layer` line per m or row count (qwen3:
qkv + o, llama: the four, grouped: gate + up + down). Each case is
within one bf16 step of its plain version and gives the same bits again
after its timed launches. --sweep-splits adds to each dense decode case
`sweep`, its time at each given K split count (a tree whose w4a16_gemm
takes `splits`).

--probe adds `ms_<probe>` to the cases it touches, from a copy of the
tree's CUDA sources with one rule changed or one part cut (cuts give
wrong results, which are not compared):
  dequant-arith      each dequantized pair is its raw nibbles in a fixed
                     bf16 pattern (dequant2, which both main loops call,
                     and the decode tile of a tree that has
                     w4a16_tile.cuh); the loads and stores kept; the
                     llama layer at m = 2048 and, with --decode, the
                     decode cases
  no-dequant         no dequant in the K loop of w4a16_wgmma.cuh (the
                     llama layer at m = 2048)
  no-loads           no copies issued in that K loop after the prologue
                     (the llama layer at m = 2048)
  stream_bn64,       the streamed decode loop's launcher with its column
  stream_bn128       tiles forced to 64, or to 128 where N allows
  stream_stages3,    the ring 3, 4 or 6 stages deep at every BM (the
  stream_stages4,    rule: 3 at BM 64, else 4)
  stream_stages6
  stream_no_mma,     the decode loop without its mma, or without its
  stream_no_dequant  dequant, on every step but the last / first
The stream_* probes touch the --decode cases (dense and grouped), with
the K split count each probe's own rule picks, and need a tree with
csrc/w4a16_stream.cuh.

--ptxas compiles w4a16_gemm.cu (and each probe's copy) with
`-Xptxas -v`, prints each kernel's registers and spills, and fails on a
C7518 (ptxas serialized a kernel's wgmma).

Prints one JSON line per case and appends each to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import os
import re
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LLAMA = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
         "down": (14336, 4096)}
LLAMA_M = (256, 2048, 8192)
QWEN = {"qkv": (2048, 5120), "o": (4096, 2048)}
QWEN_M = (1, 32, 64, 2048)
MOE = {"gate": (2048, 768), "up": (2048, 768), "down": (768, 2048)}
GROUPED_A = (8, 256, 2048, 16384)
DECODE_QWEN_M = (1, 32, 64)
DECODE_LLAMA_M = (32,)
DECODE_A = (8, 256)

STREAM = "w4a16_stream.cuh"
# Source patches of each --probe: (header, pattern, replacement), applied
# where the header exists (each probe must patch at least one), and the
# cases it touches ("prefill": the llama layer at m = 2048, "decode": the
# --decode cases), and whether it still computes the function.
PROBES = {
    "dequant-arith": ([
        ("w4a16_wgmma.cuh",
         r"(uint32_t dequant2\(uint32_t t, uint32_t z128,\s*uint32_t s\) \{)"
         r".*?(\n\})",
         r"\1\n  return (((t >> kShift) & 0x000F000Fu) | 0x3F803F80u)"
         r" ^ (z128 & s & 0x00100010u);\2"),
        ("w4a16_tile.cuh",
         r"(uint32_t dequant_pair\(int q0, int q1, int z,\s*float s\) \{)"
         r".*?(\n\})",
         r"\1\n  return 0x3F803F80u | (uint32_t)q0 | ((uint32_t)q1 << 16)"
         r" | ((uint32_t)z & 0x30u) | (__float_as_uint(s) & 0x00400040u);\2")],
        ("prefill", "decode"), False),
    "no-dequant": ([
        ("w4a16_wgmma.cuh",
         r"\n *dequant\(base, nx % S, nx & 1, z128, s2\);", "")],
        ("prefill",), False),
    "no-loads": ([
        ("w4a16_wgmma.cuh", r"if \(ahead < nsteps\) \{", "if (false) {")],
        ("prefill",), False),
    "stream_bn64": ([(STREAM, r"const bool stream_narrow =\s*[^;]*;",
                      "const bool stream_narrow = true;")],
                    ("decode",), True),
    "stream_bn128": ([(STREAM, r"const bool stream_narrow =\s*[^;]*;",
                       "const bool stream_narrow = a.N % 128 != 0;")],
                     ("decode",), True),
    **{f"stream_stages{d}": ([(STREAM, r"constexpr int kStreamStages =[^;]*;",
                               f"constexpr int kStreamStages = {d};")],
                             ("decode",), True) for d in (3, 4, 6)},
    "stream_no_mma": ([(STREAM,
                        r"\n      mma\(acc, stage\(j\), wl\[j & 1\]\);", "")],
                      ("decode",), False),
    "stream_no_dequant": ([(STREAM, r"\n      dequant\(stage\(j \+ 1\), "
                            r"wl\[\(j \+ 1\) & 1\], scl\);", "")],
                          ("decode",), False),
}


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


def ptxas_rows(args, name, log):
    """Emit each kernel's registers and spills from `nvcc -Xptxas -v`'s
    log of build `name`; returns its C7518 lines."""
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


def probe_libraries(build, args):
    """{probe: the tree's w4a16_gemm library built from a copy of its
    sources with PROBES[probe] applied}, one nvcc process a probe (and,
    with --ptxas, one for the tree's own source), all started together."""
    procs = {}
    verbose = ["-Xptxas", "-v"] if args.ptxas else []
    if args.ptxas:
        root = os.path.join(build.BUILD_ROOT, "ptxas")
        os.makedirs(root, exist_ok=True)
        procs[None] = (os.path.join(root, "libw4a16_gemm.so"),
                       os.path.join(build.CSRC, "w4a16_gemm.cu"))
    for probe in args.probe:
        root = os.path.join(build.BUILD_ROOT, "probe", probe)
        shutil.rmtree(root, ignore_errors=True)
        csrc = os.path.join(root, "csrc")
        shutil.copytree(build.CSRC, csrc)
        patched = 0
        for name, pat, rep in PROBES[probe][0]:
            path = os.path.join(csrc, name)
            if not os.path.exists(path):
                continue
            with open(path) as f:
                text, n = re.subn(pat, rep, f.read(), count=1, flags=re.S)
            if n != 1:
                raise RuntimeError(f"{probe}: pattern not found in {name}")
            with open(path, "w") as f:
                f.write(text)
            patched += 1
        if not patched:
            raise RuntimeError(f"{probe}: no header of this tree to patch")
        procs[probe] = (os.path.join(root, "libw4a16_gemm.so"),
                        os.path.join(csrc, "w4a16_gemm.cu"))
    running = {key: (so, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, *verbose, "-o", so, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for key, (so, src) in procs.items()}
    libs, serialized = {}, []
    for key, (so, proc) in running.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{key or 'w4a16_gemm'}: nvcc exit "
                               f"{proc.returncode}\n{log}")
        if args.ptxas:
            serialized += ptxas_rows(
                args, "w4a16_gemm" + (f":{key}" if key else ""), log)
        if key is None:
            continue
        lib = ctypes.CDLL(so)
        for fn, argtypes in build.SIGNATURES["w4a16_gemm"].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[key] = lib
    if serialized:
        raise AssertionError(f"ptxas serialized wgmma: {serialized}")
    return libs


def with_probes(build, probe_libs, phase, row, fn, want, smoke, timer):
    """Time `fn` on each probe library that touches `phase` cases
    (ms_<probe>); a probe that computes the function must stay within
    one bf16 step of `want`. Returns whether every such probe did."""
    ok = True
    saved = build._libs.get("w4a16_gemm")
    for probe, lib in probe_libs.items():
        if phase not in PROBES[probe][1]:
            continue
        build._libs["w4a16_gemm"] = lib
        if PROBES[probe][2]:
            ok &= smoke.bf16_step_check(fn(), want)[0]
        row[f"ms_{probe}"] = timer(fn)
        build._libs["w4a16_gemm"] = saved
    return ok


def dense_rows(torch, smoke, timer, args, probe_libs):
    """w4a16_gemm by site and m (--decode: the decode sizes); returns the
    rows."""
    from ferrum_tpu_torch.ops.kernels import build
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    from ferrum_tpu_torch.ops.quant import w4a16_weight
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    if args.decode:
        cases = [("llama-3.1-8b", s, kn, DECODE_LLAMA_M)
                 for s, kn in LLAMA.items()]
        cases += [("qwen3-30b-a3b", s, kn, DECODE_QWEN_M)
                  for s, kn in QWEN.items()]
    else:
        cases = [("llama-3.1-8b", s, kn, LLAMA_M) for s, kn in LLAMA.items()]
        cases += [("qwen3-30b-a3b", s, kn, QWEN_M) for s, kn in QWEN.items()]
    plan = getattr(qmm, "w4a16_decode_plan", None)
    takes_splits = "splits" in inspect.signature(qmm.w4a16_gemm).parameters
    rows = []
    for model, site, (k, n), ms in cases:
        p = smoke.make_gemm_weight(torch, k, n, gen, two_level=False)
        w_bf16 = w4a16_weight(p)
        for m in ms:
            x = torch.randn(m, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            want = qmm.w4a16_plain(x, p)
            got = qmm.w4a16_gemm(x, p)
            ok, share, err = smoke.bf16_step_check(got, want)
            bound, by = smoke.bound_ms(
                p.qweight.nbytes + p.scales.nbytes + p.zeros.nbytes
                + x.nbytes + 2 * m * n, 2.0 * m * k * n,
                smoke.BF16_FLOPS_PER_S)
            row = {"tree": args.label, "kernel": "w4a16_gemm",
                   "model": model, "site": site, "m": m, "k": k, "n": n,
                   "ms": timer(lambda: qmm.w4a16_gemm(x, p)),
                   "library_ms": timer(lambda: torch.matmul(x, w_bf16)),
                   "bound_ms": bound, "bound_by": by}
            if m <= 64 and plan is not None:
                row["plan"] = plan(m, n, k)
            if m <= 64 and args.sweep_splits and takes_splits:
                row["sweep"] = {}
                for sp in args.sweep_splits:
                    def call():
                        return qmm.w4a16_gemm(x, p, splits=sp)
                    ok &= smoke.bf16_step_check(call(), want)[0]
                    row["sweep"][sp] = timer(call)
            if args.decode:
                ok &= with_probes(build, probe_libs, "decode", row,
                                  lambda: qmm.w4a16_gemm(x, p), want, smoke,
                                  timer)
            elif model == "llama-3.1-8b" and m == 2048:
                with_probes(build, probe_libs, "prefill", row,
                            lambda: qmm.w4a16_gemm(x, p), want, smoke, timer)
            ok &= bool(torch.equal(qmm.w4a16_gemm(x, p), got))
            row.update(within_bf16_step=ok, share_differing=share,
                       max_abs_err=err)
            emit(args.out, row)
            rows.append(row)
            if not ok:
                raise AssertionError(f"w4a16_gemm {site} m={m}: {err}")
        del p, w_bf16
        torch.cuda.empty_cache()
    return rows


def grouped_rows(torch, smoke, timer, args, probe_libs):
    """moe_grouped_w4a16 at the qwen3 expert sites by routed row count
    (--decode: the decode counts); returns the rows."""
    from ferrum_tpu_torch.ops.kernels import build
    from ferrum_tpu_torch.ops.kernels import moe_gemm
    from ferrum_tpu_torch.ops.quant import w4a16_weight
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    plan = getattr(moe_gemm, "grouped_w4a16_plan", None)
    rows = []
    for site, (k, n) in MOE.items():
        p = smoke.make_moe_stack(torch, k, n, gen, two_level=False)
        w_bf16 = w4a16_weight(p)
        e = p.qweight.shape[0]
        for a in (DECODE_A if args.decode else GROUPED_A):
            sizes = smoke.routed_sizes(torch, gen, a)
            gs = sizes.to(torch.int32)
            x = torch.randn(a, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            tmap = moe_gemm.grouped_map(gs, a)

            def launch():
                return moe_gemm.grouped_w4a16_on_map(x, p, tmap)
            got = launch()
            want = moe_gemm.grouped_w4a16_plain(x, p, gs)
            ok, share, err = smoke.bf16_step_check(got, want)
            active = int((sizes > 0).sum().item())
            per = p.qweight[0].nbytes + p.scales[0].nbytes + p.zeros[0].nbytes
            bound, by = smoke.bound_ms(active * per + x.nbytes + 2 * a * n,
                                       2.0 * a * k * n,
                                       smoke.BF16_FLOPS_PER_S)
            offs = torch.cumsum(sizes, 0).to(torch.int32)
            grouped_mm = getattr(torch, "_grouped_mm", None)
            row = {"tree": args.label, "kernel": "moe_grouped_w4a16",
                   "site": site, "rows": a, "k": k, "n": n,
                   "active_experts": active, "ms": timer(launch),
                   "call_ms": timer(lambda: moe_gemm.grouped_w4a16(x, p, gs)),
                   "library_ms": None if grouped_mm is None else timer(
                       lambda: grouped_mm(x, w_bf16, offs=offs)),
                   "bound_ms": bound, "bound_by": by}
            if a <= 256 and plan is not None:
                row["plan"] = plan(a, n, k, e)
            if args.decode:
                ok &= with_probes(build, probe_libs, "decode", row, launch,
                                  want, smoke, timer)
            ok &= bool(torch.equal(launch(), got))
            row.update(within_bf16_step=ok, share_differing=share,
                       max_abs_err=err)
            emit(args.out, row)
            rows.append(row)
            if not ok:
                raise AssertionError(f"moe_grouped_w4a16 {site} {a}: {err}")
        del p, w_bf16
        torch.cuda.empty_cache()
    return rows


def layer_line(args, rows, kernel, key, at, sites, model=None):
    """One `layer` line: the rows of `kernel` at `key` == `at` over
    `sites` (of `model`), their times and bounds summed."""
    sel = [r for r in rows if r["kernel"] == kernel and r[key] == at
           and r["site"] in sites and r.get("model") == model]
    if len(sel) != len(sites):
        return
    keys = [k for k in sel[0] if k.endswith("ms")]
    emit(args.out, {"tree": args.label, "layer": kernel, "model": model,
                    key: at, **{k: None if any(r.get(k) is None for r in sel)
                                else sum(r[k] for r in sel) for k in keys}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--decode", action="store_true")
    ap.add_argument("--sweep-splits", default="",
                    type=lambda v: [int(s) for s in v.split(",") if s])
    ap.add_argument("--probe", action="append", default=[],
                    choices=sorted(PROBES))
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch
    if not torch.cuda.is_available():
        print("torch_w4a16_ab: no CUDA device", file=sys.stderr)
        return 2
    from ferrum_tpu_torch.ops.kernels import build
    if not os.path.abspath(build.__file__).startswith(
            os.path.abspath(args.tree)):
        raise RuntimeError(f"imported {build.__file__}, not {args.tree}")
    smoke = load_smoke()
    build_s = build.build_all()
    emit(args.out, {"tree": args.label, "build_s": build_s,
                    "card": smoke.smi_line()})
    probe_libs = probe_libraries(build, args)
    timer = smoke.Timer(torch)
    rows = dense_rows(torch, smoke, timer, args, probe_libs)
    if args.decode:
        for m in DECODE_QWEN_M:
            layer_line(args, rows, "w4a16_gemm", "m", m, tuple(QWEN),
                       "qwen3-30b-a3b")
        for m in DECODE_LLAMA_M:
            layer_line(args, rows, "w4a16_gemm", "m", m, tuple(LLAMA),
                       "llama-3.1-8b")
    rows = grouped_rows(torch, smoke, timer, args, probe_libs)
    for a in (DECODE_A if args.decode else GROUPED_A):
        layer_line(args, rows, "moe_grouped_w4a16", "rows", a, tuple(MOE))
    return 0


if __name__ == "__main__":
    sys.exit(main())
