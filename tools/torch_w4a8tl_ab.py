#!/usr/bin/env python3
"""Time the PyTorch port's two-level w4a8 GEMMs of one source tree on a card.

    python3 tools/torch_w4a8tl_ab.py --tree DIR --label NAME
        [--probe bn128|bn256 ...] [--ptxas] [--out FILE]

Imports `ferrum_tpu_torch` from DIR -- this checkout, or an older one
unpacked with `git archive <commit> | tar -x -C build/<name>` (build/ is
git-ignored) -- builds its kernels there, and times, on weights and
activations made from fixed seeds (so two trees see the same inputs):

  w4a8tl_prefill,         llama-3.1-8b projections at m = 256 / 2048 /
  w4a8tl_prefill_mcache   8192, qwen3-30b-a3b qkv / o at m = 2048
  w4a8tl_decode,          llama-3.1-8b projections at m = 32 (the serve
  w4a8tl_gd_decode        phase's decode batch)
  moe_grouped             qwen3-30b-a3b gate / up / down expert stacks at
                          120 (16-row tiles) / 2048 / 16384 routed rows
                          (128-row tiles): the launch alone, on a tile map
                          built before the timed window (`ms`), and the
                          whole call, map included (`call_ms`)

each required equal to its plain version (torch.equal), beside the
card's bound and the library call (`torch._int_mm` on the int8 w8;
`torch._grouped_mm` on the bf16 stack). Times are CUDA-event medians
with the L2 flushed (chip_smoke.Timer). After the cases, one `layer`
line per (kernel, m) sums the four llama projections, and one per row
count sums the qwen3 layer's gate, up and down. To compare trees, run
them alternately on one machine (A B B A).

--probe bn128 / bn256 adds `ms_<probe>` to the moe_grouped cases at
128-row tiles: the launch on a copy of the tree's moe_gemm.cu built with
its column-tile rule forced to 128 / 256 columns (where N allows).
--ptxas compiles the sources on the int8 wgmma main loop with `-Xptxas
-v` and prints each kernel's registers and spills, and fails on a C7518
(ptxas serialized a kernel's wgmma).

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
DECODE_M = 32
QWEN = {"qkv": (2048, 5120), "o": (4096, 2048)}
QWEN_M = 2048
MOE = {"gate": (2048, 768), "up": (2048, 768), "down": (768, 2048)}
GROUPED_A = (120, 2048, 16384)
# --probe: the column-tile rule of the grouped kernel at 128-row tiles.
PROBES = {"bn128": "const bool wide = false;",
          "bn256": "const bool wide = N % 256 == 0;"}
WIDE_RULE = r"const bool wide = [^;]*;"
WGMMA_SOURCES = ("w4a8tl_gemm", "w4a8tl_mcache", "moe_gemm")


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


def dense_rows(torch, smoke, timer, args):
    """The four dense two-level kernels, each case on one weight and one
    activation shared by the kernels of its m; returns the llama rows."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    prefill = (("w4a8tl_prefill", qmm.w4a8tl_prefill),
               ("w4a8tl_prefill_mcache", qmm.w4a8tl_prefill_mcache))
    decode = (("w4a8tl_decode", qmm.w4a8tl_decode),
              ("w4a8tl_gd_decode", qmm.w4a8tl_gd_decode))
    cases = [("llama-3.1-8b", site, kn, (DECODE_M,) + PREFILL_M)
             for site, kn in LLAMA.items()]
    cases += [("qwen3-30b-a3b", site, kn, (QWEN_M,))
              for site, kn in QWEN.items()]
    rows = []
    for model, site, (k, n), ms in cases:
        p = smoke.make_gemm_weight(torch, k, n, gen)
        w8_cm = smoke.int_mm_weight(torch, p)
        wbytes = (p.qweight.nbytes + p.scales2.nbytes + p.zeros.nbytes
                  + p.chan_scale.nbytes)
        for m in ms:
            x = torch.randn(m, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            xq, xs = qmm.quantize_activation_rows(x)
            want = qmm.w4a8tl_plain(xq, xs, p, torch.bfloat16)
            bound, by = smoke.bound_ms(
                wbytes + xq.nbytes + xs.nbytes + 2 * m * n, 2.0 * m * k * n)
            library_ms = timer(lambda: torch._int_mm(xq, w8_cm))
            for kernel, fn in (decode if m == DECODE_M else prefill):
                got = fn(xq, xs, p, torch.bfloat16)
                ms_ = timer(lambda: fn(xq, xs, p, torch.bfloat16))
                again = fn(xq, xs, p, torch.bfloat16)
                ok = bool(torch.equal(got, want)) \
                    and bool(torch.equal(again, want))
                row = {"tree": args.label, "kernel": kernel, "model": model,
                       "site": site, "m": m, "k": k, "n": n, "ms": ms_,
                       "library_ms": library_ms, "bound_ms": bound,
                       "bound_by": by, "equal": ok}
                emit(args.out, row)
                rows.append(row)
                if not ok:
                    raise AssertionError(f"{kernel} {site} m={m} differs")
        del p, w8_cm
        torch.cuda.empty_cache()
    return rows


def probe_library(build, probe):
    """The tree's moe_gemm library built from a copy of its sources with
    the grouped kernel's column-tile rule replaced by PROBES[probe]."""
    root = os.path.join(build.BUILD_ROOT, "probe", probe)
    shutil.rmtree(root, ignore_errors=True)
    csrc = os.path.join(root, "csrc")
    shutil.copytree(build.CSRC, csrc)
    path = os.path.join(csrc, "moe_gemm.cu")
    with open(path) as f:
        text, n = re.subn(WIDE_RULE, PROBES[probe], f.read(), count=1)
    if n != 1:
        raise RuntimeError(f"{probe}: no column-tile rule in {path}")
    with open(path, "w") as f:
        f.write(text)
    so = os.path.join(root, "libmoe_gemm.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so, path],
                   check=True)
    lib = ctypes.CDLL(so)
    for fn, argtypes in build.SIGNATURES["moe_gemm"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def ptxas_report(build, args):
    """Registers and spills of every kernel of the sources on the int8
    wgmma main loop (`nvcc -Xptxas -v`, one process a source, in
    parallel); raises on a C7518."""
    root = os.path.join(build.BUILD_ROOT, "ptxas")
    os.makedirs(root, exist_ok=True)
    procs = [(name, subprocess.Popen(
        [build.nvcc_path(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
         os.path.join(root, f"lib{name}.so"),
         os.path.join(build.CSRC, f"{name}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for name in WGMMA_SOURCES]
    serialized = []
    for name, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {name}: exit {proc.returncode}\n{log}")
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
    if serialized:
        raise AssertionError(f"ptxas serialized wgmma: {serialized}")


def tile_windows(tile_map, bm):
    """Rows of its expert in each valid logical tile of a tile map (the
    rows the kernel's block for that tile computes for real)."""
    gid, mtid, offsets, valid = (t.tolist() for t in tile_map)
    wins = [min(offsets[e + 1], mt * bm + bm) - max(offsets[e], mt * bm)
            for e, mt, v in zip(gid, mtid, valid) if v]
    return [w for w in wins if w > 0]


def grouped_rows(torch, smoke, timer, args, probe_libs):
    """moe_grouped at the qwen3 expert sites; returns the rows."""
    from ferrum_tpu_torch.ops.kernels import build
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
            if row["bm"] == 128:
                saved = build._libs.get("moe_gemm")
                for probe, lib in probe_libs.items():
                    build._libs["moe_gemm"] = lib
                    ok &= bool(torch.equal(launch(), want))
                    row[f"ms_{probe}"] = timer(launch)
                build._libs["moe_gemm"] = saved
            row["equal"] = ok and bool(torch.equal(launch(), want))
            emit(args.out, row)
            rows.append(row)
            if not row["equal"]:
                raise AssertionError(f"moe_grouped {site} {a} differs")
        del p, w_bf16
        torch.cuda.empty_cache()
    return rows


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
    ap.add_argument("--probe", action="append", default=[],
                    choices=sorted(PROBES))
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
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
    probe_libs = {p: probe_library(build, p) for p in args.probe}
    timer = smoke.Timer(torch)
    rows = dense_rows(torch, smoke, timer, args)
    for kernel in ("w4a8tl_prefill", "w4a8tl_prefill_mcache",
                   "w4a8tl_decode", "w4a8tl_gd_decode"):
        for m in (DECODE_M,) + PREFILL_M:
            layer_lines(args, rows, kernel, "m", m, tuple(LLAMA))
    rows = grouped_rows(torch, smoke, timer, args, probe_libs)
    for a in GROUPED_A:
        layer_lines(args, rows, "moe_grouped", "rows", a, tuple(MOE))
    return 0


if __name__ == "__main__":
    sys.exit(main())
