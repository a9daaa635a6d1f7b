#!/usr/bin/env python3
"""Time the PyTorch port's two w4a16 GEMMs of one source tree on a card.

    python3 tools/torch_w4a16_ab.py --tree DIR --label NAME
        [--probe NAME ...] [--out FILE]

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

--probe adds the llama layer at m = 2048 (ms_<probe>) built from a copy
of the tree's CUDA sources with one part of the prefill main loop cut,
so the time saved is that part's share (the results are then wrong):
  dequant-arith  each dequantized pair is its raw nibbles in a fixed
                 bf16 pattern; the weight, scale and zero loads and the
                 stores of the dequantized tile kept (either main loop)
  no-dequant     no dequant in the K loop of w4a16_wgmma.cuh: no packed
                 tile read, no bf16 tile stored (wgmma reads stale tiles)
  no-loads       no copies issued in that K loop after the prologue

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
LLAMA_M = (256, 2048, 8192)
QWEN = {"qkv": (2048, 5120), "o": (4096, 2048)}
QWEN_M = (1, 32, 64, 2048)
MOE = {"gate": (2048, 768), "up": (2048, 768), "down": (768, 2048)}
GROUPED_A = (8, 256, 2048, 16384)

# Source patches of each --probe: (header, pattern, replacement), applied
# where the header exists; each probe must patch at least one.
PROBES = {
    "dequant-arith": [
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
    "no-dequant": [
        ("w4a16_wgmma.cuh",
         r"\n *dequant\(base, nx % S, nx & 1, z128, s2\);", "")],
    "no-loads": [
        ("w4a16_wgmma.cuh", r"if \(ahead < nsteps\) \{", "if (false) {")],
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


def probe_library(build, probe):
    """The tree's w4a16_gemm library built from a copy of its sources
    with PROBES[probe] applied."""
    root = os.path.join(build.BUILD_ROOT, "probe", probe)
    shutil.rmtree(root, ignore_errors=True)
    csrc = os.path.join(root, "csrc")
    shutil.copytree(build.CSRC, csrc)
    patched = 0
    for name, pat, rep in PROBES[probe]:
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
    so = os.path.join(root, "libw4a16_gemm.so")
    subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", so,
                    os.path.join(csrc, "w4a16_gemm.cu")], check=True)
    lib = ctypes.CDLL(so)
    for fn, argtypes in build.SIGNATURES["w4a16_gemm"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def dense_rows(torch, smoke, timer, args, probe_libs):
    from ferrum_tpu_torch.ops.kernels import build
    from ferrum_tpu_torch.ops.kernels.quant_matmul import (w4a16_gemm,
                                                           w4a16_plain)
    from ferrum_tpu_torch.ops.quant import w4a16_weight
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    cases = [("llama-3.1-8b", s, kn, LLAMA_M) for s, kn in LLAMA.items()]
    cases += [("qwen3-30b-a3b", s, kn, QWEN_M) for s, kn in QWEN.items()]
    for model, site, (k, n), ms in cases:
        p = smoke.make_gemm_weight(torch, k, n, gen, two_level=False)
        w_bf16 = w4a16_weight(p)
        for m in ms:
            x = torch.randn(m, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            got = w4a16_gemm(x, p)
            ok, share, err = smoke.bf16_step_check(got, w4a16_plain(x, p))
            bound, by = smoke.bound_ms(
                p.qweight.nbytes + p.scales.nbytes + p.zeros.nbytes
                + x.nbytes + 2 * m * n, 2.0 * m * k * n,
                smoke.BF16_FLOPS_PER_S)
            row = {"tree": args.label, "kernel": "w4a16_gemm",
                   "model": model, "site": site, "m": m, "k": k, "n": n,
                   "ms": timer(lambda: w4a16_gemm(x, p)),
                   "library_ms": timer(lambda: torch.matmul(x, w_bf16)),
                   "bound_ms": bound, "bound_by": by, "within_bf16_step": ok,
                   "share_differing": share, "max_abs_err": err}
            if model == "llama-3.1-8b" and m == 2048:
                saved = build._libs.get("w4a16_gemm")
                for probe, lib in probe_libs.items():
                    build._libs["w4a16_gemm"] = lib
                    row[f"ms_{probe}"] = timer(lambda: w4a16_gemm(x, p))
                build._libs["w4a16_gemm"] = saved
            emit(args.out, row)
            if not ok:
                raise AssertionError(f"w4a16_gemm {site} m={m}: {err}")
        del p, w_bf16
        torch.cuda.empty_cache()


def grouped_rows(torch, smoke, timer, args):
    from ferrum_tpu_torch.ops.kernels.build import check, library
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (group_tile_map,
                                                       grouped_w4a16_plain)
    from ferrum_tpu_torch.ops.quant import w4a16_weight
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    lib = library("w4a16_gemm")
    for site, (k, n) in MOE.items():
        p = smoke.make_moe_stack(torch, k, n, gen, two_level=False)
        w_bf16 = w4a16_weight(p)
        e = p.qweight.shape[0]
        for a in GROUPED_A:
            sizes = smoke.routed_sizes(torch, gen, a)
            gs = sizes.to(torch.int32)
            x = torch.randn(a, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            bm = 16 if a <= 256 else 128
            gid, mtid, offsets, valid = group_tile_map(gs, bm,
                                                       -(-a // bm) + e - 1)
            out = torch.empty((a, n), dtype=torch.bfloat16, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream

            def launch():
                check(lib.ferrum_moe_grouped_w4a16(
                    x.data_ptr(), p.qweight.data_ptr(), p.scales.data_ptr(),
                    p.zeros.data_ptr(), gid.data_ptr(), mtid.data_ptr(),
                    offsets.data_ptr(), valid.data_ptr(), out.data_ptr(),
                    gid.numel(), bm, n, k,
                    int(p.scales.dtype == torch.float32), stream),
                    "moe_grouped_w4a16")
                return out
            got = launch().clone()
            ok, share, err = smoke.bf16_step_check(
                got, grouped_w4a16_plain(x, p, gs))
            active = int((sizes > 0).sum().item())
            per = p.qweight[0].nbytes + p.scales[0].nbytes + p.zeros[0].nbytes
            bound, by = smoke.bound_ms(active * per + x.nbytes + 2 * a * n,
                                       2.0 * a * k * n,
                                       smoke.BF16_FLOPS_PER_S)
            offs = torch.cumsum(sizes, 0).to(torch.int32)
            grouped_mm = getattr(torch, "_grouped_mm", None)
            row = {"tree": args.label, "kernel": "moe_grouped_w4a16",
                   "site": site, "rows": a, "k": k, "n": n,
                   "active_experts": active,
                   "kernel_ms": timer(launch),
                   "library_ms": None if grouped_mm is None else timer(
                       lambda: grouped_mm(x, w_bf16, offs=offs)),
                   "bound_ms": bound, "bound_by": by, "within_bf16_step": ok,
                   "share_differing": share, "max_abs_err": err}
            emit(args.out, row)
            if not ok:
                raise AssertionError(f"moe_grouped_w4a16 {site} {a}: {err}")
        del p, w_bf16
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--probe", action="append", default=[],
                    choices=sorted(PROBES))
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
    probe_libs = {p: probe_library(build, p) for p in args.probe}
    emit(args.out, {"tree": args.label, "build_s": build_s,
                    "card": smoke.smi_line()})
    timer = smoke.Timer(torch)
    dense_rows(torch, smoke, timer, args, probe_libs)
    grouped_rows(torch, smoke, timer, args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
