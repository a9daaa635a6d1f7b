#!/usr/bin/env python3
"""Serve one lane of the PyTorch port of one source tree on a card.

    python3 tools/torch_serve_ab.py --tree DIR --label NAME [--lane A]
        [--profile] [--out FILE]

Imports `chip_smoke` and `ferrum_tpu_torch` from DIR -- this checkout,
or an older one unpacked with `git archive <commit> | tar -x -C
build/<name>` (build/ is git-ignored) -- builds its kernels there, and
builds the lane's engine (the first of the tree's chip_smoke.LANES
whose name starts with --lane) with the tree's own `build_engine`, so
each tree runs its own engine settings on the same random weights
(seed 0). After one solo request to warm it, it serves 1, 4 and 32
concurrent greedy 256/128 requests (prompts from fixed seeds, the same
in both trees) and prints for each run the wall time, output tok/s,
TTFT p50 and TPOT p50 (host clock), the launches of `kv_append_rows`
and, on a tree whose runner counts them, windows by lane bucket. With
--profile, torch.profiler over 32 concurrent 256/32 requests adds the
device's busy share of the wall time (a lower bound: the profiler's own
host cost inflates the wall time).

Host-clock numbers spread up to ~2x between machines: compare trees
only inside one call, run alternately (A B B A). Prints one JSON line
per run and appends each to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time


def serve(torch, cs, engine, mc, conc, seed):
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ferrum_tpu_torch.ops import kernels as K

    prompts = np.random.default_rng(seed).integers(
        0, mc.vocab_size, (conc, cs.PROMPT_LEN))
    runner = engine.runner
    buckets0 = dict(getattr(runner, "windows_by_bucket", {}))
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(conc) as ex:
        resps = list(ex.map(engine.infer, [cs.request(p) for p in prompts]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_out = sum(len(r.token_ids) for r in resps)
    if n_out != conc * cs.OUTPUT_LEN:
        raise AssertionError(f"{n_out} tokens of {conc * cs.OUTPUT_LEN}")
    tpot = [(r.e2e_latency - r.ttft) / (cs.OUTPUT_LEN - 1) for r in resps]
    windows = {b: n - buckets0.get(b, 0) for b, n in
               sorted(getattr(runner, "windows_by_bucket", {}).items())
               if n - buckets0.get(b, 0)}
    return {"requests": conc, "wall_s": wall, "output_tok_s": n_out / wall,
            "ttft_p50_ms": statistics.median(r.ttft for r in resps) * 1e3,
            "tpot_p50_ms": statistics.median(tpot) * 1e3,
            "kv_append_rows": K.KV_APPEND_ROWS.launches,
            "windows_by_bucket": windows or None}


def profile(torch, cs, engine, mc):
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from torch.profiler import ProfilerActivity, profile as prof_ctx

    prompts = np.random.default_rng(2).integers(
        0, mc.vocab_size, (cs.SERVE_REQUESTS, cs.PROMPT_LEN))
    reqs = [cs.request(p, 32) for p in prompts]
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(reqs)) as ex:
            list(ex.map(engine.infer, reqs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
                  for e in prof.key_averages()
                  if e.device_type.name == "CUDA")
    return {"profile_wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / (wall * 1e3)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--lane", default="A")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    import chip_smoke as cs
    from ferrum_tpu_torch.ops.kernels import build

    if not torch.cuda.is_available():
        print("torch_serve_ab: no CUDA device", file=sys.stderr)
        return 2
    build.build_all()
    lane = next(ln for ln in cs.LANES if ln["name"].startswith(args.lane))
    mc, engine = cs.build_engine(lane["model"], lane["mode"],
                                 lane["float_scale"], lane.get("layers"))
    base = {"label": args.label, "lane": lane["name"],
            "card": cs.smi_line()}
    lines = []
    try:
        engine.infer(cs.request(range(cs.PROMPT_LEN)))
        for conc in (1, 4, cs.SERVE_REQUESTS):
            lines.append({**base, **serve(torch, cs, engine, mc, conc,
                                          seed=conc)})
        if args.profile:
            lines.append({**base, **profile(torch, cs, engine, mc)})
    finally:
        engine.stop()
    for line in lines:
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
