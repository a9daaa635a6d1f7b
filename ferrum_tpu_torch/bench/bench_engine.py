"""Offline serving benchmark over the engine (bench-serve analog).

Port of `ferrum_tpu/bench/bench_engine.py`: tokenizer-aware random
prompts (256/128 cells), closed-loop concurrency cells, per-request
TTFT / TPOT / ITL / E2E, mean / stddev / ci95 over repeats and an
env-hash cell identity. The report keys and the "ferrum-tpu-bench/v1"
schema string are the JAX package's. Each cell itemizes its time from
the runner's counters (decode dispatch, decode sync, prefill) and
counts the program keys first met inside it (`compilations_during_cell`,
engine/runner.py's compile audit): nonzero means a warm-up hole.
`guided_schema` attaches a json_schema constraint to every request, as
the JAX package's cells do.
"""

from __future__ import annotations

import hashlib
import json
import math
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from ..engine.engine import ContinuousBatchEngine
from ..types import GuidedOptions, InferenceRequest, SamplingParams


@dataclass
class RequestMetrics:
    ttft: float
    e2e: float
    itls: List[float]
    output_tokens: int

    @property
    def tpot(self) -> float:
        if self.output_tokens <= 1:
            return 0.0
        return (self.e2e - self.ttft) / (self.output_tokens - 1)


@dataclass
class ScalarStats:
    """mean / stddev / ci95 half-width."""

    mean: float
    stddev: float
    ci95_hw: float

    @classmethod
    def of(cls, xs: List[float]) -> "ScalarStats":
        if not xs:
            return cls(0.0, 0.0, 0.0)
        m = statistics.fmean(xs)
        sd = statistics.stdev(xs) if len(xs) > 1 else 0.0
        return cls(m, sd, 1.96 * sd / math.sqrt(len(xs)) if len(xs) > 1 else 0.0)


def _pct(xs: List[float], p: float) -> float:
    if not xs:
        return 0.0
    return float(np.percentile(np.asarray(xs), p))


def env_hash(extra: Dict[str, str]) -> str:
    """Apples-to-apples cell identity: torch, CUDA and the device name
    (the JAX package hashes jax's backend, device and version)."""
    import torch

    items = {
        "torch": torch.__version__,
        "cuda": str(torch.version.cuda),
        "device": torch.cuda.get_device_name(0)
        if torch.cuda.is_available() else "cpu",
        **extra,
    }
    blob = json.dumps(items, sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def run_cell(engine: ContinuousBatchEngine, *, concurrency: int,
             num_requests: int, input_len: int = 256, output_len: int = 128,
             seed: int = 0, warmup: int = 2,
             guided_schema: Optional[Dict] = None) -> Dict:
    """One closed-loop concurrency cell. Returns the cell report dict.
    guided_schema: attach a json_schema constraint to every request
    (guided-throughput cells)."""
    rng = np.random.default_rng(seed)
    vocab = engine.runner.model_cfg.vocab_size
    eos = set(engine.tokenizer.eos_token_ids)
    cand = [t for t in range(1, min(vocab, 50000)) if t not in eos]

    def mkreq():
        ids = rng.choice(cand, size=input_len).tolist()
        guided = None
        if guided_schema is not None:
            guided = GuidedOptions(json_schema=guided_schema, strict=False)
        return InferenceRequest(
            prompt_token_ids=ids, guided=guided,
            sampling=SamplingParams(temperature=0.0, max_tokens=output_len,
                                    ignore_eos=True))

    # Warmup: one CONCURRENT wave (the large-group batched prefill and
    # the steady-state decode buckets), then every batch-size sibling prefill
    # key, smaller bucket and mixed window, so no key is first met
    # mid-measurement.
    if warmup:
        wt = [threading.Thread(target=engine.infer, args=(mkreq(),))
              for _ in range(max(concurrency, warmup))]
        for t in wt:
            t.start()
        for t in wt:
            t.join()
        engine.runner.warm_prefill_siblings()

    results: List[RequestMetrics] = []
    errors: List[str] = []
    lock = threading.Lock()
    work = [mkreq() for _ in range(num_requests)]
    widx = [0]

    def worker():
        while True:
            with lock:
                if widx[0] >= len(work):
                    return
                req = work[widx[0]]
                widx[0] += 1
            t0 = time.monotonic()
            try:
                ttft = None
                last_t = None
                itls = []
                n_out = 0
                for chunk in engine.infer_stream(req):
                    now = time.monotonic()
                    if chunk.token_ids:
                        n_out += len(chunk.token_ids)
                        if ttft is None:
                            ttft = now - t0
                        elif last_t is not None:
                            itls.append(now - last_t)
                        last_t = now
                m = RequestMetrics(ttft=ttft or 0.0, e2e=time.monotonic() - t0,
                                   itls=itls, output_tokens=n_out)
                with lock:
                    results.append(m)
            except Exception as e:  # noqa: BLE001
                with lock:
                    errors.append(repr(e))

    comp0 = engine.runner.compilations
    log0 = len(engine.runner.compile_log)
    r = engine.runner
    t0s = (r.decode_device_time, r.decode_sync_time,
           r.prefill_device_time, r.decode_steps, r.prefill_steps)
    t_start = time.monotonic()
    threads = [threading.Thread(target=worker) for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start
    compiled = engine.runner.compilations - comp0

    total_out = sum(r.output_tokens for r in results)
    all_itls = [x for r in results for x in r.itls]
    return {
        "concurrency": concurrency,
        "completed": len(results),
        "requested": num_requests,
        "errors": len(errors),
        "error_samples": errors[:3],
        "wall_s": wall,
        "output_tok_s": total_out / wall if wall > 0 else 0.0,
        "ttft_p50_ms": _pct([r.ttft for r in results], 50) * 1e3,
        "ttft_p95_ms": _pct([r.ttft for r in results], 95) * 1e3,
        "tpot_p50_ms": _pct([r.tpot for r in results], 50) * 1e3,
        "tpot_p95_ms": _pct([r.tpot for r in results], 95) * 1e3,
        "itl_p95_ms": _pct(all_itls, 95) * 1e3,
        "e2e_p50_ms": _pct([r.e2e for r in results], 50) * 1e3,
        # Program keys first met DURING the measured window -- nonzero
        # means a warm-up hole (engine/runner.py's compile audit).
        "compilations_during_cell": compiled,
        "compiled_in_cell": [repr(e) for e in
                             engine.runner.compile_log[log0:]],
        # Phase-time itemization (runner counter deltas over the cell):
        # decode_dispatch_s = start_decode_window dispatch calls,
        # decode_sync_s = blocking window fetches (device wait lands
        # here), prefill_s = run_prefill_batch wall. The remainder of
        # wall_s is engine-loop/scheduler/client host time.
        "phase_times": {
            "decode_dispatch_s": round(r.decode_device_time - t0s[0], 3),
            "decode_sync_s": round(r.decode_sync_time - t0s[1], 3),
            "prefill_s": round(r.prefill_device_time - t0s[2], 3),
            "decode_steps": r.decode_steps - t0s[3],
            "prefill_calls": r.prefill_steps - t0s[4],
        },
    }


def run_cell_open_loop(engine: ContinuousBatchEngine, *, rate_rps: float,
                       duration_s: float = 30.0, input_len: int = 256,
                       output_len: int = 128, seed: int = 0,
                       warmup: int = 2, max_inflight: int = 256) -> Dict:
    """Open-loop Poisson arrivals at `rate_rps`.

    Unlike the closed-loop cells, request launches do NOT wait for
    completions: inter-arrival gaps are Exp(rate) draws on a fixed
    schedule, so queueing delay shows up in TTFT — the latency-under-
    load posture vLLM-class serving systems are judged on. Launches
    stop after `duration_s`; every launched request runs to completion.
    """
    rng = np.random.default_rng(seed)
    vocab = engine.runner.model_cfg.vocab_size
    eos = set(engine.tokenizer.eos_token_ids)
    cand = [t for t in range(1, min(vocab, 50000)) if t not in eos]

    def mkreq():
        ids = rng.choice(cand, size=input_len).tolist()
        return InferenceRequest(
            prompt_token_ids=ids,
            sampling=SamplingParams(temperature=0.0, max_tokens=output_len,
                                    ignore_eos=True))

    if warmup:
        wt = [threading.Thread(target=engine.infer, args=(mkreq(),))
              for _ in range(warmup)]
        for t in wt:
            t.start()
        for t in wt:
            t.join()
        engine.runner.warm_prefill_siblings()

    # Pre-draw the arrival schedule (deterministic per seed: a dedicated
    # rng so warmup/prompt draws don't shift it).
    sched_rng = np.random.default_rng((seed, 0xA881))
    gaps = sched_rng.exponential(1.0 / max(rate_rps, 1e-9), size=4096)
    sched, acc = [], 0.0
    for g in gaps:
        acc += g
        if acc > duration_s:
            break
        sched.append(acc)

    results: List[RequestMetrics] = []
    errors: List[str] = []
    lock = threading.Lock()
    threads: List[threading.Thread] = []

    def worker(req):
        t0 = time.monotonic()
        try:
            ttft = None
            last_t = None
            itls = []
            n_out = 0
            for chunk in engine.infer_stream(req):
                now = time.monotonic()
                if chunk.token_ids:
                    n_out += len(chunk.token_ids)
                    if ttft is None:
                        ttft = now - t0
                    elif last_t is not None:
                        itls.append(now - last_t)
                    last_t = now
            m = RequestMetrics(ttft=ttft or 0.0, e2e=time.monotonic() - t0,
                               itls=itls, output_tokens=n_out)
            with lock:
                results.append(m)
        except Exception as e:  # noqa: BLE001
            with lock:
                errors.append(repr(e))

    comp0 = engine.runner.compilations
    reqs = [mkreq() for _ in sched]
    t_start = time.monotonic()
    for at, req in zip(sched, reqs):
        delay = at - (time.monotonic() - t_start)
        if delay > 0:
            time.sleep(delay)
        if len(threads) - len(results) >= max_inflight:
            errors.append("inflight cap hit: offered load unsustainable")
            break
        th = threading.Thread(target=worker, args=(req,))
        th.start()
        threads.append(th)
    for th in threads:
        th.join()
    wall = time.monotonic() - t_start

    total_out = sum(r.output_tokens for r in results)
    return {
        "mode": "open-loop",
        "offered_rps": rate_rps,
        "duration_s": duration_s,
        "launched": len(threads),
        "completed": len(results),
        "errors": len(errors),
        "error_samples": errors[:3],
        "wall_s": wall,
        "achieved_rps": len(results) / wall if wall > 0 else 0.0,
        "output_tok_s": total_out / wall if wall > 0 else 0.0,
        "ttft_p50_ms": _pct([r.ttft for r in results], 50) * 1e3,
        "ttft_p95_ms": _pct([r.ttft for r in results], 95) * 1e3,
        "ttft_p99_ms": _pct([r.ttft for r in results], 99) * 1e3,
        "tpot_p50_ms": _pct([r.tpot for r in results], 50) * 1e3,
        "itl_p95_ms": _pct([x for r in results for x in r.itls], 95) * 1e3,
        "e2e_p50_ms": _pct([r.e2e for r in results], 50) * 1e3,
        "compilations_during_cell": engine.runner.compilations - comp0,
    }


def run_bench(engine: ContinuousBatchEngine, *, concurrencies=(1, 4, 16, 32),
              num_requests_per_cell: Optional[Dict[int, int]] = None,
              input_len: int = 256, output_len: int = 128,
              model_label: str = "", n_repeats: int = 1,
              guided_schema: Optional[Dict] = None) -> Dict:
    """n_repeats > 1 re-runs every cell (warmup only before the first
    repeat) and reports mean/stddev/ci95 over repeats."""
    cells = []
    for c in concurrencies:
        n = (num_requests_per_cell or {}).get(c, max(2 * c, 8))
        reps = [run_cell(engine, concurrency=c, num_requests=n,
                         input_len=input_len, output_len=output_len,
                         seed=rep, warmup=2 if rep == 0 else 0,
                         guided_schema=guided_schema)
                for rep in range(max(1, n_repeats))]
        cell = dict(reps[-1])
        if len(reps) > 1:
            for k in ("output_tok_s", "ttft_p50_ms", "ttft_p95_ms",
                      "tpot_p50_ms", "itl_p95_ms", "e2e_p50_ms"):
                st = ScalarStats.of([r[k] for r in reps])
                cell[k] = st.mean
                cell[k + "_stats"] = {"mean": st.mean, "stddev": st.stddev,
                                      "ci95_hw": st.ci95_hw,
                                      "n": len(reps)}
        cells.append(cell)
    return {
        "schema": "ferrum-tpu-bench/v1",
        "model": model_label,
        "workload": {"input_len": input_len, "output_len": output_len,
                     "mode": "closed-loop"},
        "env_hash": env_hash({"model": model_label}),
        "cells": cells,
    }
