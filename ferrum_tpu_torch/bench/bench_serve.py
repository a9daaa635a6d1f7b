"""HTTP-level serving benchmark (vLLM `bench serve`-style workload).

Port of `ferrum_tpu/bench/bench_serve.py` on the standard library in
place of aiohttp: random word prompts streamed from a live
/v1/completions endpoint in closed-loop concurrency cells, each of
`concurrency` worker threads holding one persistent `http.client`
connection; per-request TTFT / TPOT / ITL / E2E from the SSE arrival
times (a "token" is an SSE event with text, as in the JAX client), and
the JAX report's keys, schema string and `ScalarStats` over repeats.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
from typing import Dict, List, Tuple
from urllib.parse import urlsplit

import numpy as np

from .bench_engine import ScalarStats, _pct, env_hash

WORDS = ["the", "alpha", "stream", "rock", "compute", "seven", "blue",
         "matrix", "quick", "delta", "cloud", "zero", "prime", "flux"]


def _random_prompt(rng: np.random.Generator, approx_tokens: int) -> str:
    return " ".join(rng.choice(WORDS) for _ in range(approx_tokens))


def _connect(base_url: str, timeout: float) -> http.client.HTTPConnection:
    u = urlsplit(base_url)
    return http.client.HTTPConnection(u.hostname, u.port or 80,
                                      timeout=timeout)


def _one_request(conn: http.client.HTTPConnection, prefix: str, model: str,
                 prompt: str, output_len: int) -> Dict:
    t0 = time.monotonic()
    ttft = None
    last = None
    itls: List[float] = []
    n_tokens = 0
    body = {"model": model, "prompt": prompt, "max_tokens": output_len,
            "stream": True, "temperature": 0.0, "ignore_eos": True}
    conn.request("POST", f"{prefix}/v1/completions", body=json.dumps(body),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    if resp.status >= 400:
        detail = resp.read()[:200]
        raise RuntimeError(f"HTTP {resp.status}: {detail!r}")
    while True:
        raw = resp.readline()
        if not raw:
            break
        line = raw.decode().strip()
        if not line.startswith("data:"):
            continue
        payload = line[5:].strip()
        if payload == "[DONE]":
            break
        now = time.monotonic()
        obj = json.loads(payload)
        choices = obj.get("choices") or []
        if choices and choices[0].get("text"):
            n_tokens += 1
            if ttft is None:
                ttft = now - t0
            elif last is not None:
                itls.append(now - last)
            last = now
    resp.read()                          # the stream's end: reuse the socket
    return {"ttft": ttft or 0.0, "e2e": time.monotonic() - t0,
            "itls": itls, "tokens": n_tokens}


def _run_cell(base_url: str, model: str, concurrency: int, num_requests: int,
              input_len: int, output_len: int, seed: int = 0,
              timeout: float = 3600.0) -> Dict:
    rng = np.random.default_rng(seed)
    prompts = [_random_prompt(rng, input_len) for _ in range(num_requests)]
    results: List[Dict] = []
    errors: List[str] = []
    lock = threading.Lock()
    next_i = [0]
    prefix = urlsplit(base_url).path.rstrip("/")

    def worker():
        conn = _connect(base_url, timeout)
        try:
            while True:
                with lock:
                    i = next_i[0]
                    if i >= num_requests:
                        return
                    next_i[0] += 1
                try:
                    r = _one_request(conn, prefix, model, prompts[i],
                                     output_len)
                except Exception as e:  # noqa: BLE001
                    conn.close()
                    conn = _connect(base_url, timeout)
                    with lock:
                        errors.append(repr(e))
                    continue
                with lock:
                    results.append(r)
        finally:
            conn.close()

    t_start = time.monotonic()
    threads = [threading.Thread(target=worker, daemon=True)
               for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.monotonic() - t_start
    total = sum(r["tokens"] for r in results)
    tpots = [(r["e2e"] - r["ttft"]) / max(r["tokens"] - 1, 1)
             for r in results]
    return {
        "concurrency": concurrency,
        "completed": len(results),
        "requested": num_requests,
        "errors": len(errors),
        "error_samples": errors[:3],
        "wall_s": wall,
        "output_tok_s": total / wall if wall else 0.0,
        "ttft_p50_ms": _pct([r["ttft"] for r in results], 50) * 1e3,
        "tpot_p50_ms": _pct(tpots, 50) * 1e3,
        "itl_p95_ms": _pct([x for r in results for x in r["itls"]], 95) * 1e3,
        "e2e_p50_ms": _pct([r["e2e"] for r in results], 50) * 1e3,
    }


def run_bench_serve(base_url: str, model: str,
                    concurrencies: Tuple[int, ...] = (1, 4, 16, 32),
                    num_requests: int = 64, input_len: int = 256,
                    output_len: int = 128, n_repeats: int = 1,
                    timeout: float = 3600.0) -> Dict:
    cells = []
    for c in concurrencies:
        reps = [_run_cell(base_url, model, c, num_requests, input_len,
                          output_len, seed=r, timeout=timeout)
                for r in range(n_repeats)]
        tputs = [r["output_tok_s"] for r in reps]
        cell = dict(reps[-1])
        cell["output_tok_s_stats"] = ScalarStats.of(tputs).__dict__
        cells.append(cell)
    return {
        "schema": "ferrum-tpu-bench-serve/v1",
        "base_url": base_url,
        "model": model,
        "workload": {"input_len": input_len, "output_len": output_len,
                     "n_repeats": n_repeats, "mode": "closed-loop"},
        "env_hash": env_hash({"model": model, "lane": "bench-serve"}),
        "cells": cells,
    }
