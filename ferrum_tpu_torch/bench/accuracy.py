"""Accuracy gates: greedy self-determinism, quant token divergence,
teacher-forced logit metrics, weight-space quantization error, and the
HTTP client functions of the lm_eval loglikelihood contract.

Port of `ferrum_tpu/bench/accuracy.py`. `teacher_forced_logits` is a
plain torch forward over one token list (no KV cache, no engine, f32
scores as the JAX reference's einsums); `quant_logit_metrics` and
`weight_quant_error` are numpy, as in the JAX package. The HTTP
functions (`completions_logprobs`, `loglikelihood`, `perplexity`,
`compare_to_baseline`, `lm_eval_light`) are the JAX package's, stdlib
urllib against a /v1/completions endpoint (server/app.py's echo +
logprobs scoring round).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..engine.engine import ContinuousBatchEngine
from ..types import InferenceRequest, SamplingParams

DEFAULT_PROMPTS = (
    "The capital of France is",
    "Water is composed of hydrogen and",
    "In computer science, a binary search runs in",
    "The first law of thermodynamics states that energy",
    "To bake bread you first mix flour with",
)


@dataclass
class DeterminismReport:
    prompts: int
    token_agreement: float          # must be 1.0 (100%)
    passed: bool


def greedy_self_determinism(engine: ContinuousBatchEngine,
                            prompts: Sequence[str] = DEFAULT_PROMPTS,
                            max_tokens: int = 64) -> DeterminismReport:
    """Two greedy runs per prompt must agree 100%."""
    agree = total = 0
    for p in prompts:
        runs = []
        for _ in range(2):
            req = InferenceRequest(
                prompt=p, sampling=SamplingParams(max_tokens=max_tokens,
                                                  ignore_eos=True))
            runs.append(engine.infer(req).token_ids)
        n = min(len(runs[0]), len(runs[1]))
        agree += sum(a == b for a, b in zip(runs[0][:n], runs[1][:n]))
        total += n
    rate = agree / max(total, 1)
    return DeterminismReport(prompts=len(prompts), token_agreement=rate,
                             passed=rate == 1.0)


@dataclass
class DivergenceReport:
    prompts: int
    tokens_compared: int
    divergence_rate: float          # gate: < 0.10
    passed: bool


def quant_token_divergence(engine_hi: ContinuousBatchEngine,
                           engine_lo: ContinuousBatchEngine,
                           prompts: Sequence[str] = DEFAULT_PROMPTS,
                           max_tokens: int = 64,
                           gate: float = 0.10) -> DivergenceReport:
    """Greedy token divergence between a high-precision engine and its
    quantized counterpart."""
    div = total = 0
    for p in prompts:
        a = engine_hi.infer(InferenceRequest(
            prompt=p, sampling=SamplingParams(max_tokens=max_tokens,
                                              ignore_eos=True))).token_ids
        b = engine_lo.infer(InferenceRequest(
            prompt=p, sampling=SamplingParams(max_tokens=max_tokens,
                                              ignore_eos=True))).token_ids
        n = min(len(a), len(b))
        div += sum(x != y for x, y in zip(a[:n], b[:n]))
        total += n
    rate = div / max(total, 1)
    return DivergenceReport(prompts=len(prompts), tokens_compared=total,
                            divergence_rate=rate, passed=rate < gate)


def teacher_forced_logits(params, cfg, tokens: Sequence[int]
                          ) -> torch.Tensor:
    """Full-sequence causal logits f32 [N, vocab] for one token list: the
    model's trunk with a plain causal GQA attention (f32 scores and
    weights, -1e30 masked; each layer's sliding window and the
    attention softcap), on the params' device."""
    from ..models.llama_family import (forward_hidden, logits_from_hidden,
                                       make_inv_freq, make_local_inv_freq)

    dev = params.embed.device
    toks = torch.tensor(list(tokens), dtype=torch.int64, device=dev)
    pos = torch.arange(toks.shape[0], device=dev)
    g = cfg.num_heads // cfg.num_kv_heads
    cap = cfg.attn_logit_softcap

    def attn(li, q, k, v):
        kf = k.repeat_interleave(g, dim=1).to(torch.float32)  # [N, Hq, D]
        vf = v.repeat_interleave(g, dim=1).to(torch.float32)
        s = torch.einsum("qhd,khd->hqk", q.to(torch.float32), kf)
        s = s * cfg.attn_scale
        if cap:
            s = cap * torch.tanh(s / cap)
        mask = pos[None, :] <= pos[:, None]
        sw = cfg.layer_sliding_window(li)
        if sw is not None:
            mask = mask & (pos[None, :] > pos[:, None] - sw)
        s = torch.where(mask[None], s, torch.tensor(-1e30, device=dev))
        w = torch.softmax(s, dim=-1)
        return torch.einsum("hqk,khd->qhd", w, vf).to(q.dtype)

    h = forward_hidden(params, cfg, toks, pos, attn,
                       inv_freq=make_inv_freq(cfg, dev),
                       inv_freq_local=make_local_inv_freq(cfg, dev))
    return logits_from_hidden(params, cfg, h).to(torch.float32)


def quant_logit_metrics(logits_f, logits_q) -> Dict:
    """Tie-robust quantization-error metrics between float-oracle and
    quantized logits over the same teacher-forced positions [N, vocab]:
    per-position KL(p_float || p_int4) (kl_mean / kl_p95), the
    shift-invariant relative logit error (rel_err_mean / max), raw top-1
    agreement, the oracle's top-1 margin, and agreement where that margin
    exceeds twice the median top-1 perturbation (None when under 5% of
    positions do: the oracle then has no confident decisions)."""
    lf = np.asarray(logits_f, dtype=np.float64)
    lq = np.asarray(logits_q, dtype=np.float64)

    def _logsoftmax(x):
        m = x.max(axis=-1, keepdims=True)
        z = x - m
        return z - np.log(np.exp(z).sum(axis=-1, keepdims=True))

    lsf, lsq = _logsoftmax(lf), _logsoftmax(lq)
    pf = np.exp(lsf)
    kl = (pf * (lsf - lsq)).sum(axis=-1)                   # [N]

    cf = lf - lf.mean(axis=-1, keepdims=True)
    d = lq - lf
    d = d - d.mean(axis=-1, keepdims=True)
    rel = np.linalg.norm(d, axis=-1) / np.maximum(
        np.linalg.norm(cf, axis=-1), 1e-9)

    top1f = lf.argmax(axis=-1)
    top1q = lq.argmax(axis=-1)
    agree = top1f == top1q
    part = np.partition(lf, -2, axis=-1)
    margin = part[:, -1] - part[:, -2]                     # oracle gap
    pert = np.abs(d[np.arange(d.shape[0]), top1f])
    thresh = 2.0 * float(np.median(pert))
    big = margin > thresh
    vacuous = float(big.mean()) < 0.05
    agree_at_margin = None if vacuous else float(agree[big].mean())

    return {
        "positions": int(lf.shape[0]),
        "kl_mean": float(kl.mean()),
        "kl_p95": float(np.percentile(kl, 95)),
        "rel_err_mean": float(rel.mean()),
        "rel_err_max": float(rel.max()),
        "top1_agree": float(agree.mean()),
        "margin_median": float(np.median(margin)),
        "margin_p10": float(np.percentile(margin, 10)),
        "top1_pert_median": float(np.median(pert)),
        "margin_threshold": thresh,
        "frac_above_margin": float(big.mean()),
        "margin_vacuous": bool(vacuous),
        "agree_at_margin": agree_at_margin,
    }


def weight_quant_error(params_f, params_q) -> Dict:
    """Weight-space relative error of each dequantized int4 tensor
    against its float source, ||dequant(Q(W)) - W||_2 / ||W||_2 per
    projection (int4 g128 of gaussian weights: ~0.10; a packing, scale
    or zero-point fault shows as >= 3x that)."""
    from ..ops.linear import DenseLinearParams
    from ..ops.quant import QuantLinearParams, dequantize

    errs = {}
    for li, (lf, lq) in enumerate(zip(params_f.layers, params_q.layers)):
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            pf, pq = getattr(lf, name), getattr(lq, name)
            if not (isinstance(pf, DenseLinearParams)
                    and isinstance(pq, QuantLinearParams)):
                continue
            w = pf.w.to(torch.float64).cpu().numpy()
            wq = dequantize(pq).to(torch.float64).cpu().numpy()  # bf16
            errs[f"layers[{li}].{name}"] = float(
                np.linalg.norm(wq - w) / max(np.linalg.norm(w), 1e-12))
    vals = np.array(list(errs.values()))
    return {
        "tensors": len(errs),
        "rel_err_mean": float(vals.mean()) if len(vals) else 0.0,
        "rel_err_max": float(vals.max()) if len(vals) else 0.0,
        "worst_tensor": (max(errs, key=errs.get) if errs else None),
    }


# ---------------------------------------------------------------------------
# HTTP: the lm_eval local-completions loglikelihood contract
# ---------------------------------------------------------------------------

def completions_logprobs(base_url: str, prompt: str,
                         model: str = "ferrum",
                         timeout: float = 300.0) -> Dict:
    """POST /v1/completions with echo + logprobs + max_tokens=0 and
    return the OpenAI logprobs object ({tokens, token_logprobs,
    top_logprobs, text_offset})."""
    import urllib.request

    body = json.dumps({"model": model, "prompt": prompt,
                       "max_tokens": 0, "echo": True,
                       "logprobs": 1}).encode()
    req = urllib.request.Request(
        base_url.rstrip("/") + "/v1/completions", data=body,
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        out = json.loads(resp.read())
    return out["choices"][0]["logprobs"]


def loglikelihood(base_url: str, context: str, continuation: str,
                  model: str = "ferrum") -> Dict:
    """Sum of the continuation tokens' logprobs given the context, and
    whether each was the argmax (is_greedy), as loglikelihood tasks
    score. Continuation tokens are found by text offset: a token
    straddling the boundary counts toward the continuation."""
    lp = completions_logprobs(base_url, context + continuation, model)
    cut = len(context)
    ll = 0.0
    greedy = True
    for off, tok_lp, top in zip(lp["text_offset"],
                                lp["token_logprobs"],
                                lp["top_logprobs"]):
        if off < cut or tok_lp is None:
            continue
        ll += tok_lp
        if top:
            best = max(top.values())
            greedy = greedy and tok_lp >= best - 1e-6
    return {"loglikelihood": ll, "is_greedy": greedy}


def perplexity(base_url: str, texts: Sequence[str],
               model: str = "ferrum") -> Dict:
    """Corpus perplexity over the scored positions:
    {perplexity, tokens, total_logprob}."""
    total_lp = 0.0
    n = 0
    for t in texts:
        lp = completions_logprobs(base_url, t, model)
        for tok_lp in lp["token_logprobs"]:
            if tok_lp is not None:
                total_lp += tok_lp
                n += 1
    return {"perplexity": math.exp(-total_lp / max(n, 1)),
            "tokens": n, "total_logprob": total_lp}


def compare_to_baseline(results: Dict[str, float],
                        baseline: Dict[str, float],
                        rtol: float = 0.05) -> Dict:
    """Per-metric rtol comparison against a baseline; metrics missing
    from the baseline are recorded, not failed."""
    report = {"rtol": rtol, "metrics": {}, "passed": True}
    for k, v in results.items():
        base = baseline.get(k)
        entry = {"value": v, "baseline": base}
        if base is not None:
            ok = abs(v - base) <= rtol * abs(base)
            entry["passed"] = ok
            report["passed"] = report["passed"] and ok
        report["metrics"][k] = entry
    return report


# Primary result metric per lm_eval task.
_TASK_METRIC = {"mmlu": "acc,none", "arc_easy": "acc,none",
                "gsm8k": "exact_match,strict-match"}


def lm_eval_light(base_url: str, tasks: Optional[Dict[str, int]] = None,
                  rtol: float = 0.05,
                  baseline: Optional[Dict[str, float]] = None,
                  model: str = "ferrum",
                  tokenizer: Optional[str] = None,
                  num_concurrent: int = 4) -> Dict:
    """lm-evaluation-harness subsets (mmlu 100q 5-shot, arc_easy 100q,
    gsm8k 50q) against a /v1/completions endpoint through lm_eval's
    local-completions model. Without the `lm_eval` package (it is not
    on the card's machine) this returns a skipped report."""
    tasks = tasks or {"mmlu": 100, "arc_easy": 100, "gsm8k": 50}
    try:
        import lm_eval
    except ImportError:
        return {"skipped": "lm_eval not installed (offline environment)",
                "tasks": tasks}

    model_args = (
        f"base_url={base_url.rstrip('/')}/v1/completions,"
        f"model={model},num_concurrent={num_concurrent},max_retries=2")
    if tokenizer:
        model_args += f",tokenizer={tokenizer},tokenizer_backend=huggingface"

    results: Dict[str, float] = {}
    raw = {}
    for task, limit in tasks.items():
        out = lm_eval.simple_evaluate(
            model="local-completions", model_args=model_args,
            tasks=[task], limit=limit,
            num_fewshot=5 if task == "mmlu" else None)
        raw[task] = out["results"]
        metric = _TASK_METRIC.get(task, "acc,none")
        # mmlu aggregates subtasks; take the task's own row when
        # present, else the mean of its subtask rows.
        row = out["results"].get(task)
        if row is not None and metric in row:
            results[task] = float(row[metric])
        else:
            vals = [float(r[metric]) for r in out["results"].values()
                    if metric in r]
            results[task] = sum(vals) / max(len(vals), 1)

    report = {"tasks": tasks, "results": results}
    if baseline:
        report["gate"] = compare_to_baseline(results, baseline, rtol)
    return report
