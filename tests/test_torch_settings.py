"""The engine's remaining settings against the JAX package (CPU).

Adaptive window lengths (`adaptive_windows`, the JAX default) with the
pipelined loop, slack lanes (`slot_slack`), the scheduler's policies
(`scheduler` continuous / fifo / priority), `enable_chunked_prefill`
and its trace JSONL (`scheduler_trace_path`), build-time fusion
(`fuse_proj`, `fuse_sites` with the "moe" site), the embedding squeeze
(`squeeze_embeddings`: an int8 table and an int4 lm_head), dense MoE
expert stacks (`jax.lax.ragged_dot`'s route) and the unwired
`moe_mlp_gather_decode`. Inputs are made with numpy from a seed; the
JAX package runs on the CPU with its Pallas entries pointed at the jnp
forms tests/torch_parity.py holds against interpret-mode runs.

Tolerances: the quantizers, the fused integer projections and the
scheduler's records are held bit for bit (the trace's `t` field aside);
the engines' greedy streams token for token; f32 dense products and the
bf16-rounded routes within the bounds stated at each test.

Where the JAX package is at fault (ROADMAP Queue 3), the port is held
to the unpipelined and teacher-forced stream instead, and the parity
runs stay where the JAX package is right: its scheduler reserves
decode_multi_step * (1 + pipeline_depth) positions, too few for two
doubled windows (test_adaptive_windows_keep_their_kv), its runner pads
a chunk to at most prefill_chunk_size (an unchunked prompt longer than
that fails) and its fifo admission never takes a prompt between
prefill_chunk_size and the token budget.
"""

from __future__ import annotations

import dataclasses
import json
import queue
import time

import numpy as np
import pytest
import torch

from test_torch_engine import (MARGIN, PROMPT_4, PROMPTS, SERVE_TIMEOUT_S,
                               _margins, _submit_all)
from torch_parity import (flatten_jax_params, flatten_torch_params,
                          jax_model, route_moe_w4a8tl, route_w4a8tl,
                          torch_config)

MOVED = ("adaptive_windows", "slot_slack", "scheduler",
         "enable_chunked_prefill", "scheduler_trace_path", "fuse_proj",
         "fuse_sites", "squeeze_embeddings", "prefix_offload_mb",
         "prefix_offload_algo")


# ---------------------------------------------------------------------------
# The config
# ---------------------------------------------------------------------------

def test_moved_settings_match_jax_defaults_env_and_checks():
    """Each moved field has the JAX default, its FERRUM_* name and help
    string; NOT_PORTED keeps only the fields other items wait for; the
    scheduler name is checked as the JAX package checks it."""
    from ferrum_tpu import config as jc
    from ferrum_tpu_torch import config as tc
    from ferrum_tpu_torch.types import InvalidRequestError

    mine, ref = tc.EngineConfig(), jc.EngineConfig()
    for name in MOVED:
        assert getattr(mine, name) == getattr(ref, name), name
        assert name not in tc.NOT_PORTED
    assert set(tc.NOT_PORTED) == {
        "tokenizer", "greedy_argmax_device", "quantization",
        "gdn_chunk_block",
        "tensor_parallel", "data_parallel", "expert_parallel"}
    for env, entry in tc.ENV_REGISTRY.items():
        if entry[0] in MOVED:
            assert jc.ENV_REGISTRY[env] == entry, env
    assert {e[0] for e in tc.ENV_REGISTRY.values()} >= set(MOVED)
    for bad in ("lifo", ""):
        with pytest.raises(InvalidRequestError, match="scheduler"):
            tc.EngineConfig(scheduler=bad).validate()
        with pytest.raises(Exception, match="scheduler"):
            jc.EngineConfig(scheduler=bad).validate()


@pytest.mark.parametrize("seqs,slack,spec", [
    (2, 2, ""), (4, 0, ""), (6, 2, "1,2"), (32, 2, ""), (32, 3, "1,8"),
    (8, 1, "max")])
def test_slot_slack_slots_and_buckets_match_jax(seqs, slack, spec):
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu_torch.config import EngineConfig

    kw = dict(max_num_seqs=seqs, slot_slack=slack, decode_bucket_spec=spec)
    mine, ref = EngineConfig(**kw), JaxConfig(model="m", **kw)
    assert mine.num_slots == ref.num_slots == seqs + slack
    assert mine.decode_buckets == ref.decode_buckets
    assert mine.resolved_prefix_cache_blocks \
        == ref.resolved_prefix_cache_blocks


# ---------------------------------------------------------------------------
# The scheduler: policies, unchunked prefill, the trace
# ---------------------------------------------------------------------------

def _trace_run(sched, seq_cls, req_cls, samp_cls, arrive, lens, prios,
               script):
    """Run one scheduler through the scripted iterations: arrivals,
    chunks done, one token a decode, finishes."""
    for it in range(script["iterations"]):
        for rid in arrive.get(it, ()):
            toks = list(range(3, 3 + lens[rid]))
            sched.submit(seq_cls(req_cls(
                prompt_token_ids=toks, request_id=rid, priority=prios[rid],
                sampling=samp_cls(max_tokens=64)), toks))
        batch = sched.next_batch()
        for c in batch.prefill_chunks:
            sched.note_prefill_done(c)
        for seq in batch.decode_seqs:
            seq.output_tokens.append(1)
        for seq in list(sched.running):
            if seq.request.request_id in script["finish"].get(it, ()):
                sched.finish(seq)


def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    for r in recs:
        assert isinstance(r.pop("t"), float)
    return recs


@pytest.mark.parametrize("layout", ["linear", "paged"])
@pytest.mark.parametrize("policy,chunked", [
    ("continuous", True), ("fifo", True), ("priority", True),
    ("continuous", False), ("priority", False)])
def test_scheduler_trace_matches_jax(tmp_path, policy, chunked, layout):
    """Both schedulers on one scripted run (7 requests of 7 to 200
    tokens, with priorities, into 3 slots; chunks of 32 within a
    96-token budget), each writing its trace JSONL: the files agree
    record for record, `t` aside (the JAX keys: iteration, decode,
    prefill_chunks, admitted, preempted, waiting, running, free_blocks,
    budget_left). fifo runs prompts up to 32 tokens or over the budget
    (between them the JAX fifo admits nothing: ROADMAP Queue 3). Both
    reserve for decode_multi_step windows (adaptive windows off in the
    port: with them on it reserves for the doubled length)."""
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.kv.block_pool import BlockPool as JaxPool
    from ferrum_tpu.scheduler.continuous import (
        ContinuousBatchScheduler as JaxSched)
    from ferrum_tpu.scheduler.sequence import Sequence as JaxSeq
    from ferrum_tpu.types import InferenceRequest as JaxReq
    from ferrum_tpu.types import SamplingParams as JaxSamp
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.kv.block_pool import BlockPool
    from ferrum_tpu_torch.scheduler.continuous import (
        ContinuousBatchScheduler)
    from ferrum_tpu_torch.scheduler.sequence import Sequence
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    blocks = 3 * 512 // 16 if layout == "linear" else 40
    kw = dict(max_num_seqs=3, max_model_len=512, kv_block_size=16,
              prefill_chunk_size=32, max_num_batched_tokens=96,
              decode_multi_step=4, kv_layout=layout,
              enable_prefix_cache=False, scheduler=policy,
              enable_chunked_prefill=chunked)
    paths = {p: str(tmp_path / f"{p}.jsonl") for p in ("jax", "port")}
    jsched = JaxSched(JaxConfig(model="m", scheduler_trace_path=paths["jax"],
                                **kw), JaxPool(blocks, 16), policy=policy)
    sched = ContinuousBatchScheduler(EngineConfig(
        scheduler_trace_path=paths["port"], adaptive_windows=False, **kw),
        BlockPool(blocks, 16))
    lens = {"r0": 7, "r1": 200, "r2": 30, "r3": 13, "r4": 90, "r5": 32,
            "r6": 20}
    if policy == "fifo":
        lens.update(r2=25, r4=120)
    prios = {"r0": 0, "r1": 0, "r2": 1, "r3": 0, "r4": 2, "r5": 0, "r6": 3}
    arrive = {0: ["r0", "r1", "r2"], 1: ["r3"], 2: ["r4", "r5"], 3: ["r6"]}
    script = {"iterations": 16,
              "finish": {3: {"r0"}, 6: {"r2", "r3"}, 9: {"r4"}, 12: {"r6"}}}
    _trace_run(jsched, JaxSeq, JaxReq, JaxSamp, arrive, lens, prios, script)
    _trace_run(sched, Sequence, InferenceRequest, SamplingParams, arrive,
               lens, prios, script)
    jsched._trace_fh.close()
    sched.close()
    want, got = _records(paths["jax"]), _records(paths["port"])
    assert len(got) == 16 and got == want
    admitted = [r for rec in got for r in rec["admitted"]]
    if policy == "priority":
        # r6 (priority 3) and r4 (2) overtake r5 (0), which waits.
        assert admitted.index("r6") < admitted.index("r5")
    if not chunked:
        assert any(c[2] > 32 for rec in got for c in rec["prefill_chunks"])


def test_fifo_admits_a_prompt_that_fits_the_budget_whole():
    """Under fifo a 77-token prompt (chunks of 32, a 128-token budget) is
    admitted as one chunk; the JAX scheduler never admits it (ROADMAP
    Queue 3)."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.scheduler.continuous import (
        ContinuousBatchScheduler)
    from ferrum_tpu_torch.scheduler.sequence import Sequence
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    sched = ContinuousBatchScheduler(EngineConfig(
        max_num_seqs=2, max_model_len=256, kv_block_size=16,
        prefill_chunk_size=32, max_num_batched_tokens=128, scheduler="fifo",
        kv_layout="linear"))
    toks = list(range(3, 80))
    sched.submit(Sequence(InferenceRequest(
        prompt_token_ids=toks, sampling=SamplingParams(max_tokens=4)), toks))
    batch = sched.next_batch()
    assert [len(c.tokens) for c in batch.prefill_chunks] == [77]
    assert batch.prefill_chunks[0].is_last


# ---------------------------------------------------------------------------
# Adaptive windows and slack lanes in the engines
# ---------------------------------------------------------------------------

def _settings_kw(**kw):
    base = dict(max_num_seqs=4, max_model_len=256, kv_block_size=16,
                prefill_chunk_size=32, max_num_batched_tokens=128,
                kv_dtype="f32", decode_multi_step=8, seed=0,
                enable_prefix_cache=False, kv_layout="linear")
    base.update(kw)
    return base


def _tiny_quant(monkeypatch, seed=3):
    """(jax cfg, JAX params, port cfg, port params): tiny-quant's
    two-level weights, the JAX side routed to the two-level oracle."""
    from ferrum_tpu_torch.models.convert import params_from_numpy

    route_w4a8tl(monkeypatch)
    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=seed)
    return jcfg, jparams, torch_config(jcfg), params_from_numpy(
        flatten_jax_params(jparams), "cpu")


def _jax_engine(jcfg, jparams, **kw):
    from ferrum_tpu.config import EngineConfig
    from ferrum_tpu.engine.builder import EngineBuilder
    return EngineBuilder(EngineConfig(model="parity", dtype="f32",
                                      **_settings_kw(**kw))) \
        .with_model(jcfg, jparams).build()


def _port_engine(cfg, params, **kw):
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    return EngineBuilder(EngineConfig(device="cpu", **_settings_kw(**kw))) \
        .with_model(cfg, params).build()


def _serve_recorded(engine, req_cls, samp_cls, prompts, max_tokens,
                    one_by_one=False):
    """Serve the prompts (all submitted before the loop starts, or one
    after another); returns each request's tokens (its sequence's once
    its last chunk came: the JAX engine's stream can miss a held-back
    first token, ROADMAP Queue 3, and its release of a paged sequence
    can wait past stop()) and the windows dispatched: (steps, decoding
    request ids, riding request id when its chunk ends the prompt) in
    order. Prefills' first tokens are logged as windows of 0 steps.
    Stops the engine."""
    seqs, log = {}, []
    submit = engine.scheduler.submit
    runner = engine.runner
    start, prefill = runner.start_decode_window, runner.run_prefill_batch

    def record(seq):
        seqs[seq.request.request_id] = seq
        submit(seq)

    def started(seqs, num_steps, prev=None, pf_chunk=None):
        pf = pf_chunk.seq.request.request_id \
            if pf_chunk is not None and pf_chunk.is_last else None
        log.append((num_steps, [s.request.request_id for s in seqs], pf))
        return start(seqs, num_steps, prev=prev, pf_chunk=pf_chunk)

    def prefilled(chunks, **kw):
        log.extend((0, [], c.seq.request.request_id)
                   for c in chunks if c.is_last)
        return prefill(chunks, **kw)

    engine.scheduler.submit = record
    runner.start_decode_window = started
    runner.run_prefill_batch = prefilled
    reqs = [req_cls(prompt_token_ids=list(p), sampling=samp_cls(
        max_tokens=max_tokens, ignore_eos=True)) for p in prompts]
    try:
        if one_by_one:
            queues = []
            for r in reqs:
                queues.append(engine.submit(r))
                _wait(queues[-1])
        else:
            for q in _submit_all(engine, reqs):
                _wait(q)
    finally:
        engine.stop()
    return [list(seqs[r.request_id].output_tokens) for r in reqs], log


def _wait(q):
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    while True:
        assert time.monotonic() < deadline, "engine did not finish"
        try:
            if q.get(timeout=1.0).finished:
                return
        except queue.Empty:
            continue


def _window_lengths(log, max_tokens):
    """The decode windows' lengths in dispatch order, less those whose
    every decoding request already had max_tokens tokens coming (the
    JAX engine dispatches one more window past a request's end; the
    port does not)."""
    ahead, out = {}, []
    for steps, rids, pf in log:
        if pf is not None:
            ahead[pf] = ahead.get(pf, 0) + 1
        if not steps:
            continue
        if rids and all(ahead.get(r, 0) >= max_tokens for r in rids):
            continue
        for r in rids:
            ahead[r] = ahead.get(r, 0) + steps
        out.append(steps)
    return out


# c = 1: one request after another; c = 4: four at once; pile-up: eight
# of 40 tokens (two chunks each) into four slots with a 64-token budget,
# so chunks prefill while sequences decode and requests wait. T = 8:
# doubled 16, halved 4.
ADAPTIVE_CASES = {
    "c1": (PROMPTS, True, 24, {}),
    "c4": (PROMPTS + (PROMPT_4,), False, 24, {}),
    "pileup": ([list(range(3 + 7 * i, 43 + 7 * i)) for i in range(8)],
               False, 20, dict(max_num_batched_tokens=64)),
}


@pytest.mark.parametrize("adaptive", [True, False])
@pytest.mark.parametrize("case", list(ADAPTIVE_CASES))
def test_adaptive_windows_match_jax_engine(monkeypatch, case, adaptive):
    """The pipelined engines at T = 8 with adaptive windows on (the JAX
    default) and off: greedy streams equal, every token the model's
    argmax, and the window lengths equal in dispatch order (the JAX
    engine's windows past a request's end left out). On: 16-step
    windows at <= 4 lanes with nothing waiting and no chunk scheduled,
    4-step ones in the pile-up. Outputs stay within what the JAX scheduler's 24-position
    reservation covers (test_adaptive_windows_keep_their_kv)."""
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.types import SamplingParams as JSamp
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    prompts, one_by_one, n, kw = ADAPTIVE_CASES[case]
    jcfg, jparams, cfg, params = _tiny_quant(monkeypatch)
    got, log = _serve_recorded(
        _port_engine(cfg, params, adaptive_windows=adaptive, **kw),
        InferenceRequest, SamplingParams, prompts, n, one_by_one)
    want, jlog = _serve_recorded(
        _jax_engine(jcfg, jparams, adaptive_windows=adaptive, **kw), JReq,
        JSamp, prompts, n, one_by_one)
    assert got == want
    for prompt, out in zip(prompts, got):
        argmax, margins = _margins(cfg, params, prompt, out)
        assert argmax == out and min(margins) > MARGIN / 2, min(margins)
    lengths = _window_lengths(log, n)
    assert lengths == _window_lengths(jlog, n)
    if not adaptive:
        assert set(lengths) == {8}
    elif case == "pileup":
        assert 4 in lengths and 16 in lengths
    else:
        # (at c = 4 the long prompt's second chunk keeps one window at 8)
        assert 16 in lengths and 4 not in lengths


def test_adaptive_windows_keep_their_kv(monkeypatch):
    """The JAX defaults (adaptive windows, T = 8, the paged layout with
    the prefix cache) at c = 1 with 80 tokens: the port's stream is the
    unpipelined one and each token the teacher-forced argmax; its
    scheduler reserves for two 16-step windows. (The JAX scheduler
    reserves 24 positions where a doubled window in flight and the next
    need 32: its stream leaves the unpipelined one at token 55,
    ROADMAP Queue 3.)"""
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    _, _, cfg, params = _tiny_quant(monkeypatch)
    paged = dict(kv_layout="paged", kv_num_blocks=64,
                 enable_prefix_cache=True)
    outs = []
    for kw in (paged, dict(paged, pipeline_decode=False)):
        got, log = _serve_recorded(_port_engine(cfg, params, **kw),
                                   InferenceRequest, SamplingParams,
                                   PROMPTS[:1], 80)
        outs.append(got[0])
    assert len(outs[0]) == 80 and outs[0] == outs[1]
    argmax, margins = _margins(cfg, params, PROMPTS[0], outs[0])
    assert argmax == outs[0] and min(margins) > MARGIN / 2, min(margins)


def test_adaptive_warmup_meets_no_new_key():
    """run_bench on tiny-quant with adaptive windows on (T = 8, four
    lanes at buckets 1 and 4, cells c = 1, 4 and 8): 16-step and 4-step
    windows run, and no cell or repeat first meets a program key after
    its warm-up."""
    from ferrum_tpu_torch.bench import bench_engine as be
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.quantize import init_random_quant_params

    mc = preset("tiny-quant")
    engine = _port_engine(
        mc, init_random_quant_params(mc, seed=0, device="cpu"),
        decode_bucket_spec="1", prefill_chunk_size=16,
        max_num_batched_tokens=32)
    lengths = set()
    start = engine.runner.start_decode_window
    engine.runner.start_decode_window = \
        lambda seqs, t, **kw: lengths.add(t) or start(seqs, t, **kw)
    reps = []
    run_cell = be.run_cell

    def recorded(*a, **kw):
        reps.append(run_cell(*a, **kw))
        return reps[-1]

    be.run_cell = recorded
    try:
        be.run_bench(engine, concurrencies=(1, 4, 8),
                     num_requests_per_cell={1: 2, 4: 4, 8: 12},
                     input_len=24, output_len=20, n_repeats=2,
                     model_label="tiny-quant")
    finally:
        be.run_cell = run_cell
        engine.stop()
    assert {4, 16} <= lengths, lengths
    for r in reps:
        assert r["completed"] == r["requested"] and r["errors"] == 0
        assert r["compilations_during_cell"] == 0, r["compiled_in_cell"]


@pytest.mark.parametrize("layout", ["linear", "paged"])
def test_slot_slack_streams_match_jax(monkeypatch, layout):
    """slot_slack = 2 (4 lanes for 2 sequences): num_slots and the
    buckets are the JAX engine's; six requests give the JAX engine's
    greedy streams and the no-slack engine's. On the paged layout a
    replacement is admitted while an aborted predecessor's release
    waits for the window in flight (slack_admissions; a request ending
    at max_tokens is released when its last window is read, the port
    dispatching none past it)."""
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.types import SamplingParams as JSamp
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    jcfg, jparams, cfg, params = _tiny_quant(monkeypatch)
    kv = dict(kv_layout=layout, kv_num_blocks=96 if layout == "paged"
              else 0, max_num_seqs=2)
    prompts = [PROMPTS[i % 3][:5 + i] for i in range(6)]
    engines = [_port_engine(cfg, params, slot_slack=2, **kv),
               _port_engine(cfg, params, **kv)]
    slack = engines[0]
    assert slack.runner.num_slots == 4
    jeng = _jax_engine(jcfg, jparams, slot_slack=2, **kv)
    assert jeng.runner.num_slots == 4
    assert slack.cfg.decode_buckets == jeng.cfg.decode_buckets
    want, _ = _serve_recorded(jeng, JReq, JSamp, prompts, 12)
    outs = [_serve_recorded(e, InferenceRequest, SamplingParams, prompts,
                            12)[0] for e in engines]
    assert outs[0] == outs[1] == want
    assert slack.slack_admissions == engines[1].slack_admissions == 0
    if layout == "paged":
        assert _slack_witness(_port_engine(cfg, params, slot_slack=2,
                                           **kv)) >= 1


def _slack_witness(engine):
    """Two requests decoding; with the loop held at the head of an
    iteration (a window in flight), one is aborted and one submitted.
    Returns engine.slack_admissions. Stops the engine."""
    import threading

    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    def req(p):
        return InferenceRequest(prompt_token_ids=p, sampling=SamplingParams(
            max_tokens=40, ignore_eos=True))

    try:
        first = [req(p) for p in PROMPTS[:2]]
        queues = _submit_all(engine, first)
        for q in queues:
            q.get(timeout=SERVE_TIMEOUT_S)
        gate, run = threading.Event(), engine.run_iteration
        engine.run_iteration = lambda: gate.wait() and run()
        time.sleep(0.2)
        engine.abort(first[0].request_id)
        queues.append(engine.submit(req(PROMPTS[2])))
        gate.set()
        del engine.run_iteration
        for q in queues:
            _wait(q)
    finally:
        engine.stop()
    return engine.slack_admissions


@pytest.mark.parametrize("kw", [dict(enable_chunked_prefill=False),
                                dict(scheduler="fifo")],
                         ids=["unchunked", "fifo"])
def test_whole_prompt_prefill_serves(monkeypatch, tmp_path, kw):
    """A 77-token prompt beside two short ones, chunks of 32 within a
    128-token budget: unchunked (and under fifo) the prompt goes in one
    chunk, and every stream equals the chunked engine's and the model's
    teacher-forced argmax. (The JAX runner pads a chunk to at most
    prefill_chunk_size, so the JAX engine fails on the unchunked prompt
    and its fifo never admits it: ROADMAP Queue 3.) The engine writes
    its trace: one record an iteration, the long prompt's chunk of 77
    among them."""
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    _, _, cfg, params = _tiny_quant(monkeypatch)
    prompts = [list(range(3, 80)), PROMPTS[0], PROMPTS[2]]
    trace = tmp_path / "trace.jsonl"
    outs = []
    for extra in (dict(kw, scheduler_trace_path=str(trace)), {}):
        got, _ = _serve_recorded(_port_engine(cfg, params, **extra),
                                 InferenceRequest, SamplingParams, prompts,
                                 10)
        outs.append(got)
    assert outs[0] == outs[1]
    for prompt, out in zip(prompts, outs[0]):
        argmax, margins = _margins(cfg, params, prompt, out)
        assert argmax == out and min(margins) > MARGIN / 2, min(margins)
    recs = [json.loads(line) for line in trace.read_text().splitlines()]
    assert recs and [r["iteration"] for r in recs] == list(
        range(1, len(recs) + 1))
    assert any(c[2] == 77 for r in recs for c in r["prefill_chunks"])


# ---------------------------------------------------------------------------
# Fusion sites
# ---------------------------------------------------------------------------

def _unfused(jcfg_or_name, seed):
    """JAX params, two-level int4, with no fusion applied."""
    import jax
    import jax.numpy as jnp

    from ferrum_tpu.engine.builder import apply_two_level
    from ferrum_tpu.models.configs import preset
    from ferrum_tpu.models.llama_family import init_random_params
    from ferrum_tpu.models.quantize import quantize_model_params

    jcfg = preset(jcfg_or_name) if isinstance(jcfg_or_name, str) \
        else jcfg_or_name
    params = quantize_model_params(
        init_random_params(jcfg, seed=seed, dtype=jnp.float32), 128,
        dtype=jnp.float32)
    return jcfg, jax.jit(apply_two_level)(params)


@pytest.mark.parametrize("sites", ["", "qkv", "gate_up", "qkv,gate_up",
                                   "qkv,gate_up,moe", "moe"])
@pytest.mark.parametrize("model", ["tiny-quant", "moe"])
def test_fuse_sites_logits_match_jax_and_split(monkeypatch, model, sites):
    """fuse_projections at each site set (the empty set: fuse_proj=False)
    fuses what the JAX pass fuses, the fused arrays bit for bit; the
    port's prefill + 4 decode steps give the split forward's logits bit
    for bit (every fused projection is an integer-exact two-level one)
    and the JAX fused forward's within tests/test_torch_moe.py's
    bounds (every logit within 5e-2 of the scale, 95% of the token rows
    within 1e-5 of it)."""
    from ferrum_tpu.engine.builder import fuse_projections as jfuse
    from ferrum_tpu.models.configs import ModelConfig, MoeConfig
    from ferrum_tpu_torch.engine.builder import fuse_projections
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from test_torch_moe import (MAX_LEN, _model_inputs, _run_jax_model,
                                _run_torch_model)

    route_moe_w4a8tl(monkeypatch)
    jcfg = "tiny-quant" if model == "tiny-quant" else ModelConfig(
        family="qwen3_moe", vocab_size=1024, hidden_size=256, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=64, intermediate_size=512,
        rope_theta=10000.0, qk_norm=True, rms_norm_eps=1e-6,
        moe=MoeConfig(num_experts=8, num_experts_per_tok=2,
                      moe_intermediate_size=256, norm_topk_prob=True),
        eos_token_ids=(2,))
    jcfg, jsplit = _unfused(jcfg, seed=2)
    cfg = torch_config(jcfg)
    flat = flatten_jax_params(jsplit)
    split = params_from_numpy(flat, "cpu")
    fused = fuse_projections(params_from_numpy(flat, "cpu"), sites)
    jfused = jfuse(_unfused(jcfg, seed=2)[1], sites)
    want_flat = flatten_jax_params(jfused)
    got_flat = flatten_torch_params(fused)
    assert set(got_flat) == set(want_flat)
    for k in want_flat:
        assert np.array_equal(got_flat[k], want_flat[k]), k
    lp = fused.layers[0]
    assert (lp.qkv is not None) == ("qkv" in sites)
    if model == "moe":
        assert (lp.moe.gate_up is not None) == ("moe" in sites)
    else:
        assert (lp.gate_up is not None) == ("gate_up" in sites)
    inputs = _model_inputs(cfg.vocab_size)
    want, fed = _run_jax_model(jcfg, jfused, inputs)
    got = _run_torch_model(cfg, fused, inputs, fed)
    ref = _run_torch_model(cfg, split, inputs, fed)
    for g, r in zip(got, ref):
        assert np.array_equal(g, r)
    real = (inputs[1] < MAX_LEN).reshape(-1)
    want[0], got[0] = want[0][real], got[0][real]
    rows_close = []
    for w, g in zip(want, got):
        scale = np.abs(w).max()
        err = np.abs(w - g)
        assert err.max() <= 5e-2 * scale, err.max() / scale
        rows_close += list((err <= 1e-5 * scale).all(axis=-1))
    assert np.mean(rows_close) >= 0.95


def test_fuse_proj_off_in_both_builders():
    """fuse_proj=False builds the split model in both packages, whatever
    fuse_sites says; on, the builders fuse the sites of fuse_sites."""
    import jax.numpy as jnp

    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.engine.builder import EngineBuilder as JaxBuilder
    from ferrum_tpu.models.configs import preset as jpreset
    from ferrum_tpu.models.llama_family import init_random_params as jinit
    from ferrum_tpu_torch.models.convert import params_from_numpy

    jcfg = jpreset("tiny-test")
    jparams = jinit(jcfg, seed=0, dtype=jnp.float32)
    flat = flatten_jax_params(jparams)
    for on, sites in ((False, "qkv,gate_up"), (True, "qkv"),
                      (True, "gate_up")):
        kw = dict(max_num_seqs=2, max_model_len=128, kv_block_size=16,
                  kv_layout="linear", enable_prefix_cache=False,
                  fuse_proj=on, fuse_sites=sites)
        jeng = JaxBuilder(JaxConfig(model="m", dtype="f32", **kw)) \
            .with_model(jcfg, jinit(jcfg, seed=0, dtype=jnp.float32)).build()
        eng = _port_engine(torch_config(jcfg), params_from_numpy(flat, "cpu"),
                           **kw)
        try:
            for e in (jeng, eng):
                lp = e.runner.params.layers[0]
                assert (lp.qkv is not None) == (on and "qkv" in sites)
                assert (lp.gate_up is not None) == (on and "gate_up" in sites)
        finally:
            jeng.stop()
            eng.stop()


# ---------------------------------------------------------------------------
# The embedding squeeze
# ---------------------------------------------------------------------------

def _squeeze_cfg(tied, hidden=None):
    """tests/test_squeeze_embed.py's model: hidden 64 tied, 128 untied
    (a group-128 lm_head)."""
    from ferrum_tpu.models.configs import ModelConfig
    hidden = hidden or (64 if tied else 128)
    return ModelConfig(
        family="qwen3", vocab_size=512, hidden_size=hidden, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=hidden // 4,
        intermediate_size=2 * hidden, qk_norm=True,
        tie_word_embeddings=tied, rope_theta=10000.0, eos_token_ids=(257,))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_embedding_matches_jax(dtype):
    """Bit for bit: int8 rows and f32 scales, a zero row (the 1e-8 floor)
    and rows with values on .5 boundaries among them."""
    import jax.numpy as jnp

    from ferrum_tpu.models.quantize import quantize_embedding as jq
    from ferrum_tpu_torch.models import quantize as tq

    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.05, (300, 96)).astype(np.float32)
    w[3] = 0.0
    w[5] = np.arange(96) * 0.5 - 24.0
    jw = jnp.asarray(w, getattr(jnp, dtype))
    want = jq(jw)
    tw = torch.from_numpy(np.array(jw.astype(jnp.float32))).to(
        getattr(torch, dtype))
    for rows in (tq.SQUEEZE_ROWS, 7):
        tq.SQUEEZE_ROWS, keep = rows, tq.SQUEEZE_ROWS
        try:
            got = tq.quantize_embedding(tw)
        finally:
            tq.SQUEEZE_ROWS = keep
        assert got.q.dtype == torch.int8 and got.scale.shape == (300, 1)
        np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
        np.testing.assert_array_equal(got.scale.numpy(),
                                      np.asarray(want.scale))


@pytest.mark.parametrize("tied", [True, False])
def test_quantize_model_params_squeezed_matches_jax(tied):
    """quantize_model_params(squeeze_embeddings=True): every array bit
    for bit (the int8 table, the int4 lm_head with its scales), the
    lm_head quantized whole and in blocks of columns."""
    import jax.numpy as jnp

    from ferrum_tpu.models.llama_family import init_random_params as jinit
    from ferrum_tpu.models.quantize import quantize_model_params as jqm
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.models.quantize import quantize_model_params

    jcfg = _squeeze_cfg(tied)
    jparams = jinit(jcfg, seed=1, dtype=jnp.float32)
    from ferrum_tpu_torch.models import quantize as tq

    want = flatten_jax_params(jqm(jparams, 64, dtype=jnp.float32,
                                  squeeze_embeddings=True))
    for cols in (tq.QUANT_COLS, 96):     # whole, and 96 columns a block
        keep, tq.QUANT_COLS = tq.QUANT_COLS, cols
        try:
            got = flatten_torch_params(quantize_model_params(
                params_from_numpy(flatten_jax_params(jparams), "cpu"), 64,
                dtype=torch.float32, squeeze_embeddings=True))
        finally:
            tq.QUANT_COLS = keep
        assert set(got) == set(want) and "embed.q" in got
        assert ("lm_head.qweight" in got) == (not tied)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("h_dtype", ["float32", "bfloat16"])
def test_tied_int8_logits_match_jax(h_dtype):
    """h . bf16(q)^T (h's dtype) with f32 sums, times the row scale: the
    JAX tied int8 logits within 1e-5 of the logit scale (the frameworks'
    f32 sums differ in order); the same within 1e-6 whatever the rows a
    block (TIED_INT8_ROWS), and within 2e-2 of the bf16 table's logits
    (the int8 rounding)."""
    import jax.numpy as jnp

    from ferrum_tpu.models.llama_family import (
        QuantEmbedding as JQE, logits_from_hidden as jlogits)
    from ferrum_tpu_torch.models import llama_family as lf
    from ferrum_tpu_torch.models.configs import ModelConfig

    jcfg = _squeeze_cfg(True)
    rng = np.random.default_rng(3)
    table = rng.normal(0, 0.05, (512, 64)).astype(np.float32)
    h = rng.normal(0, 1, (5, 64)).astype(np.float32)
    from ferrum_tpu.models.quantize import quantize_embedding as jq
    jqe = jq(jnp.asarray(table))
    jh = jnp.asarray(h, getattr(jnp, h_dtype))
    from ferrum_tpu.models.llama_family import ModelParams as JMP
    want = np.asarray(jlogits(JMP(embed=jqe, layers=[], final_norm=None,
                                  lm_head=None), jcfg, jh))
    qe = lf.QuantEmbedding(q=torch.from_numpy(np.array(jqe.q)),
                           scale=torch.from_numpy(np.array(jqe.scale)))
    th = torch.from_numpy(np.array(jh.astype(jnp.float32))).to(
        getattr(torch, h_dtype))
    params = lf.ModelParams(embed=qe, layers=[], final_norm=None,
                            lm_head=None)
    cfg = torch_config(jcfg)
    assert isinstance(cfg, ModelConfig)
    got = lf.logits_from_hidden(params, cfg, th).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= 1e-5 * scale
    keep = lf.TIED_INT8_ROWS
    lf.TIED_INT8_ROWS = 7
    try:
        blocks = lf.logits_from_hidden(params, cfg, th).numpy()
    finally:
        lf.TIED_INT8_ROWS = keep
    assert np.abs(blocks - got).max() <= 1e-6 * scale
    dense = th.float().numpy() @ table.T
    assert np.abs(got - dense).max() <= 2e-2 * scale


@pytest.mark.parametrize("tied", [True, False])
def test_squeezed_engine_matches_jax(monkeypatch, tied):
    """squeeze_embeddings=True through both builders on f32 random
    weights (tests/test_squeeze_embed.py's models): the table int8 and
    an untied lm_head int4 in both, the arrays bit for bit; three
    greedy requests give the JAX engine's tokens, each the squeezed
    model's argmax. Both packages route the float-scale lm_head as on
    the TPU (tests/torch_parity.py route_float_scale)."""
    import jax.numpy as jnp

    from ferrum_tpu.engine.builder import EngineBuilder as JaxBuilder
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.models.llama_family import init_random_params as jinit
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.types import SamplingParams as JSamp
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.models.llama_family import QuantEmbedding
    from ferrum_tpu_torch.ops.quant import QuantLinearParams
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    from torch_parity import route_float_scale

    route_float_scale(monkeypatch, w4a8=True)
    # Untied: hidden 256, a lm_head the float-scale kernels tile.
    jcfg = _squeeze_cfg(tied, None if tied else 256)
    flat = flatten_jax_params(jinit(jcfg, seed=0, dtype=jnp.float32))
    kw = dict(max_num_seqs=2, max_model_len=128, kv_block_size=16,
              max_num_batched_tokens=64, prefill_chunk_size=32,
              kv_dtype="f32", seed=0, kv_layout="linear",
              enable_prefix_cache=False, squeeze_embeddings=True)
    jeng = JaxBuilder(JaxConfig(model="m", dtype="f32", **kw)).with_model(
        jcfg, jinit(jcfg, seed=0, dtype=jnp.float32)).build()
    cfg = torch_config(jcfg)
    eng = _port_engine(cfg, params_from_numpy(flat, "cpu"), **kw)
    p = eng.runner.params
    assert isinstance(p.embed, QuantEmbedding)
    assert isinstance(p.lm_head, QuantLinearParams) != tied
    want_flat = flatten_jax_params(jeng.runner.params)
    got_flat = flatten_torch_params(p)
    for k in ("embed.q", "embed.scale") + (() if tied else (
            "lm_head.qweight", "lm_head.scales", "lm_head.zeros")):
        np.testing.assert_array_equal(got_flat[k], want_flat[k], err_msg=k)
    prompts = [PROMPTS[0], [t % 500 for t in PROMPTS[2]],
               [77, 3, 250, 16, 9]]
    got, _ = _serve_recorded(eng, InferenceRequest, SamplingParams,
                             prompts, 8)
    want, _ = _serve_recorded(jeng, JReq, JSamp, prompts, 8)
    assert got == want
    for prompt, out in zip(prompts, got):
        argmax, margins = _margins(cfg, p, prompt, out)
        assert argmax == out and min(margins) > MARGIN / 2, min(margins)


def test_squeezed_random_draw_and_builder_squeeze_take_two_routes():
    """init_random_quant_params(squeeze_embeddings=True) draws the int8
    table (scales 0.02 / 127) and a two-level int4 lm_head, as the JAX
    draw's shapes and dtypes; the builder leaves it as drawn. The
    builder's squeeze of a bf16 model quantizes the lm_head after the
    two-level pass, so it serves float-scale (no scales2), as in the
    JAX builder."""
    import jax.numpy as jnp

    from ferrum_tpu.models.quantize import init_random_quant_params as jdraw
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.llama_family import QuantEmbedding
    from ferrum_tpu_torch.models.quantize import init_random_quant_params

    cfg = dataclasses.replace(preset("tiny-quant"), tie_word_embeddings=False)
    from ferrum_tpu.models.configs import preset as jpreset
    jcfg = dataclasses.replace(jpreset("tiny-quant"),
                               tie_word_embeddings=False)
    want = flatten_jax_params(jdraw(jcfg, seed=0, dtype=jnp.bfloat16,
                                    squeeze_embeddings=True))
    drawn = init_random_quant_params(cfg, seed=0, device="cpu",
                                     squeeze_embeddings=True)
    got = flatten_torch_params(drawn)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape \
            == want[k].shape, k
    np.testing.assert_array_equal(got["embed.scale"], want["embed.scale"])
    assert got["embed.q"].min() >= -127
    kw = dict(device="cpu", max_num_seqs=2, max_model_len=128,
              kv_layout="linear", squeeze_embeddings=True)
    eng = EngineBuilder(EngineConfig(**kw)).with_model(cfg, drawn).build()
    assert eng.runner.params.lm_head.scales2 is not None
    eng.stop()
    from ferrum_tpu_torch.models.llama_family import init_random_params
    from ferrum_tpu_torch.models.quantize import quantize_model_params
    dense = quantize_model_params(init_random_params(cfg, 0, device="cpu"))
    eng = EngineBuilder(EngineConfig(**kw)).with_model(cfg, dense).build()
    lm = eng.runner.params.lm_head
    assert isinstance(eng.runner.params.embed, QuantEmbedding)
    assert lm.scales2 is None and lm.scales.dtype == torch.bfloat16
    assert eng.runner.params.layers[0].qkv.scales2 is not None
    eng.stop()


# ---------------------------------------------------------------------------
# Dense MoE expert stacks and the gather route
# ---------------------------------------------------------------------------

def _dense_moe(dtype, fused, seed=5):
    """(jax cfg, JAX MoeLayerParams, port cfg, port MoeLayerParams) with
    dense stacks gate / up [E, H, I], down [E, I, H] (or gate_up fused)."""
    import jax.numpy as jnp

    from ferrum_tpu.models.configs import ModelConfig, MoeConfig
    from ferrum_tpu.models.llama_family import MoeLayerParams as JMoe
    from ferrum_tpu.ops.linear import DenseLinearParams as JDense
    from ferrum_tpu_torch.models.llama_family import MoeLayerParams
    from ferrum_tpu_torch.ops.linear import DenseLinearParams

    h, inter, e = 64, 48, 8
    jcfg = ModelConfig(
        family="qwen3_moe", vocab_size=64, hidden_size=h, num_layers=1,
        num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
        moe=MoeConfig(num_experts=e, num_experts_per_tok=2,
                      moe_intermediate_size=inter, norm_topk_prob=True))
    rng = np.random.default_rng(seed)
    arrs = {"router": rng.normal(0, 0.5, (h, e)),
            "gate": rng.normal(0, 0.2, (e, h, inter)),
            "up": rng.normal(0, 0.2, (e, h, inter)),
            "down": rng.normal(0, 0.2, (e, inter, h))}
    arrs = {k: np.array(jnp.asarray(v, getattr(jnp, dtype)).astype(
        jnp.float32)) for k, v in arrs.items()}
    j = {k: jnp.asarray(v, getattr(jnp, dtype)) for k, v in arrs.items()}
    t = {k: torch.from_numpy(v).to(getattr(torch, dtype))
         for k, v in arrs.items()}
    jp = JMoe(router=JDense(w=j["router"], bias=None), gate=j["gate"],
              up=j["up"], down=j["down"])
    tp = MoeLayerParams(router=DenseLinearParams(w=t["router"], bias=None),
                        gate=t["gate"], up=t["up"], down=t["down"])
    if fused:
        jp.gate_up, jp.gate, jp.up = jnp.concatenate(
            [j["gate"], j["up"]], axis=-1), None, None
        tp.gate_up, tp.gate, tp.up = torch.cat([t["gate"], t["up"]], -1), \
            None, None
    return jcfg, jp, torch_config(jcfg), tp


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [1, 6, 40])
def test_dense_moe_matches_jax_ragged_dot(t, dtype, fused):
    """Dense stacks, split or fused, through moe_mlp against the JAX
    package's sort + ragged_dot route: f32 within 1e-5 of the output
    scale; bf16 (bf16 operands, f32 sums, act and output rounded to
    bf16 on both sides) within 2 bf16 steps of the scale, the sums'
    order being the frameworks' own."""
    import jax.numpy as jnp

    from ferrum_tpu.ops.moe import moe_mlp as jmoe
    from ferrum_tpu_torch.ops.moe import moe_mlp, moe_mlp_ref

    jcfg, jp, cfg, tp = _dense_moe(dtype, fused)
    x = np.random.default_rng(t).normal(0, 1, (t, 64)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(jmoe(jx, jp, jcfg).astype(jnp.float32))
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = moe_mlp(tx, tp, cfg).float().numpy()
    scale = np.abs(want).max()
    tol = 1e-5 if dtype == "float32" else 2 ** -7
    assert np.abs(got - want).max() <= tol * scale, \
        np.abs(got - want).max() / scale
    if not fused and dtype == "float32":
        ref = moe_mlp_ref(tx, tp, cfg).numpy()
        assert np.abs(got - ref).max() <= 1e-5 * scale


def test_dense_moe_checkpoint_serves_as_jax(tmp_path):
    """A dense qwen3_moe checkpoint directory with quantization="none":
    both packages load dense expert stacks; four greedy requests give
    the JAX engine's tokens (f32)."""
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.engine.builder import EngineBuilder as JaxBuilder
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.types import SamplingParams as JSamp
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    from test_torch_loader import make_dir

    d = make_dir(tmp_path, "qwen3_moe_dense_quantize_on_load")
    kw = dict(model=d, dtype="f32", kv_dtype="f32", max_num_seqs=4,
              max_model_len=256, kv_block_size=16, kv_layout="linear",
              enable_prefix_cache=False, quantization="none")
    eng = EngineBuilder(EngineConfig(device="cpu", **kw)).build()
    assert isinstance(eng.runner.params.layers[0].moe.down, torch.Tensor)
    jeng = JaxBuilder(JaxConfig(**kw)).build()
    prompts = [PROMPTS[0], PROMPTS[1][:12], PROMPTS[2], PROMPT_4]
    prompts = [[t % 100 + 3 for t in p] for p in prompts]
    got, _ = _serve_recorded(eng, InferenceRequest, SamplingParams,
                             prompts, 6)
    want, _ = _serve_recorded(jeng, JReq, JSamp, prompts, 6)
    assert got == want


@pytest.mark.parametrize("t", [1, 3])
def test_moe_mlp_gather_decode_matches_jax(monkeypatch, t):
    """The routed experts' fused stacks gathered and run through the
    all-experts kernel's function, against the JAX form (its kernel
    routed to the jnp form, 32 rows an assignment): within 2e-3 of the
    output scale, 99% of the outputs within 1e-5 (as
    tests/test_torch_moe.py's all-experts route: an f32 ulp of silu can
    flip one bf16 rounding). None without a fused gate_up, as there."""
    import jax.numpy as jnp

    from ferrum_tpu.ops.moe import moe_mlp_gather_decode as jgather
    from ferrum_tpu_torch.ops.moe import moe_mlp_gather_decode
    from test_torch_moe import H, _moe_pair

    route_moe_w4a8tl(monkeypatch)
    jcfg, jp, cfg, tp = _moe_pair(fused=True)
    x = np.random.default_rng(t).normal(0, 1, (t, H)).astype(np.float32)
    want = np.asarray(jgather(jnp.asarray(x), jp, jcfg))
    got = moe_mlp_gather_decode(torch.from_numpy(x), tp, cfg).numpy()
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= 2e-3 * scale and np.mean(err <= 1e-5 * scale) >= 0.99
    _, _, cfg, split = _moe_pair(fused=False)
    assert moe_mlp_gather_decode(torch.from_numpy(x), split, cfg) is None
