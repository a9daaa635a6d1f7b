"""Engine parity: ferrum_tpu_torch's engine vs ferrum_tpu's on one model.

Both engines serve the same greedy requests on `tiny-quant` (int4 g128
two-level, f32, linear KV layout) with the same weights; the JAX
engine's w4a8 dispatch is routed to its w4a8tl oracle. The token
streams must be equal, in the unpipelined loop (full-frame windows) and
in the JAX package's default loop as bench.py runs it: lane-bucketed
windows with a window length per bucket, mixed prefill-in-window and
the dispatch-ahead pipeline, at c = 1 and c = 4. Greedy tokens are an
argmax, so a near-tie could flip on an f32 rounding difference: the
test first checks, by a teacher-forced pass of the port's model, that
every generated token leads the runner-up by a clear margin, so a
near-tie fails loudly instead of flaking.

Also here: the engine settings against the JAX EngineConfig, the
scheduler against the JAX one on a scripted trace, lane compaction at
the runner, and port-only behaviour of the pipelined loop (one K/V
append a window, stop() draining the windows in flight, the
refill-first hold streak).
"""

import queue
import threading
import time

import numpy as np
import pytest
import torch

from torch_parity import (flatten_jax_params, jax_model, route_w4a8tl,
                          torch_config)

PROMPTS = ([5, 9, 17, 3, 44, 101, 7], list(range(30, 70)),
           [900, 12, 12, 400, 8, 77, 301, 5, 66, 2, 19, 23, 1000])
PROMPT_4 = [77, 3, 250, 16, 9, 901, 44, 12, 600, 5, 31]
MAX_TOKENS = 8
MARGIN = 1e-3   # of the logit scale: ~1000x the f32 gap between frameworks
               # (~1e-6); the smallest margin on these prompts is 1.8e-3
# Each engine run must finish its requests within this (CPU, tiny
# models: a few seconds plus the JAX package's compiles).
SERVE_TIMEOUT_S = 120.0

# The loops compared: (engine settings, concurrency). "unpipelined": one
# full-frame window at a time, waited for, every prefill standalone;
# the others: the JAX package's defaults with bench.py's kind of ladder
# (buckets 1, 2 and the 4-slot top; T = 6 at bucket 1, 4 elsewhere).
# T stays at most 6 because the JAX scheduler reserves 3 windows of
# decode_multi_step (4) tokens ahead: a longer bucket-1 window makes
# the JAX engine drop the K/V of its last positions (the port reserves
# for its longest window; test_long_bucket_windows_keep_their_kv).
UNPIPELINED = dict(pipeline_decode=False, mixed_prefill=False,
                   decode_bucket_spec="max")
PIPELINED = dict(pipeline_decode=True, mixed_prefill=True, pipeline_depth=2,
                 decode_bucket_spec="1,2", decode_t_spec="1:6")
LOOPS = {"unpipelined-c3": (UNPIPELINED, 3), "pipelined-c1": (PIPELINED, 1),
         "pipelined-c4": (PIPELINED, 4)}


# The port's engines here serve the linear layout with no prefix store,
# as the JAX engines they are held against (the defaults are the paged
# layout and the prefix cache).
LINEAR = dict(kv_layout="linear", enable_prefix_cache=False)


def _engine_kw():
    return dict(max_num_seqs=4, max_model_len=256, kv_block_size=16,
                prefill_chunk_size=32, max_num_batched_tokens=128,
                kv_dtype="f32", decode_multi_step=4, seed=0)


def _prompts(concurrency):
    return PROMPTS + (PROMPT_4,) if concurrency == 4 else PROMPTS


def _submit_all(engine, reqs):
    """Submit every request before the engine's loop starts, so that its
    first iteration admits them together: the schedule the mixed-window
    checks rely on. (Submitting while the loop runs let it admit the
    first one or two alone on a loaded host, and then hold the rest's
    chunks for refill-first together with the long prompt's last chunk,
    which then rides no window.)"""
    start = engine.ensure_loop
    engine.ensure_loop = lambda: None
    try:
        queues = [engine.submit(r) for r in reqs]
    finally:
        engine.ensure_loop = start
    start()
    return queues


def _serve(engine, req_cls, samp_cls, prompts=PROMPTS, concurrency=3):
    """Generated tokens per prompt, read from each sequence when the
    scheduler finishes it, and the streamed token ids. concurrency 1
    serves the prompts one after another, else all at once. (The JAX
    engine's per-token accept streams a token only with non-empty text,
    so a first token holding back a partial UTF-8 byte is missing from
    its stream while completion_tokens counts it; the sequence has every
    token.) Fails if the requests are not done within SERVE_TIMEOUT_S."""
    done = {}
    finish = engine.scheduler.finish

    def record(seq):
        done[seq.request.request_id] = list(seq.output_tokens)
        finish(seq)

    engine.scheduler.finish = record
    reqs = [req_cls(prompt_token_ids=list(p),
                    sampling=samp_cls(max_tokens=MAX_TOKENS,
                                      ignore_eos=True)) for p in prompts]
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    streamed = {}

    def drain(req, q):
        ids = streamed.setdefault(req.request_id, [])
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                pytest.fail(f"engine did not finish within "
                            f"{SERVE_TIMEOUT_S} s")
            try:
                chunk = q.get(timeout=min(left, 1.0))
            except queue.Empty:
                continue
            ids.extend(chunk.token_ids)
            if chunk.finished:
                assert chunk.completion_tokens == MAX_TOKENS
                return

    try:
        if concurrency == 1:
            for r in reqs:
                drain(r, engine.submit(r))
        else:
            queues = _submit_all(engine, reqs)
            for r, q in zip(reqs, queues):
                drain(r, q)
    finally:
        engine.stop()
    return [done[r.request_id] for r in reqs], \
        [streamed[r.request_id] for r in reqs]


def _jax_streams(jcfg, jparams, loop="unpipelined-c3"):
    from ferrum_tpu.config import EngineConfig
    from ferrum_tpu.engine.builder import EngineBuilder
    from ferrum_tpu.types import InferenceRequest, SamplingParams
    mode, conc = LOOPS[loop]
    cfg = EngineConfig(
        model="parity", dtype="f32", kv_layout="linear",
        enable_prefix_cache=False, adaptive_windows=False, **mode,
        **_engine_kw())
    engine = EngineBuilder(cfg).with_model(jcfg, jparams).build()
    return _serve(engine, InferenceRequest, SamplingParams, _prompts(conc),
                  conc)[0]


def _torch_engine(cfg, params, **kw):
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    return EngineBuilder(EngineConfig(device="cpu", **{
        **_engine_kw(), **LINEAR, **kw})).with_model(cfg, params).build()


def _torch_streams(cfg, params, loop="unpipelined-c3"):
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    mode, conc = LOOPS[loop]
    engine = _torch_engine(cfg, params, **mode)
    got = _serve(engine, InferenceRequest, SamplingParams, _prompts(conc),
                 conc)
    return got + (engine,)


def _margins(cfg, params, prompt, out):
    """Teacher-forced pass over prompt + outputs: (argmax ids, top-1 minus
    top-2 over the logit scale) at each generating position."""
    from ferrum_tpu_torch.models import llama_family as lf
    seq = list(prompt) + list(out)
    t = -(-len(seq) // 16) * 16
    kv = lf.PagedKvCache.create(cfg, 16, 16, dtype=torch.float32,
                                device="cpu")
    tokens = torch.zeros(1, t, dtype=torch.int64)
    tokens[0, :len(seq)] = torch.tensor(seq)
    pos = torch.arange(t)[None]
    flat = torch.where(pos < len(seq), pos, torch.full_like(pos, 1 << 30))
    h, _ = lf.prefill_forward_batched(
        params, cfg, kv, tokens, pos, torch.arange(16)[None],
        torch.tensor([len(seq)]), flat, ctx_pad=t)
    logits = lf.logits_from_hidden(params, cfg, h[0])
    gen = logits[len(prompt) - 1:len(seq) - 1]
    top2 = torch.topk(gen, 2, dim=-1).values
    return gen.argmax(-1).tolist(), \
        ((top2[:, 0] - top2[:, 1]) / logits.abs().max()).tolist()


def check_streams(cfg, params, jcfg, jparams, loop):
    """The port's streams: every token streamed, each the model's clear
    argmax; then equal to the JAX engine's. Returns the port engine."""
    got, streamed, engine = _torch_streams(cfg, params, loop)
    assert streamed == got          # the port streams every token
    for prompt, out in zip(_prompts(LOOPS[loop][1]), got):
        assert len(out) == MAX_TOKENS
        argmax, margins = _margins(cfg, params, prompt, out)
        assert argmax == out, "engine tokens differ from the model's argmax"
        assert min(margins) > MARGIN, (
            f"near-tie (margin {min(margins):.2e} of the logit scale): "
            f"pick another seed, the comparison would be a coin flip")
    assert got == _jax_streams(jcfg, jparams, loop)
    return engine


@pytest.mark.parametrize("loop", list(LOOPS))
def test_greedy_streams_match_jax_engine(monkeypatch, loop):
    from ferrum_tpu_torch.models.convert import params_from_numpy

    route_w4a8tl(monkeypatch)
    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=3)
    cfg = torch_config(jcfg)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    engine = check_streams(cfg, params, jcfg, jparams, loop)
    windows = engine.runner.windows_by_bucket
    if loop == "pipelined-c1":
        # 7 tokens after the prefill's: two 6-step windows a request, the
        # second dispatched before the first is read, and no third (the
        # two in flight reach max_tokens).
        assert windows == {1: 2 * len(PROMPTS)}
    if loop == "pipelined-c4":
        assert engine.runner.mixed_windows >= 1 and 4 in windows


def test_stop_never_sweeps_while_the_loop_runs(monkeypatch):
    """stop() aborts the waiting requests only once the loop thread has
    ended: with the loop held inside an iteration past the join's
    timeout, stop() raises and leaves every request and its queue as
    they were; once the iteration returns, the loop ends and stop()
    finishes the request with ABORT."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine import engine as eng
    from ferrum_tpu_torch.tokenizer import make_byte_tokenizer
    from ferrum_tpu_torch.types import (FinishReason, InferenceRequest,
                                        SamplingParams)
    engine = eng.ContinuousBatchEngine(
        EngineConfig(device="cpu", **LINEAR, **_engine_kw()), runner=None,
        tokenizer=make_byte_tokenizer())
    entered, release = threading.Event(), threading.Event()

    def held_iteration():
        entered.set()
        release.wait()
        return False

    engine.run_iteration = held_iteration
    q = engine.submit(InferenceRequest(prompt_token_ids=[5, 9, 17],
                                       sampling=SamplingParams(max_tokens=4)))
    assert entered.wait(30)
    monkeypatch.setattr(eng, "STOP_JOIN_S", 0.05)
    with pytest.raises(RuntimeError, match="still running"):
        engine.stop()
    assert q.empty() and len(engine._requests) == 1
    release.set()
    monkeypatch.setattr(eng, "STOP_JOIN_S", 30.0)
    engine.stop()
    chunk = q.get_nowait()
    assert chunk.finished and chunk.finish_reason == FinishReason.ABORT
    assert not engine._requests and q.empty()


# ---------------------------------------------------------------------------
# Engine settings, scheduler, runner and loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("slots", [4, 8, 32])
@pytest.mark.parametrize("buckets", ["", "max", "1,8", "1,4,16"])
def test_decode_buckets_and_window_lengths_match_jax(buckets, slots):
    """EngineConfig.decode_buckets and t_for_bucket equal the JAX
    EngineConfig's for each bucket spec and slot count, under no
    decode_t_spec and under "1:32" and "1:32,8:16"; the JAX defaults of
    the loop's and the KV cache's fields too, and the prefix store's
    resolved size."""
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu_torch.config import EngineConfig
    for t_spec in ("", "1:32", "1:32,8:16"):
        kw = dict(max_num_seqs=slots, decode_bucket_spec=buckets,
                  decode_t_spec=t_spec)
        mine, ref = EngineConfig(**kw), JaxConfig(model="m", **kw)
        assert mine.decode_buckets == ref.decode_buckets
        for b in range(1, slots + 1):
            assert mine.t_for_bucket(b) == ref.t_for_bucket(b)
    mine, ref = EngineConfig(), JaxConfig(model="m")
    for name in ("pipeline_decode", "pipeline_depth", "mixed_prefill",
                 "refill_first", "decode_bucket_spec", "decode_t_spec",
                 "decode_multi_step", "kv_layout", "kv_dtype",
                 "kv_num_blocks", "enable_prefix_cache",
                 "prefix_cache_policy", "prefix_cache_blocks"):
        assert getattr(mine, name) == getattr(ref, name), name
    for blocks in (-1, 0, 5):
        kw = dict(max_num_seqs=slots, prefix_cache_blocks=blocks)
        assert EngineConfig(**kw).resolved_prefix_cache_blocks \
            == JaxConfig(model="m", **kw).resolved_prefix_cache_blocks


def _trace_step(sched, batch, it, script):
    """Apply one iteration of the scripted trace to a scheduler: chunks
    run, every decoding sequence accepts `script["accept"]` tokens, and
    the sequences the script finishes at this iteration finish."""
    for c in batch.prefill_chunks:
        sched.note_prefill_done(c)
    for seq in batch.decode_seqs:
        seq.output_tokens.extend([1] * script["accept"])
    for seq in list(sched.running):
        if seq.request.request_id in script["finish"].get(it, ()):
            sched.finish(seq)


def _summary(batch):
    return dict(
        decode=[s.request.request_id for s in batch.decode_seqs],
        chunks=[(c.seq.request.request_id, c.start, len(c.tokens),
                 c.is_last) for c in batch.prefill_chunks],
        admitted=[s.request.request_id for s in batch.admitted],
        deferred=[s.request.request_id for s in batch.deferred_decodes],
        steps=batch.decode_steps,
        slots=sorted((s.request.request_id, s.slot)
                     for s in batch.decode_seqs),
        blocks=sorted((s.request.request_id, len(s.blocks.blocks))
                      for s in batch.decode_seqs))


@pytest.mark.parametrize("pipelined", [True, False])
def test_next_batch_matches_jax_scheduler(pipelined):
    """Both schedulers on one scripted trace of 14 iterations: 6 requests
    of 7 to 200 tokens arrive over time into 4 slots (chunks of 32, a
    96-token budget), pinned sets and in-flight step counts as the
    pipelined engine passes them, finishes that free slots for waiting
    requests. Every batch equals the JAX one: decode set, chunks,
    admissions, deferrals, the minimum-progress clamp, slots and the
    blocks reserved (the lookahead of the windows in flight)."""
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.kv.block_pool import BlockPool
    from ferrum_tpu.scheduler.continuous import (
        ContinuousBatchScheduler as JaxSched)
    from ferrum_tpu.scheduler.sequence import Sequence as JaxSeq
    from ferrum_tpu.types import InferenceRequest as JaxReq
    from ferrum_tpu.types import SamplingParams as JaxSamp
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.scheduler.continuous import (
        ContinuousBatchScheduler)
    from ferrum_tpu_torch.scheduler.sequence import Sequence
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    kw = dict(max_num_seqs=4, max_model_len=512, kv_block_size=16,
              prefill_chunk_size=32, max_num_batched_tokens=96,
              decode_multi_step=4, pipeline_decode=pipelined)
    jcfg = JaxConfig(model="m", kv_layout="linear",
                     enable_prefix_cache=False, **kw)
    jsched = JaxSched(jcfg, BlockPool(4 * 512 // 16, 16))
    # The port reserves for adaptive windows' doubled length, the JAX
    # scheduler for decode_multi_step (ROADMAP Queue 3): held at the
    # fixed length, both reserve alike.
    sched = ContinuousBatchScheduler(EngineConfig(
        **LINEAR, adaptive_windows=False, **kw))
    lens = {"r0": 7, "r1": 200, "r2": 40, "r3": 13, "r4": 90, "r5": 33}
    arrive = {0: ["r0", "r1"], 1: ["r2"], 2: ["r3", "r4"], 6: ["r5"]}
    script = {"accept": 4 if pipelined else 1,
              "finish": {4: {"r0"}, 7: {"r2", "r3"}, 10: {"r4"}}}
    for it in range(14):
        for rid in arrive.get(it, ()):
            toks = list(range(3, 3 + lens[rid]))
            jsched.submit(JaxSeq(JaxReq(prompt_token_ids=toks, request_id=rid,
                                        sampling=JaxSamp(max_tokens=64)),
                                 toks))
            sched.submit(Sequence(InferenceRequest(
                prompt_token_ids=toks, request_id=rid,
                sampling=SamplingParams(max_tokens=64)), toks))
        pinned = frozenset(s.request.request_id for s in sched.running
                           if it % 3 and s.phase.value == "decoding")
        inflight = 4 * (it % 3) if pipelined else -1
        want = jsched.next_batch(pinned=pinned, inflight_steps=inflight)
        got = sched.next_batch(pinned=pinned, inflight_steps=inflight)
        assert _summary(got) == _summary(want), it
        _trace_step(jsched, want, it, script)
        _trace_step(sched, got, it, script)


def _runner_engine(params, cfg, **kw):
    """A port engine whose loop never starts: the test drives it."""
    engine = _torch_engine(cfg, params, **kw)
    engine.ensure_loop = lambda: None
    return engine


def _start(engine, slots_prompts):
    """Admit sequences into chosen slots and prefill them (first tokens
    accepted). Greedy with a repetition penalty of 3, so the tokens
    depend on each slot's counts and do not settle into one repeated
    token. Returns the sequences."""
    from ferrum_tpu_torch.kv.block_pool import SlotBlocks
    from ferrum_tpu_torch.scheduler.continuous import PrefillChunk
    from ferrum_tpu_torch.scheduler.sequence import Phase, Sequence
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    cfg, runner = engine.cfg, engine.runner
    seqs, chunks = [], []
    for slot, prompt in slots_prompts:
        seq = Sequence(InferenceRequest(
            prompt_token_ids=prompt,
            sampling=SamplingParams(max_tokens=16, ignore_eos=True,
                                    repetition_penalty=3.0)), prompt)
        seq.slot = slot
        seq.blocks = SlotBlocks(engine.scheduler.pool, slot,
                                cfg.max_blocks_per_seq)
        seq.blocks.ensure_capacity(len(prompt) + 16)
        seq.phase = Phase.DECODING
        seq.prefilled = len(prompt)
        runner.admit_slot(seq)
        seqs.append(seq)
        chunks.append(PrefillChunk(seq, 0, prompt, True))
    res = runner.run_prefill_batch(chunks)
    for seq in seqs:
        seq.output_tokens.append(
            int(res.tokens.numpy()[res.rows[seq.request.request_id]]))
    return seqs


@pytest.mark.parametrize("slots,bucket", [([5], 1), ([6, 1], 2),
                                          ([0, 7, 3], 4)])
def test_lane_compaction_gives_the_full_frame_tokens(slots, bucket):
    """A window over 1, 2 or 3 sequences in slots spread over 8 packs them
    into lanes of bucket 1, 2 or 4 (gathers, pad lanes at the sink) and
    gives the tokens of the same window at the full frame of 8 (lane ==
    slot). Pad lanes and the slots outside the window leave the counts
    and the cache as they were; the window's own slots end with the same
    counts, and a cache within 1e-5 of the scale (tiny-quant, f32, the
    parity test's weights, whose tokens vary)."""
    from ferrum_tpu_torch.models.convert import params_from_numpy

    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=3)
    cfg = torch_config(jcfg)
    rng = np.random.default_rng(len(slots))
    engine = _runner_engine(params_from_numpy(flatten_jax_params(jparams),
                                              "cpu"),
                            cfg, max_num_seqs=8, decode_bucket_spec="1,2,4")
    runner = engine.runner
    prompts = [list(rng.integers(3, cfg.vocab_size, 20 + 5 * i))
               for i in range(len(slots))]
    seqs = _start(engine, list(zip(slots, prompts)))
    state0 = (runner.counts.clone(), runner.kv.k.clone(), runner.kv.v.clone())
    runs = {}
    for spec in ("1,2,4", "max"):
        runner.counts.copy_(state0[0])
        runner.kv.k.copy_(state0[1])
        runner.kv.v.copy_(state0[2])
        runner.cfg.decode_bucket_spec = spec
        w = runner.start_decode_window(seqs, 12)
        assert w.s_pad == (bucket if spec != "max" else 8)
        runs[spec] = (runner.sync_window(w), runner.counts.clone(),
                      runner.kv.k.clone(), runner.kv.v.clone())
    assert runs["1,2,4"][0] == runs["max"][0]
    assert any(len(set(t)) > 1 for t in runs["max"][0].values())
    mp = engine.cfg.max_blocks_per_seq
    for spec, (_, counts, k, v) in runs.items():
        for s in range(8):
            rows = slice(s * mp, (s + 1) * mp)
            if s in slots:
                assert torch.equal(counts[s], runs["max"][1][s])
                for a, b in ((k, runs["max"][2]), (v, runs["max"][3])):
                    scale = b[:, rows].abs().max()
                    assert (a[:, rows] - b[:, rows]).abs().max() \
                        <= 1e-5 * scale
            else:
                assert torch.equal(counts[s], state0[0][s]), (spec, s)
                assert torch.equal(k[:, rows], state0[1][:, rows])
                assert torch.equal(v[:, rows], state0[2][:, rows])


def test_long_bucket_windows_keep_their_kv(monkeypatch):
    """At c = 1 with 32-step windows at bucket 1 (bench.py's "1:32") and
    decode_multi_step 8, the pipelined port gives the unpipelined
    engine's tokens, each the teacher-forced argmax by a clear margin:
    its scheduler reserves the region for the longest window, so no
    window position's K/V is dropped. It runs no window past the
    request's end. (The JAX scheduler reserves 3 windows of
    decode_multi_step tokens, 24, where a window in flight and the next
    need 63; on these weights and prompt its stream leaves the
    unpipelined one at token 53.)"""
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    route_w4a8tl(monkeypatch)
    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=3)
    cfg = torch_config(jcfg)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    req = lambda: InferenceRequest(  # noqa: E731
        prompt_token_ids=PROMPTS[0],
        sampling=SamplingParams(max_tokens=80, ignore_eos=True))
    out, windows = [], []
    for kw in (dict(decode_multi_step=8, decode_t_spec="1:32",
                    decode_bucket_spec="1,2"), UNPIPELINED):
        engine = _torch_engine(cfg, params, **kw)
        out.append(engine.infer(req()).token_ids)
        windows.append(engine.runner.windows_by_bucket)
        engine.stop()
    assert len(out[0]) == 80 and out[0] == out[1]
    # The 80 positions' smallest lead is 5.3e-4 of the logit scale,
    # still ~500x the f32 differences between the loops' attention forms.
    argmax, margins = _margins(cfg, params, PROMPTS[0], out[0])
    assert argmax == out[0] and min(margins) > MARGIN / 2, min(margins)
    # 79 tokens after the prefill's: three 32-step windows; no fourth is
    # dispatched once the windows in flight reach max_tokens.
    assert windows[0] == {1: 3}


def test_one_kv_append_a_window(monkeypatch):
    """Each decode window lands its K/V (mixed prefill rows too) with one
    `append_rows_pairs` call, i.e. one kv_append_rows launch on the card;
    the batched prefills use append_pages. Four requests on tiny-quant
    through the pipelined loop."""
    from ferrum_tpu_torch.models import llama_family as lf
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.quantize import init_random_quant_params
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    calls = []
    orig = lf.append_rows_pairs
    monkeypatch.setattr(lf, "append_rows_pairs",
                        lambda *a: calls.append(1) or orig(*a))
    cfg = preset("tiny-quant")
    engine = _torch_engine(cfg, init_random_quant_params(cfg, 0,
                                                         device="cpu"),
                           **PIPELINED)
    qs = _submit_all(engine, [InferenceRequest(
        prompt_token_ids=p, sampling=SamplingParams(max_tokens=12,
                                                    ignore_eos=True))
        for p in _prompts(4)])
    for q in qs:
        while not q.get(timeout=SERVE_TIMEOUT_S).finished:
            pass
    engine.stop()
    windows = sum(engine.runner.windows_by_bucket.values())
    assert windows >= 3 and len(calls) == windows
    assert engine.runner.mixed_windows >= 1


def test_stop_drains_the_windows_in_flight():
    """stop() on an engine whose windows are still in flight fetches them
    and streams their tokens before it finishes the requests with
    ABORT; nothing stays in flight."""
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.quantize import init_random_quant_params
    from ferrum_tpu_torch.types import (FinishReason, InferenceRequest,
                                        SamplingParams)

    cfg = preset("tiny-quant")
    engine = _runner_engine(init_random_quant_params(cfg, 0, device="cpu"),
                            cfg, **PIPELINED)
    qs = [engine.submit(InferenceRequest(
        prompt_token_ids=p, sampling=SamplingParams(max_tokens=64,
                                                    ignore_eos=True)))
          for p in PROMPTS]
    for _ in range(6):
        engine.run_iteration()
    assert engine._inflight_q
    seqs = [st.seq for st in engine._requests.values()]
    accepted = [len(seq.output_tokens) for seq in seqs]
    engine.stop()
    assert not engine._inflight_q
    for q, seq, n0 in zip(qs, seqs, accepted):
        chunks = [q.get_nowait() for _ in range(q.qsize())]
        assert chunks[-1].finish_reason == FinishReason.ABORT
        assert sum((c.token_ids for c in chunks), []) == seq.output_tokens
        assert len(seq.output_tokens) > n0      # the drained window's


def test_refill_first_holds_at_most_eight_in_a_row():
    """A steady admission wave (three 200-token prompts in 16-token
    chunks) beside one decoding sequence at low occupancy: refill-first
    holds decode for 8 iterations, then decodes every iteration while
    the wave goes on (the streak resets only when the hold conditions
    end, not on the forced iteration)."""
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.quantize import init_random_quant_params
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    cfg = preset("tiny-quant")
    engine = _runner_engine(init_random_quant_params(cfg, 0, device="cpu"),
                            cfg, max_num_seqs=8, prefill_chunk_size=16,
                            max_num_batched_tokens=64, **PIPELINED)
    req = lambda p, n: InferenceRequest(  # noqa: E731
        prompt_token_ids=p, sampling=SamplingParams(max_tokens=n,
                                                    ignore_eos=True))
    engine.submit(req(PROMPTS[0], 200))
    for _ in range(3):
        engine.run_iteration()
    rng = np.random.default_rng(0)
    for _ in range(3):
        engine.submit(req(list(rng.integers(3, 1000, 200)), 4))
    held = []
    for _ in range(12):
        steps = engine.runner.decode_steps
        engine.run_iteration()
        held.append(engine.runner.decode_steps == steps)
    engine.stop()
    assert held == [True] * 8 + [False] * 4, held


# ---------------------------------------------------------------------------
# Stop strings, abort, per-request seeds, prompt scoring, submit checks
# ---------------------------------------------------------------------------

def _jax_engine(jcfg, jparams, loop, **kw):
    from ferrum_tpu.config import EngineConfig
    from ferrum_tpu.engine.builder import EngineBuilder
    mode, _ = LOOPS[loop]
    cfg = EngineConfig(
        model="parity", dtype="f32", kv_layout="linear",
        enable_prefix_cache=False, adaptive_windows=False, **mode,
        **{**_engine_kw(), **kw})
    return EngineBuilder(cfg).with_model(jcfg, jparams).build()


def _run_each(engine, reqs):
    """Serve the requests one after another. Per request: (text, the
    sequence's tokens when it finished, completion_tokens, finish
    reason, streamed ids, logprobs). Stops the engine."""
    done = {}
    finish = engine.scheduler.finish

    def record(seq):
        done.setdefault(seq.request.request_id, list(seq.output_tokens))
        finish(seq)

    engine.scheduler.finish = record
    out = []
    try:
        for r in reqs:
            q = engine.submit(r)
            deadline = time.monotonic() + SERVE_TIMEOUT_S
            chunks = []
            while not chunks or not chunks[-1].finished:
                assert time.monotonic() < deadline, "engine did not finish"
                try:
                    chunks.append(q.get(timeout=1.0))
                except queue.Empty:
                    continue
            last = chunks[-1]
            out.append(("".join(c.text for c in chunks),
                        done.get(r.request_id),
                        last.completion_tokens, last.finish_reason.value,
                        sum((c.token_ids for c in chunks), []),
                        last.logprobs))
    finally:
        engine.stop()
    return out


def _stop_cases(tok, out, t):
    """Stop strings whose first match ends at a token mid-window, at the
    last token of a window and across two windows (the previous token's
    last character and this one's first), for windows of t tokens after
    the prefill's first token. Each is the shortest tail of the text up
    to that token that the text before it does not hold."""
    texts = [tok.decode(out[:k]) for k in range(len(out) + 1)]

    def ending_at(k, span):
        prev, cur = texts[k - 1], texts[k]
        if not cur.startswith(prev) or len(cur) == len(prev) \
                or "�" in cur:
            return None
        end = len(prev) + 1
        for j in range(end - 1 - span, -1, -1):
            if cur[j:end] not in prev:
                return cur[j:end]
        return None

    cases = []
    for targets, span in (((3, 2, 4), 0), ((1 + t, t, 2 + t), 0),
                          ((2 + t, 3 + t, 1 + t), 1)):
        for k in targets:
            if k <= len(out):
                stop = ending_at(k, span)
                if stop:
                    cases.append(stop)
                    break
    return cases


@pytest.mark.parametrize("loop", ["unpipelined-c3", "pipelined-c1"])
def test_stop_strings_match_jax_engine(monkeypatch, loop):
    """Text, tokens, completion_tokens and finish reason equal the JAX
    engine's, for a stop that lands mid-window, at a window's end and
    across two windows; the port streams every token it accepts."""
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.types import SamplingParams as JSp
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    route_w4a8tl(monkeypatch)
    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=3)
    cfg = torch_config(jcfg)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    t = 4 if loop.startswith("unpipelined") else 6
    plain = _run_each(_torch_engine(cfg, params, **LOOPS[loop][0]), [
        InferenceRequest(prompt_token_ids=list(p), sampling=SamplingParams(
            max_tokens=MAX_TOKENS, ignore_eos=True)) for p in PROMPTS])
    from ferrum_tpu_torch.tokenizer import make_byte_tokenizer
    tok = make_byte_tokenizer(vocab_extra=cfg.vocab_size - 258)
    specs = []
    for p, res in zip(PROMPTS, plain):
        for stop in _stop_cases(tok, res[1], t):
            specs.append((p, stop))
    assert len(specs) >= 6, specs
    # Each stop ends by token MAX_TOKENS (the tokens whose margins the
    # greedy parity test checks); the budget past it only keeps a stop
    # at that token from finishing by length first.
    budget = MAX_TOKENS + 4
    got = _run_each(_torch_engine(cfg, params, **LOOPS[loop][0]), [
        InferenceRequest(prompt_token_ids=list(p), sampling=SamplingParams(
            max_tokens=budget, ignore_eos=True, stop=[s]))
        for p, s in specs])
    want = _run_each(_jax_engine(jcfg, jparams, loop), [
        JReq(prompt_token_ids=list(p), sampling=JSp(
            max_tokens=budget, ignore_eos=True, stop=[s]))
        for p, s in specs])
    for (p, s), g, w in zip(specs, got, want):
        assert g[:4] == w[:4], (s, g, w)
        assert g[4] == g[1]             # every accepted token streamed
        assert g[3] == "stop" and g[2] <= MAX_TOKENS, (s, g)


@pytest.mark.parametrize("layout", ["linear", "paged"])
def test_abort_frees_the_slot_and_blocks(layout):
    """abort(): the final chunk says ABORT (as the JAX engine's), the
    request leaves the running set, its slot frees, and on the paged
    layout its blocks return to the pool once the window in flight is
    read."""
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.quantize import init_random_quant_params
    from ferrum_tpu_torch.types import (FinishReason, InferenceRequest,
                                        SamplingParams)

    cfg = preset("tiny-quant")
    kw = dict(PIPELINED)
    if layout == "paged":
        kw.update(kv_layout="paged", kv_num_blocks=48)
    engine = _runner_engine(init_random_quant_params(cfg, 0, device="cpu"),
                            cfg, **kw)
    free0 = engine.pool.num_free
    slots0 = sorted(engine.scheduler._free_slots)
    try:
        q = engine.submit(InferenceRequest(
            prompt_token_ids=PROMPTS[1], sampling=SamplingParams(
                max_tokens=200, ignore_eos=True)))
        other = engine.submit(InferenceRequest(
            prompt_token_ids=PROMPTS[0], sampling=SamplingParams(
                max_tokens=200, ignore_eos=True)))
        rid = next(iter(engine._requests))
        for _ in range(4):
            engine.run_iteration()
        assert engine._inflight_q
        engine.abort(rid)
        engine.abort("no-such-request")
        engine.run_iteration()
        chunks = [q.get_nowait() for _ in range(q.qsize())]
        assert chunks[-1].finished
        assert chunks[-1].finish_reason == FinishReason.ABORT
        assert chunks[-1].prompt_tokens == len(PROMPTS[1])
        assert rid not in engine._requests
        engine.abort(rid)                 # finished: a no-op
        for _ in range(4):
            engine.run_iteration()
        assert engine.metrics_snapshot().running_requests == 1
        assert len(engine.scheduler._free_slots) == len(slots0) - 1
        for _ in range(3):
            assert not other.get_nowait().finished
        engine.abort(next(iter(engine._requests)))
        for _ in range(3):
            engine.run_iteration()
        assert engine.metrics_snapshot().running_requests == 0
        assert sorted(engine.scheduler._free_slots) == slots0
        assert engine.pool.num_free == free0
        assert not engine._inflight_q and not engine._requests
    finally:
        engine.stop()


def test_abort_matches_jax_engine_final_chunk(monkeypatch):
    """Both engines end an aborted request with one ABORT chunk carrying
    the prompt's length, and serve the next request."""
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.types import SamplingParams as JSp
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    route_w4a8tl(monkeypatch)
    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=3)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    finals = []
    for engine, req, sp in (
            (_torch_engine(torch_config(jcfg), params, **PIPELINED),
             InferenceRequest, SamplingParams),
            (_jax_engine(jcfg, jparams, "pipelined-c1"), JReq, JSp)):
        try:
            r = req(prompt_token_ids=PROMPTS[1],
                    sampling=sp(max_tokens=200, ignore_eos=True))
            q = engine.submit(r)
            first = q.get(timeout=SERVE_TIMEOUT_S)
            engine.abort(r.request_id)
            last = first
            while not last.finished:
                last = q.get(timeout=SERVE_TIMEOUT_S)
            finals.append((last.finish_reason.value, last.prompt_tokens))
            nxt = engine.infer(req(prompt_token_ids=PROMPTS[0],
                                   sampling=sp(max_tokens=3,
                                               ignore_eos=True)))
            assert nxt.completion_tokens == 3
            assert engine.metrics_snapshot().running_requests == 0
        finally:
            engine.stop()
    assert finals[0] == finals[1] == ("abort", len(PROMPTS[1]))


def test_seeded_request_same_alone_batched_and_in_another_slot():
    """A seeded sampled request gives the same tokens alone (slot 0), in
    a batch of 4 beside unseeded requests (slot 3), second of two in
    the unpipelined loop (slot 1), and on the paged layout alone and
    third of three (slot 2); another seed gives other tokens."""
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.quantize import init_random_quant_params
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    cfg = preset("tiny-quant")
    params = init_random_quant_params(cfg, 0, device="cpu")

    def sampled(prompt, seed):
        return InferenceRequest(
            prompt_token_ids=list(prompt), sampling=SamplingParams(
                max_tokens=10, temperature=1.0, top_k=50, seed=seed,
                ignore_eos=True))

    def run(kw, others, seed=1234):
        engine = _torch_engine(cfg, params, **kw)
        reqs = [sampled(p, None) for p in others] + [sampled(PROMPT_4, seed)]
        slots = {}
        admit = engine.runner.admit_slot

        def record(seq):
            slots[seq.request.request_id] = seq.slot
            admit(seq)

        engine.runner.admit_slot = record
        try:
            queues = _submit_all(engine, reqs)
            toks = []
            for q in queues:
                ids = []
                while True:
                    c = q.get(timeout=SERVE_TIMEOUT_S)
                    ids += c.token_ids
                    if c.finished:
                        break
                toks.append(ids)
        finally:
            engine.stop()
        return toks[-1], slots[reqs[-1].request_id]

    alone, s0 = run(PIPELINED, [])
    batch, s3 = run(PIPELINED, PROMPTS)
    second, s1 = run(UNPIPELINED, PROMPTS[:1])
    paged_kw = {**PIPELINED, "kv_layout": "paged", "kv_num_blocks": 64}
    paged_alone, _ = run(paged_kw, [])
    paged, s2 = run(paged_kw, PROMPTS[1:])
    other, _ = run(PIPELINED, [], seed=99)
    assert (s0, s3, s1, s2) == (0, 3, 1, 2)
    assert len(alone) == 10 and alone == batch == second
    # The paged layout's attention sums in another order: its logits may
    # differ from the linear layout's in the last bits, so it is held to
    # itself alone.
    assert paged == paged_alone
    assert other != alone


def test_unseeded_noise_is_the_generator_draw():
    """With no seeded row, lane_noise is the shared generator's draw,
    the one sample_step takes itself; seeded rows depend on (seed,
    position) only."""
    from ferrum_tpu_torch.sampling.device import (TOPK_CAP, gumbel_noise,
                                                  lane_noise, seeded_gumbel)

    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    slots = torch.tensor([2, 0, 1])
    seeds = torch.tensor([7, 8, 9, 0])
    seeded = torch.zeros(4, dtype=torch.bool)
    pos = torch.tensor([10, 11, 12])
    got = lane_noise(slots, pos, seeds, seeded, 1024, g1)
    assert torch.equal(got, gumbel_noise((3, TOPK_CAP), g2, "cpu"))
    seeded[1] = True
    mixed = lane_noise(slots, pos, seeds, seeded, 1024, g1)
    own = seeded_gumbel(torch.tensor([8]), torch.tensor([12]), TOPK_CAP)
    assert torch.equal(mixed[2], own[0])          # row 2 holds slot 1
    assert torch.isfinite(own).all()
    assert not torch.equal(own, seeded_gumbel(torch.tensor([8]),
                                              torch.tensor([13]), TOPK_CAP))
    big = seeded_gumbel(torch.tensor([-(1 << 63), (1 << 63) - 1]),
                        torch.tensor([0, 4095]), TOPK_CAP)
    assert torch.isfinite(big).all()


@pytest.mark.parametrize("loop", ["unpipelined-c3", "pipelined-c1"])
def test_prompt_scoring_matches_jax_score_mode(monkeypatch, loop):
    """echo + logprobs with max_tokens=0: per-position logprobs within
    5e-3 of the JAX engine's score mode and the same argmax ids, for a
    one-chunk prompt and a 40-token prompt scored over two 32-token
    chunks; no token is generated."""
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.types import SamplingParams as JSp
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    route_w4a8tl(monkeypatch)
    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=3)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    prompts = [PROMPTS[0], PROMPTS[1], PROMPT_4]
    got = _run_each(
        _torch_engine(torch_config(jcfg), params, **LOOPS[loop][0]),
        [InferenceRequest(prompt_token_ids=list(p), echo=True,
                          sampling=SamplingParams(max_tokens=0, logprobs=1))
         for p in prompts])
    want = _run_each(_jax_engine(jcfg, jparams, loop), [
        JReq(prompt_token_ids=list(p), echo=True,
             sampling=JSp(max_tokens=0, logprobs=1)) for p in prompts])
    for p, g, w in zip(prompts, got, want):
        assert g[2] == w[2] == 0 and g[3] == w[3] == "length"
        glp, wlp = g[5], w[5]
        assert len(glp) == len(wlp) == len(p)
        assert glp[0]["logprob"] is None and wlp[0]["logprob"] is None
        for a, b in zip(glp, wlp):
            assert a["token_id"] == b["token_id"]
            assert a["argmax_id"] == b["argmax_id"]
            if b["logprob"] is None:
                assert a["logprob"] is None
                continue
            assert a["logprob"] == pytest.approx(b["logprob"], abs=5e-3)
            assert a["argmax_logprob"] == pytest.approx(
                b["argmax_logprob"], abs=5e-3)


def test_submit_validation_matches_jax(monkeypatch):
    """The same error type and param as the JAX engine's submit, and the
    same max_tokens clamp."""
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.types import InvalidRequestError as JErr
    from ferrum_tpu.types import SamplingParams as JSp
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.types import (InferenceRequest,
                                        InvalidRequestError, SamplingParams)

    route_w4a8tl(monkeypatch)
    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=3)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    cases = [
        dict(prompt_token_ids=[]),
        dict(prompt_token_ids=list(range(3, 259))),
        dict(prompt_token_ids=[5, 6], sp=dict(max_tokens=0)),
        dict(prompt_token_ids=[5, 6], echo=True,
             sp=dict(max_tokens=3, logprobs=1)),
        dict(prompt_token_ids=[5, 6], sp=dict(max_tokens=-1)),
        dict(prompt_token_ids=[5, 6], sp=dict(temperature=-0.5)),
        dict(prompt_token_ids=[5, 6], sp=dict(top_p=0.0)),
        dict(prompt_token_ids=list(range(3, 253)), sp=dict(max_tokens=100)),
        dict(prompt_token_ids=list(range(3, 256)), sp=dict(max_tokens=9)),
    ]
    results = []
    for engine, req_cls, sp_cls, err in (
            (_runner_engine(params, torch_config(jcfg)), InferenceRequest,
             SamplingParams, InvalidRequestError),
            (_jax_engine(jcfg, jparams, "unpipelined-c3"), JReq, JSp, JErr)):
        engine.ensure_loop = lambda: None
        row = []
        try:
            for c in cases:
                c = dict(c)
                r = req_cls(sampling=sp_cls(**c.pop("sp", {})), **c)
                try:
                    engine.submit(r)
                    row.append(("ok", r.sampling.max_tokens))
                except err as e:
                    row.append(("error", e.param))
        finally:
            engine.stop()
        results.append(row)
    assert results[0] == results[1]
    assert ("ok", 6) in results[0] and ("error", "echo") in results[0]
