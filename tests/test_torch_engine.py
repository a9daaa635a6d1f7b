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


def _engine_kw():
    return dict(max_num_seqs=4, max_model_len=256, kv_block_size=16,
                prefill_chunk_size=32, max_num_batched_tokens=128,
                kv_dtype="f32", decode_multi_step=4, seed=0)


def _prompts(concurrency):
    return PROMPTS + (PROMPT_4,) if concurrency == 4 else PROMPTS


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
            queues = [engine.submit(r) for r in reqs]
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
    return EngineBuilder(EngineConfig(device="cpu", **{**_engine_kw(),
                                                       **kw})) \
        .with_model(cfg, params).build()


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
        EngineConfig(device="cpu", **_engine_kw()), runner=None,
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
    the loop's fields too."""
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
                 "decode_multi_step"):
        assert getattr(mine, name) == getattr(ref, name), name


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
    sched = ContinuousBatchScheduler(EngineConfig(**kw))
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
        seq.blocks = SlotBlocks(slot, cfg.max_blocks_per_seq,
                                cfg.kv_block_size)
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
    qs = [engine.submit(InferenceRequest(
        prompt_token_ids=p, sampling=SamplingParams(max_tokens=12,
                                                    ignore_eos=True)))
          for p in _prompts(4)]
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
