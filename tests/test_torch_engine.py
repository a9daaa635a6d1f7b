"""Engine parity: ferrum_tpu_torch's engine vs ferrum_tpu's on one model.

Both engines serve the same 3 concurrent greedy requests on `tiny-quant`
(int4 g128 two-level, f32, linear KV layout) with the same weights; the
JAX engine's w4a8 dispatch is routed to its w4a8tl oracle. The token
streams must be equal. Greedy tokens are an argmax, so a near-tie could
flip on an f32 rounding difference: the test first checks, by a
teacher-forced pass of the port's model, that every generated token
leads the runner-up by a clear margin, so a near-tie fails loudly
instead of flaking.
"""

import threading

import pytest
import torch

from torch_parity import (flatten_jax_params, jax_model, route_w4a8tl,
                          torch_config)

PROMPTS = ([5, 9, 17, 3, 44, 101, 7], list(range(30, 70)),
           [900, 12, 12, 400, 8, 77, 301, 5, 66, 2, 19, 23, 1000])
MAX_TOKENS = 8
MARGIN = 1e-3   # of the logit scale: ~1000x the f32 gap between frameworks
               # (~1e-6); the smallest margin on these prompts is 1.8e-3


def _engine_kw():
    return dict(max_num_seqs=4, max_model_len=256, kv_block_size=16,
                prefill_chunk_size=32, max_num_batched_tokens=128,
                kv_dtype="f32", decode_multi_step=4, seed=0)


def _serve(engine, req_cls, samp_cls):
    """Generated tokens per prompt, read from each sequence when the
    scheduler finishes it. (The JAX engine's per-token accept streams a
    token only with non-empty text, so a first token holding back a
    partial UTF-8 byte is missing from its response's token_ids while
    completion_tokens counts it; the sequence has every token.)"""
    from concurrent.futures import ThreadPoolExecutor
    done = {}
    finish = engine.scheduler.finish

    def record(seq):
        done[seq.request.request_id] = list(seq.output_tokens)
        finish(seq)

    engine.scheduler.finish = record
    reqs = [req_cls(prompt_token_ids=list(p),
                    sampling=samp_cls(max_tokens=MAX_TOKENS,
                                      ignore_eos=True)) for p in PROMPTS]
    try:
        with ThreadPoolExecutor(len(reqs)) as ex:
            resps = list(ex.map(engine.infer, reqs))
    finally:
        engine.stop()
    assert all(r.completion_tokens == MAX_TOKENS for r in resps)
    return [done[r.request_id] for r in reqs], [r.token_ids for r in resps]


def _jax_streams(jcfg, jparams):
    from ferrum_tpu.config import EngineConfig
    from ferrum_tpu.engine.builder import EngineBuilder
    from ferrum_tpu.types import InferenceRequest, SamplingParams
    cfg = EngineConfig(
        model="parity", dtype="f32", kv_layout="linear",
        enable_prefix_cache=False,
        mixed_prefill=False, pipeline_decode=False, adaptive_windows=False,
        decode_bucket_spec="max", **_engine_kw())
    engine = EngineBuilder(cfg).with_model(jcfg, jparams).build()
    return _serve(engine, InferenceRequest, SamplingParams)[0]


def _torch_streams(cfg, params):
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    engine = EngineBuilder(EngineConfig(device="cpu", **_engine_kw())) \
        .with_model(cfg, params).build()
    return _serve(engine, InferenceRequest, SamplingParams)


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


def test_greedy_streams_match_jax_engine(monkeypatch):
    from ferrum_tpu_torch.models.convert import params_from_numpy

    route_w4a8tl(monkeypatch)
    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=3)
    cfg = torch_config(jcfg)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    got, streamed = _torch_streams(cfg, params)
    assert streamed == got          # the port streams every token
    for prompt, out in zip(PROMPTS, got):
        assert len(out) == MAX_TOKENS
        argmax, margins = _margins(cfg, params, prompt, out)
        assert argmax == out, "engine tokens differ from the model's argmax"
        assert min(margins) > MARGIN, (
            f"near-tie (margin {min(margins):.2e} of the logit scale): "
            f"pick another seed, the comparison would be a coin flip")
    want = _jax_streams(jcfg, jparams)
    assert got == want


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
