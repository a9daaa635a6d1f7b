"""Speculative decoding in the port (CPU) against the JAX package.

The same inputs, made with numpy from a seed, go through both packages:
`processed_probs` (and the port's `sample_step` drawing only from its
support), the verify pass's row appends (`prefill_forward_batched(
append="rows")` at a start off the page grid, bf16 / int8 KV, linear /
paged, a windowed layer), the single-sequence `prefill_forward`,
`verify_speculation`, the port's on-device accept/reject against the
target law, and whole engines: greedy spec streams equal to the port's
plain engine's and to the JAX spec engine's, with the JAX engine's
acceptance counts, on the tiny f32 model of tests/test_spec_engine.py
and on `tiny-quant` (two-level int4 through the plain versions), plus
EOS, max_tokens, stop strings, guided requests, int8 KV, the paged
layout under preemption, seeded sampling, the reservation for any K,
the draft sources and the CLI.

The JAX engines run the paged layout: on the linear one the JAX spec
engine reads `seq.slot` after the sequence's slot was released and
fails (ROADMAP Queue 3); the port keeps each round's lanes.
"""

import dataclasses
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from torch_parity import (flatten_jax_params, jax_model, route_w4a8tl,
                          torch_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_TIMEOUT_S = 120.0


# ---------------------------------------------------------------------------
# processed_probs
# ---------------------------------------------------------------------------

S, VOCAB = 6, 300          # past TOPK_CAP: the cap truncates pure top-p
EOS = (2, 7)


def _sampling_inputs(seed=0):
    rng = np.random.default_rng(seed)
    logits = (rng.normal(size=(S, VOCAB)) * 3.0).astype(np.float32)
    counts = ((rng.random((S, VOCAB)) < 0.05)
              * rng.integers(1, 3, (S, VOCAB))).astype(np.int32)
    counts[:, EOS[0]] = 1
    params = dict(
        temperature=np.array([0.0, 0.7, 1.0, 1.3, 0.9, 0.5], np.float32),
        top_k=np.array([0, 0, 5, 40, 0, 3], np.int32),
        top_p=np.array([1.0, 0.9, 1.0, 0.8, 0.5, 1.0], np.float32),
        repetition_penalty=np.array([1.0, 1.3, 1.0, 1.1, 1.0, 2.0],
                                    np.float32),
        min_tokens_active=np.array([False, True, False, True, False,
                                    False]))
    mask = rng.random((S, VOCAB)) < 0.7
    mask[:, 11] = True
    return logits, counts, params, mask


def _torch_params(params):
    from ferrum_tpu_torch.sampling.device import SlotSamplingParams
    return SlotSamplingParams(**{k: torch.from_numpy(v)
                                 for k, v in params.items()})


@pytest.mark.parametrize("guided", [False, True])
def test_processed_probs_matches_jax(guided):
    import jax.numpy as jnp

    from ferrum_tpu.sampling.device import SlotSamplingParams as JSP
    from ferrum_tpu.sampling.device import processed_probs as jax_pp
    from ferrum_tpu_torch.sampling.device import processed_probs

    logits, counts, params, mask = _sampling_inputs()
    want = np.asarray(jax_pp(
        jnp.asarray(logits), JSP(**{k: jnp.asarray(v)
                                    for k, v in params.items()}),
        jnp.asarray(counts), EOS,
        allowed_mask=jnp.asarray(mask) if guided else None))
    got = processed_probs(torch.from_numpy(logits), _torch_params(params),
                          torch.from_numpy(counts), EOS,
                          allowed_mask=torch.from_numpy(mask) if guided
                          else None).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    assert (got[0] == np.eye(VOCAB)[got[0].argmax()]).all()    # greedy
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)


def test_sample_step_draws_from_processed_probs():
    """Every token the port's sample_step draws has nonzero probability
    under processed_probs, and over 3000 draws a row's frequencies are
    within 0.05 total variation of it."""
    from ferrum_tpu_torch.sampling.device import processed_probs, sample_step

    logits, counts, params, mask = _sampling_inputs(1)
    n = 3000
    rep = {k: np.repeat(v, n, axis=0) for k, v in params.items()}
    lg, ct, mk = (torch.from_numpy(np.repeat(a, n, axis=0))
                  for a in (logits, counts, mask))
    gen = torch.Generator().manual_seed(0)
    toks = sample_step(lg, _torch_params(rep), ct, EOS, generator=gen,
                       allowed_mask=mk).view(S, n).numpy()
    probs = processed_probs(torch.from_numpy(logits), _torch_params(params),
                            torch.from_numpy(counts), EOS,
                            allowed_mask=torch.from_numpy(mask)).numpy()
    for row in range(S):
        assert (probs[row, toks[row]] > 0).all(), row
        freq = np.bincount(toks[row], minlength=VOCAB) / n
        assert 0.5 * np.abs(freq - probs[row]).sum() < 0.05, row


# ---------------------------------------------------------------------------
# The verify pass's row appends; the single-sequence prefill
# ---------------------------------------------------------------------------

PAGE, MAX_PAGES, B, T = 8, 8, 2, 5
STARTS = (13, 21)             # off the page grid
REAL = (5, 3)                 # row 1 carries 2 pad rows
CTX = 32


def _tiny(window):
    """(jax cfg, jax params, port cfg, port params): tiny-test, f32; with
    a window, layer 0 attends through a sliding window of 6 (layer 1
    global)."""
    from ferrum_tpu.models.configs import preset
    from ferrum_tpu_torch.models.convert import params_from_numpy

    jcfg = preset("tiny-test")
    if window:
        jcfg = dataclasses.replace(jcfg, sliding_window=window,
                                   sliding_window_pattern=2)
    jcfg, jparams = jax_model(jcfg, quantized=False, seed=1)
    return jcfg, jparams, torch_config(jcfg), params_from_numpy(
        flatten_jax_params(jparams), "cpu")


def _cache_arrays(cfg, kv_dtype, nb, seed):
    """A random initial cache as numpy: values (bf16-representable f32,
    or int8) and, for int8, f32 scales."""
    rng = np.random.default_rng(seed)
    shape = (cfg.num_layers, nb, PAGE, cfg.kv_size)
    if kv_dtype == "int8":
        vals = [rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2)]
        sc = [(rng.random(shape[:3] + (cfg.num_kv_heads,)) * 0.02 + 1e-3)
              .astype(np.float32) for _ in range(2)]
        return vals, sc
    vals = [torch.from_numpy(rng.normal(size=shape).astype(np.float32))
            .to(torch.bfloat16).float().numpy() for _ in range(2)]
    return vals, None


def _rows_inputs(layout, seed=0):
    rng = np.random.default_rng(seed)
    nb = B * MAX_PAGES
    tables = np.arange(nb).reshape(B, MAX_PAGES) if layout == "linear" \
        else rng.permutation(nb).reshape(B, MAX_PAGES)
    tokens = np.zeros((B, T), np.int32)
    positions = np.full((B, T), 4096, np.int32)
    flat = np.full((B, T), 1 << 30, np.int32)
    for b, (st, n) in enumerate(zip(STARTS, REAL)):
        tokens[b, :n] = rng.integers(3, 512, n)
        p = st + np.arange(n)
        positions[b, :n] = p
        flat[b, :n] = tables[b, p // PAGE] * PAGE + p % PAGE
    totals = np.array([st + n for st, n in zip(STARTS, REAL)], np.int32)
    return (tokens, positions, tables.astype(np.int32), totals, flat), nb


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("layout", ["linear", "paged"])
@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_prefill_rows_append_matches_jax(kv_dtype, layout, window):
    import jax.numpy as jnp

    from ferrum_tpu.models.llama_family import PagedKvCache as JKv
    from ferrum_tpu.models.llama_family import (
        prefill_forward_batched as jax_prefill)
    from ferrum_tpu_torch.models.llama_family import (PagedKvCache,
                                                      prefill_forward_batched)

    jcfg, jparams, cfg, params = _tiny(window)
    inputs, nb = _rows_inputs(layout)
    vals, sc = _cache_arrays(cfg, kv_dtype, nb, seed=2)
    impl = "linear" if layout == "linear" else "ref"
    jdt = jnp.int8 if kv_dtype == "int8" else jnp.bfloat16
    jkv = JKv(k=jnp.asarray(vals[0], jdt), v=jnp.asarray(vals[1], jdt),
              page=PAGE, kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
              k_scale=None if sc is None else jnp.asarray(sc[0]),
              v_scale=None if sc is None else jnp.asarray(sc[1]))
    jh, jkv = jax_prefill(jparams, jcfg, jkv, *map(jnp.asarray, inputs),
                          ctx_pad=CTX, attn_impl=impl, append="rows")
    tdt = torch.int8 if kv_dtype == "int8" else torch.bfloat16
    kv = PagedKvCache(k=torch.from_numpy(vals[0].copy()).to(tdt),
                      v=torch.from_numpy(vals[1].copy()).to(tdt), page=PAGE,
                      kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                      k_scale=None if sc is None
                      else torch.from_numpy(sc[0].copy()),
                      v_scale=None if sc is None
                      else torch.from_numpy(sc[1].copy()))
    ti = [torch.from_numpy(a).to(torch.int64) for a in inputs]
    h, kv = prefill_forward_batched(params, cfg, kv, *ti, ctx_pad=CTX,
                                    attn_impl=impl, append="rows")

    real = np.arange(T)[None, :] < np.asarray(REAL)[:, None]
    jh = np.asarray(jh)
    scale = np.abs(jh[real]).max()
    np.testing.assert_allclose(h.numpy()[real], jh[real],
                               atol=1e-5 * scale, rtol=0)
    # The written rows, by flat slot; every other row as it was.
    flat = inputs[4][real]
    written = np.zeros(nb * PAGE, bool)
    written[flat] = True
    written = written.reshape(nb, PAGE)
    arrays = [("k", vals[0]), ("v", vals[1])]
    if sc is not None:
        arrays += [("k_scale", sc[0]), ("v_scale", sc[1])]
    for name, before in arrays:
        mine = getattr(kv, name).float().numpy()
        ref = np.asarray(getattr(jkv, name)).astype(np.float32)
        np.testing.assert_array_equal(mine[:, ~written], before[:, ~written]
                                      .astype(np.float32))
        np.testing.assert_array_equal(ref[:, ~written], before[:, ~written]
                                      .astype(np.float32))
        assert not np.array_equal(mine[:, written],
                                  before[:, written].astype(np.float32))
        if kv_dtype == "int8" and name in ("k", "v"):
            # One int8 step where an f32 ulp moved x / s across a .5.
            assert np.abs(mine[:, written] - ref[:, written]).max() <= 1
        else:
            np.testing.assert_allclose(
                mine[:, written], ref[:, written], rtol=2 ** -7,
                atol=1e-6 * np.abs(ref[:, written]).max())


@pytest.mark.parametrize("layout", ["linear", "paged"])
def test_prefill_forward_matches_jax(layout):
    """One sequence's page-aligned chunk (start 16, 16 tokens, 3 pads)
    over a random f32 cache: hidden states and the appended pages."""
    import jax.numpy as jnp

    from ferrum_tpu.models.llama_family import PagedKvCache as JKv
    from ferrum_tpu.models.llama_family import prefill_forward as jax_pf
    from ferrum_tpu_torch.models.llama_family import (PagedKvCache,
                                                      prefill_forward)

    jcfg, jparams, cfg, params = _tiny(None)
    rng = np.random.default_rng(4)
    nb = MAX_PAGES
    table = (np.arange(nb) if layout == "linear"
             else rng.permutation(nb)).astype(np.int32)
    start, t, n = 16, 16, 13
    tokens = np.zeros(t, np.int32)
    tokens[:n] = rng.integers(3, 512, n)
    pos = np.full(t, 4096, np.int32)
    pos[:n] = start + np.arange(n)
    flat = np.full(t, 1 << 30, np.int32)
    flat[:n] = table[pos[:n] // PAGE] * PAGE + pos[:n] % PAGE
    vals = [rng.normal(size=(cfg.num_layers, nb, PAGE, cfg.kv_size))
            .astype(np.float32) for _ in range(2)]
    impl = "linear" if layout == "linear" else "ref"
    args = (tokens, pos, table, np.int32(start + n), flat)
    jh, jkv = jax_pf(jparams, jcfg, JKv(
        k=jnp.asarray(vals[0]), v=jnp.asarray(vals[1]), page=PAGE,
        kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim),
        *map(jnp.asarray, args), ctx_pad=CTX, attn_impl=impl)
    kv = PagedKvCache(k=torch.from_numpy(vals[0].copy()),
                      v=torch.from_numpy(vals[1].copy()), page=PAGE,
                      kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim)
    h, kv = prefill_forward(params, cfg, kv,
                            *(torch.from_numpy(np.asarray(a)).to(torch.int64)
                              for a in args), ctx_pad=CTX, attn_impl=impl)
    jh = np.asarray(jh)
    scale = np.abs(jh[:n]).max()
    np.testing.assert_allclose(h.numpy()[:n], jh[:n], atol=1e-5 * scale,
                               rtol=0)
    for name in ("k", "v"):
        ref = np.asarray(getattr(jkv, name))
        np.testing.assert_allclose(getattr(kv, name).numpy(), ref,
                                   atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_prefill_forward_refuses_int8_kv():
    from ferrum_tpu_torch.models.llama_family import (PagedKvCache,
                                                      prefill_forward)
    _, _, cfg, params = _tiny(None)
    kv = PagedKvCache.create(cfg, 4, PAGE, dtype=torch.int8, device="cpu")
    z = torch.zeros(PAGE, dtype=torch.int64)
    with pytest.raises(NotImplementedError, match="int8"):
        prefill_forward(params, cfg, kv, z, z, torch.arange(4),
                        torch.tensor(PAGE), z, ctx_pad=16)


# ---------------------------------------------------------------------------
# Accept / reject
# ---------------------------------------------------------------------------

def _softmax(x):
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


@pytest.mark.parametrize("greedy", [False, True])
def test_verify_speculation_matches_jax(greedy):
    from ferrum_tpu.engine.speculative import verify_speculation as jax_vs
    from ferrum_tpu_torch.engine.speculative import verify_speculation

    data = np.random.default_rng(5)
    for trial in range(200):
        k, v = int(data.integers(1, 6)), int(data.integers(2, 12))
        target = _softmax(data.normal(size=(k + 1, v)) * 1.5)
        draft = _softmax(data.normal(size=(k, v)) * 1.5)
        toks = np.array([data.choice(v, p=draft[i]) for i in range(k)])
        if trial % 3 == 0:
            toks = target[:k].argmax(-1)
        got = verify_speculation(toks, draft, target,
                                 np.random.default_rng(trial), greedy)
        want = jax_vs(toks, draft, target, np.random.default_rng(trial),
                      greedy)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), trial


class _Runner:
    """What SpecDecoder._accept_sampled reads of its runner."""

    def __init__(self, v, seed=0):
        self.generator = torch.Generator().manual_seed(seed)
        self.eos_mask = torch.zeros(v, dtype=torch.bool)


@pytest.mark.parametrize("seeded", [False, True])
def test_device_accept_reject_keeps_the_target_law(seeded):
    """The round's accept/reject driven by fixed p (temperature 1, no
    truncation) and q over 24000 lanes, K = 2: the first emitted token
    follows p[0] (each frequency within 0.015, as
    tests/test_speculative.py holds the host scheme), the second
    follows p[1] where the first was accepted, and the emitted pairs
    are not q's (the draft's law is corrected)."""
    from ferrum_tpu_torch.engine.spec_decode import SpecDecoder
    from ferrum_tpu_torch.sampling.device import SlotSamplingParams

    rng = np.random.default_rng(6)
    v, k, n = 8, 2, 24000
    p = _softmax(rng.normal(size=(k + 1, v)) * 1.5).astype(np.float32)
    q = _softmax(rng.normal(size=(k, v)) * 1.5).astype(np.float32)
    drafts = np.stack([rng.choice(v, n, p=q[i] / q[i].sum())
                       for i in range(k)], axis=1)
    fake = type("D", (), {"runner": _Runner(v)})()
    lanes = torch.arange(n)
    sp = SlotSamplingParams(torch.ones(n), torch.zeros(n, dtype=torch.int64),
                            torch.ones(n), torch.ones(n),
                            torch.zeros(n, dtype=torch.bool))
    extra, acc = SpecDecoder._accept_sampled(
        fake, torch.from_numpy(np.log(p))[None].expand(n, k + 1, v),
        torch.from_numpy(drafts), torch.from_numpy(q)[None].expand(n, k, v),
        torch.zeros(n, v, dtype=torch.int32), sp, lanes * 7,
        lanes.to(torch.int64) * 1000003 + 17,
        torch.full((n,), seeded), seeded)
    extra, acc = extra.numpy(), acc.numpy()
    first = np.where(acc >= 1, drafts[:, 0], extra)
    freq = np.bincount(first, minlength=v) / n
    np.testing.assert_allclose(freq, p[0], atol=0.015)
    second = np.where(acc >= 2, drafts[:, 1], extra)[acc >= 1]
    freq2 = np.bincount(second, minlength=v) / len(second)
    np.testing.assert_allclose(freq2, p[1], atol=0.03)
    assert 0.5 * np.abs(freq - q[0]).sum() > 0.1


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

def _spec_model_cfg(layers):
    """tests/test_spec_engine.py's model (both packages' ModelConfig)."""
    from ferrum_tpu.models.configs import ModelConfig
    return ModelConfig(
        family="qwen3", vocab_size=512, hidden_size=64, num_layers=layers,
        num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
        qk_norm=True, tie_word_embeddings=True, rope_theta=10000.0,
        eos_token_ids=(257,))


def _spec_engine_kw(k=3):
    """tests/test_spec_engine.py's engine settings (the JAX defaults
    beside them: the paged layout, the prefix cache, T = 8, depth 2)."""
    return dict(model="test", max_num_seqs=4, kv_num_blocks=96,
                kv_block_size=8, max_model_len=256,
                max_num_batched_tokens=128, prefill_chunk_size=32,
                dtype="f32", kv_dtype="f32", seed=0, spec_num_tokens=k)


def _f32_models(draft_seed=0):
    """(jax target, jax draft, port target, port draft) as (cfg, params)
    pairs: tests/test_spec_engine.py's 2-layer target and 1-layer draft,
    f32 random weights (seed 0, the draft's `draft_seed`)."""
    import jax.numpy as jnp

    from ferrum_tpu.models.llama_family import init_random_params
    from ferrum_tpu_torch.models.convert import params_from_numpy

    out = []
    for layers, seed in ((2, 0), (1, draft_seed)):
        mc = _spec_model_cfg(layers)
        out.append((mc, init_random_params(mc, seed=seed,
                                           dtype=jnp.float32)))
    return out + [(torch_config(mc), params_from_numpy(
        flatten_jax_params(p), "cpu")) for mc, p in out]


def _quant_models(monkeypatch, draft_layers=2, draft_seed=3):
    """tiny-quant (two-level int4, seed 3) as the target, through the
    plain versions (the JAX side routed to its w4a8tl oracle); the draft
    tiny-quant at `draft_layers` layers and `draft_seed`."""
    from ferrum_tpu.models.configs import preset
    from ferrum_tpu_torch.models.convert import params_from_numpy

    route_w4a8tl(monkeypatch)
    out = [jax_model("tiny-quant", quantized=True, seed=3),
           jax_model(dataclasses.replace(preset("tiny-quant"),
                                         num_layers=draft_layers),
                     quantized=True, seed=draft_seed)]
    return out + [(torch_config(c), params_from_numpy(
        flatten_jax_params(p), "cpu")) for c, p in out]


QUANT_KW = dict(model="parity", max_num_seqs=4, kv_num_blocks=64,
                kv_block_size=16, max_model_len=256,
                max_num_batched_tokens=128, prefill_chunk_size=32,
                dtype="f32", kv_dtype="f32", decode_multi_step=4, seed=0,
                enable_prefix_cache=False, spec_num_tokens=3)
QUANT_PROMPTS = ([5, 9, 17, 3, 44, 101, 7], list(range(30, 70)),
                 [900, 12, 12, 400, 8, 77, 301, 5, 66, 2, 19, 23, 1000],
                 [77, 3, 250, 16, 9, 901, 44, 12, 600, 5, 31])


def _port_engine(target, draft=None, tokenizer=None, **kw):
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    b = EngineBuilder(EngineConfig(device="cpu", **kw)).with_model(*target)
    if tokenizer is not None:
        b = b.with_tokenizer(tokenizer)
    if draft is not None:
        b = b.with_draft_model(*draft)
    return b.build()


def _jax_engine(target, draft=None, tokenizer=None, **kw):
    from ferrum_tpu.config import EngineConfig
    from ferrum_tpu.engine.builder import EngineBuilder
    b = EngineBuilder(EngineConfig(adaptive_windows=False, **kw)) \
        .with_model(*target)
    if tokenizer is not None:
        b = b.with_tokenizer(tokenizer)
    if draft is not None:
        b = b.with_draft_model(*draft)
    return b.build()


def _wait_idle(engine):
    """Until no round or window is in flight and no first token pending
    (the loop drains them on its own), so the next request's schedule
    does not depend on when it arrived."""
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    while engine._inflight_q or engine._pending_first:
        assert time.monotonic() < deadline, "engine never went idle"
        time.sleep(0.01)


def _serve(engine, prompts, together, **sp):
    """Each prompt's generated tokens, read from its sequence when the
    scheduler finishes it (the JAX engine streams a token only with
    text), and its finish reason. `together`: all submitted before the
    loop starts (one admission wave); else one after another, the engine
    idle between them."""
    mod = sys.modules[type(engine).__module__.rsplit(".", 2)[0] + ".types"]
    done = {}
    finish = engine.scheduler.finish

    def record(seq):
        done.setdefault(seq.request.request_id, list(seq.output_tokens))
        finish(seq)

    engine.scheduler.finish = record
    reqs = [mod.InferenceRequest(
        prompt_token_ids=list(p) if not isinstance(p, str) else None,
        prompt=p if isinstance(p, str) else None,
        sampling=mod.SamplingParams(**sp)) for p in prompts]
    reasons = {}

    def drain(r, q):
        while True:
            chunk = q.get(timeout=SERVE_TIMEOUT_S)
            if chunk.finished:
                reasons[r.request_id] = chunk.finish_reason.value
                return

    if together:
        start = engine.ensure_loop
        engine.ensure_loop = lambda: None
        queues = [engine.submit(r) for r in reqs]
        engine.ensure_loop = start
        start()
        for r, q in zip(reqs, queues):
            drain(r, q)
    else:
        for r in reqs:
            drain(r, engine.submit(r))
            _wait_idle(engine)
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    while len(done) < len(reqs):       # a deferred release comes last
        assert time.monotonic() < deadline, "a sequence was never released"
        time.sleep(0.01)
    _wait_idle(engine)
    engine.scheduler.finish = finish
    return [done[r.request_id] for r in reqs], \
        [reasons[r.request_id] for r in reqs]


def _stats(engine):
    return dataclasses.astuple(engine.spec.stats)


@pytest.mark.parametrize("together", [False, True])
def test_f32_spec_engine_matches_plain_and_jax(together):
    """tests/test_spec_engine.py's model and settings: greedy spec tokens
    equal the port's plain engine's and the JAX spec engine's, and the
    acceptance counts the JAX engine's, alone and at concurrency 4."""
    jt, jd, tt, td = _f32_models()
    prompts = ["Hello world", "The quick brown fox", "a", "alpha beta"]
    sp = dict(max_tokens=16, temperature=0.0)
    plain = _port_engine(tt, **_spec_engine_kw())
    spec = _port_engine(tt, td, **_spec_engine_kw())
    jspec = _jax_engine(jt, jd, **_spec_engine_kw())
    try:
        want = _serve(plain, prompts, together, **sp)
        got = _serve(spec, prompts, together, **sp)
        jgot = _serve(jspec, prompts, together, **sp)
        assert got == want
        assert got == jgot
        assert _stats(spec) == _stats(jspec)
        assert spec.spec.stats.proposals > 0
    finally:
        for e in (plain, spec, jspec):
            e.stop()


@pytest.mark.parametrize("draft", ["target", "one-layer"])
@pytest.mark.parametrize("together", [False, True])
def test_quant_spec_engine_matches_plain_and_jax(monkeypatch, together,
                                                 draft):
    """tiny-quant through the plain versions, draft = the target (high
    acceptance, below 1: the draft cache never holds the prompt) or a
    one-layer tiny-quant of another seed (low acceptance): greedy spec
    tokens equal the plain engine's and the JAX spec engine's; the
    acceptance counts equal the JAX engine's."""
    models = _quant_models(monkeypatch, *((2, 3) if draft == "target"
                                          else (1, 5)))
    jt, jd, tt, td = models
    sp = dict(max_tokens=14, ignore_eos=True, temperature=0.0)
    plain = _port_engine(tt, **QUANT_KW)
    spec = _port_engine(tt, td, **QUANT_KW)
    jspec = _jax_engine(jt, jd, **QUANT_KW)
    try:
        want = _serve(plain, QUANT_PROMPTS, together, **sp)
        got = _serve(spec, QUANT_PROMPTS, together, **sp)
        assert got == want
        assert _serve(jspec, QUANT_PROMPTS, together, **sp) == got
        assert _stats(spec) == _stats(jspec)
        st = spec.spec.stats
        if draft == "target":
            assert 0 < st.acceptance_rate < 1.0
    finally:
        for e in (plain, spec, jspec):
            e.stop()


def test_quant_spec_engine_behaviours(monkeypatch):
    """Against the port's plain engine on tiny-quant: a stop token (EOS)
    finishes where it does there, max_tokens not a multiple of K+1, stop
    strings cut the text where they do there."""
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    _, _, tt, td = _quant_models(monkeypatch, 1, 5)
    plain = _port_engine(tt, **QUANT_KW)
    spec = _port_engine(tt, td, **QUANT_KW)
    try:
        free = _serve(plain, QUANT_PROMPTS, True, max_tokens=20,
                      ignore_eos=True, temperature=0.0)[0]
        stops = [out[5] for out in free]
        for max_tokens in (5, 9):
            sp = dict(max_tokens=max_tokens, ignore_eos=True,
                      temperature=0.0)
            assert _serve(spec, QUANT_PROMPTS, True, **sp) \
                == _serve(plain, QUANT_PROMPTS, True, **sp)
        for prompt, stop in zip(QUANT_PROMPTS, stops):
            sp = dict(max_tokens=20, temperature=0.0, stop_token_ids=[stop])
            got = _serve(spec, [prompt], False, **sp)
            assert got == _serve(plain, [prompt], False, **sp)
            assert got[1] == ["stop"] and got[0][0][-1] == stop
        for prompt in QUANT_PROMPTS[:2]:
            full = plain.infer(InferenceRequest(
                prompt_token_ids=prompt, sampling=SamplingParams(
                    max_tokens=20, temperature=0.0, ignore_eos=True)))
            stop_s = full.text[3:6]
            if len(stop_s) < 3:
                continue
            kw = dict(max_tokens=20, temperature=0.0, ignore_eos=True,
                      stop=[stop_s])
            r0 = plain.infer(InferenceRequest(
                prompt_token_ids=prompt, sampling=SamplingParams(**kw)))
            r1 = spec.infer(InferenceRequest(
                prompt_token_ids=prompt, sampling=SamplingParams(**kw)))
            assert (r1.text, r1.token_ids, r1.finish_reason) \
                == (r0.text, r0.token_ids, r0.finish_reason)
            assert stop_s not in r1.text
    finally:
        plain.stop()
        spec.stop()


def test_min_tokens_under_rounds_matches_jax(monkeypatch):
    """min_tokens under speculation, as in the JAX round: a round does
    not mask EOS (ROADMAP Queue 3), so an EOS the target picks before
    min_tokens comes out as an ordinary token, where the plain engine
    masks it. tiny-quant with the model's EOS set to the first token of
    its greedy stream (after the prefill's) that it has not picked
    before: the port's spec tokens and acceptance counts equal the JAX
    spec engine's; the plain engine keeps EOS out of the first
    min_tokens tokens."""
    models = _quant_models(monkeypatch, 1, 5)
    prompt = QUANT_PROMPTS[0]
    free = _port_engine(models[2], **QUANT_KW)
    try:
        stream = _serve(free, [prompt], False, max_tokens=12,
                        ignore_eos=True, temperature=0.0)[0][0]
    finally:
        free.stop()
    i = next(j for j in range(1, len(stream)) if stream[j] not in stream[:j])
    eos = stream[i]
    jt, jd, tt, td = [(dataclasses.replace(c, eos_token_ids=(eos,)), p)
                      for c, p in models]
    sp = dict(max_tokens=i + 6, min_tokens=i + 4, temperature=0.0)
    plain = _port_engine(tt, **QUANT_KW)
    spec = _port_engine(tt, td, **QUANT_KW)
    jspec = _jax_engine(jt, jd, **QUANT_KW)
    try:
        want = _serve(plain, [prompt], False, **sp)[0][0]
        assert eos not in want[:i + 4] and len(want) == i + 6
        got = _serve(spec, [prompt], False, **sp)
        assert got == _serve(jspec, [prompt], False, **sp)
        assert _stats(spec) == _stats(jspec)
        assert got[0][0][i] == eos          # the recorded fault
    finally:
        for e in (plain, spec, jspec):
            e.stop()


def test_spec_guided_composition():
    """tests/test_spec_engine.py's guided case on the port: three patterns
    alone (the device-FSM path engaged, tokens equal to the plain
    engine's and to the JAX spec engine's), then a mixed batch of guided
    and unguided requests through the rounds."""
    from ferrum_tpu.tokenizer import make_byte_tokenizer as jax_tok
    from ferrum_tpu.types import GuidedOptions as JGO
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.types import SamplingParams as JSP
    from ferrum_tpu_torch.tokenizer import make_byte_tokenizer
    from ferrum_tpu_torch.types import (GuidedOptions, InferenceRequest,
                                        SamplingParams)

    jt, jd, tt, td = _f32_models()
    tok = make_byte_tokenizer(vocab_extra=512 - 258)
    plain = _port_engine(tt, tokenizer=tok, **_spec_engine_kw())
    spec = _port_engine(tt, td, tokenizer=tok, **_spec_engine_kw())
    jspec = _jax_engine(jt, jd, tokenizer=jax_tok(vocab_extra=512 - 258),
                        **_spec_engine_kw())
    try:
        for pattern in (r"(yes|no)", r"(foo|bar)+x", r"-?\d\d"):
            want = plain.infer(InferenceRequest(
                prompt="q:", sampling=SamplingParams(max_tokens=8,
                                                     temperature=0.0),
                guided=GuidedOptions(regex=pattern)))
            got = spec.infer(InferenceRequest(
                prompt="q:", sampling=SamplingParams(max_tokens=8,
                                                     temperature=0.0),
                guided=GuidedOptions(regex=pattern)))
            jgot = jspec.infer(JReq(
                prompt="q:", sampling=JSP(max_tokens=8, temperature=0.0),
                guided=JGO(regex=pattern)))
            assert any(v[0] is not None for v in spec._fsm_cache.values())
            assert got.token_ids == want.token_ids, pattern
            assert got.text == jgot.text, pattern
        results = {}

        def worker(i):
            guided = GuidedOptions(regex=r"(red|green|blue)") \
                if i % 2 == 0 else None
            results[i] = spec.infer(InferenceRequest(
                prompt=f"m{i}", sampling=SamplingParams(
                    max_tokens=6, temperature=0.0), guided=guided))

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVE_TIMEOUT_S)
        assert len(results) == 4
        for i in (0, 2):
            assert results[i].text in ("red", "green", "blue")
        assert spec.spec.stats.proposals > 0
    finally:
        for e in (plain, spec, jspec):
            e.stop()


def test_quant_spec_engine_int8_kv_matches_jax(monkeypatch):
    """int8 KV (the paged layout): the port's spec tokens and acceptance
    counts equal the JAX spec engine's. (Not the plain engine's: a
    window holds its K/V in bf16 until it lands, a round's verify
    attends to its own rows in f32, so the two round int8 KV apart and a
    near-tie may go either way, in the JAX package as here.)"""
    jt, jd, tt, td = _quant_models(monkeypatch, 1, 5)
    kw = dict(QUANT_KW, kv_dtype="int8")
    spec = _port_engine(tt, td, **kw)
    jspec = _jax_engine(jt, jd, **kw)
    try:
        sp = dict(max_tokens=14, ignore_eos=True, temperature=0.0)
        got = _serve(spec, QUANT_PROMPTS, True, **sp)
        assert got == _serve(jspec, QUANT_PROMPTS, True, **sp)
        assert _stats(spec) == _stats(jspec)
    finally:
        spec.stop()
        jspec.stop()


def test_quant_spec_engine_paged_preemption(monkeypatch):
    """The paged layout on a pool small enough to preempt (recompute):
    the spec engine's greedy tokens equal the plain engine's."""
    _, _, tt, td = _quant_models(monkeypatch, 1, 5)
    kw = dict(QUANT_KW, kv_num_blocks=12)
    prompts = [list(range(3 + i, 43 + i)) for i in range(4)]
    plain = _port_engine(tt, **kw)
    spec = _port_engine(tt, td, **kw)
    try:
        sp = dict(max_tokens=40, ignore_eos=True, temperature=0.0)
        want = _serve(plain, prompts, True, **sp)
        assert _serve(spec, prompts, True, **sp) == want
        assert spec.scheduler.stats.preemptions >= 1
    finally:
        plain.stop()
        spec.stop()


def test_seeded_sampled_spec_is_batch_and_slot_invariant(monkeypatch):
    """A seeded sampled request gives the same tokens alone, batched with
    three unseeded sampled requests, and in another slot (slot 0 held by
    a running request); each on a fresh engine (the draft cache of a
    used slot holds stale rows: ROADMAP Queue 3)."""
    _, _, tt, td = _quant_models(monkeypatch, 1, 5)
    kw = dict(QUANT_KW, kv_layout="linear", kv_num_blocks=0)
    seeded = dict(max_tokens=16, ignore_eos=True, temperature=0.8, top_k=40,
                  seed=1234)
    prompt = QUANT_PROMPTS[0]
    runs = {}
    for case in ("alone", "batched", "other-slot"):
        engine = _port_engine(tt, td, **kw)
        try:
            if case == "alone":
                runs[case] = _serve(engine, [prompt], True, **seeded)[0][0]
            elif case == "batched":
                from ferrum_tpu_torch.types import (InferenceRequest,
                                                    SamplingParams)
                others = [engine.submit(InferenceRequest(
                    prompt_token_ids=p, sampling=SamplingParams(
                        max_tokens=16, ignore_eos=True, temperature=1.0)))
                    for p in QUANT_PROMPTS[1:]]
                runs[case] = _serve(engine, [prompt], True, **seeded)[0][0]
                for q in others:
                    while not q.get(timeout=SERVE_TIMEOUT_S).finished:
                        pass
            else:
                from ferrum_tpu_torch.types import (InferenceRequest,
                                                    SamplingParams)
                hold = engine.submit(InferenceRequest(
                    prompt_token_ids=QUANT_PROMPTS[1],
                    sampling=SamplingParams(max_tokens=60, ignore_eos=True,
                                            temperature=0.0)))
                while not engine.scheduler.running:
                    time.sleep(0.01)
                runs[case] = _serve(engine, [prompt], True, **seeded)[0][0]
                while not hold.get(timeout=SERVE_TIMEOUT_S).finished:
                    pass
        finally:
            engine.stop()
    assert runs["batched"] == runs["alone"]
    assert runs["other-slot"] == runs["alone"]


def test_long_rounds_keep_their_kv(monkeypatch):
    """K = 6 past decode_multi_step x (1 + pipeline_depth) = 2: the
    scheduler reserves 2 (K + 1) positions ahead, so no verify or draft
    row lands past a sequence's blocks; on a paged pool of 8-token
    blocks the greedy tokens equal the plain engine's."""
    _, _, tt, td = _quant_models(monkeypatch, 2, 3)
    kw = dict(QUANT_KW, kv_block_size=8, decode_multi_step=1,
              pipeline_depth=1, spec_num_tokens=6)
    plain = _port_engine(tt, **kw)
    spec = _port_engine(tt, td, **kw)
    try:
        assert spec.scheduler.decode_lookahead >= 2 * 7
        sp = dict(max_tokens=30, ignore_eos=True, temperature=0.0)
        assert _serve(spec, QUANT_PROMPTS, True, **sp) \
            == _serve(plain, QUANT_PROMPTS, True, **sp)
    finally:
        plain.stop()
        spec.stop()


# ---------------------------------------------------------------------------
# Draft sources, settings, CLI
# ---------------------------------------------------------------------------

def test_draft_sources(tmp_path):
    """random:<preset> draws init_random_params(draft, cfg.seed) (bit for
    bit the JAX package's draws), a checkpoint directory loads through
    load_checkpoint, with_draft_model takes explicit params; a draft of
    another vocabulary raises ModelLoadError."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.llama_family import init_random_params
    from ferrum_tpu_torch.models.safetensors_io import write_safetensors
    from ferrum_tpu_torch.types import InferenceRequest, ModelLoadError

    kw = dict(model="random:tiny-test", device="cpu", dtype="f32",
              max_num_seqs=2, max_model_len=128, kv_num_blocks=32, seed=3)
    eng = EngineBuilder(EngineConfig(spec_draft_model="random:tiny-test",
                                     **kw)).build()
    try:
        want = init_random_params(preset("tiny-test"), 3,
                                  dtype=torch.float32, device="cpu")
        assert torch.equal(eng.spec.draft_params.embed, want.embed)
        r = eng.infer(InferenceRequest(prompt="hi"))
        assert r.completion_tokens > 0 and eng.spec.stats.proposals > 0
    finally:
        eng.stop()

    cfg = preset("tiny-test")
    d = tmp_path / "draft"
    d.mkdir()
    (d / "config.json").write_text(
        '{"architectures": ["Qwen3ForCausalLM"], '
        '"model_type": "qwen3", "vocab_size": 512, "hidden_size": 64, '
        '"num_hidden_layers": 1, "num_attention_heads": 4, '
        '"num_key_value_heads": 2, "head_dim": 16, '
        '"intermediate_size": 128, "tie_word_embeddings": true, '
        '"rope_theta": 10000.0, "rms_norm_eps": 1e-6, '
        '"eos_token_id": 257}')
    rng = np.random.default_rng(0)

    def w(*shape):
        return torch.from_numpy(rng.normal(0, 0.02, shape)
                                .astype(np.float32))

    h, q, kvs = 64, 64, 32
    tensors = {"model.embed_tokens.weight": w(512, h),
               "model.norm.weight": torch.ones(h)}
    pre = "model.layers.0."
    tensors.update({
        pre + "input_layernorm.weight": torch.ones(h),
        pre + "post_attention_layernorm.weight": torch.ones(h),
        pre + "self_attn.q_norm.weight": torch.ones(16),
        pre + "self_attn.k_norm.weight": torch.ones(16),
        pre + "self_attn.q_proj.weight": w(q, h),
        pre + "self_attn.k_proj.weight": w(kvs, h),
        pre + "self_attn.v_proj.weight": w(kvs, h),
        pre + "self_attn.o_proj.weight": w(h, q),
        pre + "mlp.gate_proj.weight": w(128, h),
        pre + "mlp.up_proj.weight": w(128, h),
        pre + "mlp.down_proj.weight": w(h, 128)})
    write_safetensors(str(d / "model.safetensors"), tensors)
    eng = EngineBuilder(EngineConfig(spec_draft_model=str(d), **kw)).build()
    try:
        assert eng.spec.draft_cfg.num_layers == 1
        assert torch.equal(eng.spec.draft_params.embed,
                           tensors["model.embed_tokens.weight"])
        assert eng.infer(InferenceRequest(prompt="hi")).completion_tokens > 0
    finally:
        eng.stop()

    small = dataclasses.replace(cfg, vocab_size=256)
    with pytest.raises(ModelLoadError, match="vocab"):
        EngineBuilder(EngineConfig(**kw)).with_draft_model(
            small, init_random_params(small, 0, dtype=torch.float32,
                                      device="cpu")).build()
    b = EngineBuilder(EngineConfig(**kw))
    b.with_draft_model(cfg, init_random_params(cfg, 1, dtype=torch.float32,
                                               device="cpu"))
    assert b.cfg.spec_draft_model == "explicit"


def test_spec_settings_resolve_as_jax():
    """FERRUM_SPEC_DRAFT / FERRUM_SPEC_K and the flags reach the port's
    EngineConfig as the JAX package's resolve sets them; K < 1 raises."""
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.types import InvalidRequestError

    env = {"FERRUM_SPEC_DRAFT": "random:tiny-test", "FERRUM_SPEC_K": "2"}
    mine = EngineConfig.resolve(environ=env)
    ref = JaxConfig.resolve(environ=env) if hasattr(JaxConfig, "resolve") \
        else None
    assert (mine.spec_draft_model, mine.spec_num_tokens) \
        == ("random:tiny-test", 2)
    if ref is not None:
        assert (ref.spec_draft_model, ref.spec_num_tokens) \
            == (mine.spec_draft_model, mine.spec_num_tokens)
    cli = EngineConfig.resolve(cli_overrides={"spec_num_tokens": 5},
                               environ=env)
    assert cli.spec_num_tokens == 5
    with pytest.raises(InvalidRequestError, match="spec_num_tokens"):
        EngineConfig.resolve(cli_overrides={"spec_num_tokens": 0})


def test_cli_run_with_a_draft():
    """`python -m ferrum_tpu_torch run random:tiny-test --device cpu
    --spec-draft random:tiny-test` in a fresh interpreter: exit 0, text
    and its token count, jax never imported."""
    code = ("import sys, runpy\n"
            "sys.argv = ['ferrum_tpu_torch', 'run', 'random:tiny-test', "
            "'--device', 'cpu', '--spec-draft', 'random:tiny-test', "
            "'--spec-k', '3', '--prompt', 'hello', '--max-tokens', '8', "
            "'--temperature', '0', '--max-model-len', '256', "
            "'--max-num-seqs', '2']\n"
            "try:\n"
            "    runpy.run_module('ferrum_tpu_torch', run_name='__main__')\n"
            "    rc = 0\n"
            "except SystemExit as e:\n"
            "    rc = e.code\n"
            "assert 'jax' not in sys.modules, 'the port imported jax'\n"
            "sys.exit(rc)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=180, cwd=REPO,
                       env={**os.environ, "FERRUM_DTYPE": "f32"})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "8 tokens" in r.stderr
