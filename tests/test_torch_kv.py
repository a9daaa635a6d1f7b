"""The KV cache's other forms: ferrum_tpu_torch against ferrum_tpu.

  - the block pool, the paged prefix cache (lru / fifo / clock) and the
    linear prefix store's queued copies, on one scripted sequence of
    operations in both packages: equal block ids, hits, evictions and
    cached blocks;
  - `quantize_kv` bit for bit, zero rows and rows at ±127 and on
    rounding ties included;
  - the int8 terms of the three flat attention forms and the paged
    layout's gather-based forms, against the JAX functions;
  - greedy token streams of both engines (tiny-quant, int4 two-level,
    f32; the JAX w4a8 dispatch routed to its two-level oracle) under
    int8 KV, the linear prefix store, the paged layout with shared
    prefix blocks, and a paged pool small enough to preempt: equal
    tokens, hits, reused tokens and preemptions; the repetition counts
    of a reused prefix;
  - the port's pipelined loop under preemption, in the configuration of
    tests/test_engine_e2e.py::test_pipeline_matches_unpipelined (its JAX
    run can hang; every JAX run here is unpipelined under preemption),
    against the port's unpipelined stream, which is the model's
    teacher-forced argmax;
  - the pairs form of the page appends (plain version).
Every engine wait is bounded (SERVE_TIMEOUT_S), so a hang fails one
test and leaves the run going.
"""

import queue
import time

import numpy as np
import pytest
import torch

import test_torch_engine as te
from torch_parity import (flatten_jax_params, jax_model, route_w4a8tl,
                          torch_config)

SERVE_TIMEOUT_S = 120.0
MAX_TOKENS = 8

# ---------------------------------------------------------------------------
# Block pool and prefix caches
# ---------------------------------------------------------------------------

PAGE = 4


def _caches(policy, num_blocks=10):
    from ferrum_tpu.kv.block_pool import BlockPool as JPool
    from ferrum_tpu.kv.prefix_cache import PrefixCache as JCache
    from ferrum_tpu_torch.kv.block_pool import BlockPool
    from ferrum_tpu_torch.kv.prefix_cache import PrefixCache
    jp, tp = JPool(num_blocks, PAGE), BlockPool(num_blocks, PAGE)
    return (jp, JCache(jp, policy=policy)), (tp, PrefixCache(tp,
                                                             policy=policy))


def _state(pool, cache):
    st = cache.stats
    return (pool.num_free, sorted(pool._refcount.items()),
            pool.stats.allocated_total, pool.stats.freed_total,
            pool.stats.cow_shares, st.hits, st.misses,
            st.saved_prefill_tokens, st.cached_blocks, st.evictions,
            list(cache._by_hash.items()))


@pytest.mark.parametrize("policy", ["lru", "fifo", "clock"])
def test_pool_and_prefix_cache_match_jax(policy):
    """One script of allocate / share / free / insert / match / evict on
    both packages' pool and cache: after every step the same free list
    count, refcounts, stats, cached hashes (the blake2b chain: equal
    keys) and returned block ids."""
    (jp, jc), (tp, tc) = _caches(policy)
    a = list(range(100, 112))          # 3 full blocks
    b = a[:8] + [7, 7, 7, 7, 9]        # shares a's first 2 blocks
    c = list(range(300, 310))
    script = []

    def both(fn):
        got = fn(tp, tc), fn(jp, jc)
        assert got[0] == got[1], fn
        assert _state(tp, tc) == _state(jp, jc), fn
        script.append(got[0])
        return got[0]

    blocks_a = both(lambda p, c_: p.allocate(3))
    both(lambda p, c_: c_.insert(a, blocks_a))
    both(lambda p, c_: [p.free(x) for x in blocks_a])
    both(lambda p, c_: c_.match_prefix(b))
    both(lambda p, c_: c_.match_prefix(a))            # never the whole
    both(lambda p, c_: c_.match_prefix(a + [1]))      # 3 blocks
    both(lambda p, c_: c_.match_prefix(c))            # miss
    shared = both(lambda p, c_: c_.match_prefix(b)[0])
    both(lambda p, c_: [p.share(x) for x in shared])
    blocks_c = both(lambda p, c_: p.allocate(3))
    both(lambda p, c_: c_.insert(c + [0, 0], blocks_c))
    both(lambda p, c_: c_.evict(p.num_free + 2))      # shared ones stay
    both(lambda p, c_: [p.free(x) for x in shared + blocks_c])
    both(lambda p, c_: c_.match_prefix(a + [1]))
    both(lambda p, c_: c_.evict(p.num_blocks))
    both(lambda p, c_: c_.clear())
    assert tp.num_free == tp.num_blocks
    assert any(isinstance(x, tuple) and x[1] for x in script)


class _CopyRecorder:
    """A runner stand-in: records the prefix-store copies."""

    def __init__(self):
        self.copies = []
        self.store = None

    def ensure_prefix_store(self, n):
        self.store = n

    def copy_prefix_blocks(self, src, dst, to_store):
        self.copies.append((list(src), list(dst), to_store))


@pytest.mark.parametrize("policy", ["lru", "fifo", "clock"])
def test_linear_prefix_store_queues_the_jax_copies(policy):
    """The linear layout's store (3 blocks): inserts queue slot → store
    copies, a full store evicts by policy, and each flush issues the JAX
    package's copies (last wins by destination)."""
    from ferrum_tpu.kv.linear_prefix import LinearPrefixCache as JLin
    from ferrum_tpu_torch.kv.linear_prefix import LinearPrefixCache
    runs = []
    for cls in (LinearPrefixCache, JLin):
        rec = _CopyRecorder()
        cache = cls(rec, 3, PAGE, policy=policy)
        cache.insert(list(range(9)), [40, 41, 42])
        cache.flush_pending()
        hit = cache.match_prefix(list(range(9)))
        cache.insert(list(range(50, 63)), [7, 8, 9])
        cache.insert(list(range(50, 63)), [7, 8, 9])
        cache.flush_pending()
        cache.flush_pending()
        runs.append((rec.store, rec.copies, hit, dict(cache._by_hash),
                     cache.stats.__dict__, cache.pool.num_free))
    assert runs[0] == runs[1]
    assert runs[0][1] and runs[0][4]["evictions"] > 0


# ---------------------------------------------------------------------------
# quantize_kv and attention
# ---------------------------------------------------------------------------

def test_quantize_kv_is_bit_exact():
    """f32 amax / 127, round half to even, clip ±127: equal int8 values
    and scales, on random rows, rows of zeros, rows whose amax maps to
    ±127 and rows of exact .5 ties."""
    import jax.numpy as jnp
    from ferrum_tpu.models.llama_family import quantize_kv as jq
    from ferrum_tpu_torch.models.llama_family import quantize_kv as tq
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (6, 5, 4, 16)).astype(np.float32)
    x[0, 0] = 0.0
    x[1, 1, 2] = 0.0
    ties = np.array([127, 2.5, -2.5, 0.5, -0.5, 1.5, 126.5, -127] * 2,
                    np.float32)
    x[2, 2, 1] = ties
    x[3, 3, 3] = -ties
    x[4, 4, 0] = np.linspace(-127, 127, 16, dtype=np.float32)
    q_t, s_t = tq(torch.from_numpy(x))
    q_j, s_j = jq(jnp.asarray(x))
    assert q_t.dtype == torch.int8 and s_t.dtype == torch.float32
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    assert q_t[2, 2, 1].tolist() == [127, 2, -2, 0, 0, 2, 126, -127] * 2
    assert not q_t[0, 0].any() and q_t.abs().max() == 127
    # bf16 input, as the card's K/V rows
    xb = torch.from_numpy(x).to(torch.bfloat16)
    q_b, s_b = tq(xb)
    q_jb, s_jb = jq(jnp.asarray(x, jnp.bfloat16))
    np.testing.assert_array_equal(q_b.numpy(), np.asarray(q_jb))
    np.testing.assert_array_equal(s_b.numpy(), np.asarray(s_jb))


S, HQ, HKV, D, C = 3, 8, 4, 16, 32


def _close(got, want):
    want = np.asarray(want, np.float32)
    got = got.to(torch.float32).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _int8_cache(rng, lead):
    vals = rng.integers(-127, 128, lead + (HKV * D,)).astype(np.int8)
    scales = rng.uniform(0.001, 0.05, lead + (HKV,)).astype(np.float32)
    return vals, scales


@pytest.mark.parametrize("window", [False, True])
def test_int8_flat_decode_attention_matches_jax(window):
    import jax.numpy as jnp
    from ferrum_tpu.ops import attention as ja
    from ferrum_tpu_torch.ops import attention as ta
    rng = np.random.default_rng(1)
    q = rng.normal(0, 1, (S, HQ, D)).astype(np.float32)
    kv, ks = _int8_cache(rng, (S, C))
    vv, vs = _int8_cache(rng, (S, C))
    k_self = rng.normal(0, 1, (S, HKV, D)).astype(np.float32)
    v_self = rng.normal(0, 1, (S, HKV, D)).astype(np.float32)
    lens = np.array([5, 17, 30], np.int32)
    kw = {}
    if window:
        w = 4
        kw = dict(k_win=rng.normal(0, 1, (w, S, HKV, D)).astype(np.float32),
                  v_win=rng.normal(0, 1, (w, S, HKV, D)).astype(np.float32),
                  win_valid=np.arange(w)[None].repeat(S, 0) < 2,
                  cache_len=lens - 2)
    want = ja.flat_decode_attention(
        jnp.asarray(q), jnp.asarray(kv), jnp.asarray(vv), jnp.asarray(lens),
        jnp.asarray(k_self), jnp.asarray(v_self), hkv=HKV, scale=0.25,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        **{k: jnp.asarray(v) for k, v in kw.items()})
    got = ta.flat_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kv), torch.from_numpy(vv),
        torch.from_numpy(lens), torch.from_numpy(k_self),
        torch.from_numpy(v_self), hkv=HKV, scale=0.25,
        k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs),
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    _close(got, want)


def test_int8_flat_prefill_forms_match_jax():
    """flat_prefill_attention (one sequence and a batch of two) and
    flat_prefill_window_attention over an int8 prefix."""
    import jax
    import jax.numpy as jnp
    from ferrum_tpu.ops import attention as ja
    from ferrum_tpu_torch.ops import attention as ta
    rng = np.random.default_rng(2)
    t = 8
    q = rng.normal(0, 1, (2, t, HQ, D)).astype(np.float32)
    kv, ks = _int8_cache(rng, (2, C))
    vv, vs = _int8_cache(rng, (2, C))
    kn = rng.normal(0, 1, (2, t, HKV, D)).astype(np.float32)
    vn = rng.normal(0, 1, (2, t, HKV, D)).astype(np.float32)
    pos = np.stack([np.arange(12, 12 + t), np.arange(3, 3 + t)]) \
        .astype(np.int32)
    pos[1, 6:] = 10_000                        # pad rows
    total = np.array([20, 9], np.int32)
    J = jnp.asarray

    def jax_one(*a):
        return ja.flat_prefill_attention(
            *a[:7], hkv=HKV, scale=0.25, k_scale=a[7], v_scale=a[8])

    want = jax.vmap(jax_one)(J(q), J(kv), J(vv), J(pos), J(total), J(kn),
                             J(vn), J(ks), J(vs))
    T = torch.from_numpy
    got = ta.flat_prefill_attention(
        T(q), T(kv), T(vv), T(pos), T(total), T(kn), T(vn), hkv=HKV,
        scale=0.25, k_scale=T(ks), v_scale=T(vs))
    _close(got, want)
    one = ta.flat_prefill_attention(
        T(q[0]), T(kv[0]), T(vv[0]), T(pos[0]), T(total[:1]), T(kn[0]),
        T(vn[0]), hkv=HKV, scale=0.25, k_scale=T(ks[0]), v_scale=T(vs[0]))
    _close(one, want[0])

    steps, p = 3, 4
    wk = rng.normal(0, 1, (steps, p, HKV, D)).astype(np.float32)
    wv = rng.normal(0, 1, (steps, p, HKV, D)).astype(np.float32)
    qp = np.arange(20 + 2 * p, 20 + 3 * p).astype(np.int32)
    args = (q[0, :p], kv[0], vv[0], 20, wk, wv, 2, 20, 10, kn[0, :p],
            vn[0, :p], qp)
    want = ja.flat_prefill_window_attention(
        *[J(a) for a in args], hkv=HKV, scale=0.25, k_scale=J(ks[0]),
        v_scale=J(vs[0]))
    got = ta.flat_prefill_window_attention(
        *[T(a) if isinstance(a, np.ndarray) else a for a in args], hkv=HKV,
        scale=0.25, k_scale=T(ks[0]), v_scale=T(vs[0]))
    _close(got, want)


@pytest.mark.parametrize("self_term", [False, True])
def test_paged_reference_forms_match_jax(self_term):
    """gather_kv, paged_decode_attention_ref (cache holding the token, or
    the token as a self term) and paged_prefill_attention_ref, on block
    tables scattered over the pool."""
    import jax.numpy as jnp
    from ferrum_tpu.ops import attention as ja
    from ferrum_tpu_torch.ops import attention as ta
    rng = np.random.default_rng(3)
    nb, page, maxp = 12, 4, 6
    kc = rng.normal(0, 1, (nb, page, HKV, D)).astype(np.float32)
    vc = rng.normal(0, 1, (nb, page, HKV, D)).astype(np.float32)
    tables = np.array([[3, 7, 1, 0, 0, 0], [11, 2, 5, 9, 4, 0],
                       [6, 0, 0, 0, 0, 0]], np.int32)
    lens = np.array([10, 21, 3], np.int32)
    q = rng.normal(0, 1, (S, HQ, D)).astype(np.float32)
    J, T = jnp.asarray, torch.from_numpy
    np.testing.assert_array_equal(
        ta.gather_kv(T(kc), T(tables), 16, page).numpy(),
        np.asarray(ja.gather_kv(J(kc), J(tables), 16, page)))
    kw_j, kw_t = {}, {}
    if self_term:
        ksf = rng.normal(0, 1, (S, HKV, D)).astype(np.float32)
        vsf = rng.normal(0, 1, (S, HKV, D)).astype(np.float32)
        kw_j = dict(k_self=J(ksf), v_self=J(vsf))
        kw_t = dict(k_self=T(ksf), v_self=T(vsf))
    want = ja.paged_decode_attention_ref(
        J(q), J(kc), J(vc), J(tables), J(lens), ctx_pad=maxp * page,
        scale=0.25, **kw_j)
    got = ta.paged_decode_attention_ref(
        T(q), T(kc), T(vc), T(tables), T(lens), ctx_pad=maxp * page,
        scale=0.25, **kw_t)
    _close(got, want)
    qp = rng.normal(0, 1, (8, HQ, D)).astype(np.float32)
    pos = np.array([13, 14, 15, 16, 17, 18, 10_000, 10_001], np.int32)
    want = ja.paged_prefill_attention_ref(
        J(qp), J(kc), J(vc), J(tables[1]), J(pos), J(np.int32(19)),
        ctx_pad=maxp * page, scale=0.25)
    got = ta.paged_prefill_attention_ref(
        T(qp), T(kc), T(vc), T(tables[1]), T(pos), torch.tensor(19),
        ctx_pad=maxp * page, scale=0.25)
    _close(got, want)


# ---------------------------------------------------------------------------
# The pairs form of the page appends
# ---------------------------------------------------------------------------

def test_append_pages_pairs_plain_equals_per_array_writes():
    """One to four (cache, pages) arrays at shared ids -- bf16 K and V,
    int8 K and V with f32 scale pages, mixed in one call -- equal one
    plain page write per array; ids >= B and OOB_SENTINEL dropped; in
    place."""
    from ferrum_tpu_torch.models.llama_family import OOB_SENTINEL
    from ferrum_tpu_torch.ops.kernels import kv_append as tka
    rng = np.random.default_rng(4)
    b, page = 7, 4
    ids = torch.tensor([5, b, 0, OOB_SENTINEL, 3, b + 2], dtype=torch.int32)

    def arr(dtype, f, n):
        if dtype == torch.int8:
            return torch.from_numpy(
                rng.integers(-127, 128, (n, page, f)).astype(np.int8))
        return torch.from_numpy(
            rng.normal(0, 1, (n, page, f)).astype(np.float32)).to(dtype)

    kinds = [(torch.bfloat16, 32), (torch.bfloat16, 32), (torch.int8, 32),
             (torch.float32, 2)]
    for k in range(1, 5):
        caches = [arr(dt, f, b) for dt, f in kinds[:k]]
        pages = [arr(dt, f, len(ids)) for dt, f in kinds[:k]]
        want = [tka.append_pages_plain(c.clone(), p, ids)
                for c, p in zip(caches, pages)]
        before = [c.clone() for c in caches]
        got = tka.append_pages_pairs(list(zip(caches, pages)), ids)
        for g, c, w, b0, p in zip(got, caches, want, before, pages):
            assert g is c and torch.equal(c, w)
            assert torch.equal(c[5], p[0]) and torch.equal(c[3], p[4])
            assert torch.equal(c[[1, 2, 4, 6]], b0[[1, 2, 4, 6]])
    with pytest.raises(ValueError, match="1 to 4"):
        tka.append_pages_pairs([(caches[0], pages[0])] * 5, ids)


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_builder_layout_and_autosize_match_jax(kv_dtype):
    """autosize_kv_blocks and params_nbytes equal the JAX package's on one
    byte budget; the builder autosizes a paged pool from a budget given
    on the CPU, raises naming kv_num_blocks without one, and resolves
    "auto" as the JAX builder does: paged under a pinned capacity or a
    budget too small for every slot's region, else linear."""
    import jax.numpy as jnp
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.engine import builder as jb
    from ferrum_tpu.models.configs import preset as jpreset
    from ferrum_tpu.models.llama_family import init_random_params
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine import builder as tb
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.llama_family import \
        init_random_params as tinit
    from ferrum_tpu_torch.types import ModelLoadError

    kw = dict(max_num_seqs=4, max_model_len=256, kv_block_size=16,
              kv_dtype=kv_dtype)
    jparams = init_random_params(jpreset("tiny-test"), 0, dtype=jnp.float32)
    params = tinit(preset("tiny-test"), 0, dtype=torch.float32,
                   device="cpu")
    nbytes = tb.params_nbytes(params)
    assert nbytes == jb.params_nbytes(jparams)
    for budget in (8 << 20, 64 << 20):
        assert tb.autosize_kv_blocks(
            preset("tiny-test"), EngineConfig(**kw), nbytes, budget) \
            == jb.autosize_kv_blocks(jpreset("tiny-test"),
                                     JaxConfig(model="m", **kw), nbytes,
                                     budget)

    def build(budget=None, **extra):
        b = tb.EngineBuilder(EngineConfig(device="cpu", dtype="f32",
                                          **kw, **extra)).with_model(
            preset("tiny-test"), tinit(preset("tiny-test"), 0,
                                       dtype=torch.float32, device="cpu"))
        if budget:
            b.with_device_memory(budget)
        engine = b.build()
        engine.stop()
        return engine.cfg.kv_layout, engine.runner.kv.num_blocks

    # A budget that holds ~30 blocks (the slots' regions need 64).
    mc = preset("tiny-test")
    block = 2 * mc.num_layers * 16 * mc.kv_size * (
        1 if kv_dtype == "int8" else 2)
    block += 2 * mc.num_layers * 16 * mc.num_kv_heads * 4 \
        if kv_dtype == "int8" else 0
    small, big = int((nbytes + 30.5 * block) / 0.78), 64 << 20
    want = tb.autosize_kv_blocks(mc, EngineConfig(**kw), nbytes, small)
    assert want == 30
    assert build(small, kv_layout="paged") == ("paged", want)
    with pytest.raises(ModelLoadError, match="kv_num_blocks"):
        build(kv_layout="paged")
    assert build(kv_layout="paged", kv_num_blocks=20) == ("paged", 20)
    assert build(kv_layout="auto", kv_num_blocks=20) == ("paged", 20)
    assert build(small, kv_layout="auto") == ("paged", want)
    assert build(big, kv_layout="auto") == ("linear", 4 * 16)
    assert build(kv_layout="auto") == ("linear", 4 * 16)

@pytest.fixture(scope="module")
def model():
    """(jax cfg, jax params, port cfg, port params): tiny-quant, seed 3,
    the parity tests' weights."""
    from ferrum_tpu_torch.models.convert import params_from_numpy
    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=3)
    return jcfg, jparams, torch_config(jcfg), params_from_numpy(
        flatten_jax_params(jparams), "cpu")


def _kw(**kw):
    return {**te._engine_kw(), **kw}


def _jax_engine(model, **kw):
    from ferrum_tpu.config import EngineConfig
    from ferrum_tpu.engine.builder import EngineBuilder
    jcfg, jparams = model[:2]
    cfg = EngineConfig(model="parity", dtype="f32", adaptive_windows=False,
                       **_kw(**kw))
    return EngineBuilder(cfg).with_model(jcfg, jparams).build()


def _port_engine(model, **kw):
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    cfg, params = model[2:]
    return EngineBuilder(EngineConfig(device="cpu", **_kw(**kw))) \
        .with_model(cfg, params).build()


def _drain(q, deadline):
    while True:
        left = deadline - time.monotonic()
        if left <= 0:
            pytest.fail(f"engine did not finish within {SERVE_TIMEOUT_S} s")
        try:
            chunk = q.get(timeout=min(left, 1.0))
        except queue.Empty:
            continue
        if chunk.finished:
            return chunk


def serve_waves(engine, waves, max_tokens=MAX_TOKENS, **samp):
    """Each wave's prompts submitted together (the first before the loop
    starts), the next wave once the last has finished. Returns the
    generated tokens per wave (read from each sequence at its release)
    and the engine; the engine is stopped."""
    mod = type(engine).__module__.split(".")[0]
    types = __import__(f"{mod}.types", fromlist=["InferenceRequest"])
    done = {}
    finish = engine.scheduler.finish

    def record(seq):
        done.setdefault(seq.request.request_id, list(seq.output_tokens))
        finish(seq)

    engine.scheduler.finish = record
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    ids = []
    try:
        for prompts in waves:
            reqs = [types.InferenceRequest(
                prompt_token_ids=list(p), sampling=types.SamplingParams(
                    max_tokens=max_tokens, ignore_eos=True, **samp))
                for p in prompts]
            for r, q in zip(reqs, te._submit_all(engine, reqs)):
                chunk = _drain(q, deadline)
                assert chunk.completion_tokens == max_tokens
            ids.append([r.request_id for r in reqs])
    finally:
        engine.stop()
    return [[done[i] for i in wave] for wave in ids]


SHARED = [int(x) for x in np.random.default_rng(7).integers(3, 1000, 32)]
WAVES = ([SHARED + [5, 9, 17, 3, 44], SHARED + list(range(30, 52)),
          SHARED + [900, 12, 12, 400]],
         [SHARED + [77, 3, 250], SHARED + [5, 9, 17, 3, 44, 101, 7],
          SHARED + [600, 5, 31, 8, 8]])


@pytest.mark.parametrize("loop", ["unpipelined-c3", "pipelined-c4"])
def test_int8_linear_streams_match_jax(monkeypatch, model, loop):
    """kv_dtype int8 on the linear layout, prefix store off: equal greedy
    streams, in the unpipelined loop and the pipelined one with mixed
    prefill (its riding chunk attends an int8 prefix)."""
    route_w4a8tl(monkeypatch)
    mode, conc = te.LOOPS[loop]
    kw = dict(kv_layout="linear", kv_dtype="int8", enable_prefix_cache=False,
              **mode)
    port = _port_engine(model, **kw)
    assert port.runner.kv.quantized
    got = serve_waves(port, [te._prompts(conc)])
    assert got == serve_waves(_jax_engine(model, **kw), [te._prompts(conc)])
    if loop == "pipelined-c4":
        assert port.runner.mixed_windows >= 1


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_linear_prefix_store_matches_jax(monkeypatch, model, kv_dtype):
    """Two waves sharing a 2-block prefix on the linear layout with the
    prefix store: the second wave hits; tokens, hits, misses and reused
    tokens equal the JAX engine's; the port's prefill tokens fall by the
    reused share; the streams equal the port's without a store."""
    route_w4a8tl(monkeypatch)
    kw = dict(kv_layout="linear", kv_dtype=kv_dtype, **te.UNPIPELINED)
    port = _port_engine(model, **kw)
    got = serve_waves(port, WAVES)
    jax_engine = _jax_engine(model, **kw)
    assert got == serve_waves(jax_engine, WAVES)
    mine, ref = port.metrics_snapshot(), jax_engine.metrics_snapshot()
    for name in ("prefix_cache_hits", "prefix_cache_misses",
                 "prefix_cache_saved_tokens", "tokens_prefilled"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert mine.prefix_cache_hits == len(WAVES[1])
    assert mine.prefix_cache_saved_tokens == 32 * len(WAVES[1])
    assert mine.tokens_prefilled == sum(
        len(p) for w in WAVES for p in w) - 32 * len(WAVES[1])
    assert port.runner.compile_log.count(
        ("prefix_copy", (32, "linear", kv_dtype))) == 1
    assert got == serve_waves(
        _port_engine(model, enable_prefix_cache=False, **kw), WAVES)


def test_paged_shared_prefix_matches_jax(monkeypatch, model):
    """The paged layout with the prefix cache: the second wave adopts the
    first's 2 prompt blocks by sharing; equal tokens, hits, reused
    tokens and shares."""
    route_w4a8tl(monkeypatch)
    kw = dict(kv_layout="paged", kv_num_blocks=64, **te.UNPIPELINED)
    port = _port_engine(model, **kw)
    assert port.runner.attn_impl == "ref"
    got = serve_waves(port, WAVES)
    jax_engine = _jax_engine(model, **kw)
    assert got == serve_waves(jax_engine, WAVES)
    mine, ref = port.metrics_snapshot(), jax_engine.metrics_snapshot()
    for name in ("prefix_cache_hits", "prefix_cache_saved_tokens",
                 "tokens_prefilled"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert mine.prefix_cache_hits == len(WAVES[1])
    assert port.pool.stats.cow_shares == jax_engine.pool.stats.cow_shares
    assert port.prefix_cache.stats.cached_blocks \
        == jax_engine.prefix_cache.stats.cached_blocks > 0
    # Every block back in the pool but those the cache holds.
    assert port.pool.num_free == 64 - port.prefix_cache.stats.cached_blocks


# The scripted trace's pool: both loops preempt and reuse a prefix.
POOL = 25


@pytest.mark.parametrize("pipelined", [True, False])
def test_paged_scheduler_matches_jax(pipelined):
    """Both schedulers on the paged layout, one scripted trace: 6
    requests (two sharing a 3-block prefix with an earlier one) into 4
    slots over a 25-block pool with the prefix cache; windows accept 4
    tokens (pipelined, with pinned sets) or 1; finishes free blocks to
    the cache. Every batch equals the JAX one: decode set, chunks,
    admissions, preempted victims, deferrals, the minimum-progress
    clamp, every sequence's block ids, the free count and the cache's
    hits and evictions."""
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.kv.block_pool import BlockPool as JPool
    from ferrum_tpu.kv.prefix_cache import PrefixCache as JCache
    from ferrum_tpu.scheduler.continuous import (
        ContinuousBatchScheduler as JaxSched)
    from ferrum_tpu.scheduler.sequence import Sequence as JaxSeq
    from ferrum_tpu.types import InferenceRequest as JaxReq
    from ferrum_tpu.types import SamplingParams as JaxSamp
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.kv.block_pool import BlockPool
    from ferrum_tpu_torch.kv.prefix_cache import PrefixCache
    from ferrum_tpu_torch.scheduler.continuous import (
        ContinuousBatchScheduler)
    from ferrum_tpu_torch.scheduler.sequence import Sequence
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    kw = dict(max_num_seqs=4, max_model_len=256, kv_block_size=8,
              prefill_chunk_size=32, max_num_batched_tokens=64,
              decode_multi_step=4, pipeline_decode=pipelined,
              kv_layout="paged", kv_num_blocks=POOL)
    jpool, tpool = JPool(POOL, 8), BlockPool(POOL, 8)
    jsched = JaxSched(JaxConfig(model="m", **kw), jpool, JCache(jpool))
    # The port reserves for adaptive windows' doubled length, the JAX
    # scheduler for decode_multi_step (ROADMAP Queue 3): held at the
    # fixed length, both hand out the same blocks.
    sched = ContinuousBatchScheduler(EngineConfig(
        adaptive_windows=False, **kw), tpool, PrefixCache(tpool))
    base = list(range(500, 524))
    prompts = {"r0": base + [1, 2, 3], "r1": list(range(40, 90)),
               "r2": list(range(7, 20)), "r3": base + [9] * 20,
               "r4": list(range(300, 345)), "r5": base + [4, 5]}
    arrive = {0: ["r0", "r1"], 1: ["r2"], 3: ["r4"], 5: ["r3"], 6: ["r5"]}
    finish = {4: {"r0"}, 11: {"r2"}, 15: {"r1"}}
    accept = 4 if pipelined else 1

    def summary(sch, batch):
        return dict(
            decode=[q.request.request_id for q in batch.decode_seqs],
            chunks=[(c.seq.request.request_id, c.start, len(c.tokens),
                     c.is_last) for c in batch.prefill_chunks],
            admitted=[q.request.request_id for q in batch.admitted],
            preempted=[q.request.request_id for q in batch.preempted],
            deferred=[q.request.request_id for q in batch.deferred_decodes],
            steps=batch.decode_steps,
            blocks=sorted((q.request.request_id, list(q.blocks.blocks))
                          for q in sch.running if q.blocks is not None),
            free=sch.pool.num_free, hits=sch.prefix_cache.stats.hits,
            evictions=sch.prefix_cache.stats.evictions,
            preemptions=sch.stats.preemptions)

    seen_preempt = False
    for it in range(24):
        for rid in arrive.get(it, ()):
            toks = prompts[rid]
            jsched.submit(JaxSeq(JaxReq(prompt_token_ids=toks,
                                        request_id=rid,
                                        sampling=JaxSamp(max_tokens=40)),
                                 toks))
            sched.submit(Sequence(InferenceRequest(
                prompt_token_ids=toks, request_id=rid,
                sampling=SamplingParams(max_tokens=40)), toks))
        pinned = frozenset(q.request.request_id for q in sched.running
                           if pipelined and it % 3
                           and q.phase.value == "decoding")
        inflight = 4 * (it % 3) if pipelined else -1
        want = jsched.next_batch(pinned=pinned, inflight_steps=inflight)
        got = sched.next_batch(pinned=pinned, inflight_steps=inflight)
        assert summary(sched, got) == summary(jsched, want), it
        seen_preempt |= bool(got.preempted)
        for sch, batch in ((jsched, want), (sched, got)):
            for c in batch.prefill_chunks:
                sch.note_prefill_done(c)
            for q in batch.decode_seqs:
                if q.phase.value == "decoding":
                    q.output_tokens.extend([1] * accept)
            for q in list(sch.running):
                if q.request.request_id in finish.get(it, ()):
                    sch.finish(q)
    st = sched.prefix_cache.stats
    assert seen_preempt and st.hits > 0 and st.evictions > 0, st


PREEMPT_PROMPTS = [[int(x) for x in np.random.default_rng(20 + i).integers(
    3, 1000, 25 * (i + 1))] for i in range(4)]
PREEMPT_KW = dict(kv_layout="paged", kv_block_size=8, kv_num_blocks=14,
                  max_model_len=256, enable_prefix_cache=False)


def _record_victims(engine):
    """The prompts of the sequences preempted, in order."""
    victims = []
    preempt = engine.scheduler._preempt_victim

    def recorded(*a, **kw):
        v = preempt(*a, **kw)
        if v is not None:
            victims.append((tuple(v.prompt_tokens), v.num_output_tokens))
        return v

    engine.scheduler._preempt_victim = recorded
    return victims


def test_paged_preemption_matches_jax(monkeypatch, model):
    """A paged pool of 14 blocks for four requests of 25 to 100 tokens:
    sequences are preempted and recomputed; the unpipelined streams, the
    victims (in order, with their output counts) and the preemption
    counts equal the JAX engine's."""
    route_w4a8tl(monkeypatch)
    kw = dict(PREEMPT_KW, **te.UNPIPELINED)
    port = _port_engine(model, **kw)
    mine = _record_victims(port)
    got = serve_waves(port, [PREEMPT_PROMPTS], max_tokens=12)
    jax_engine = _jax_engine(model, **kw)
    ref = _record_victims(jax_engine)
    assert got == serve_waves(jax_engine, [PREEMPT_PROMPTS], max_tokens=12)
    assert mine == ref and len(mine) >= 1
    assert port.scheduler.stats.preemptions \
        == jax_engine.scheduler.stats.preemptions >= 1
    assert port.pool.num_free == 14


@pytest.mark.parametrize("layout", ["linear", "paged"])
def test_repetition_counts_cover_a_reused_prefix(monkeypatch, model, layout):
    """Greedy with a repetition penalty of 3 over a reused prefix that
    holds the tokens the model generates unpenalized: the reused tokens
    are counted as if prefilled, so both waves equal the JAX engine's
    and the port's with no prefix reuse -- and differ when the port
    skips those counts (the check has teeth)."""
    route_w4a8tl(monkeypatch)
    kw = dict(kv_layout=layout, kv_num_blocks=64 if layout == "paged" else 0,
              **te.UNPIPELINED)
    liked = sorted({t for out in serve_waves(
        _port_engine(model, enable_prefix_cache=False, **kw), WAVES)
        for wave in out for t in wave})
    shared = (SHARED[:32 - 2 * len(liked)] + liked * 2)[:32]
    waves = [[shared + p[32:] for p in wave] for wave in WAVES]
    pen = dict(repetition_penalty=3.0)
    got = serve_waves(_port_engine(model, **kw), waves, **pen)
    assert got == serve_waves(_jax_engine(model, **kw), waves, **pen)
    assert got == serve_waves(
        _port_engine(model, enable_prefix_cache=False, **kw), waves, **pen)
    uncounted = _port_engine(model, **kw)
    uncounted.runner.add_prompt_counts = lambda slot, tokens: None
    assert serve_waves(uncounted, waves, **pen)[1] != got[1]


def test_pipelined_preemption_completes(model):
    """The port's pipelined loop (depth 2, 8-step windows) on a 14-block
    paged pool with four requests, three times: every request completes
    within the bounded wait, sequences are preempted, and the tokens
    equal the port's unpipelined stream, which is the model's
    teacher-forced argmax with a clear margin at every position."""
    cfg, params = model[2:]
    base = dict(PREEMPT_KW, decode_multi_step=8)
    plain = serve_waves(_port_engine(model, pipeline_decode=False, **base),
                        [PREEMPT_PROMPTS], max_tokens=12)[0]
    for prompt, out in zip(PREEMPT_PROMPTS, plain):
        argmax, margins = te._margins(cfg, params, prompt, out)
        assert argmax == out and min(margins) > te.MARGIN
    for _ in range(3):
        engine = _port_engine(model, pipeline_decode=True, **base)
        assert serve_waves(engine, [PREEMPT_PROMPTS], max_tokens=12)[0] \
            == plain
        assert engine.scheduler.stats.preemptions >= 1
        assert engine.pool.num_free == 14
