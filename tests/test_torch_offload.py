"""The prefix cache's host offload tier: ferrum_tpu_torch against ferrum_tpu.

  - the four compression strategies (none, int8, int4, fp8) on f32, bf16
    and int8 blocks, in the engine's [L, page, kv_size] layout and in
    the [T, H, D] one: payload bytes, scales and decompressed values
    equal bit for bit (bf16 compared as its 16 bits);
  - the tier: put / get with the raw-vs-compressed rule per dtype, the
    LRU byte budget (saves, restores, drops, bytes held after every
    step of one script), and the JAX tier's loss on an int8 cache (its
    K and V compressed to int8 again and truncated on the way back),
    which the port keeps value for value (ROADMAP Queue 3);
  - the paged PrefixCache with a tier over fake block I/O: the same
    block ids, refcounts and stats as the JAX cache on one script;
  - both engines (tests/test_prefix_offload.py's model and settings) on
    f32, bf16 and int8 KV, with the tier's none and int8 strategies:
    serve, wait for the release, evict every block, serve again -- the
    same greedy tokens and the same tier counts.
"""

import time

import ml_dtypes
import numpy as np
import pytest
import torch

from torch_parity import flatten_jax_params

ALGOS = ("none", "int8", "int4", "fp8")
DTYPES = ("f32", "bf16", "int8")
# The engine's block layout [L, page, kv_size] and the [T, H, D] one.
LAYOUTS = {"engine": (2, 8, 64), "thd": (8, 4, 16)}


def _block(rng, dtype, shape):
    """A numpy block: normal values (x 3), bf16 through ml_dtypes, int8
    as a quantized cache holds them (within ±127)."""
    x = rng.standard_normal(shape).astype(np.float32) * 3
    if dtype == "int8":
        return np.clip(np.round(x * 20), -127, 127).astype(np.int8)
    if dtype == "bf16":
        return x.astype(ml_dtypes.bfloat16)
    return x


def _torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(x.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits_jax(x) -> np.ndarray:
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _same(jx, tx) -> bool:
    a, b = _bits_jax(jx), _bits(tx)
    return a.shape == b.shape and a.dtype == b.dtype \
        and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# The strategies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("algo", ALGOS)
def test_strategy_matches_jax_bit_for_bit(algo, dtype, layout):
    """compress: the payload (codes) and the f32 scales equal; decompress:
    the values equal bit for bit in the block's own dtype."""
    from ferrum_tpu.kv import compression as jc
    from ferrum_tpu_torch.kv import compression as tc

    seed = ALGOS.index(algo) * 10 + DTYPES.index(dtype)
    x = _block(np.random.default_rng(seed), dtype, LAYOUTS[layout])
    js, ts = jc.make_strategy(algo), tc.make_strategy(algo)
    jb, tb = js.compress(x), ts.compress(_torch(x))
    assert _same(jb.data, tb.data)
    assert (jb.scale is None) == (tb.scale is None)
    if jb.scale is not None:
        assert _same(jb.scale, tb.scale) and tb.scale.dtype == torch.float32
    assert tb.nbytes == jb.nbytes
    assert tb.original_shape == jb.original_shape
    assert (tb.algorithm, tb.params) == (jb.algorithm, jb.params)
    assert _same(js.decompress(jb), ts.decompress(tb))
    assert ts.compression_ratio() == js.compression_ratio()


def test_fp8_ties_take_the_lower_entry_as_jax():
    """Magnitudes exactly between two e4m3 entries (and on them, at 0,
    at the subnormal step and at 448) give the JAX codes: a tie takes
    the lower entry, where a round-half-even cast to float8 would not."""
    from ferrum_tpu.kv.compression import Fp8Compression as J
    from ferrum_tpu_torch.kv.compression import Fp8Compression as T

    table = J()._pos[:127]
    mids = (table[:-1] + table[1:]) / 2
    row = np.concatenate([table, mids, -mids, [0.0, 2.0 ** -10]]
                         ).astype(np.float32)
    # One row whose amax is 448, so the scale is exactly 1.
    x = row[None, None, :]
    jb, tb = J().compress(x), T().compress(torch.from_numpy(x))
    assert float(jb.scale.reshape(-1)[0]) == 1.0
    assert _same(jb.data, tb.data)
    assert _same(J().decompress(jb), T().decompress(tb))


def test_make_strategy_refuses_as_jax():
    from ferrum_tpu.kv.compression import make_strategy as jm
    from ferrum_tpu_torch.kv.compression import make_strategy as tm
    for fn in (jm, tm):
        with pytest.raises(ValueError, match="unknown compression"):
            fn("zstd")


# ---------------------------------------------------------------------------
# The tier
# ---------------------------------------------------------------------------

def _group(rng, dtype, layers=2, page=8, kv_heads=4, head_dim=16):
    """One block group as read_kv_block gives it: (k, v) [L, page,
    kv_size], and for an int8 cache the f32 scale planes [L, page,
    kv_heads] too."""
    shape = (layers, page, kv_heads * head_dim)
    out = [_block(rng, dtype, shape), _block(rng, dtype, shape)]
    if dtype == "int8":
        out += [rng.random((layers, page, kv_heads), np.float32)
                for _ in range(2)]
    return tuple(out)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("algo", ALGOS)
def test_tier_put_get_matches_jax(algo, dtype):
    """The raw-vs-compressed rule per array (an f32 array of < 4 dims is
    kept raw: an f32 cache's K and V, an int8 cache's scale planes),
    bytes held, and the restored arrays bit for bit."""
    from ferrum_tpu.kv.compression import HostOffloadTier as JT
    from ferrum_tpu.kv.compression import make_strategy as jm
    from ferrum_tpu_torch.kv.compression import HostOffloadTier as TT
    from ferrum_tpu_torch.kv.compression import make_strategy as tm

    group = _group(np.random.default_rng(7), dtype)
    jt, tt = JT(1 << 24, jm(algo)), TT(1 << 24, tm(algo))
    jt.put(11, group)
    tt.put(11, tuple(_torch(a) for a in group))
    jcomp, tcomp = jt._blocks[11][0], tt._blocks[11][0]
    assert [c.algorithm for c in tcomp] == [c.algorithm for c in jcomp]
    if dtype == "f32":
        assert all(c.algorithm == "none" for c in tcomp)
    if dtype == "int8":
        assert [c.algorithm for c in tcomp[2:]] == ["none", "none"]
        assert tcomp[0].algorithm == algo
    assert tt.stats.bytes_held == jt.stats.bytes_held > 0
    got, want = tt.get(11), jt.get(11)
    assert len(got) == len(want)
    assert all(_same(w, g) for w, g in zip(want, got))
    assert tt.get(12) is None and jt.get(12) is None
    assert vars(tt.stats) == vars(jt.stats)


@pytest.mark.parametrize("algo", ["none", "int8", "int4"])
def test_tier_lru_budget_matches_jax(algo):
    """One script of puts, repeated puts, gets and misses under a budget
    of ~2.5 block groups: after every step the same stats and the same
    held hashes in LRU order; a group over the whole budget is not
    kept."""
    from ferrum_tpu.kv.compression import HostOffloadTier as JT
    from ferrum_tpu.kv.compression import make_strategy as jm
    from ferrum_tpu_torch.kv.compression import HostOffloadTier as TT
    from ferrum_tpu_torch.kv.compression import make_strategy as tm

    rng = np.random.default_rng(3)
    groups = {h: _group(rng, "bf16") for h in range(1, 7)}
    probe = JT(1 << 30, jm(algo))
    probe.put(0, groups[1])
    budget = int(2.5 * probe.stats.bytes_held)
    jt, tt = JT(budget, jm(algo)), TT(budget, tm(algo))
    script = [("put", 1), ("put", 2), ("get", 1), ("put", 3), ("put", 2),
              ("get", 9), ("put", 4), ("get", 3), ("put", 5), ("put", 1),
              ("get", 5), ("put", 6), ("get", 4)]
    for op, h in script:
        if op == "put":
            jt.put(h, groups[h])
            tt.put(h, tuple(_torch(a) for a in groups[h]))
        else:
            assert (jt.get(h) is None) == (tt.get(h) is None)
        assert vars(tt.stats) == vars(jt.stats), (op, h)
        assert list(tt._blocks) == list(jt._blocks), (op, h)
        assert tt.stats.bytes_held <= budget
    assert jt.stats.drops > 0
    tiny_j, tiny_t = JT(16, jm(algo)), TT(16, tm(algo))
    tiny_j.put(1, groups[1])
    tiny_t.put(1, tuple(_torch(a) for a in groups[1]))
    assert 1 not in tiny_t and 1 not in tiny_j
    assert vars(tiny_t.stats) == vars(tiny_j.stats)


def test_int8_cache_recompressed_and_truncated_as_jax():
    """The JAX tier's loss on an int8 cache (ROADMAP Queue 3): an int8
    K block [2, 8, 64] within ±60 goes through the int8 strategy again
    (scale amax / 127 per row), and decompress truncates q * scale back
    to int8, so values come back one step short. The port gives the
    same values, and the same count of changed ones."""
    from ferrum_tpu.kv.compression import HostOffloadTier as JT
    from ferrum_tpu_torch.kv.compression import HostOffloadTier as TT

    rng = np.random.default_rng(0)
    k = np.clip(np.round(rng.standard_normal((2, 8, 64)) * 30), -60,
                60).astype(np.int8)
    scales = rng.random((2, 8, 4), np.float32)
    group = (k, k.copy(), scales, scales.copy())
    jt, tt = JT(1 << 24), TT(1 << 24)
    jt.put(5, group)
    tt.put(5, tuple(_torch(a) for a in group))
    want, got = jt.get(5), tt.get(5)
    assert all(_same(w, g) for w, g in zip(want, got))
    diff = np.abs(got[0].numpy().astype(np.int32) - k.astype(np.int32))
    assert diff.max() == 1 and (diff > 0).sum() > 0
    assert np.array_equal(got[2].numpy(), scales)     # raw scale planes


# ---------------------------------------------------------------------------
# PrefixCache + tier, fake block I/O (tests/test_prefix_offload.py's)
# ---------------------------------------------------------------------------

PAGE = 4


def _cache_pair(num_blocks, algo="none", policy="lru"):
    """A JAX and a port cache over pools of `num_blocks`, each with a
    tier and block I/O that reads block b as (b, -b) and records writes."""
    from ferrum_tpu.kv.block_pool import BlockPool as JPool
    from ferrum_tpu.kv.compression import HostOffloadTier as JT
    from ferrum_tpu.kv.compression import make_strategy as jm
    from ferrum_tpu.kv.prefix_cache import PrefixCache as JCache
    from ferrum_tpu_torch.kv.block_pool import BlockPool
    from ferrum_tpu_torch.kv.compression import HostOffloadTier as TT
    from ferrum_tpu_torch.kv.compression import make_strategy as tm
    from ferrum_tpu_torch.kv.prefix_cache import PrefixCache

    out = []
    for pool_cls, cache_cls, tier, array in (
            (JPool, JCache, JT(1 << 24, jm(algo)),
             lambda v: np.full((1, PAGE, 8), v, np.float32)),
            (BlockPool, PrefixCache, TT(1 << 24, tm(algo)),
             lambda v: torch.full((1, PAGE, 8), v, dtype=torch.float32))):
        pool = pool_cls(num_blocks, PAGE)
        writes = []
        cache = cache_cls(
            pool, enabled=True, policy=policy, offload=tier,
            block_io=(lambda b, a=array: (a(float(b)), a(-float(b))),
                      lambda b, arrays, w=writes: w.append(
                          (b, float(arrays[0][0, 0, 0])))))
        out.append((pool, cache, tier, writes))
    return out


def _snapshot(pool, cache, tier, writes):
    st = cache.stats
    return (pool.num_free, sorted(pool._refcount.items()), st.hits,
            st.misses, st.saved_prefill_tokens, st.cached_blocks,
            st.evictions, list(cache._by_hash.items()), len(tier),
            vars(tier.stats), list(writes))


@pytest.mark.parametrize("policy", ["lru", "fifo", "clock"])
def test_prefix_cache_spill_and_restore_match_jax(policy):
    """tests/test_prefix_offload.py::test_prefix_cache_spills_and_restores
    on both caches: insert two full blocks, release, match, evict all
    (both spill), match again (both restored into new blocks, written
    through block_io): equal block ids, refcounts, stats, writes."""
    pair = _cache_pair(8, policy=policy)
    toks = list(range(PAGE * 2 + 1))
    results = []
    for pool, cache, tier, writes in pair:
        steps = []
        blocks = pool.allocate(2)
        cache.insert(toks, blocks)
        for b in blocks:
            pool.free(b)
        steps.append(cache.match_prefix(toks))
        steps.append(cache.evict(min_free_target=pool.num_blocks))
        steps.append(_snapshot(pool, cache, tier, writes))
        steps.append(cache.match_prefix(toks))
        steps.append(_snapshot(pool, cache, tier, writes))
        results.append(steps)
    assert results[0] == results[1]
    assert pair[1][2].stats.saves == 2 and pair[1][2].stats.restores == 2


def test_prefix_cache_restore_needs_a_free_block_as_jax():
    """No eviction cascade: with the pool exhausted, a chain that reaches
    an offloaded block stops there in both caches."""
    pair = _cache_pair(2)
    toks = list(range(PAGE + 1))
    results = []
    for pool, cache, tier, writes in pair:
        b0 = pool.allocate(1)
        cache.insert(toks, b0)
        pool.free(b0[0])
        cache.evict(min_free_target=pool.num_blocks)
        pool.allocate(2)
        results.append((cache.match_prefix(toks),
                        _snapshot(pool, cache, tier, writes)))
    assert results[0] == results[1]
    assert results[1][0] == ([], 0)


# ---------------------------------------------------------------------------
# Engines (tests/test_prefix_offload.py's fixture)
# ---------------------------------------------------------------------------

SERVE_TIMEOUT_S = 120.0
PROMPT = list(range(10, 10 + 33))          # 4 full blocks + 1 token


def _engine_cfg(kv_dtype, algo):
    return dict(max_num_seqs=2, kv_num_blocks=64, kv_block_size=8,
                max_model_len=256, max_num_batched_tokens=128,
                prefill_chunk_size=32, enable_prefix_cache=True,
                kv_layout="paged", prefix_offload_mb=16,
                prefix_offload_algo=algo, kv_dtype=kv_dtype, seed=0)


def _model():
    import jax.numpy as jnp
    from ferrum_tpu.models.configs import ModelConfig
    from ferrum_tpu.models.llama_family import init_random_params

    mc = ModelConfig(
        family="qwen3", vocab_size=512, hidden_size=64, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
        qk_norm=True, tie_word_embeddings=True, rope_theta=10000.0,
        eos_token_ids=(257,))
    return mc, init_random_params(mc, seed=0, dtype=jnp.float32)


def _wait_released(eng):
    deadline = time.monotonic() + SERVE_TIMEOUT_S
    while eng.scheduler.running or eng._inflight_q:
        assert time.monotonic() < deadline, "the sequence was not released"
        time.sleep(0.02)


def _serve_evict_serve(eng, req):
    """Serve, wait for the release, evict every block (each spills),
    serve again: (tokens, tokens, tier stats after each phase)."""
    first = eng.infer(req()).token_ids
    _wait_released(eng)
    cache = eng.prefix_cache
    cache.evict(min_free_target=eng.pool.num_blocks)
    spilled = dict(vars(cache.offload.stats))
    again = eng.infer(req()).token_ids
    return first, again, spilled, dict(vars(cache.offload.stats))


@pytest.mark.parametrize("algo", ["none", "int8"])
@pytest.mark.parametrize("kv_dtype", DTYPES)
def test_engine_offload_matches_jax_engine(kv_dtype, algo):
    """Serve the 33-token prompt (8 greedy tokens), evict every cached
    block into the tier, serve it again from the restored blocks: the
    port's tokens of both serves and its tier counts (saves, restores,
    drops, bytes held) equal the JAX engine's."""
    from ferrum_tpu.config import EngineConfig as JConfig
    from ferrum_tpu.engine.builder import EngineBuilder as JBuilder
    from ferrum_tpu.tokenizer import make_byte_tokenizer as jtok
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.types import SamplingParams as JSamp
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    from torch_parity import torch_config

    jmc, jparams = _model()
    jeng = JBuilder(JConfig(model="test", dtype="f32",
                            **_engine_cfg(kv_dtype, algo))) \
        .with_model(jmc, jparams).with_tokenizer(jtok(vocab_extra=512 - 258)).build()
    try:
        want = _serve_evict_serve(jeng, lambda: JReq(
            prompt_token_ids=list(PROMPT),
            sampling=JSamp(temperature=0.0, max_tokens=8, ignore_eos=True)))
    finally:
        jeng.stop()
    eng = EngineBuilder(EngineConfig(device="cpu",
                                     **_engine_cfg(kv_dtype, algo))) \
        .with_model(torch_config(jmc),
                    params_from_numpy(flatten_jax_params(jparams), "cpu")) \
        .build()
    try:
        assert eng.prefix_cache.offload is not None
        got = _serve_evict_serve(eng, lambda: InferenceRequest(
            prompt_token_ids=list(PROMPT),
            sampling=SamplingParams(temperature=0.0, max_tokens=8,
                                    ignore_eos=True)))
        audit = [k for site, k in eng.runner.compile_log
                 if site == "kv_block_io"]
    finally:
        eng.stop()
    assert got == want
    assert got[2]["saves"] >= 4 and got[3]["restores"] >= 4
    assert audit == [(kv_dtype == "int8", "paged", kv_dtype)]


@pytest.mark.parametrize("layout,prefix,mb", [
    ("paged", True, 16), ("paged", False, 16), ("linear", True, 16),
    ("paged", True, 0)])
def test_tier_built_only_on_paged_with_prefix_cache(layout, prefix, mb):
    """As the JAX engine: the tier exists only on the paged layout with
    the prefix cache on and a budget above 0."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from torch_parity import torch_config

    jmc, jparams = _model()
    from ferrum_tpu_torch.models.convert import params_from_numpy
    cfg = EngineConfig(device="cpu", **{
        **_engine_cfg("f32", "int8"), "kv_layout": layout,
        "enable_prefix_cache": prefix, "prefix_offload_mb": mb,
        "prefix_cache_blocks": 8})
    eng = EngineBuilder(cfg).with_model(
        torch_config(jmc),
        params_from_numpy(flatten_jax_params(jparams), "cpu")).build()
    try:
        tier = getattr(eng.prefix_cache, "offload", None)
        assert (tier is not None) == (layout == "paged" and prefix
                                      and mb > 0)
        if tier is not None:
            assert tier.capacity_bytes == mb << 20
            assert tier.strategy.name == "int8"
    finally:
        eng.stop()


def test_config_fields_and_env_match_jax():
    """prefix_offload_mb / _algo: the JAX defaults, its FERRUM_* names and
    help strings; no longer in NOT_PORTED; an unknown algorithm is
    refused naming the field."""
    from ferrum_tpu import config as jc
    from ferrum_tpu_torch import config as tc
    from ferrum_tpu_torch.types import InvalidRequestError

    for name in ("prefix_offload_mb", "prefix_offload_algo"):
        assert getattr(tc.EngineConfig(), name) \
            == getattr(jc.EngineConfig(), name)
        assert name not in tc.NOT_PORTED
    for env in ("FERRUM_PREFIX_OFFLOAD_MB", "FERRUM_PREFIX_OFFLOAD_ALGO"):
        assert tc.ENV_REGISTRY[env] == jc.ENV_REGISTRY[env]
        assert env not in tc.NOT_PORTED_ENV
    cfg = tc.EngineConfig.resolve(environ={
        "FERRUM_PREFIX_OFFLOAD_MB": "64", "FERRUM_PREFIX_OFFLOAD_ALGO": "fp8"})
    assert (cfg.prefix_offload_mb, cfg.prefix_offload_algo) == (64, "fp8")
    with pytest.raises(InvalidRequestError, match="prefix_offload_algo"):
        tc.EngineConfig(prefix_offload_algo="zstd").validate()
