"""Gemma 3 and windowed attention: ferrum_tpu_torch vs ferrum_tpu, on the CPU.

- Every attention form of the port (flat decode with and without a
  decode window's in-window terms, the prefill-in-window block, flat
  prefill, the paged layout's decode and prefill) against the JAX
  function on the same inputs: sliding window None / 3 / 8 x softcap
  None / 50, a bf16 cache and an int8 one (values with f32 scales);
- the one place the port departs: a decode window whose steps reach past
  a layer's sliding window. The JAX window form lets every in-window
  term in (ROADMAP Queue 3); the port windows them, so its window form
  equals its per-step form there too;
- tiny gemma3 trunks (the tests/test_hf_parity.py dict, a 6-layer
  `sliding_window_pattern` 6 config with both softcaps and linear rope
  scaling, explicit `layer_types`) with every norm weight random, so the
  (1 + w) form is exercised: the teacher-forced forward (forward_hidden
  and logits_from_hidden), batched prefill and decode steps on both
  layouts, and a decode window of 4 steps with a prefill block riding
  it, each against the JAX package on weights carried by
  `params_from_numpy`;
- both engines' greedy streams on tiny gemma3 and tiny mistral with a
  window, prompts longer than the window, linear and paged layouts, the
  pipelined loop at c = 1 and c = 4 (windows of at most 6 steps inside
  the window of 8, where the two window forms agree).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (flatten_jax_params, jax_model, route_w4a8tl,
                          torch_config)

TOL = dict(rtol=1e-5, atol=1e-5)
HQ, HKV, D = 4, 2, 16
F = HKV * D
SCALE = 0.25
WINDOWS = [None, 3, 8]
CAPS = [None, 50.0]
KV = ["bf16", "int8"]


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# Attention forms
# ---------------------------------------------------------------------------

class _Kv:
    """One form's inputs in both packages' forms. "bf16": q, cache and new
    K/V rounded to bf16 (both see the same values); "int8": f32 q and new
    K/V, an int8 cache with f32 scales per (token, kv head)."""

    def __init__(self, kind, seed):
        self.kind = kind
        self.rng = np.random.default_rng(seed)

    def act(self, *shape, std=3.0):
        """A float operand: (jax array, torch tensor)."""
        a = self.rng.normal(0, std, shape).astype(np.float32)
        if self.kind == "bf16":
            t = torch.from_numpy(a).to(torch.bfloat16)
            return jnp.asarray(t.float().numpy(), jnp.bfloat16), t
        return jnp.asarray(a), torch.from_numpy(a)

    def cache(self, *shape):
        """A flat cache [..., C, F]: (jax, torch, jax scales, torch scales),
        scales [..., C, Hkv] or None."""
        if self.kind == "bf16":
            return self.act(*shape, std=1.0) + (None, None)
        q = self.rng.integers(-127, 128, shape).astype(np.int8)
        s = self.rng.uniform(0.002, 0.02, shape[:-1] + (HKV,)
                             ).astype(np.float32)
        return jnp.asarray(q), _t(q), jnp.asarray(s), _t(s)

    def paged(self, nb, page):
        """A paged cache [NB, page, Hkv, D], an int8 one dequantized to f32
        (as both packages hand it to the reference form)."""
        jc, tc, js, ts = self.cache(nb, page, F)
        if js is None:
            return jc.reshape(nb, page, HKV, D), tc.view(nb, page, HKV, D)
        deq = (np.asarray(jc, np.float32).reshape(nb, page, HKV, D)
               * np.asarray(js)[..., None])
        return jnp.asarray(deq), _t(deq)

    def check(self, got, want):
        """f32 / int8: 1e-5. bf16 outputs: within one bf16 step at the
        output's scale, 2% of them off (a bf16 rounding of a probability
        or an output on the other side after f32 sums taken in another
        order; tests/test_torch_ops.py's bf16 rule)."""
        want = np.asarray(jnp.asarray(want, jnp.float32))
        got = got.float().numpy()
        if self.kind == "bf16":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=2 ** -7 * np.abs(want).max())
            assert np.mean(got != want) <= 0.02
        else:
            np.testing.assert_allclose(got, want, **TOL)


def _decode(kv, sw, cap, window):
    from ferrum_tpu.ops.attention import flat_decode_attention as jfn
    from ferrum_tpu_torch.ops.attention import flat_decode_attention as tfn
    s, c, t = 3, 32, 4
    jq, tq = kv.act(s, HQ, D)
    jk, tk, jks, tks = kv.cache(s, c, F)
    jv, tv, jvs, tvs = kv.cache(s, c, F)
    jkn, tkn = kv.act(s, HKV, D, std=1.0)
    jvn, tvn = kv.act(s, HKV, D, std=1.0)
    kw = dict(hkv=HKV, scale=SCALE, sliding_window=sw, softcap=cap)
    jw, tw = dict(k_scale=jks, v_scale=jvs), dict(k_scale=tks, v_scale=tvs)
    if window:
        # The window's last step inside every window tested (2 < 3).
        step = 2 if sw is not None else t - 1
        cache_len = np.array([1, 20, 0], np.int32)   # lane 2: a pad lane
        lens = cache_len + step
        valid = np.broadcast_to(np.arange(t)[None] < step, (s, t))
        jkw, tkw = kv.act(t, s, HKV, D, std=1.0)
        jvw, tvw = kv.act(t, s, HKV, D, std=1.0)
        jw.update(k_win=jkw, v_win=jvw, win_valid=jnp.asarray(valid),
                  cache_len=cache_len)
        tw.update(k_win=tkw, v_win=tvw, win_valid=_t(valid),
                  cache_len=_t(cache_len))
    else:
        lens = np.array([1, 9, 32], np.int32)       # 1: the self term only
    want = jfn(jq, jk, jv, lens, jkn, jvn, **kw, **jw)
    got = tfn(tq, tk, tv, _t(lens), tkn, tvn, **kw, **tw)
    kv.check(got, want)


def _prefill_window(kv, sw, cap):
    from ferrum_tpu.ops.attention import flat_prefill_window_attention as jfn
    from ferrum_tpu_torch.ops.attention import (
        flat_prefill_window_attention as tfn)
    p, c, start, t, step, valid_len = 8, 16, 5, 4, 3, 26
    jq, tq = kv.act(p, HQ, D)
    jk, tk, jks, tks = kv.cache(c, F)
    jv, tv, jvs, tvs = kv.cache(c, F)
    jwk, twk = kv.act(t, p, HKV, D, std=1.0)
    jwv, twv = kv.act(t, p, HKV, D, std=1.0)
    jkn, tkn = kv.act(p, HKV, D, std=1.0)
    jvn, tvn = kv.act(p, HKV, D, std=1.0)
    rows = step * p + np.arange(p)
    pos = np.where(rows < valid_len, start + rows,
                   (1 << 16) + rows).astype(np.int32)
    kw = dict(hkv=HKV, scale=SCALE, sliding_window=sw, softcap=cap)
    want = jfn(jq, jk, jv, jnp.int32(start), jwk, jwv, jnp.int32(step),
               jnp.int32(start), jnp.int32(valid_len), jkn, jvn, pos,
               k_scale=jks, v_scale=jvs, **kw)
    got = tfn(tq, tk, tv, start, twk, twv, step, start, valid_len, tkn,
              tvn, _t(pos), k_scale=tks, v_scale=tvs, **kw)
    kv.check(got, want)


def _prefill(kv, sw, cap):
    from ferrum_tpu.ops.attention import flat_prefill_attention as jfn
    from ferrum_tpu_torch.ops.attention import flat_prefill_attention as tfn
    b, t, c = 2, 8, 16
    jq, tq = kv.act(b, t, HQ, D)
    jk, tk, jks, tks = kv.cache(b, c, F)
    jv, tv, jvs, tvs = kv.cache(b, c, F)
    jkn, tkn = kv.act(b, t, HKV, D, std=1.0)
    jvn, tvn = kv.act(b, t, HKV, D, std=1.0)
    # row 0: an 11-token prefix + 8 chunk tokens; row 1: a fresh 6-token
    # chunk and two pad rows.
    pos = np.array([np.arange(11, 19), [0, 1, 2, 3, 4, 5, 99, 100]],
                   np.int32)
    total = np.array([19, 6], np.int32)
    kw = dict(hkv=HKV, scale=SCALE, sliding_window=sw, softcap=cap)
    if jks is None:
        want = jax.vmap(lambda *a: jfn(*a, **kw))(jq, jk, jv, pos, total,
                                                  jkn, jvn)
    else:
        want = jax.vmap(lambda *a: jfn(*a[:7], k_scale=a[7], v_scale=a[8],
                                       **kw))(jq, jk, jv, pos, total, jkn,
                                              jvn, jks, jvs)
    got = tfn(tq, tk, tv, _t(pos), _t(total), tkn, tvn, k_scale=tks,
              v_scale=tvs, **kw)
    real = pos < total[:, None]
    kv.check(got[_t(real)], np.asarray(jnp.asarray(want, jnp.float32))[real])


def _paged_decode(kv, sw, cap):
    from ferrum_tpu.ops.attention import paged_decode_attention_ref as jfn
    from ferrum_tpu_torch.ops.attention import (
        paged_decode_attention_ref as tfn)
    s, page, nb, ctx = 3, 8, 12, 32
    jq, tq = kv.act(s, HQ, D)
    jk, tk = kv.paged(nb, page)
    jv, tv = kv.paged(nb, page)
    jkn, tkn = kv.act(s, HKV, D, std=1.0)
    jvn, tvn = kv.act(s, HKV, D, std=1.0)
    tables = kv.rng.permutation(nb)[:s * 4].reshape(s, 4).astype(np.int32)
    lens = np.array([1, 13, 32], np.int32)
    kw = dict(ctx_pad=ctx, scale=SCALE, sliding_window=sw, softcap=cap)
    for jself, tself in (({}, {}), (dict(k_self=jkn, v_self=jvn),
                                    dict(k_self=tkn, v_self=tvn))):
        want = jfn(jq, jk, jv, tables, lens, **kw, **jself)
        got = tfn(tq, tk, tv, _t(tables), _t(lens), **kw, **tself)
        kv.check(got, want)


def _paged_prefill(kv, sw, cap):
    from ferrum_tpu.ops.attention import paged_prefill_attention_ref as jfn
    from ferrum_tpu_torch.ops.attention import (
        paged_prefill_attention_ref as tfn)
    t, page, nb, ctx = 8, 8, 6, 24
    jq, tq = kv.act(t, HQ, D)
    jk, tk = kv.paged(nb, page)
    jv, tv = kv.paged(nb, page)
    table = kv.rng.permutation(nb)[:3].astype(np.int32)
    pos = np.array([12, 13, 14, 15, 16, 17, 99, 100], np.int32)
    kw = dict(ctx_pad=ctx, scale=SCALE, sliding_window=sw, softcap=cap)
    want = jfn(jq, jk, jv, table, pos, jnp.int32(18), **kw)
    got = tfn(tq, tk, tv, _t(table), _t(pos), torch.tensor(18), **kw)
    real = pos < 18
    kv.check(got[_t(real)], np.asarray(jnp.asarray(want, jnp.float32))[real])


FORMS = {
    "decode": functools.partial(_decode, window=False),
    "decode_window": functools.partial(_decode, window=True),
    "prefill_window": _prefill_window,
    "prefill": _prefill,
    "paged_decode": _paged_decode,
    "paged_prefill": _paged_prefill,
}


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("sw", WINDOWS)
@pytest.mark.parametrize("form", list(FORMS))
def test_attention_forms_match_jax(form, sw, cap):
    """Each attention form with a sliding window and a softcap equals the
    JAX function, with a bf16 cache and with an int8 one (tolerances:
    `_Kv.check`)."""
    seed = 12 * list(FORMS).index(form) + 4 * WINDOWS.index(sw) \
        + 2 * CAPS.index(cap)
    for i, kind in enumerate(KV):
        FORMS[form](_Kv(kind, seed + i), sw, cap)


def test_window_masks_bite():
    """The cases above see the window: the same decode and prefill inputs
    give other outputs without it."""
    from ferrum_tpu_torch.ops.attention import (flat_decode_attention,
                                                flat_prefill_attention)
    rng = np.random.default_rng(1)
    f32 = lambda *sh: _t(rng.normal(0, 1, sh).astype(np.float32))  # noqa
    q, k, v = f32(2, HQ, D), f32(2, 32, F), f32(2, 32, F)
    kn, vn = f32(2, HKV, D), f32(2, HKV, D)
    lens = _t(np.array([20, 32]))
    outs = [flat_decode_attention(q, k, v, lens, kn, vn, hkv=HKV,
                                  scale=SCALE, sliding_window=sw,
                                  softcap=cap)
            for sw, cap in ((None, None), (8, None), (None, 1.0))]
    assert not torch.allclose(outs[0], outs[1])
    assert not torch.allclose(outs[0], outs[2])
    qp, kp, vp = f32(8, HQ, D), f32(16, F), f32(16, F)
    pos = _t(np.arange(16, 24))
    a, b = (flat_prefill_attention(qp, kp, vp, pos, torch.tensor(24),
                                   f32(8, HKV, D), f32(8, HKV, D), hkv=HKV,
                                   scale=SCALE, sliding_window=sw)
            for sw in (None, 3))
    assert not torch.allclose(a, b)


@pytest.mark.parametrize("sw", [3, 8])
def test_window_terms_past_the_window(sw):
    """A decode window whose step reaches past the sliding window (step 5,
    4 rows of the window before it). The JAX window form lets every
    in-window term in: it differs from the same attention with those rows
    cached (its per-step form). The port windows the in-window terms: its
    window form equals that per-step attention (f32, 1e-5) at sw = 3, and
    at sw = 8 (the window still covers them) both packages agree."""
    from ferrum_tpu.ops.attention import flat_decode_attention as jfn
    from ferrum_tpu_torch.ops.attention import flat_decode_attention as tfn
    rng = np.random.default_rng(sw)
    s, c, t, step = 2, 32, 6, 5
    f32 = lambda *sh: rng.normal(0, 1, sh).astype(np.float32)  # noqa
    q, k, v = f32(s, HQ, D), f32(s, c, F), f32(s, c, F)
    kw_, vw_ = f32(t, s, HKV, D), f32(t, s, HKV, D)
    cache_len = np.array([4, 12], np.int32)
    lens = cache_len + step
    valid = np.broadcast_to(np.arange(t)[None] < step, (s, t))
    kn, vn = kw_[step], vw_[step]
    # The per-step view: the window's rows before `step` in the cache.
    kc, vc = k.copy(), v.copy()
    for j in range(step):
        for lane in range(s):
            kc[lane, cache_len[lane] - 1 + j] = kw_[j, lane].reshape(F)
            vc[lane, cache_len[lane] - 1 + j] = vw_[j, lane].reshape(F)
    kw = dict(hkv=HKV, scale=SCALE, sliding_window=sw)
    per_step = jfn(q, kc, vc, lens, kn, vn, **kw)
    jax_win = jfn(q, k, v, lens, kn, vn, k_win=kw_, v_win=vw_,
                  win_valid=jnp.asarray(valid), cache_len=cache_len, **kw)
    port_win = tfn(_t(q), _t(k), _t(v), _t(lens), _t(kn), _t(vn),
                   k_win=_t(kw_), v_win=_t(vw_), win_valid=_t(valid),
                   cache_len=_t(cache_len), **kw)
    port_step = tfn(_t(q), _t(kc), _t(vc), _t(lens), _t(kn), _t(vn), **kw)
    np.testing.assert_allclose(port_step.numpy(), np.asarray(per_step),
                               **TOL)
    np.testing.assert_allclose(port_win.numpy(), np.asarray(per_step),
                               **TOL)
    if sw > step:
        np.testing.assert_allclose(np.asarray(jax_win),
                                   np.asarray(per_step), **TOL)
    else:
        assert np.abs(np.asarray(jax_win) - np.asarray(per_step)).max() \
            > 1e-2


# ---------------------------------------------------------------------------
# Tiny gemma3 trunks
# ---------------------------------------------------------------------------

# tests/test_hf_parity.py's gemma3 dict.
HF_PARITY = dict(
    architectures=["Gemma3ForCausalLM"], vocab_size=128, hidden_size=64,
    num_hidden_layers=4, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16, intermediate_size=128, rms_norm_eps=1e-6,
    rope_theta=10000.0, rope_local_base_freq=10000.0, sliding_window=8,
    query_pre_attn_scalar=16.0,
    layer_types=["sliding_attention", "sliding_attention",
                 "sliding_attention", "full_attention"],
    max_position_embeddings=512, tie_word_embeddings=True)
GEMMA_CONFIGS = {
    "hf_parity": HF_PARITY,
    # Layers 0-4 local, layer 5 global; both softcaps; the global layers'
    # table scaled linearly, the local ones' not.
    "pattern6": dict(
        HF_PARITY, num_hidden_layers=6, layer_types=None,
        sliding_window_pattern=6, sliding_window=6, rope_theta=100000.0,
        rope_scaling=dict(rope_type="linear", factor=4.0),
        final_logit_softcapping=3.0, attn_logit_softcapping=2.0,
        query_pre_attn_scalar=24.0, tie_word_embeddings=False),
    "layer_types": dict(
        HF_PARITY, architectures=["Gemma3ForConditionalGeneration"],
        layer_types=["full_attention", "sliding_attention",
                     "full_attention", "sliding_attention"],
        sliding_window=5, final_logit_softcapping=5.0),
}


def gemma_model(name, seed=0):
    """(jax cfg, jax params f32 with every norm weight random, the port's
    cfg, the port's params) of a GEMMA_CONFIGS entry."""
    from ferrum_tpu.models.configs import config_from_hf_dict
    from ferrum_tpu.models.llama_family import init_random_params
    from ferrum_tpu_torch.models.convert import params_from_numpy

    d = {k: v for k, v in GEMMA_CONFIGS[name].items() if v is not None}
    if d["architectures"] == ["Gemma3ForConditionalGeneration"]:
        d = {"architectures": d["architectures"], "text_config": d}
    jcfg = config_from_hf_dict(d)
    jparams = init_random_params(jcfg, seed=seed, dtype=jnp.float32)
    rng = np.random.default_rng(seed + 100)

    def rnd(a):
        return jnp.asarray(rng.normal(0, 0.3, a.shape), jnp.float32)

    for lp in jparams.layers:
        for f in ("input_norm", "q_norm", "k_norm", "post_attn_norm",
                  "pre_mlp_norm", "post_mlp_norm"):
            setattr(lp, f, rnd(getattr(lp, f)))
    jparams.final_norm = rnd(jparams.final_norm)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    return jcfg, jparams, torch_config(jcfg), params


@pytest.mark.parametrize("name", list(GEMMA_CONFIGS))
def test_gemma3_config_maps_as_jax(name):
    """The port's config_from_hf_dict gives the JAX one's ModelConfig,
    field for field; per-layer windows and the attention scale too."""
    from ferrum_tpu.models.configs import config_from_hf_dict as jmap
    from ferrum_tpu_torch.models.configs import config_from_hf_dict

    d = {k: v for k, v in GEMMA_CONFIGS[name].items() if v is not None}
    if d["architectures"] == ["Gemma3ForConditionalGeneration"]:
        d = {"architectures": d["architectures"], "text_config": d}
    want, got = jmap(d), config_from_hf_dict(d)
    assert got == torch_config(want)
    for li in range(got.num_layers):
        assert got.layer_sliding_window(li) == want.layer_sliding_window(li)
    assert got.attn_scale == want.attn_scale
    assert got.family == "gemma3" and got.sandwich_norms


@pytest.mark.parametrize("name", list(GEMMA_CONFIGS))
def test_teacher_forced_logits_match_jax(name):
    """forward_hidden (embedding scale, (1 + w) norms, sandwich norms,
    GeGLU, local and global RoPE) and logits_from_hidden (final softcap)
    under the plain causal attention with each layer's window and the
    attention softcap: `bench/accuracy.py`'s teacher_forced_logits of
    both packages, 20 tokens, f32, 1e-5 of the logit scale."""
    from ferrum_tpu.bench.accuracy import teacher_forced_logits as jtf
    from ferrum_tpu_torch.bench.accuracy import teacher_forced_logits

    jcfg, jparams, cfg, params = gemma_model(name)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, 20)
    want = np.asarray(jtf(jparams, jcfg, toks.tolist()))
    got = teacher_forced_logits(params, cfg, toks.tolist()).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


SLOTS, PAGE, MAX_LEN, CTX, T_PAD = 2, 8, 64, 32, 24
PROMPT_LENS = (19, 11)
DECODE_STEPS = 4


def _trunk_inputs(vocab):
    rng = np.random.default_rng(5)
    tokens = np.zeros((SLOTS, T_PAD), np.int32)
    positions = np.full((SLOTS, T_PAD), MAX_LEN + CTX, np.int32)
    flat = np.full((SLOTS, T_PAD), 1 << 30, np.int32)
    for s, n in enumerate(PROMPT_LENS):
        tokens[s, :n] = rng.integers(0, vocab, n)
        positions[s, :n] = np.arange(n)
        flat[s, :n] = s * MAX_LEN + np.arange(n)
    pages = MAX_LEN // PAGE
    tables = (np.arange(SLOTS)[:, None] * pages
              + np.arange(pages)[None, :]).astype(np.int32)
    return tokens, positions, flat, tables, np.asarray(PROMPT_LENS, np.int32)


def _jax_trunk(cfg, params, inputs, impl):
    from ferrum_tpu.models.llama_family import (
        PagedKvCache, decode_forward, logits_from_hidden,
        prefill_forward_batched)

    tokens, positions, flat, tables, lens = inputs
    kv = PagedKvCache.create(cfg, SLOTS * MAX_LEN // PAGE, PAGE,
                             dtype=jnp.float32)
    h, kv = prefill_forward_batched(
        params, cfg, kv, tokens, positions, tables, lens, flat,
        ctx_pad=CTX, attn_impl=impl, append="pages")
    out = [np.asarray(logits_from_hidden(params, cfg,
                                         h.reshape(-1, h.shape[-1])))]
    last = out[0].reshape(SLOTS, T_PAD, -1)[np.arange(SLOTS), lens - 1]
    tok = last.argmax(-1).astype(np.int32)
    fed = []
    for step in range(DECODE_STEPS):
        pos = lens + step
        fed.append(tok)
        h, kv = decode_forward(
            params, cfg, kv, tok, pos, tables, pos + 1,
            np.arange(SLOTS, dtype=np.int32) * MAX_LEN + pos, ctx_pad=CTX,
            attn_impl=impl)
        lg = np.asarray(logits_from_hidden(params, cfg, h))
        out.append(lg)
        tok = lg.argmax(-1).astype(np.int32)
    return out, fed


def _torch_trunk(cfg, params, inputs, fed, impl):
    from ferrum_tpu_torch.models import llama_family as lf

    tokens, positions, flat, tables, lens = inputs
    t = lambda a: torch.from_numpy(np.asarray(a)).to(torch.int64)  # noqa
    kv = lf.PagedKvCache.create(cfg, SLOTS * MAX_LEN // PAGE, PAGE,
                                dtype=torch.float32, device="cpu")
    h, kv = lf.prefill_forward_batched(
        params, cfg, kv, t(tokens), t(positions), t(tables), t(lens),
        t(flat), ctx_pad=CTX, attn_impl=impl)
    out = [lf.logits_from_hidden(params, cfg, h.reshape(-1, h.shape[-1]))]
    for step, tok in enumerate(fed):
        pos = lens + step
        h, kv = lf.decode_forward(
            params, cfg, kv, t(tok), t(pos), t(tables), t(pos + 1),
            t(np.arange(SLOTS) * MAX_LEN + pos), ctx_pad=CTX,
            attn_impl=impl)
        out.append(lf.logits_from_hidden(params, cfg, h))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("impl", ["linear", "ref"])
@pytest.mark.parametrize("name", list(GEMMA_CONFIGS))
def test_prefill_and_decode_match_jax(name, impl):
    """prefill_forward_batched (prompts of 19 and 11 tokens, longer than
    every window) and 4 per-step decode_forward calls, on the linear
    layout ("linear") and the paged one ("ref"): the logits equal the
    JAX package's within 1e-5 of the logit scale (f32)."""
    jcfg, jparams, cfg, params = gemma_model(name)
    inputs = _trunk_inputs(cfg.vocab_size)
    want, fed = _jax_trunk(jcfg, jparams, inputs, impl)
    got = _torch_trunk(cfg, params, inputs, fed, impl)
    real = (inputs[1] < MAX_LEN).reshape(-1)
    want[0], got[0] = want[0][real], got[0][real]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("name", list(GEMMA_CONFIGS))
def test_decode_window_matches_jax_and_per_step_form(monkeypatch, name):
    """tests/test_torch_model.py's window case on a gemma3 trunk: a
    window of 4 steps (inside every window tested) with a 10-token
    prefill chunk riding it in blocks of 8; the hidden states and the
    cache after the window equal the JAX window's and the lanes' equal
    4 per-step calls (f32, 1e-5 of the scale)."""
    import test_torch_model as tm

    jcfg, jparams, cfg, params = gemma_model(name)
    setup = tm._window_setup(cfg.vocab_size)
    kv0, fed, want_h, want_kv = tm._jax_window(jcfg, jparams, setup, True)
    got_h, got_kv = tm._torch_window(cfg, params, setup, kv0, fed, True)
    for step, (g, w) in enumerate(zip(got_h, want_h)):
        tm._close(g[:tm.W_SLOTS], w[:tm.W_SLOTS], 1.0)
        real = step * tm.PF_P + np.arange(len(g) - tm.W_SLOTS) < tm.PF_N
        if real.any():
            tm._close(g[tm.W_SLOTS:][real], w[tm.W_SLOTS:][real], 1.0)
    for g, w in zip(got_kv, want_kv):
        tm._close(g, w, 1.0)
    ref_h, _ = tm._torch_window(cfg, params, setup, kv0, fed, False,
                                per_step=True)
    for g, r in zip(got_h, ref_h):
        tm._close(g[:2], r[:2], 1.0)


def test_init_random_params_matches_jax():
    """The port's init_random_params on a gemma3 config: the JAX draws bit
    for bit, zero-centred norms, the sandwich norms present."""
    from ferrum_tpu.models.llama_family import init_random_params as jinit
    from ferrum_tpu_torch.models.llama_family import init_random_params
    from torch_parity import flatten_torch_params

    jcfg, _, cfg, _ = gemma_model("pattern6")
    want = flatten_jax_params(jinit(jcfg, seed=4, dtype=jnp.bfloat16))
    got = flatten_torch_params(init_random_params(cfg, seed=4,
                                                  device="cpu"))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k],
                                                         np.float32), k)
    assert "layers.0.post_mlp_norm" in got
    assert not got["layers.0.post_attn_norm"].any()


def test_quantize_model_params_keeps_the_sandwich_norms():
    """quantize_model_params carries post_attn_norm / post_mlp_norm (the
    JAX one's quantize.py:186-188): every leaf equals the JAX one's
    (packed bytes, scales and norms, exact)."""
    from ferrum_tpu.models.quantize import quantize_model_params as jquant
    from ferrum_tpu_torch.models.quantize import quantize_model_params
    from torch_parity import flatten_torch_params

    _, jparams, _, params = gemma_model("pattern6")
    got = flatten_torch_params(quantize_model_params(
        params, dtype=torch.float32))
    want = flatten_jax_params(jquant(jparams, dtype=jnp.float32))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)
    assert "layers.5.post_attn_norm" in got


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

# Widths the int4 g128 layout takes; a window of 8 under prompts of 7-40.
ENGINE_BASE = dict(vocab_size=1024, hidden_size=256, num_hidden_layers=4,
                   num_attention_heads=4, num_key_value_heads=2, head_dim=64,
                   intermediate_size=512, rms_norm_eps=1e-6,
                   rope_theta=10000.0, max_position_embeddings=2048,
                   bos_token_id=1, eos_token_id=2, sliding_window=8)
ENGINE_MODELS = {
    "gemma3": dict(ENGINE_BASE, architectures=["Gemma3ForCausalLM"],
                   sliding_window_pattern=2, query_pre_attn_scalar=48.0,
                   rope_local_base_freq=1000.0, tie_word_embeddings=True,
                   final_logit_softcapping=30.0),
    "mistral_window": dict(ENGINE_BASE, architectures=["MistralForCausalLM"],
                           tie_word_embeddings=False),
}
# Seeds with every greedy token a clear argmax in both engines. (gemma3
# seed 6 has a token 2.5e-3 of the logit scale ahead, where one int8
# activation rounding taken in another summation order flips the JAX
# engine's window against the model's teacher-forced argmax.)
ENGINE_SEEDS = {"gemma3": 5, "mistral_window": 3}


PAGED_BLOCKS = 40


def _serve(engine, prompts, concurrency):
    """tests/test_torch_engine.py's `_serve`, waiting after the last final
    chunk until the scheduler has released every sequence: the pipelined
    JAX engine on the paged layout releases a finished sequence only once
    its windows in flight are read, which can come after its final chunk
    (stopping the engine first lost the release). Returns (tokens per
    prompt at release, streamed ids per prompt); bounded by
    SERVE_TIMEOUT_S."""
    import time

    import test_torch_engine as te

    mod = type(engine).__module__.split(".")[0]
    types = __import__(f"{mod}.types", fromlist=["InferenceRequest"])
    done = {}
    finish = engine.scheduler.finish

    def record(seq):
        done.setdefault(seq.request.request_id, list(seq.output_tokens))
        finish(seq)

    engine.scheduler.finish = record
    reqs = [types.InferenceRequest(
        prompt_token_ids=list(p), sampling=types.SamplingParams(
            max_tokens=te.MAX_TOKENS, ignore_eos=True)) for p in prompts]
    deadline = time.monotonic() + te.SERVE_TIMEOUT_S
    streamed = {}

    def drain(req, q):
        ids = streamed.setdefault(req.request_id, [])
        while time.monotonic() < deadline:
            try:
                chunk = q.get(timeout=1.0)
            except Exception:
                continue
            ids.extend(chunk.token_ids)
            if chunk.finished:
                assert chunk.completion_tokens == te.MAX_TOKENS
                return
        pytest.fail(f"engine did not finish within {te.SERVE_TIMEOUT_S} s")

    try:
        if concurrency == 1:
            for r in reqs:
                drain(r, engine.submit(r))
        else:
            for r, q in zip(reqs, te._submit_all(engine, reqs)):
                drain(r, q)
        while len(done) < len(reqs) and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        engine.stop()
    return [done[r.request_id] for r in reqs], \
        [streamed[r.request_id] for r in reqs]


def _engine(pkg, cfg, params, layout, mode):
    """An engine of `pkg` ("ferrum_tpu" or "ferrum_tpu_torch") on the
    layout, with tests/test_torch_engine.py's settings."""
    import importlib

    import test_torch_engine as te

    ecfg = importlib.import_module(f"{pkg}.config").EngineConfig
    builder = importlib.import_module(f"{pkg}.engine.builder").EngineBuilder
    kw = dict(kv_layout=layout, enable_prefix_cache=False,
              kv_num_blocks=PAGED_BLOCKS if layout == "paged" else 0,
              **te._engine_kw(), **mode)
    if pkg == "ferrum_tpu":
        kw.update(model="parity", dtype="f32", adaptive_windows=False)
    else:
        kw.update(device="cpu")
    return builder(ecfg(**kw)).with_model(cfg, params).build()


@pytest.mark.parametrize("loop", ["pipelined-c1", "pipelined-c4"])
@pytest.mark.parametrize("layout", ["linear", "paged"])
@pytest.mark.parametrize("model", list(ENGINE_MODELS))
def test_greedy_streams_match_jax_engine(monkeypatch, model, layout, loop):
    """Both engines serve the same greedy requests (prompts of 7, 40, 13
    and 11 tokens against a window of 8) on int4 two-level weights: the
    port streams every token, each the model's clear argmax
    (tests/test_torch_engine.py's margin check), and its tokens equal
    the JAX engine's, on the linear layout and on the paged one (40
    blocks of 16). The windows (T = 6 at bucket 1, 4 elsewhere) stay
    inside the sliding window."""
    import test_torch_engine as te
    from ferrum_tpu.models.configs import config_from_hf_dict
    from ferrum_tpu_torch.models.convert import params_from_numpy

    route_w4a8tl(monkeypatch)
    jcfg, jparams = jax_model(config_from_hf_dict(ENGINE_MODELS[model]),
                              quantized=True, seed=ENGINE_SEEDS[model])
    cfg = torch_config(jcfg)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    mode, conc = te.LOOPS[loop]
    prompts = te._prompts(conc)
    got, streamed = _serve(_engine("ferrum_tpu_torch", cfg, params, layout,
                                   mode), prompts, conc)
    assert streamed == got
    for prompt, out in zip(prompts, got):
        assert len(out) == te.MAX_TOKENS
        argmax, margins = te._margins(cfg, params, prompt, out)
        assert argmax == out, "engine tokens differ from the model's argmax"
        assert min(margins) > te.MARGIN, min(margins)
    want, _ = _serve(_engine("ferrum_tpu", jcfg, jparams, layout, mode),
                     prompts, conc)
    assert got == want
