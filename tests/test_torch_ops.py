"""Op-level parity of ferrum_tpu_torch vs ferrum_tpu, plus package rules.

Norms, rope (llama3 scaling), the flat-layout decode and prefill
attention, on-device sampling and the byte tokenizer, fed the same
numpy inputs in both packages. Float paths compare in f32 at 1e-5: the
two frameworks do the same f32 arithmetic in other summation orders
(measured differences ~1e-7). Sampling compares exactly, with the
Gumbel noise the JAX package draws from its keys fed to the port.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (thread count)

TOL = dict(rtol=1e-5, atol=1e-5)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "ferrum_tpu_torch")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_rms_norms_match_jax():
    from ferrum_tpu.ops import norms as jn
    from ferrum_tpu_torch.ops import norms as tn
    rng = np.random.default_rng(0)
    x, r = rng.normal(0, 2, (2, 5, 64)).astype(np.float32), \
        rng.normal(0, 1, (2, 5, 64)).astype(np.float32)
    w = rng.normal(1, 0.1, 64).astype(np.float32)
    np.testing.assert_allclose(tn.rms_norm(_t(x), _t(w), 1e-6).numpy(),
                               np.asarray(jn.rms_norm(x, w, 1e-6)), **TOL)
    got = tn.fused_add_rms_norm(_t(x), _t(r), _t(w), 1e-5)
    want = jn.fused_add_rms_norm(x, r, w, 1e-5)
    for g, wt in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wt), **TOL)


def test_rope_llama3_matches_jax():
    from ferrum_tpu.models.configs import preset
    from ferrum_tpu.ops import rope as jr
    from ferrum_tpu_torch.ops import rope as tr
    from torch_parity import torch_config
    jcfg = preset("llama-3.1-8b")
    cfg = torch_config(jcfg)
    inv_j = jr.rope_inv_freq(128, jcfg.rope_theta, jcfg.rope_scaling)
    inv_t = tr.rope_inv_freq(128, cfg.rope_theta, cfg.rope_scaling)
    np.testing.assert_array_equal(inv_j, inv_t)
    assert not np.array_equal(inv_t, tr.rope_inv_freq(128, cfg.rope_theta))
    pos = np.array([0, 1, 17, 255, 4000, 70000], np.int32)
    x = np.random.default_rng(1).normal(0, 1, (6, 4, 128)).astype(np.float32)
    cj, sj = jr.rope_cos_sin(jnp.asarray(pos), jnp.asarray(inv_j))
    ct, st = tr.rope_cos_sin(_t(pos), _t(inv_t))
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), **TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), **TOL)
    np.testing.assert_allclose(tr.apply_rope(_t(x), ct, st).numpy(),
                               np.asarray(jr.apply_rope(x, cj, sj)), **TOL)


HQ, HKV, D = 4, 2, 16
F = HKV * D


def test_flat_decode_attention_matches_jax():
    from ferrum_tpu.ops.attention import flat_decode_attention as jfn
    from ferrum_tpu_torch.ops.attention import flat_decode_attention as tfn
    rng = np.random.default_rng(2)
    s, c = 3, 32
    q = rng.normal(0, 1, (s, HQ, D)).astype(np.float32)
    k = rng.normal(0, 1, (s, c, F)).astype(np.float32)
    v = rng.normal(0, 1, (s, c, F)).astype(np.float32)
    ks = rng.normal(0, 1, (s, HKV, D)).astype(np.float32)
    vs = rng.normal(0, 1, (s, HKV, D)).astype(np.float32)
    lens = np.array([1, 9, 32], np.int32)          # 1 = self term only
    want = jfn(q, k, v, lens, ks, vs, hkv=HKV, scale=0.25)
    got = tfn(_t(q), _t(k), _t(v), _t(lens), _t(ks), _t(vs), hkv=HKV,
              scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flat_prefill_attention_matches_jax():
    from ferrum_tpu.ops.attention import flat_prefill_attention as jfn
    from ferrum_tpu_torch.ops.attention import flat_prefill_attention as tfn
    rng = np.random.default_rng(3)
    b, t, c = 2, 8, 16
    q = rng.normal(0, 1, (b, t, HQ, D)).astype(np.float32)
    k = rng.normal(0, 1, (b, c, F)).astype(np.float32)
    v = rng.normal(0, 1, (b, c, F)).astype(np.float32)
    kn = rng.normal(0, 1, (b, t, HKV, D)).astype(np.float32)
    vn = rng.normal(0, 1, (b, t, HKV, D)).astype(np.float32)
    # row 0: 5-token prefix + 8 chunk tokens; row 1: fresh 6-token chunk
    # with two pad rows past the total length.
    pos = np.array([np.arange(5, 13), [0, 1, 2, 3, 4, 5, 99, 100]],
                   np.int32)
    total = np.array([13, 6], np.int32)
    want = jax.vmap(lambda *a: jfn(*a, hkv=HKV, scale=0.25))(
        q, k, v, pos, total, kn, vn)
    got = tfn(_t(q), _t(k), _t(v), _t(pos), _t(total), _t(kn), _t(vn),
              hkv=HKV, scale=0.25)
    real = pos < total[:, None]
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               **TOL)
    one = tfn(_t(q[0]), _t(k[0]), _t(v[0]), _t(pos[0]), _t(total[0]),
              _t(kn[0]), _t(vn[0]), hkv=HKV, scale=0.25)
    np.testing.assert_allclose(one.numpy(), got.numpy()[0], **TOL)


# Window attention: T steps of a decode window over S lanes, the cache
# frozen at each lane's cache_len; the window's own K/V rows of the steps
# before `step` join as extra terms.
WIN_T, WIN_S, WIN_C = 4, 3, 32


def _win_inputs(seed):
    rng = np.random.default_rng(seed)
    s, c, t = WIN_S, WIN_C, WIN_T
    f32 = lambda *sh: rng.normal(0, 1, sh).astype(np.float32)  # noqa
    return dict(q=f32(s, HQ, D), k=f32(s, c, F), v=f32(s, c, F),
                ks=f32(s, HKV, D), vs=f32(s, HKV, D),
                kw=f32(t, s, HKV, D), vw=f32(t, s, HKV, D),
                # lane 0: 1 cached token (no history); lane 2: pad lane
                # (cache_len 0: the self term and the window only).
                cache_len=np.array([1, 20, 0], np.int32))


@pytest.mark.parametrize("step", [0, WIN_T - 1])
def test_flat_decode_attention_window_terms_match_jax(step):
    """flat_decode_attention with k_win/v_win/win_valid/cache_len equals
    the JAX function at the window's first and last step (f32, 1e-5)."""
    from ferrum_tpu.ops.attention import flat_decode_attention as jfn
    from ferrum_tpu_torch.ops.attention import flat_decode_attention as tfn
    a = _win_inputs(5 + step)
    lens = a["cache_len"] + step
    valid = np.broadcast_to(np.arange(WIN_T)[None] < step, (WIN_S, WIN_T))
    want = jfn(a["q"], a["k"], a["v"], lens, a["ks"], a["vs"], hkv=HKV,
               scale=0.25, k_win=a["kw"], v_win=a["vw"],
               win_valid=jnp.asarray(valid), cache_len=a["cache_len"])
    got = tfn(_t(a["q"]), _t(a["k"]), _t(a["v"]), _t(lens), _t(a["ks"]),
              _t(a["vs"]), hkv=HKV, scale=0.25, k_win=_t(a["kw"]),
              v_win=_t(a["vw"]), win_valid=_t(valid),
              cache_len=_t(a["cache_len"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("step,valid_len", [(0, 10), (WIN_T - 1, 10),
                                            (WIN_T - 1, WIN_T * 8)])
def test_flat_prefill_window_attention_matches_jax(step, valid_len):
    """A P-row block of one slot's chunk riding a decode window: the slot's
    cached prefix (5 tokens), the chunk's blocks of earlier steps and
    itself, causally. valid_len 10 < T*P leaves pad rows (the last
    steps' blocks are all pads); every row is compared, pads included
    (f32, 1e-5)."""
    from ferrum_tpu.ops.attention import flat_prefill_window_attention as jfn
    from ferrum_tpu_torch.ops.attention import (
        flat_prefill_window_attention as tfn)
    rng = np.random.default_rng(7 + step)
    p, c, start = 8, 16, 5
    f32 = lambda *sh: rng.normal(0, 1, sh).astype(np.float32)  # noqa
    q, kc, vc = f32(p, HQ, D), f32(c, F), f32(c, F)
    wk, wv = f32(WIN_T, p, HKV, D), f32(WIN_T, p, HKV, D)
    kn, vn = f32(p, HKV, D), f32(p, HKV, D)
    rows = step * p + np.arange(p)
    pos = np.where(rows < valid_len, start + rows,
                   (1 << 16) + rows).astype(np.int32)
    want = jfn(q, kc, vc, jnp.int32(start), wk, wv, jnp.int32(step),
               jnp.int32(start), jnp.int32(valid_len), kn, vn, pos,
               hkv=HKV, scale=0.25)
    got = tfn(_t(q), _t(kc), _t(vc), start, _t(wk), _t(wv), step, start,
              valid_len, _t(kn), _t(vn), _t(pos), hkv=HKV, scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("slots,toks", [
    ([0, 4], [1, 2]),            # slot 4 of 4: a pad id, dropped
    ([2, 4, 4, 1], [3, 5, 6, 8]),  # pad lanes at s_pad = 4, token 8 = V
    ([3, 3, 0], [7, 7, 0]),      # repeats accumulate
])
def test_update_counts_drops_pad_ids_as_jax(slots, toks):
    """update_counts on counts int32 [4, 8]: ids outside [0, S) (pad
    lanes at s_pad) and tokens outside [0, V) (count pads) are dropped,
    as the JAX function's mode="drop"; exact."""
    from ferrum_tpu.sampling.device import update_counts as jfn
    from ferrum_tpu_torch.sampling.device import update_counts as tfn
    base = np.random.default_rng(9).integers(0, 3, (4, 8)).astype(np.int32)
    sl, tk = np.array(slots, np.int32), np.array(toks, np.int32)
    want = np.asarray(jfn(jnp.asarray(base), sl, tk))
    got = tfn(_t(base), _t(sl).long(), _t(tk).long())
    np.testing.assert_array_equal(got.numpy(), want)


def _bf16(a):
    """numpy f32 → the same values rounded to bf16, as (numpy f32, torch
    bf16) so both packages see identical bf16 inputs."""
    t = torch.from_numpy(a).to(torch.bfloat16)
    return t.float().numpy(), t


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_bf16_attention_keeps_f32_products(kind):
    """With bf16 inputs both packages take the score and PV products to
    f32 unrounded (preferred_element_type=f32). Scores spread ~6 and reach
    ~20 here, where bf16's spacing is 0.125: scores rounded to bf16 change
    30-80% of the bf16 outputs (measured). Both packages then do the same
    arithmetic and agree bit for bit (measured); the tolerance, 2% of the
    outputs off by one bf16 step at the output's scale (2^-7 of max |out|)
    at most, leaves room for a bf16 rounding of a probability or an output
    to fall on the other side after f32 sums taken in other orders."""
    from ferrum_tpu.ops import attention as ja
    from ferrum_tpu_torch.ops import attention as ta
    rng = np.random.default_rng(6)
    b, t, c = 2, 8, 32
    shape_q = (b, HQ, D) if kind == "decode" else (b, t, HQ, D)
    shape_new = (b, HKV, D) if kind == "decode" else (b, t, HKV, D)
    q, tq = _bf16(rng.normal(0, 6, shape_q).astype(np.float32))
    k, tk = _bf16(rng.normal(0, 1, (b, c, F)).astype(np.float32))
    v, tv = _bf16(rng.normal(0, 1, (b, c, F)).astype(np.float32))
    kn, tkn = _bf16(rng.normal(0, 1, shape_new).astype(np.float32))
    vn, tvn = _bf16(rng.normal(0, 1, shape_new).astype(np.float32))
    bf = jnp.bfloat16
    jargs = [jnp.asarray(a, bf) for a in (q, k, v)]
    jnew = [jnp.asarray(a, bf) for a in (kn, vn)]
    if kind == "decode":
        lens = np.array([20, 32], np.int32)
        want = ja.flat_decode_attention(*jargs, lens, *jnew, hkv=HKV,
                                        scale=0.25)
        got = ta.flat_decode_attention(tq, tk, tv, _t(lens), tkn, tvn,
                                       hkv=HKV, scale=0.25)
    else:
        pos = np.array([np.arange(12, 20), np.arange(0, 8)], np.int32)
        total = np.array([20, 8], np.int32)
        want = jax.vmap(lambda *a: ja.flat_prefill_attention(
            *a, hkv=HKV, scale=0.25))(jargs[0], jargs[1], jargs[2], pos,
                                       total, *jnew)
        got = ta.flat_prefill_attention(tq, tk, tv, _t(pos), _t(total),
                                        tkn, tvn, hkv=HKV, scale=0.25)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 ** -7 * np.abs(want).max())
    assert np.mean(got != want) <= 0.02


@pytest.mark.parametrize("batched", [False, True])
def test_matmul_f32_matches_preferred_element_type(batched):
    """matmul_f32 on bf16 operands returns the f32 sums that
    jnp.dot/einsum(preferred_element_type=f32) returns (the tied-embedding
    logits and the attention products): 1e-5 leaves room for f32 sums in
    other orders, while a result rounded to bf16 is off by up to 2^-9."""
    from ferrum_tpu_torch.ops.linear import matmul_f32
    rng = np.random.default_rng(7)
    shape_a, shape_b = ((3, 40, 64), (3, 64, 48)) if batched \
        else ((40, 64), (64, 48))
    a, ta = _bf16(rng.normal(0, 1, shape_a).astype(np.float32))
    b, tb = _bf16(rng.normal(0, 1, shape_b).astype(np.float32))
    eq = "bmk,bkn->bmn" if batched else "mk,kn->mn"
    want = np.asarray(jnp.einsum(eq, jnp.asarray(a, jnp.bfloat16),
                                 jnp.asarray(b, jnp.bfloat16),
                                 preferred_element_type=jnp.float32))
    got = matmul_f32(ta, tb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _jax_noise(keys, k_cap):
    """The Gumbel noise JAX's sample_step draws from these keys."""
    typed = jax.vmap(jax.random.wrap_key_data)(keys)
    draw = jax.vmap(lambda k: jax.random.split(k)[0])(typed)
    return np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (k_cap,)))(draw))


def test_sample_step_matches_jax_with_equal_noise():
    from ferrum_tpu.sampling import device as jd
    from ferrum_tpu_torch.sampling import device as td
    rng = np.random.default_rng(4)
    s, v = 6, 300
    logits = rng.normal(0, 3, (s, v)).astype(np.float32)
    counts = (rng.random((s, v)) < 0.05).astype(np.int32)
    temp = np.array([0.0, 0.7, 1.0, 1.3, 0.5, 0.0], np.float32)
    top_k = np.array([0, 0, 20, 5, 0, 3], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.8, 0.5, 1.0], np.float32)
    pen = np.array([1.0, 1.2, 1.0, 1.5, 1.0, 1.3], np.float32)
    min_act = np.array([False, True, False, False, True, False])
    eos = (2, 7)
    keys = np.asarray(jax.vmap(lambda i: jax.random.key_data(
        jax.random.PRNGKey(i)))(jnp.arange(s)))
    want, _ = jd.sample_step(
        jnp.asarray(logits),
        jd.SlotSamplingParams(jnp.asarray(temp), jnp.asarray(top_k),
                              jnp.asarray(top_p), jnp.asarray(pen),
                              jnp.asarray(min_act)),
        jnp.asarray(counts), jnp.asarray(keys), eos)
    noise = _jax_noise(keys, min(td.TOPK_CAP, v))
    params = td.SlotSamplingParams(_t(temp), _t(top_k).long(), _t(top_p),
                                   _t(pen), _t(min_act))
    got = td.sample_step(_t(logits), params, _t(counts), eos,
                         noise=_t(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    greedy = td.sample_step(_t(logits), params, _t(counts), eos,
                            greedy_only=True)
    want_g, _ = jd.sample_step(
        jnp.asarray(logits),
        jd.SlotSamplingParams(jnp.asarray(temp), jnp.asarray(top_k),
                              jnp.asarray(top_p), jnp.asarray(pen),
                              jnp.asarray(min_act)),
        jnp.asarray(counts), jnp.asarray(keys), eos, greedy_only=True)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(want_g))


@pytest.mark.parametrize("v", [4, 8, 16, 32, 300])
def test_sample_step_tie_order_matches_jax(v):
    """Tied logits: the port's sample_step gives the JAX package's token
    with the same noise. Slots: every logit 0 at top_k 1 (JAX: token 0)
    and sampled over all of them; only ids 0 and 3 tied at the top, at
    top_k 1 and sampled between the two; a tie straddling the candidate
    cut -- at V = 300, 260 ids tied at the top and k_cap = 256; at V <=
    256 (k_cap = V), 3V/4 ids tied and top_k = V/2 -- sampled; and greedy
    (temperature 0) over a tie."""
    from ferrum_tpu.sampling import device as jd
    from ferrum_tpu_torch.sampling import device as td
    rng = np.random.default_rng(v)
    s = 7
    logits = np.zeros((s, v), np.float32)
    logits[2:4] = rng.uniform(-30.0, -5.0, (2, v))
    logits[2:4, [0, 3]] = 1.0
    tied = rng.permutation(v)[:260 if v > 256 else 3 * v // 4]
    logits[4:6] = -3.0
    logits[4:6, tied] = 2.0
    logits[6] = logits[4]
    temp = np.array([1.0, 1.0, 1.0, 1.0, 1.0, 0.7, 0.0], np.float32)
    half = 0 if v > 256 else v // 2
    top_k = np.array([1, 0, 1, 2, half, 0, 0], np.int32)
    ones = np.ones(s, np.float32)
    counts = np.zeros((s, v), np.int32)
    min_act = np.zeros(s, bool)
    keys = np.asarray(jax.vmap(lambda i: jax.random.key_data(
        jax.random.PRNGKey(i)))(jnp.arange(s) + v))
    want, _ = jd.sample_step(
        jnp.asarray(logits),
        jd.SlotSamplingParams(jnp.asarray(temp), jnp.asarray(top_k),
                              jnp.asarray(ones), jnp.asarray(ones),
                              jnp.asarray(min_act)),
        jnp.asarray(counts), jnp.asarray(keys), ())
    want = np.asarray(want)
    assert want[0] == 0 and want[2] == 0
    noise = _jax_noise(keys, min(td.TOPK_CAP, v))
    params = td.SlotSamplingParams(_t(temp), _t(top_k).long(), _t(ones),
                                   _t(ones), _t(min_act))
    got = td.sample_step(_t(logits), params, _t(counts), (),
                         noise=_t(noise))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("text", ["Hello world", "héllo ✓ 日本 \x00\x7f",
                                  "<bos>abc<eos>x"])
def test_byte_tokenizer_matches_jax(text):
    from ferrum_tpu.tokenizer import make_byte_tokenizer as jtok
    from ferrum_tpu_torch.tokenizer import make_byte_tokenizer as ttok
    j, t = jtok(vocab_extra=12), ttok(vocab_extra=12)
    ids = j.encode(text)
    assert t.encode(text) == ids
    ids = ids + list(np.random.default_rng(5).integers(0, 270, 50))
    assert t.decode(ids) == j.decode(ids)
    assert t.vocab_size == j.vocab_size


# ---------------------------------------------------------------------------
# Package rules
# ---------------------------------------------------------------------------

def _py_files():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "tools", "torch_w4a16_ab.py")
    yield os.path.join(REPO, "tools", "torch_w4a8tl_ab.py")


def test_port_imports_neither_jax_nor_ferrum_tpu():
    offenders = []
    for path in _py_files():
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "ferrum_tpu",
                                       "flax", "optax"):
                    offenders.append((os.path.relpath(path, REPO), n))
    assert not offenders, offenders


def test_port_imports_where_jax_cannot():
    """Every module of the package imports in a process where importing
    jax (or ferrum_tpu) raises."""
    code = (
        "import sys, importlib, pkgutil\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'ferrum_tpu'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import ferrum_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'ferrum_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_need_cuda_unless_cpu_is_asked_for():
    from ferrum_tpu_torch.device import resolve_device
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.quantize import init_random_quant_params
    assert resolve_device("cpu").type == "cpu"
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_random_quant_params(preset("tiny-quant"), 0)


def test_no_try_gives_way_to_a_plain_version():
    """No except handler in the kernel modules (a kernel either launches
    or raises; the plain route is chosen by the tensor's device only)."""
    kdir = os.path.join(PKG, "ops", "kernels")
    for f in os.listdir(kdir):
        if f.endswith(".py"):
            tree = ast.parse(open(os.path.join(kdir, f)).read())
            assert not any(isinstance(n, ast.Try) for n in ast.walk(tree)), f


def test_kernel_records_name_their_sources_and_tpu_kernels():
    """Every `Kernel` record (the `source` and `replaces` that chip_smoke.py
    prints): one per TPU kernel of PERF.md's table, eleven; its CUDA source
    exists and is a built source with C signatures, and every built source
    carries a record; `replaces` names the function defined at that line of
    the JAX package."""
    from ferrum_tpu_torch.ops import kernels as K
    from ferrum_tpu_torch.ops.kernels import build

    assert len({k.name for k in K.KERNELS}) == len(K.KERNELS) == 11
    sources = set()
    for k in K.KERNELS:
        assert os.path.exists(os.path.join(REPO, k.source)), k.source
        sources.add(os.path.splitext(os.path.basename(k.source))[0])
        path, line, fn = k.replaces.replace(":", " ").split()[:3]
        text = open(os.path.join(REPO, path)).read().splitlines()
        assert text[int(line) - 1].startswith(f"def {fn}("), k.replaces
    assert sources == set(build.SOURCES) == set(build.SIGNATURES)
