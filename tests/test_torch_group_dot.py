"""Group-dot mode and prep-cached prefill: ferrum_tpu_torch vs ferrum_tpu.

The plain versions of the two kernels of this slice are held against the
Pallas kernels they replace, run in interpret mode on the same numpy-made
inputs, bit for bit (every sum is an exact integer before the same f32
epilogue):
- `w4a8tl_gd_plain` (kernel `w4a8tl_gd_decode`) against
  `_quant_matmul_w4a8tl_gd` (`_qmm_w4a8tl_gd_kernel`), and against
  `w4a8tl_plain`: moving scales2 and the zero correction to the output
  side is exact in integer arithmetic;
- `w4a8tl_plain` (kernel `w4a8tl_prefill_mcache`) against
  `_quant_matmul_w4a8tl_2d_mcache` (`_qmm_w4a8tl_mcache_kernel`).
The wrap case puts the output-side sum where a deferred zero correction
would pass 2^31 before it cancels; every version must give 0 there.

Then the slice as a whole: `tiny-quant` (two-level int4) with
`w4a8_gd` "all" and "down", model logits and engine greedy streams
against the JAX package, whose dispatch runs as on the TPU with its gd
entry computed by `torch_parity.jax_qmm_w4a8tl_gd` (held against interpret
mode here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_float_scale as tfs
import test_torch_model as tm
import test_torch_engine as te
from torch_parity import (flatten_jax_params, jax_model, jax_qmm_w4a8tl_gd,
                          route_float_scale, run_pallas_interpret,
                          torch_config)
from ferrum_tpu.ops import quant as jq
from ferrum_tpu.ops.pallas import quant_matmul as qm
from ferrum_tpu_torch.ops import quant as tq
from ferrum_tpu_torch.ops.kernels import quant_matmul as tqm


def _two_level_pair(k, n, seed):
    """(JAX, port) two-level params of one random weight with per-group
    offsets (zeros, scales2 and chan all vary), requantized by the JAX
    package and carried over as its bytes."""
    pj, _ = tfs._pair(k, n, seed, scale_dtype="f32")
    pj = jq.requantize_two_level(pj)
    pt = tq.QuantLinearParams(
        qweight=torch.from_numpy(np.array(pj.qweight)),
        scales=torch.from_numpy(np.array(pj.scales)),
        zeros=torch.from_numpy(np.array(pj.zeros)), bias=None,
        in_features=k, out_features=n, group_size=128,
        scales2=torch.from_numpy(np.array(pj.scales2)),
        chan_scale=torch.from_numpy(np.array(pj.chan_scale)))
    return pj, pt


def _activations(m, k, seed):
    """(JAX xq, xs, port xq, xs): the JAX package's row quantization of
    seeded normal rows, the same bytes on both sides."""
    x = np.random.default_rng(seed).normal(0, 1, (m, k)).astype(np.float32)
    xq, xs = qm.quantize_activation_rows(jnp.asarray(x))
    return (xq, xs, torch.from_numpy(np.array(xq)),
            torch.from_numpy(np.array(xs)))


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


# ---------------------------------------------------------------------------
# 1. the plain versions vs interpret-mode Pallas, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("out", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,n,bkb", [(1024, 512, None), (2048, 256, 256)])
def test_gd_plain_matches_pallas_interpret(k, n, bkb, out):
    """m = 32 (the Pallas int8 tile) at 1024 → 512 (one K step of 4
    groups per plane, as tests/test_quant.py) and 2048 → 256 with bkb 256
    (4 K steps of 2 groups): `w4a8tl_gd_plain` and the jnp form the model
    tests route to equal the interpret-mode kernel exactly."""
    pj, pt = _two_level_pair(k, n, seed=k + n)
    xq, xs, txq, txs = _activations(32, k, seed=k)
    jdt, tdt = getattr(jnp, out), getattr(torch, out)
    want = _f32(run_pallas_interpret(qm._quant_matmul_w4a8tl_gd, xq, xs, pj,
                                     jdt, bkb=bkb))
    got = tqm.w4a8tl_gd_decode(txq, txs, pt, tdt)
    assert got.dtype == tdt and tuple(got.shape) == (32, n)
    np.testing.assert_array_equal(_f32(got), want)
    np.testing.assert_array_equal(_f32(jax_qmm_w4a8tl_gd(xq, xs, pj, jdt)),
                                  want)


@pytest.mark.parametrize("m,k,n,seed", [
    (1, 512, 256, 0), (7, 1536, 128, 1), (32, 1024, 384, 2),
    (64, 2048, 256, 3), (33, 4096, 128, 4)])
def test_gd_plain_equals_w4a8tl_plain(m, k, n, seed):
    """The group-dot form and the w8 form of the same two-level weight
    give the same bits, f32 and bf16 output, on seeded random weights and
    activations (the port's own quantization)."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy(rng.normal(0, 0.02, (k, n)).astype(np.float32)
                         + rng.uniform(-0.03, 0.03, (k // 128, 1, n))
                         .repeat(128, 0).reshape(k, n).astype(np.float32))
    p = tq.requantize_two_level(tq.make_quant_linear(w, 128,
                                                     symmetric=False))
    assert p.scales2.unique().numel() > 1 and p.zeros.unique().numel() > 1
    x = torch.from_numpy(rng.normal(0, 1, (m, k)).astype(np.float32))
    xq, xs = tqm.quantize_activation_rows(x)
    for dt in (torch.float32, torch.bfloat16):
        got = tqm.w4a8tl_gd_plain(xq, xs, p, dt)
        assert torch.equal(got, tqm.w4a8tl_plain(xq, xs, p, dt))


def test_gd_wrap_case_gives_zero():
    """K = 14336 (llama's down projection: 112 groups), xq = 127, q = 15,
    z = 15, s2 = 127: every w8 is 0, so the exact result is 0, while
    sum_g s2 * dot alone reaches 112 * 127 * 15 * 128 * 127 ~ 3.5e9 > 2^31
    before the zero correction cancels it. The plain version (float64),
    the w8 form and the interpret-mode Pallas kernel all give 0."""
    k, n, m = 14336, 128, 32
    g = k // 128
    chan = np.random.default_rng(7).uniform(1e-3, 2e-3, (1, n)).astype(
        np.float32)
    fields = dict(qweight=np.full((k // 2, n), 0xFF, np.uint8),
                  scales=np.ones((g, n), np.float32),
                  zeros=np.full((g, n), 15, np.int8),
                  scales2=np.full((g, n), 127, np.int8), chan_scale=chan)
    pj = jq.QuantLinearParams(
        bias=None, in_features=k, out_features=n, group_size=128,
        **{f: jnp.asarray(v) for f, v in fields.items()})
    pt = tq.QuantLinearParams(
        bias=None, in_features=k, out_features=n, group_size=128,
        **{f: torch.from_numpy(v) for f, v in fields.items()})
    xq = np.full((m, k), 127, np.int8)
    xs = np.full((m, 1), 0.01, np.float32)
    got = tqm.w4a8tl_gd_plain(torch.from_numpy(xq), torch.from_numpy(xs),
                              pt, torch.float32)
    assert torch.equal(got, torch.zeros(m, n))
    assert torch.equal(tqm.w4a8tl_plain(torch.from_numpy(xq),
                                        torch.from_numpy(xs), pt,
                                        torch.float32), got)
    want = run_pallas_interpret(qm._quant_matmul_w4a8tl_gd, jnp.asarray(xq),
                                jnp.asarray(xs), pj, jnp.float32)
    np.testing.assert_array_equal(_f32(want), np.zeros((m, n), np.float32))


def test_mcache_plain_matches_pallas_interpret():
    """`w4a8tl_prefill_mcache`'s plain version (`w4a8tl_plain`) equals
    `_quant_matmul_w4a8tl_2d_mcache` in interpret mode at the shape of
    tests/test_moe_grouped.py's parity test: 512 → 256, m = 96, bkb 128,
    bn 128, bm 32 (3 m-tiles sharing each prepared weight block, 2 K
    steps), f32 output, bit for bit."""
    pj, pt = _two_level_pair(512, 256, seed=50)
    xq, xs, txq, txs = _activations(96, 512, seed=51)
    want = _f32(run_pallas_interpret(qm._quant_matmul_w4a8tl_2d_mcache, xq,
                                     xs, pj, jnp.float32, bkb=128, bn=128,
                                     bm=32))
    got = tqm.w4a8tl_prefill_mcache(txq, txs, pt, torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (96, 256)
    np.testing.assert_array_equal(_f32(got), want)


# ---------------------------------------------------------------------------
# 2. the slice as a whole: tiny-quant under w4a8_gd all / down
# ---------------------------------------------------------------------------

def _count_gd(monkeypatch):
    """Count the calls of both packages' group-dot wrappers (after
    route_float_scale: the JAX one is the jnp form)."""
    calls = {"jax": 0, "port": 0}
    jfn, tfn = qm._quant_matmul_w4a8tl_gd, tqm.w4a8tl_gd_decode

    def jcount(*a, **kw):
        calls["jax"] += 1
        return jfn(*a, **kw)

    def tcount(*a, **kw):
        calls["port"] += 1
        return tfn(*a, **kw)
    monkeypatch.setattr(qm, "_quant_matmul_w4a8tl_gd", jcount)
    monkeypatch.setattr(tqm, "w4a8tl_gd_decode", tcount)
    return calls


@pytest.mark.parametrize("mode", ["all", "down"])
def test_group_dot_logits_match_jax(monkeypatch, mode):
    """tiny-quant, two-level, w4a8 on, w4a8_gd = mode: every decode
    projection takes the group-dot kernel's function ("all"), or only
    the down projection (1024 → 512; "down"), the others the float-scale
    w4a8 kernel's. Prefill (64 rows: the decode route too) and 4 decode
    steps. The integer sums are exact and the f32 ops around them run in
    another order (measured <= 9e-7 of the logit scale in both modes), so
    every logit within 1e-5 of the logit scale, as
    tests/test_torch_model.py's dense case."""
    from ferrum_tpu_torch.models.convert import params_from_numpy

    route_float_scale(monkeypatch, w4a8=True, gd=mode)
    calls = _count_gd(monkeypatch)
    jcfg, jparams = jax_model("tiny-quant", quantized=True)
    cfg = torch_config(jcfg)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    inputs = tm._inputs(cfg.vocab_size)
    want, fed = tm._run_jax(jcfg, jparams, inputs)
    got = tm._run_torch(cfg, params, inputs, fed)
    # "all": q|k|v, o, gate|up, down of 2 layers; "down": down only.
    per_step = cfg.num_layers * (4 if mode == "all" else 1)
    # The port calls per step; the JAX package traces each program once.
    assert calls["port"] == per_step * (1 + tm.DECODE_STEPS)
    assert calls["jax"] == per_step * 2
    real = (inputs[1] < tm.MAX_LEN).reshape(-1)
    want[0], got[0] = want[0][real], got[0][real]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, atol=1e-5 * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("mode", ["all", "down"])
def test_group_dot_greedy_streams_match_jax_engine(monkeypatch, mode):
    """3 concurrent greedy requests through both engines on tiny-quant
    (two-level, seed 3) under EngineConfig(w4a8_gd=mode): equal token
    streams; every generated token leads its runner-up by te.MARGIN of
    the logit scale, or the test fails as a near-tie."""
    route_float_scale(monkeypatch, w4a8=True, gd=mode)
    calls = _count_gd(monkeypatch)
    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=3)
    cfg, params, got, streamed, want = tfs._streams(
        jcfg, jparams, {"w4a8_gd": mode})
    assert tqm._W4A8_GD == mode and qm._W4A8_GD == mode
    assert calls["port"] > 0 and calls["jax"] > 0
    assert streamed == got
    for prompt, out in zip(te.PROMPTS, got):
        assert len(out) == te.MAX_TOKENS
        argmax, margins = te._margins(cfg, params, prompt, out)
        assert argmax == out, "engine tokens differ from the model's argmax"
        assert min(margins) > te.MARGIN, (
            f"near-tie (margin {min(margins):.2e} of the logit scale): "
            f"pick another seed, the comparison would be a coin flip")
    assert got == want
