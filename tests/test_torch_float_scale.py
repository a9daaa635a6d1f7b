"""Float-scale routes: ferrum_tpu_torch vs ferrum_tpu without the
two-level requantization (w4a16 and float-scale w4a8, dense and MoE).

The plain versions of the three kernels these routes run -- w4a16_gemm,
w4a8_decode, grouped_w4a16 -- are held against the Pallas kernels they
replace (`_qmm_kernel`, `_qmm_w4a8_kernel`, `_qgmm_kernel`) run in
interpret mode on the same numpy inputs: the float-scale w4a8 one within
f32 rounding (same integer dots, same f32 order; XLA CPU fuses a
multiply-add that the kernel rounds twice) and bit for bit against the
kernel's ops taken one at a time, the two bf16 ones within one bf16 step
(their f32 sums run in another order; the plain versions sum in
float64). The route tables of both packages must correspond case by
case; model logits and engine streams are compared with the JAX side
routed to jnp forms of the kernels (torch_parity.route_float_scale),
which are held against the interpret-mode runs here too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_engine as te
import test_torch_model as tm
import test_torch_moe as tmo
from torch_parity import (flatten_jax_params, jax_grouped_w4a16, jax_model,
                          jax_qmm_w4a8, jax_qmm_w4a16, route_float_scale,
                          run_pallas_interpret, torch_config)
from ferrum_tpu.ops import quant as jq
from ferrum_tpu.ops.pallas import quant_matmul as qm
from ferrum_tpu_torch.ops import quant as tq
from ferrum_tpu_torch.ops.kernels import moe_gemm as tmg
from ferrum_tpu_torch.ops.kernels import quant_matmul as tqm


def _pair(k, n, seed, scale_dtype="bf16", shift=0.03):
    """(JAX, port) float-scale params of one random [k, n] weight with
    per-group offsets, quantized asymmetric: zeros and scales vary per
    group and column, so a kernel reading the wrong group shows."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.02, (k, n)) + rng.uniform(
        -shift, shift, (k // 128, 1, n)).repeat(128, 0).reshape(k, n)
    packed, s, z = jq.quantize_weight_np(w.astype(np.float32), 128, False)
    jdt = jnp.bfloat16 if scale_dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if scale_dtype == "bf16" else torch.float32
    pj = jq.QuantLinearParams(
        qweight=jnp.asarray(packed), scales=jnp.asarray(s, jdt),
        zeros=jnp.asarray(z), bias=None, in_features=k, out_features=n,
        group_size=128)
    pt = tq.QuantLinearParams(
        qweight=torch.from_numpy(packed), scales=torch.from_numpy(s).to(tdt),
        zeros=torch.from_numpy(z), bias=None, in_features=k, out_features=n,
        group_size=128)
    return pj, pt


def _bf16_inputs(m, k, seed):
    x = np.random.default_rng(seed).normal(0, 1, (m, k)).astype(np.float32)
    xj = jnp.asarray(x, jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)


def _f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor)
                      else jnp.asarray(a, jnp.float32))


def assert_one_bf16_step(got, want):
    """|got - want| <= 2^-7 |want| + 2^-12 max|want| everywhere: one bf16
    step of the value, plus a floor for sums that cancel near zero."""
    got, want = _f32(got), _f32(want)
    tol = 2.0 ** -7 * np.abs(want) + 2.0 ** -12 * np.abs(want).max()
    bad = np.abs(got - want) > tol
    assert not bad.any(), (f"{bad.mean():.2e} of outputs beyond one bf16 "
                           f"step; worst {np.abs(got - want).max()}")


# ---------------------------------------------------------------------------
# 1. the three kernels' plain versions vs interpret-mode Pallas
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n", [(512, 256), (1024, 512)])
@pytest.mark.parametrize("m", [1, 8, 32, 96])
def test_w4a16_plain_matches_pallas_interpret(m, k, n):
    """w4a16_plain vs `_quant_matmul_2d` in interpret mode (bf16 x, bf16
    scales, the served dtypes) and vs `quant_matmul_ref` at bf16, within
    one bf16 step; the jnp form the model tests route to, likewise."""
    pj, pt = _pair(k, n, seed=m + k)
    xj, xt = _bf16_inputs(m, k, seed=m)
    want = run_pallas_interpret(qm._quant_matmul_2d, xj, pj)
    got = tqm.w4a16_plain(xt, pt)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (m, n)
    assert_one_bf16_step(got, want)
    assert_one_bf16_step(got, jq.quant_matmul_ref(xj, pj))
    assert_one_bf16_step(jax_qmm_w4a16(xj, pj), want)


@pytest.mark.parametrize("k", [512, 1024, 1536])
@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("m", [1, 32, 64])
def test_w4a8_plain_matches_pallas_interpret(m, scale_dtype, k):
    """w4a8_plain (the w4a8_decode kernel's function, checked bit for bit
    on the card) against `_quant_matmul_w4a8_2d` at 1, 2 and 3 K steps of
    2-4 groups, f32 scales included (where the order of the group sums
    shows).

    The plain version takes the kernel's ops in the TPU kernel's order,
    each rounded on its own: it equals the jnp form run op by op bit for
    bit. The interpret-mode run compiles the kernel body with XLA CPU,
    which fuses a group's multiply by its scale into the following add
    (one rounding instead of two): it equals the *compiled* jnp form bit
    for bit, and differs from the plain version by at most 1e-6 of the
    output scale (f32 output) or one bf16 step (bf16 output). Against
    `quant_matmul_w4a8_ref` (groups summed in index order): 1e-4 of the
    output scale."""
    n = 256
    pj, pt = _pair(k, n, seed=k, scale_dtype=scale_dtype)
    x = np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32)
    xp = np.zeros((max(32, -(-m // 32) * 32), k), np.float32)
    xp[:m] = x                                   # the Pallas int8 tile
    xq, xs = qm.quantize_activation_rows(jnp.asarray(xp))
    txq, txs = tqm.quantize_activation_rows(torch.from_numpy(x))
    for out in ("float32", "bfloat16"):
        jdt = getattr(jnp, out)
        want = _f32(run_pallas_interpret(qm._quant_matmul_w4a8_2d, xq, xs,
                                         pj, jdt))[:m]
        compiled = jax.jit(lambda a, b: jax_qmm_w4a8(a, b, pj, jdt))
        np.testing.assert_array_equal(_f32(compiled(xq, xs))[:m], want)
        got = _f32(tqm.w4a8_decode(txq, txs, pt, getattr(torch, out)))
        with jax.disable_jit():
            np.testing.assert_array_equal(
                _f32(jax_qmm_w4a8(xq, xs, pj, jdt))[:m], got)
        if out == "float32":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
        else:
            assert_one_bf16_step(got, want)
    ref_j = np.asarray(jq.quant_matmul_w4a8_ref(jnp.asarray(x), pj))
    ref_t = tq.quant_matmul_w4a8_ref(torch.from_numpy(x), pt).numpy()
    scale = np.abs(ref_j).max()
    np.testing.assert_allclose(ref_t, ref_j, rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(_f32(tqm.w4a8_plain(txq, txs, pt,
                                                   torch.float32)),
                               ref_j, rtol=0, atol=1e-4 * scale)


def _jax_float_stack(e, k, n, seed):
    parts = [_pair(k, n, seed + i) for i in range(e)]
    pj = jq.QuantLinearParams(
        qweight=jnp.stack([p.qweight for p, _ in parts]),
        scales=jnp.stack([p.scales for p, _ in parts]),
        zeros=jnp.stack([p.zeros for p, _ in parts]), bias=None,
        in_features=k, out_features=n, group_size=128)
    pt = tq.QuantLinearParams(
        qweight=torch.stack([p.qweight for _, p in parts]),
        scales=torch.stack([p.scales for _, p in parts]),
        zeros=torch.stack([p.zeros for _, p in parts]), bias=None,
        in_features=k, out_features=n, group_size=128)
    return pj, pt


@pytest.mark.parametrize("sizes", [
    (32, 32, 32, 32),            # tile-aligned
    (7, 50, 0, 71),              # straddle + empty
    (0, 0, 128, 0),              # single active expert
    (1, 1, 1, 125),              # skewed
])
def test_grouped_w4a16_plain_matches_pallas_interpret(sizes):
    """grouped_w4a16_plain vs `_quant_grouped_2d` in interpret mode (bm
    32: groups straddle m-tiles) within one bf16 step, on the group rows;
    the jnp form likewise."""
    e, k, n = len(sizes), 256, 256
    a = sum(sizes)
    pj, pt = _jax_float_stack(e, k, n, seed=40)
    xj, xt = _bf16_inputs(a, k, seed=41)
    gs = np.asarray(sizes, np.int32)
    want = _f32(run_pallas_interpret(qm._quant_grouped_2d, xj, pj,
                                     jnp.asarray(gs), bm=32))
    got = tmg.grouped_w4a16(xt, pt, torch.from_numpy(gs))
    assert got.dtype == torch.bfloat16
    assert_one_bf16_step(got, want)
    assert_one_bf16_step(jax_grouped_w4a16(xj, pj, jnp.asarray(gs)), want)


# ---------------------------------------------------------------------------
# 2. routes: the shape predicate and the dispatch tables
# ---------------------------------------------------------------------------

def _record_pallas(monkeypatch):
    """JAX side: every `pl.pallas_call` records its kernel's name and
    returns zeros (nothing runs); `quant_matmul_ref` records "ref"."""
    calls = []

    def fake(kernel, *a, out_shape=None, **kw):
        calls.append(kernel.func.__name__)
        return lambda *args: jnp.zeros(out_shape.shape, out_shape.dtype)

    ref = qm.quant_matmul_ref
    monkeypatch.setattr(qm.pl, "pallas_call", fake)
    monkeypatch.setattr(qm, "quant_matmul_ref", lambda *a: (
        calls.append("ref"), ref(*a))[1])
    return calls


@pytest.mark.parametrize("k,n,group", [
    (512, 256, 128), (512, 96, 128), (384, 256, 128), (1024, 384, 128),
    (512, 200, 128), (512, 256, 64), (1536, 2560, 128)])
def test_kernel_tiles_predicate_matches_jax(monkeypatch, k, n, group):
    """`kernel_tiles` is true exactly where the JAX package's dense
    wrappers reach their Pallas kernels (w4a16 and float-scale w4a8), and
    `grouped_tiles` where its grouped w4a16 wrapper does."""
    calls = _record_pallas(monkeypatch)
    rng = np.random.default_rng(0)
    g = k // group
    pj = jq.QuantLinearParams(
        qweight=jnp.asarray(rng.integers(0, 256, (k // 2, n)), jnp.uint8),
        scales=jnp.ones((g, n), jnp.bfloat16), zeros=jnp.zeros((g, n),
                                                              jnp.int8),
        bias=None, in_features=k, out_features=n, group_size=group)
    pt = tq.QuantLinearParams(
        qweight=torch.zeros(k // 2, n, dtype=torch.uint8),
        scales=torch.ones(g, n), zeros=torch.zeros(g, n, dtype=torch.int8),
        bias=None, in_features=k, out_features=n, group_size=group)
    x = jnp.zeros((8, k), jnp.bfloat16)
    qm._quant_matmul_2d(x, pj)
    w4a8 = qm._quant_matmul_w4a8_2d(jnp.zeros((32, k), jnp.int8),
                                    jnp.ones((32, 1)), pj, jnp.bfloat16)
    assert (calls == ["_qmm_kernel", "_qmm_w4a8_kernel"]) \
        == tqm.kernel_tiles(pt)
    assert (w4a8 is None) != tqm.kernel_tiles(pt)
    stack = dataclasses.replace(pj, qweight=pj.qweight[None],
                                scales=pj.scales[None], zeros=pj.zeros[None])
    tstack = dataclasses.replace(pt, qweight=pt.qweight[None],
                                 scales=pt.scales[None], zeros=pt.zeros[None])
    calls.clear()
    got = qm._quant_grouped_2d(jnp.zeros((128, k), jnp.bfloat16), stack,
                               jnp.asarray([128], jnp.int32))
    assert (got is not None) == (calls == ["_qgmm_kernel"]) \
        == tmg.grouped_tiles(tstack)


def test_untiled_stack_takes_the_reference_fallback(monkeypatch):
    """An expert stack the grouped kernels cannot tile (K/2 = 192, not a
    multiple of 128) takes `grouped_ref` in the port and the dequantize +
    ragged_dot fallback in the JAX package, with no kernel: same rows,
    f32 sums in another order (1e-5 of the output scale)."""
    from ferrum_tpu_torch.ops.kernels import moe_gemm

    pj, pt = _jax_float_stack(3, 384, 256, seed=50)
    assert not tmg.grouped_tiles(pt)
    for mod, name in ((moe_gemm, "grouped_w4a16"),
                      (moe_gemm, "grouped_w4a8tl")):
        monkeypatch.setattr(mod, name, None)        # must not be reached
    x = np.random.default_rng(51).normal(0, 1, (20, 384)).astype(np.float32)
    gs = np.asarray([7, 0, 13], np.int32)
    want = np.asarray(qm.quant_grouped_matmul(
        jnp.asarray(x), pj, None, jnp.asarray(gs)))
    got = tmg.quant_grouped_matmul(torch.from_numpy(x), pt, None,
                                   torch.from_numpy(gs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


# JAX kernel reached → the port wrapper that must run in its place.
_PORT_OF = {"_qmm_w4a8tl_mxu_kernel": "w4a8tl_decode",
            "_qmm_w4a8tl_gd_kernel": "w4a8tl_gd_decode",
            "_qmm_w4a8tl_kernel": "w4a8tl_prefill",
            "_qmm_w4a8_kernel": "w4a8_decode",
            "_qmm_kernel": "w4a16_gemm", "ref": "ref"}


@pytest.mark.parametrize("n", [256, 96, 1024])
@pytest.mark.parametrize("two_level", [True, False])
@pytest.mark.parametrize("gd", ["mxu", "off", "all", "down"])
@pytest.mark.parametrize("w4a8", [True, False])
def test_route_table_matches_jax(monkeypatch, w4a8, gd, two_level, n):
    """The dense dispatch over w4a8 on/off x gd mxu/off/all/down x params
    with and without scales2 x m in {1, 64, 65, 300} x K = 512 against a
    weight that tiles and narrows (N = 256: "down" takes the group-dot
    kernel), one that does not tile (N = 96) and one that widens (N =
    1024: "down" takes the float-scale w4a8 kernel): the kernel the JAX
    package reaches on the TPU and the port's wrapper correspond case by
    case."""
    k = 512
    pj, pt = _pair(k, n, seed=3)
    if two_level:
        pj = jq.requantize_two_level(pj)
        pt = tq.requantize_two_level(pt)
    calls = _record_pallas(monkeypatch)
    monkeypatch.setattr(qm, "on_tpu", lambda: True)
    for mod in (qm, tqm):
        monkeypatch.setattr(mod, "_W4A8", w4a8)
        monkeypatch.setattr(mod, "_W4A8_GD", gd)
    port = []
    for name in ("w4a8tl_decode", "w4a8tl_gd_decode", "w4a8tl_prefill",
                 "w4a8_decode", "w4a16_gemm", "quant_matmul_ref"):
        orig = getattr(tqm, name)
        monkeypatch.setattr(tqm, name, lambda *a, _n=name, _o=orig: (
            port.append(_n.replace("quant_matmul_", "")), _o(*a))[1])
    for m in (1, 64, 65, 300):
        calls.clear()
        port.clear()
        x = np.random.default_rng(m).normal(0, 1, (m, k)).astype(np.float32)
        qm.quant_matmul(jnp.asarray(x), pj)
        out = tqm.quant_matmul(torch.from_numpy(x), pt)
        assert tuple(out.shape) == (m, n)
        assert [_PORT_OF[c] for c in calls] == port, (m, calls, port)
        assert len(port) == 1


@pytest.mark.parametrize("two_level", [True, False])
@pytest.mark.parametrize("w4a8", [True, False])
@pytest.mark.parametrize("t", [1, 16, 32])
def test_moe_route_matches_jax(monkeypatch, t, w4a8, two_level):
    """moe_mlp's two routes (E=8, top-2: t*k >= E from t = 4): the
    all-experts bmm only with w4a8 on and two-level stacks, else the sort
    route, whose grouped GEMMs take the two-level kernel (w4a8 on,
    two-level stacks) or the w4a16 one. The activations are quantized once
    for gate and up only on the two-level grouped route. Same kernel
    sequence as the JAX dispatch the TPU runs, and outputs within the
    tolerance of tests/test_torch_moe.py."""
    from ferrum_tpu.ops.moe import moe_mlp as jmoe
    from ferrum_tpu_torch.ops import moe as tmoe

    route_float_scale(monkeypatch, w4a8)
    jcfg, jp, cfg, tp = tmo._moe_pair(seed=5)
    if not two_level:
        jp, tp = _strip_moe(jp), _strip_moe(tp)
    jcalls, tcalls = [], []
    for name in ("quant_bmm_all_experts", "_quant_grouped_w4a8tl_2d",
                 "_quant_grouped_2d"):
        fn = getattr(qm, name)
        monkeypatch.setattr(qm, name, lambda *a, _n=name, _f=fn, **kw: (
            jcalls.append(_n), _f(*a, **kw))[1])
    port_of = {"quant_bmm_all_experts": "quant_bmm_all_experts",
               "_quant_grouped_w4a8tl_2d": "grouped_w4a8tl",
               "_quant_grouped_2d": "grouped_w4a16"}
    for mod, name in ((tmoe, "quant_bmm_all_experts"),
                      (tmg, "grouped_w4a8tl"), (tmg, "grouped_w4a16"),
                      (tmoe, "quantize_activation_rows")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _n=name, _f=fn, **kw: (
            tcalls.append(_n), _f(*a, **kw))[1])
    x = np.random.default_rng(t).normal(0, 1, (t, tmo.H)).astype(np.float32)
    got = tmoe.moe_mlp(torch.from_numpy(x), tp, cfg).numpy()
    want = np.asarray(jmoe(jnp.asarray(x), jp, jcfg))
    kernels = [c for c in tcalls if c != "quantize_activation_rows"]
    assert kernels == [port_of[c] for c in jcalls], (jcalls, tcalls)
    all_experts = w4a8 and two_level and t * tmo.TOPK >= tmo.E
    assert jcalls[0] == ("quant_bmm_all_experts" if all_experts else
                         "_quant_grouped_w4a8tl_2d" if w4a8 and two_level
                         else "_quant_grouped_2d")
    # Sort route: one quantization for gate and up (the down projection's
    # comes inside its wrapper); all-experts: the route's own two.
    quantized = tcalls.count("quantize_activation_rows")
    assert quantized == (2 if all_experts else 1 if w4a8 and two_level
                         else 0)
    scale = np.abs(want).max()
    err = np.abs(got - want)
    assert err.max() <= 2e-3 * scale, err.max() / scale
    assert np.mean(err <= 1e-5 * scale) >= 0.99


def _strip_moe(p):
    """A MoE layer's expert stacks without their two-level fields (the
    form a float-scale checkpoint loads as)."""
    return dataclasses.replace(p, **{
        f: dataclasses.replace(getattr(p, f), scales2=None, chan_scale=None)
        for f in ("gate", "up", "down")})


# ---------------------------------------------------------------------------
# 3. the builder's mode switches: requantize only under w4a8 + two-level
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,requantized,w4a8", [
    ({}, True, True), ({"w4a8": False}, False, False),
    ({"w4a8_two_level": False}, False, True),
    ({"w4a8": False, "w4a8_two_level": True}, False, False)])
def test_builder_requantizes_only_under_w4a8_two_level(monkeypatch, mode,
                                                       requantized, w4a8):
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.models.convert import params_from_numpy

    for name in ("_W4A8", "_W4A8_GD"):
        monkeypatch.setattr(tqm, name, getattr(tqm, name))
    jcfg, jparams = jax_model("tiny-quant", quantized=True, two_level=False)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    engine = EngineBuilder(EngineConfig(device="cpu", **te._engine_kw(),
                                        **mode)) \
        .with_model(torch_config(jcfg), params).build()
    engine.stop()
    lp = engine.runner.params.layers[0]
    assert (lp.qkv.scales2 is not None) == requantized
    assert (lp.gate_up.scales2 is not None) == requantized
    assert tqm.w4a8_enabled() == w4a8 and tqm._W4A8_GD == "mxu"


def test_config_rejects_unported_group_dot_modes(monkeypatch):
    """The JAX package's four w4a8_gd modes (and its bools) are accepted
    by both `EngineConfig.validate` and `set_w4a8_gd`; any other mode is
    rejected by both, as the JAX `set_w4a8_gd` rejects it."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.types import InvalidRequestError

    monkeypatch.setattr(tqm, "_W4A8_GD", tqm._W4A8_GD)
    for gd, mode in (("off", "off"), ("all", "all"), ("down", "down"),
                     ("mxu", "mxu"), (True, "all"), (False, "off")):
        EngineConfig(w4a8_gd=gd).validate()
        tqm.set_w4a8_gd(gd)
        assert tqm._W4A8_GD == mode
    for gd in ("gd", "ALL", "", None):
        with pytest.raises(InvalidRequestError, match="unknown w4a8_gd"):
            EngineConfig(w4a8_gd=gd).validate()
        with pytest.raises(ValueError, match="unknown w4a8_gd"):
            tqm.set_w4a8_gd(gd)
        with pytest.raises(ValueError, match="unknown w4a8_gd"):
            qm.set_w4a8_gd(gd)


# ---------------------------------------------------------------------------
# 4. the slice as a whole: logits and engine streams vs the JAX package
# ---------------------------------------------------------------------------

def test_float_scale_w4a8_logits_match_jax(monkeypatch):
    """tiny-quant without the two-level step, w4a8 on: prefill (64 rows)
    and decode (2 rows) take the float-scale w4a8 kernel's function on
    both sides. The JAX side, compiled, fuses each group's scale multiply
    into the next add, so its outputs differ from the port's in the last
    f32 bit; downstream, such a bit can move one int8 activation across a
    .5 boundary, which changes that token's whole row of logits (by up to
    ~1e-2 of the scale on these weights). So every logit within 5e-2 of
    the scale, and 90% of the token rows entirely within 1e-5 of it
    (measured: 1 row of 60 off)."""
    from ferrum_tpu_torch.models.convert import params_from_numpy

    route_float_scale(monkeypatch, w4a8=True)
    jcfg, jparams = jax_model("tiny-quant", quantized=True, two_level=False)
    cfg = torch_config(jcfg)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    assert params.layers[0].qkv.scales2 is None
    inputs = tm._inputs(cfg.vocab_size)
    want, fed = tm._run_jax(jcfg, jparams, inputs)
    got = tm._run_torch(cfg, params, inputs, fed)
    real = (inputs[1] < tm.MAX_LEN).reshape(-1)
    want[0], got[0] = want[0][real], got[0][real]
    rows_close = []
    for w, g in zip(want, got):
        scale = np.abs(w).max()
        err = np.abs(w - g)
        assert err.max() <= 5e-2 * scale, err.max() / scale
        rows_close += list((err <= 1e-5 * scale).all(axis=-1))
    assert np.mean(rows_close) >= 0.9, np.mean(rows_close)


def test_w4a16_moe_logits_match_jax(monkeypatch):
    """The 2-layer MoE model (E=8, top-2) without the two-level step and
    w4a8 off: every projection takes the w4a16 GEMM's function, every MoE
    layer the sort route through the grouped w4a16 one. No activation is
    quantized; f32 sums in another order, so 1e-4 of the logit scale."""
    from ferrum_tpu_torch.models.convert import params_from_numpy

    route_float_scale(monkeypatch, w4a8=False)
    jcfg = tmo._jax_moe_model()[0]
    jcfg, jparams = jax_model(jcfg, quantized=True, two_level=False)
    cfg = torch_config(jcfg)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    assert params.layers[0].moe.gate.scales2 is None
    inputs = tmo._model_inputs(cfg.vocab_size)
    want, fed = tmo._run_jax_model(jcfg, jparams, inputs)
    got = tmo._run_torch_model(cfg, params, inputs, fed)
    real = (inputs[1] < tmo.MAX_LEN).reshape(-1)
    want[0], got[0] = want[0][real], got[0][real]
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def _streams(jcfg, jparams, mode):
    """(port tokens, port streamed tokens, JAX tokens) of the engine
    parity test's 3 requests under EngineConfig(**mode) in both."""
    from ferrum_tpu.config import EngineConfig as JConfig
    from ferrum_tpu.engine.builder import EngineBuilder as JBuilder
    from ferrum_tpu.types import InferenceRequest, SamplingParams
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.types import InferenceRequest as TReq
    from ferrum_tpu_torch.types import SamplingParams as TSamp

    cfg = torch_config(jcfg)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    engine = EngineBuilder(EngineConfig(device="cpu", **te._engine_kw(),
                                        **mode)).with_model(cfg,
                                                            params).build()
    got, streamed = te._serve(engine, TReq, TSamp)
    jengine = JBuilder(JConfig(
        model="parity", dtype="f32", kv_layout="linear",
        enable_prefix_cache=False, mixed_prefill=False,
        pipeline_decode=False, adaptive_windows=False,
        decode_bucket_spec="max", **te._engine_kw(), **mode)
    ).with_model(jcfg, jparams).build()
    want = te._serve(jengine, InferenceRequest, SamplingParams)[0]
    return cfg, engine.runner.params, got, streamed, want


@pytest.mark.parametrize("mode", [{"w4a8": False},
                                  {"w4a8_two_level": False}])
def test_greedy_streams_match_jax_engine(monkeypatch, mode):
    """3 concurrent greedy requests through both engines on tiny-quant
    without the two-level step. The logit tolerance between the packages
    is 1e-5 of the scale (test_torch_model.py); every generated token
    must lead its runner-up by te.MARGIN = 1e-3 of the scale, 100x that,
    or the test fails as a near-tie instead of flaking."""
    route_float_scale(monkeypatch, w4a8=mode.get("w4a8", True))
    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=3,
                              two_level=False)
    cfg, params, got, streamed, want = _streams(jcfg, jparams, mode)
    assert params.layers[0].qkv.scales2 is None
    assert streamed == got
    for prompt, out in zip(te.PROMPTS, got):
        assert len(out) == te.MAX_TOKENS
        argmax, margins = te._margins(cfg, params, prompt, out)
        assert argmax == out, "engine tokens differ from the model's argmax"
        assert min(margins) > te.MARGIN, (
            f"near-tie (margin {min(margins):.2e} of the logit scale): "
            f"pick another seed, the comparison would be a coin flip")
    assert got == want
