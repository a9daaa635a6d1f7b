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
which are held against the interpret-mode runs here too. The two w4a16
kernels' decode-size main loop (csrc/w4a16_stream.cuh) is emulated block
by block in numpy and held against their plain versions (section 5), and
so is the float-scale w4a8 kernel's (the streamed loop's float-scale
form: its f32 fold in the TPU kernel's order, row tiles and split
planes), bit for bit against w4a8_plain, with its launcher's rule
(section 6).
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
import test_torch_quant as ttq
from test_torch_quant import _byte_perm
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
                                        **te.LINEAR, **mode)) \
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
                                        **te.LINEAR, **mode)).with_model(cfg,
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


# ---------------------------------------------------------------------------
# 5. the w4a16 kernels' decode-size tile walk, emulated: csrc/
#    w4a16_stream.cuh (the streamed decode loop in bf16) block by block in
#    numpy -- ring layout, dequant bit arithmetic, fragment reads, split-K
#    planes, row windows -- against the plain versions
# ---------------------------------------------------------------------------

_W16_KP, _W16_LINE = 64, 272                # kKP, kLine


def _w16_stages(bm):
    """kStreamStages<BM>: the launcher's ring depth."""
    return 3 if bm == 64 else 4


H100_SMS = 132
H100_SMEM_PER_SM = 233472                   # 228 KB a block set may use
H100_SMEM_PER_BLOCK_RESERVED = 1024


def _rne_bf16(f):
    """bf16 bits (uint16) of f32 values, rounded to nearest even on the
    f32 bits (subnormals too: their bf16 keeps the top 16 bits as well)."""
    b = np.asarray(f, np.float32).view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) >> 16).astype(np.uint16)


def _bf16_f32(bits):
    return (np.asarray(bits).astype(np.uint32) << np.uint32(16)).view(
        np.float32)


def _w16_dequant2(t, z128, s, shift):
    """w4a16_wgmma.cuh's dequant2 on uint32 words t: q128 = ((t >> shift)
    & 0x000F000F) | 0x43004300, then sub.rn.bf16x2 by z128 and
    mul.rn.bf16x2 by s, each 16-bit half in f32 (exact: the difference
    is an integer below 256, the product of two bf16 has 16 significant
    bits) and rounded to bf16 on its bits."""
    t = np.asarray(t, np.uint32)
    q = ((t >> np.uint32(shift)) & np.uint32(0x000F000F)) \
        | np.uint32(0x43004300)
    out = np.zeros_like(q)
    for half in (0, 16):
        def f(w):
            return _bf16_f32((np.asarray(w, np.uint32) >> np.uint32(half))
                             & np.uint32(0xFFFF))
        d = _rne_bf16(f(q) - f(z128))
        out |= _rne_bf16(_bf16_f32(d) * f(s)).astype(np.uint32) \
            << np.uint32(half)
    return out


def _w16_geometry(bm):
    """Stream<BM, ..>'s warp grid (WM, WN) of its 256 threads and unit
    rows R."""
    wm = 2 if bm >= 32 else 1
    return wm, 8 // wm, 8


def _w16_stage_bytes(bm, bn, scb):
    return bm * _W16_LINE + _W16_KP * bn + 2 * bn * scb + 2 * bn


def _w16_load(st, s, scales, x8, qw, sc8, zr8, win, n0, k, bm, bn, r,
              scb):
    """Stream::load: the 16-byte chunks cp.async places in stage `st`
    (flat uint8) for step s. x8: x's bf16 rows as bytes [rows, 2K]; line
    i holds row m0 + i, zero outside [row_lo, row_hi) (win); the packed
    tile's chunk c of row r at c ^ swz(r / R); with `scales`, the scale
    rows (sc8: bytes [K/128, N * scb]) and zero rows of both halves."""
    m0, row_lo, row_hi = win
    k2, r0, chunks = k // 2, s * _W16_KP, bn // 16
    b16 = np.arange(16)
    idx = np.arange(bm * 16)
    row, c = idx >> 4, idx & 15
    m = m0 + row
    ok = (m >= row_lo) & (m < row_hi)
    col = 2 * (np.where(c < 8, r0, k2 + r0 - 64) + c * 8)
    vals = x8[np.clip(m, 0, x8.shape[0] - 1)[:, None], col[:, None] + b16]
    st[(row * _W16_LINE + c * 16)[:, None] + b16] = np.where(ok[:, None],
                                                             vals, 0)
    a_bytes = bm * _W16_LINE
    idx = np.arange(_W16_KP * chunks)
    row, c = idx // chunks, idx % chunks
    swz = ((row // r) * (r // 8)) & (chunks - 1)
    st[(a_bytes + row * bn + ((c ^ swz) << 4))[:, None] + b16] = \
        qw[(r0 + row)[:, None], n0 + c[:, None] * 16 + b16]
    if scales:
        base, row_b = a_bytes + _W16_KP * bn, bn * scb
        for h, g in enumerate((r0 // 128, k2 // 128 + r0 // 128)):
            st[base + h * row_b:base + (h + 1) * row_b] = \
                sc8[g, n0 * scb:(n0 + bn) * scb]
            st[base + 2 * row_b + h * bn:base + 2 * row_b + (h + 1) * bn] = \
                zr8[g, n0:n0 + bn]


def _w16_scales(st, bm, bn, r, scb):
    """Stream::load_group for the dequant's units: per half h and column j
    of unit u's 4 columns 4 * (u / rbs) + j, bf16(128 + z) and the bf16
    scale (f32 scales rounded), each in both 16-bit halves of a word."""
    rbs = _W16_KP // r
    cu = np.arange(rbs * bn // 4) // rbs
    base, row_b = bm * _W16_LINE + _W16_KP * bn, bn * scb
    z128 = np.zeros((2, 4, cu.size), np.uint32)
    s = np.zeros((2, 4, cu.size), np.uint32)
    for h in range(2):
        for j in range(4):
            z = st[base + 2 * row_b + h * bn + 4 * cu + j].view(np.int8)
            z128[h, j] = _rne_bf16(128 + z.astype(np.float32)).astype(
                np.uint32) * 0x00010001
            raw = np.ascontiguousarray(
                st[(base + h * row_b + (4 * cu + j) * scb)[:, None]
                   + np.arange(scb)])
            bits = _rne_bf16(raw.view(np.float32)[:, 0]) if scb == 4 \
                else raw.view(np.uint16)[:, 0]
            s[h, j] = bits.astype(np.uint32) * 0x00010001
    return z128, s


def _w16_dequant(st, scl, bm, bn, r, lines):
    """Stream::dequant into the w lines (flat uint8): unit u takes packed
    rows R * rb .. (rb = u % rbs) of columns 4 * cu .. (cu = u / rbs), one
    __byte_perm per row pair and column, dequant2 per half, a 16-byte
    store per column and half at byte 2 * R * rb of the half."""
    words, out = st.view("<u4"), lines.view("<u4")
    rbs = _W16_KP // r
    u = np.arange(rbs * bn // 4)
    rb, cu = u % rbs, u // rbs
    swz = (rb * (r // 8)) & (bn // 16 - 1)
    base = bm * _W16_LINE + (((cu >> 2) ^ swz) << 4) + ((cu & 3) << 2)
    z128, s = scl
    row = r * rb
    lo = np.zeros((4, r // 2, u.size), np.uint32)
    hi = np.zeros((4, r // 2, u.size), np.uint32)
    for i in range(r // 2):
        w0 = words[(base + (row + 2 * i) * bn) // 4]
        w1 = words[(base + (row + 2 * i + 1) * bn) // 4]
        for j in range(4):
            t = _byte_perm(w0, w1, 0x4400 + 0x1111 * j)
            lo[j, i] = _w16_dequant2(t, z128[0, j], s[0, j], 0)
            hi[j, i] = _w16_dequant2(t, z128[1, j], s[1, j], 4)
    for j in range(4):
        w = ((4 * cu + j) * _W16_LINE + 2 * row) // 4
        for i in range(r // 2):
            out[w + i] = lo[j, i]
            out[w + 2 * _W16_KP // 4 + i] = hi[j, i]


def _w16_mma(acc, st, lines, bm, bn, wm_, wn_):
    """Stream::mma: each lane's A and B fragment words read at the
    kernel's shared-memory offsets and placed per mma.m16n8k16's bf16
    fragment layout (the lower k of a pair in the lower half); each mma's
    C added into acc [warp, MT, NT, lane, 4] and rounded to f32."""
    wtm, wtn = bm // wm_, bn // wn_
    mt, nt = wtm // 16, wtn // 8
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    sa, sb = st.view("<u2"), lines.view("<u2")
    for kc in range(2 * _W16_KP // 16):
        k0 = kc * 32 + t * 4
        amat = np.zeros((wm_, mt, 16, 16))
        for wm in range(wm_):
            for i in range(mt):
                ra = (wm * wtm + i * 16 + g) * _W16_LINE + k0
                for roff, koff in ((0, 0), (8, 0), (0, 8), (8, 8)):
                    h = (ra + roff * _W16_LINE + 2 * koff) // 2
                    amat[wm, i, g + roff, koff + 2 * t] = _bf16_f32(sa[h])
                    amat[wm, i, g + roff, koff + 2 * t + 1] = _bf16_f32(
                        sa[h + 1])
        bmat = np.zeros((wn_, nt, 16, 8))
        for wn in range(wn_):
            for j in range(nt):
                cb = (wn * wtn + j * 8 + g) * _W16_LINE + k0
                for koff in (0, 8):
                    h = (cb + 2 * koff) // 2
                    bmat[wn, j, koff + 2 * t, g] = _bf16_f32(sb[h])
                    bmat[wn, j, koff + 2 * t + 1, g] = _bf16_f32(sb[h + 1])
        for w in range(wm_ * wn_):
            c = np.einsum("irk,jkn->ijrn", amat[w // wn_], bmat[w % wn_])
            for e in range(4):
                acc[w, ..., e] = (acc[w, ..., e] + c[
                    :, :, g + 8 * (e >> 1), 2 * t + (e & 1)]).astype(
                        np.float32)


def _w16_block(w, x8, win, n0, k, bm, bn, s_begin, s_end, rng):
    """One block of dense_kernel / grouped_kernel: its main loop over
    steps [s_begin, s_end) with a ring and w line buffers that start as
    garbage; asserts that each step's w lines hold w4a16_weight's columns
    bit for bit. w: one weight's (qw, sc8, zr8, scb, bf16 weight bits
    [K, N]). Returns the f32 sums [BM, BN] by Stream::for_each_pair."""
    qw, sc8, zr8, scb, w_bits = w
    wm_, wn_, r = _w16_geometry(bm)
    wtm, wtn = bm // wm_, bn // wn_
    stages = _w16_stages(bm)
    ring = rng.integers(0, 256, (stages, _w16_stage_bytes(bm, bn, scb)),
                        np.uint8)
    lines = rng.integers(0, 256, (2, bn * _W16_LINE), np.uint8)
    acc = np.zeros((wm_ * wn_, wtm // 16, wtn // 8, 32, 4), np.float32)
    n = s_end - s_begin

    def fetch(j):
        s = s_begin + j
        if j < n:
            _w16_load(ring[j % stages], s, s == s_begin or s % 2 == 0, x8,
                      qw, sc8, zr8, win, n0, k, bm, bn, r, scb)

    def mma(j):
        r0 = (s_begin + j) * _W16_KP
        want = np.concatenate([w_bits[r0:r0 + _W16_KP, n0:n0 + bn],
                               w_bits[k // 2 + r0:k // 2 + r0 + _W16_KP,
                                      n0:n0 + bn]]).T
        got = lines[j & 1].view("<u2").reshape(bn, _W16_LINE // 2)
        np.testing.assert_array_equal(got[:, :2 * _W16_KP], want)
        _w16_mma(acc, ring[j % stages], lines[j & 1], bm, bn, wm_, wn_)

    for j in range(stages - 1):
        fetch(j)
    scl = _w16_scales(ring[0], bm, bn, r, scb)
    _w16_dequant(ring[0], scl, bm, bn, r, lines[0])
    for j in range(n - 1):
        fetch(j + stages - 1)
        if (s_begin + j + 1) % 2 == 0:
            scl = _w16_scales(ring[(j + 1) % stages], bm, bn, r, scb)
        mma(j)
        _w16_dequant(ring[(j + 1) % stages], scl, bm, bn, r,
                     lines[(j + 1) & 1])
    mma(n - 1)
    tile = np.zeros((bm, bn), np.float32)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for w_ in range(wm_ * wn_):
        wm, wn = w_ // wn_, w_ % wn_
        for i in range(wtm // 16):
            for j in range(wtn // 8):
                for e in range(4):
                    tile[wm * wtm + i * 16 + g + 8 * (e >> 1),
                         wn * wtn + j * 8 + 2 * t + (e & 1)] = \
                        acc[w_, i, j, :, e]
    return tile


def _w16_weight_bytes(p, e=None):
    """(qw, scale bytes, zero bytes, scale bytes a value, bf16 weight bits
    [K, N]) of weight p, or of expert e of a stack."""
    pick = (lambda t: t) if e is None else (lambda t: t[e])
    sc = pick(p.scales)
    scb = 4 if sc.dtype == torch.float32 else 2
    sc8 = (sc.contiguous().view(torch.int16) if scb == 2 else sc).numpy() \
        .view(np.uint8).reshape(sc.shape[0], -1)
    w = tq.w4a16_weight(p)
    return (pick(p.qweight).numpy(), sc8,
            pick(p.zeros).numpy().view(np.uint8), scb,
            pick(w).contiguous().view(torch.int16).numpy().view(np.uint16))


def _x8(x):
    return x.contiguous().view(torch.int16).numpy().view(np.uint8).reshape(
        x.shape[0], -1)


def _w16_dense(x, p, bn, splits, rng):
    """w4a16_gemm at decode m emulated: grid (N / BN, 1, splits) of
    dense_kernel blocks (BM = 16 / 32 / 64 by m), each split's f32 tile
    into its plane of part (random contents before), the planes summed in
    split order by each tile's last arrival (random order) and rounded to
    bf16; with one split the block's tile is rounded straight away."""
    m, k = x.shape
    n = p.out_features
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    nsteps = k // 2 // _W16_KP
    per = -(-nsteps // min(splits, nsteps))
    used = -(-nsteps // per)
    w, x8 = _w16_weight_bytes(p), _x8(x)
    part = rng.standard_normal((used, m, n)).astype(np.float32)
    counters = np.zeros(n // bn, np.int64)
    writes = np.zeros((m, n), np.int64)
    out = np.zeros((m, n), np.uint16)
    for tile in range(n // bn):
        n0 = tile * bn
        cols = slice(n0, n0 + bn)
        for zi in rng.permutation(used):            # arrival order
            full = _w16_block(w, x8, (0, 0, m), n0, k, bm, bn, zi * per,
                              min(nsteps, zi * per + per), rng)[:m]
            if used > 1:
                part[zi, :, cols] = full
                counters[tile] += 1
                if counters[tile] != used:
                    continue
                counters[tile] = 0
                full = np.zeros((m, bn), np.float32)
                for z in range(used):
                    full = full + part[z, :, cols]
            writes[:, cols] += 1
            out[:, cols] = _rne_bf16(full)
    assert (writes == 1).all() and not counters.any()
    return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)


def _w16_grouped(x, p, sizes, bn, rng):
    """The grouped kernel at 16-row tiles emulated: grid (N / BN, logical
    tiles of group_tile_map), each valid tile's block on its expert's
    weight over the full K, staging and writing only its expert's rows."""
    a, k = x.shape
    e, n = p.qweight.shape[0], p.out_features
    n_logical = -(-a // 16) + e - 1
    gid, mtid, offsets, valid = (t.tolist() for t in tmg.group_tile_map(
        torch.tensor(sizes, dtype=torch.int32), 16, n_logical))
    x8 = _x8(x)
    out = np.zeros((a, n), np.uint16)
    writes = np.zeros((a, n), np.int64)
    for i in range(n_logical):
        g, m0 = gid[i], mtid[i] * 16
        lo, hi = max(offsets[g], m0), min(offsets[g + 1], m0 + 16)
        if not valid[i] or lo >= hi:
            continue
        w = _w16_weight_bytes(p, g)
        for n0 in range(0, n, bn):
            full = _w16_block(w, x8, (m0, lo, hi), n0, k, 16, bn, 0,
                              k // 2 // _W16_KP, rng)
            out[lo:hi, n0:n0 + bn] = _rne_bf16(full[lo - m0:hi - m0])
            writes[lo:hi, n0:n0 + bn] += 1
    assert (writes == 1).all()
    return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)


def _w16_inputs(kind, rows, k, n, seed, scale_dtype, experts=0):
    """(x bf16 [rows, K], float-scale weight or [experts, ...] stack).
    "exact": x in -3..3, q and z in 0..15, scales powers of two (2^-4 ..
    2^3): every product and f32 sum is exact, so the kernel must give the
    plain version's bits. "random": normal x, a quantized random weight
    (scales and zeros vary by group and column)."""
    rng = np.random.default_rng(seed)
    e = max(experts, 1)
    if kind == "exact":
        x = rng.integers(-3, 4, (rows, k)).astype(np.float32)
        q = rng.integers(0, 16, (e, k, n))
        z = rng.integers(0, 16, (e, k // 128, n)).astype(np.int8)
        s = np.exp2(rng.integers(-4, 4, (e, k // 128, n))).astype(np.float32)
        packed = (q[:, :k // 2] | (q[:, k // 2:] << 4)).astype(np.uint8)
    else:
        x = rng.normal(0, 1, (rows, k)).astype(np.float32)
        parts = [_pair(k, n, seed + 1 + i)[1] for i in range(e)]
        packed = np.stack([pp.qweight.numpy() for pp in parts])
        z = np.stack([pp.zeros.numpy() for pp in parts])
        s = np.stack([pp.scales.float().numpy() for pp in parts])
    sdt = torch.bfloat16 if scale_dtype == "bf16" else torch.float32
    pick = (lambda a_: a_[0]) if not experts else (lambda a_: a_)
    p = tq.QuantLinearParams(
        qweight=torch.from_numpy(pick(packed)).contiguous(),
        scales=torch.from_numpy(pick(s)).to(sdt).contiguous(),
        zeros=torch.from_numpy(pick(z)).contiguous(), bias=None,
        in_features=k, out_features=n, group_size=128)
    return torch.from_numpy(x).to(torch.bfloat16), p


# (m, K, N, BN, splits): every m of the decode rows' tiles (BM 16 / 32 /
# 64), K of 2, 6 and 16 steps, N = 192 (64-column tiles only) and the
# 128-column ones at N = 128 and 640; splits 2 at K = 256 and at K =
# 768, and 6 at K = 2048, start a split mid-group (1 and 3 steps a split).
_W16_DENSE = [(1, 256, 128, 64, 2), (1, 2048, 640, 128, 1),
              (17, 768, 192, 64, 2), (17, 2048, 128, 128, 6),
              (32, 256, 640, 64, 1), (32, 2048, 192, 64, 6),
              (32, 768, 128, 128, 1), (64, 768, 640, 128, 2),
              (64, 2048, 192, 64, 1), (64, 256, 128, 64, 1)]


@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("m,k,n,bn,splits", _W16_DENSE)
def test_w4a16_stream_walk_matches_plain(m, k, n, bn, splits, kind):
    """w4a16_gemm at decode m on csrc/w4a16_stream.cuh, emulated block by
    block in numpy: where cp.async places each chunk (x lines, the
    swizzled packed tile, the scale rows only on a split's first step and
    at group starts), the byte-perm + bf16x2 dequant into 272-byte lines
    (bit arithmetic, rounded to nearest even on the f32 bits), the
    mma.sync fragment reads, the split plan, the planes and counters. The
    lines must equal w4a16_weight, and the result w4a16_plain's bits on
    exact inputs and within one bf16 step on random ones; bf16 and f32
    scales alternate with the case."""
    scale_dtype = ("bf16", "f32")[(m + k + (kind == "exact")) % 2]
    x, p = _w16_inputs(kind, m, k, n, 100 * m + k + n, scale_dtype)
    rng = np.random.default_rng(m + k + n + splits)
    got = _w16_dense(x, p, bn, splits, rng)
    want = tqm.w4a16_plain(x, p)
    if kind == "exact":
        assert torch.equal(got, want)
    else:
        assert_one_bf16_step(got, want)


# (group sizes, K, N, BN): one expert over three 16-row tiles, a single
# row, and three experts with an empty group, a single row and a group
# spanning tiles (boundaries inside a tile).
_W16_GROUPED = [((33,), 256, 128, 64), ((1,), 768, 192, 64),
                ((0, 1, 40), 256, 192, 64), ((17, 0, 5), 768, 128, 128)]


@pytest.mark.parametrize("kind", ["exact", "random"])
@pytest.mark.parametrize("sizes,k,n,bn", _W16_GROUPED)
def test_grouped_w4a16_stream_walk_matches_plain(sizes, k, n, bn, kind):
    """moe_grouped_w4a16 at 16-row tiles on csrc/w4a16_stream.cuh,
    emulated: each valid logical tile's block on its expert's weight,
    scales and zeros (the stack offsets), its row window staged and
    written, the rest zero lines. Rows of each group equal
    grouped_w4a16_plain's bits on exact inputs and lie within one bf16
    step on random ones."""
    scale_dtype = ("bf16", "f32")[(k + len(sizes) + (kind == "exact")) % 2]
    x, p = _w16_inputs(kind, sum(sizes), k, n, 7 * k + n, scale_dtype,
                       experts=len(sizes))
    got = _w16_grouped(x, p, sizes, bn, np.random.default_rng(sum(sizes) + k))
    want = tmg.grouped_w4a16_plain(x, p, torch.tensor(sizes))
    if kind == "exact":
        assert torch.equal(got, want)
    else:
        assert_one_bf16_step(got, want)


@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
def test_w4a16_stream_dequant_exhaustive(scale_dtype):
    """The streamed loop's dequant (one byte_perm per row pair, dequant2
    per half) through its stage layout, for every q in 0..15, every int8
    z (the quantizer emits 0..15; the arithmetic is exact for all) in
    both nibble halves, and scales 2^t (1 + u) for every t in -133 ..
    119 (bf16-subnormal below 2^-126) with random u (bf16 scales, or f32
    ones that the kernel rounds to bf16): the w lines must equal
    w4a16_weight bit for bit, at both column tiles (BN 64 and 128)."""
    rng = np.random.default_rng(21)
    k, n = 256, 512
    zs = np.arange(-128, 128)
    z = np.stack([np.tile(zs, 2), np.roll(np.tile(zs, 2), 77)]).astype(
        np.int8)
    t = rng.integers(-133, 120, (2, n))
    t[0, :253] = np.arange(-133, 120)
    s = ((1 + rng.random((2, n))) * np.exp2(t.astype(np.float64))).astype(
        np.float32)
    q = (np.arange(k)[:, None] + np.arange(n)[None] * 7) % 16
    p = tq.QuantLinearParams(
        qweight=torch.from_numpy((q[:k // 2] | (q[k // 2:] << 4)).astype(
            np.uint8)),
        scales=torch.from_numpy(s).to(torch.bfloat16 if scale_dtype == "bf16"
                                      else torch.float32),
        zeros=torch.from_numpy(z), bias=None, in_features=k, out_features=n,
        group_size=128)
    w = _w16_weight_bytes(p)
    assert ((tq.w4a16_weight(p).float().abs() < 2.0 ** -126)
            & (tq.w4a16_weight(p) != 0)).any()
    x8 = np.zeros((1, 2 * k), np.uint8)
    _, _, r = _w16_geometry(16)
    for bn in (64, 128):
        for n0 in range(0, n, bn):
            for s_ in range(k // 2 // _W16_KP):
                st = np.zeros(_w16_stage_bytes(16, bn, w[3]), np.uint8)
                lines = np.zeros(bn * _W16_LINE, np.uint8)
                _w16_load(st, s_, True, x8, w[0], w[1], w[2], (0, 0, 1),
                          n0, k, 16, bn, r, w[3])
                _w16_dequant(st, _w16_scales(st, 16, bn, r, w[3]), 16, bn,
                             r, lines)
                r0 = s_ * _W16_KP
                want = np.concatenate([w[4][r0:r0 + 64, n0:n0 + bn],
                                       w[4][k // 2 + r0:k // 2 + r0 + 64,
                                            n0:n0 + bn]]).T
                got = lines.view("<u2").reshape(bn, -1)[:, :128]
                np.testing.assert_array_equal(got, want)


def test_w4a16_stream_line_banks():
    """The 272-byte line (68 words, so the 8 lines of a fragment load
    start 4 banks apart): every mma.sync fragment load of the x and w
    lines touches 32 distinct banks, and the dequant's 16-byte stores
    give each quarter warp 32 distinct banks (8 row blocks of one
    column's 128 bytes)."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for kc in range(8):
        for roff in (0, 8):
            for koff in (0, 16):
                word = ((g + roff) * _W16_LINE + kc * 32 + 4 * t + koff) // 4
                assert np.unique(word % 32).size == 32

    def phases_free(addr):
        """16-byte stores `addr` [32 lanes]: each quarter warp's 8 stores
        cover 32 distinct banks."""
        banks = (addr[:, None] // 4 + np.arange(4)) % 32
        return all(np.unique(banks[q:q + 8]).size == 32
                   for q in range(0, 32, 8))

    _, _, r = _w16_geometry(16)
    rbs = _W16_KP // r
    rb, cu = lane % rbs, lane // rbs
    for warp_cu in (0, 4, 8, 12):                 # four warps' column units
        for j in range(4):
            for half in (0, 2 * _W16_KP):
                addr = ((4 * (cu + warp_cu) + j) * _W16_LINE
                        + 2 * r * rb + half)
                assert phases_free(addr)


def _decode_splits(m, bn, tiles, nsteps, slots):
    """w4a8tl_stream.cuh's decode_splits: the fewest splits with the least
    waves * (steps a split + 2) + splits * M * N / 1e6 (one split: no
    partials)."""
    best, best_cost = 1, None
    for s in range(1, nsteps + 1):
        per = -(-nsteps // s)
        if -(-nsteps // per) != s:
            continue
        waves = -(-(tiles * s) // slots)
        cost = waves * (per + 2) + (s * m * bn * tiles / 1e6 if s > 1
                                    else 0.0)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best


# The launcher's rule lines in csrc/w4a16_stream.cuh that _w16_plan
# mirrors.
_W16_RULE = {
    "stream_narrow": "a.N % 128 != 0 || (long)a.K / 2 * a.N <= "
                     "kStreamNarrowBytes",
}
_W16_RULE_LINES = ("constexpr int kStreamStages = BM == 64 ? 3 : 4;",
                   "constexpr int kThreads = 256;",
                   "constexpr int kLine = 4 * kKP + 16;")


def _w16_plan(m, n, k, experts=None, sms=H100_SMS):
    """The launcher's rule (decode_any, launch_bn, launch_bm, launch) in
    Python for m rows (grouped: m expert-sorted rows over `experts`): the
    plan's BM, BN, threads, stages, splits, K steps a split and resident
    blocks an SM, the last as the shared memory and the threads allow
    (registers may allow fewer)."""
    bn = 64 if n % 128 or k // 2 * n <= 16 << 20 else 128
    grouped = experts is not None
    bm = 16 if grouped or m <= 16 else 32 if m <= 32 else 64
    threads, stages = 256, _w16_stages(bm)
    smem = 2 * bn * _W16_LINE + stages * _w16_stage_bytes(bm, bn, 2)
    per_sm = min(H100_SMEM_PER_SM // (smem + H100_SMEM_PER_BLOCK_RESERVED),
                 2048 // threads)
    nsteps = k // 2 // _W16_KP
    splits = 1 if grouped else _decode_splits(m, bn, n // bn, nsteps,
                                              sms * per_sm)
    per = -(-nsteps // splits)
    return dict(bm=bm, bn=bn, threads=threads, stages=stages,
                splits=-(-nsteps // per), steps_per_split=per,
                blocks_per_sm=per_sm)


# The served decode shapes and the plans the rule gives them on an H100
# (132 SMs): qwen3-30b-a3b qkv / o at m = 1 / 32 / 64, llama-3.1-8b's four
# projections at m = 32 (EngineConfig(w4a8=False) on llama), and the
# qwen3-30b-a3b expert sites at 8 and 256 rows over 128 experts.
_W16_SERVED = {
    # (site, m, K, N, experts): (BM, BN, threads, splits, blocks an SM)
    ("qwen3 qkv", 1, 2048, 5120, None): (16, 64, 256, 4, 3),
    ("qwen3 qkv", 32, 2048, 5120, None): (32, 64, 256, 3, 2),
    ("qwen3 qkv", 64, 2048, 5120, None): (64, 64, 256, 3, 2),
    ("qwen3 o", 1, 4096, 2048, None): (16, 64, 256, 11, 3),
    ("qwen3 o", 32, 4096, 2048, None): (32, 64, 256, 8, 2),
    ("qwen3 o", 64, 4096, 2048, None): (64, 64, 256, 8, 2),
    ("llama qkv", 32, 4096, 6144, None): (32, 64, 256, 2, 2),
    ("llama o", 32, 4096, 4096, None): (32, 64, 256, 4, 2),
    ("llama gate_up", 32, 4096, 28672, None): (32, 128, 256, 1, 1),
    ("llama down", 32, 14336, 4096, None): (32, 128, 256, 4, 1),
    ("qwen3 gate / up", 8, 2048, 768, 128): (16, 64, 256, 1, 3),
    ("qwen3 down", 8, 768, 2048, 128): (16, 64, 256, 1, 3),
    ("qwen3 gate / up", 256, 2048, 768, 128): (16, 64, 256, 1, 3),
    ("qwen3 down", 256, 768, 2048, 128): (16, 64, 256, 1, 3),
}


@pytest.mark.parametrize("shape", list(_W16_SERVED), ids=str)
def test_w4a16_stream_launch_rule_at_served_shapes(shape):
    """The rule the launcher keeps (the source's rule lines are the ones
    _w16_plan mirrors) gives each served decode shape the pinned plan,
    the plan the card reported (chip_smoke.py's decode cases): 64-column
    tiles up to 16 MiB of packed weight, 256 threads, a 3-stage ring at
    BM 64 (two blocks an SM) and 4 elsewhere, the dense K splits that
    fill the resident slots in whole waves, one split of the full K where
    grouped."""
    import os
    import re

    src = open(os.path.join(
        os.path.dirname(__file__), os.pardir, "ferrum_tpu_torch", "ops",
        "kernels", "csrc", "w4a16_stream.cuh")).read()
    for name, rule in _W16_RULE.items():
        got = re.search(rf"const bool {name} =\s*([^;]*);", src)
        assert got and " ".join(got.group(1).split()) == rule, name
    for line in _W16_RULE_LINES:
        assert line in src, line
    _, m, k, n, e = shape
    plan = _w16_plan(m, n, k, e)
    assert (plan["bm"], plan["bn"], plan["threads"], plan["splits"],
            plan["blocks_per_sm"]) == _W16_SERVED[shape]
    assert plan["stages"] == _w16_stages(plan["bm"])


# ---------------------------------------------------------------------------
# 6. the float-scale decode kernel's walk, emulated: w4a8_decode on the
#    float-scale form of csrc/w4a8tl_stream.cuh (FloatScale,
#    fs_decode_kernel) block by block in numpy -- the ring (xq lines,
#    packed tile, the scale slot on each group's second step), the
#    raw-nibble unpack, the per-half dots and row sums of the group-dot
#    form, the per-group terms and plane sums in np.float32, the TPU-step
#    fold, row tiles, the split planes and the last arrival's fold --
#    against w4a8_plain bit for bit
# ---------------------------------------------------------------------------

_KP_W8, _LINE_W8, _S_W8 = ttq._KP, ttq._LINE, ttq._S


def _fs_stage_bytes(bm, bn):
    """FloatScale::kStageBytes: xq lines, packed tile, scale slot (two
    f32-wide scale rows of 4 * BN bytes, two zero rows)."""
    return bm * _LINE_W8 + _KP_W8 * bn + 2 * 4 * bn + 2 * bn


def _fs_load_scales(st, s, sc8, zr8, sbytes, k, n0, bm, bn, threads):
    """FloatScale::load_scales: the 16-byte chunks thread i copies into
    the scale slot of stage `st` for step s (a group's second): scale
    rows (sbytes a column) of the low and high group, then their zero
    rows."""
    glo = s * _KP_W8 // 128
    ghi = k // 2 // 128 + glo
    base = bm * _LINE_W8 + _KP_W8 * bn
    sch, zch = bn * sbytes // 16, bn // 16
    copied = 0
    for i in range(threads):
        if i < 2 * sch:
            h, c = divmod(i, sch)
            src = sc8[(ghi if h else glo), n0 * sbytes + 16 * c:][:16]
            dst = base + h * 4 * bn + 16 * c
        elif i - 2 * sch < 2 * zch:
            h, c = divmod(i - 2 * sch, zch)
            src = zr8[(ghi if h else glo), n0 + 16 * c:][:16]
            dst = base + 2 * 4 * bn + h * bn + 16 * c
        else:
            continue
        st[dst:dst + 16] = src
        copied += 1
    assert copied == 2 * sch + 2 * zch


def _fs_group_terms(dot, sx, pl, st, bm, bn, sf32, first):
    """FloatScale::group_terms, every warp: per half, the lanes' row-sum
    parts summed over each mma group (xor shuffles 1, 2), v = dot - z *
    sx in int32, term = f32(v) * s (one rounding), pl = term on the TPU
    step's first group, else pl + term (f32); then dot and sx zeroed.
    The scales and zeros are read at each lane's columns wn * WTN + j * 8
    + 2t + e from the scale slot of stage `st`."""
    wm_, wn_ = ttq._warps(bm)
    wtn = bn // wn_
    t = np.arange(32) & 3
    base = bm * _LINE_W8 + _KP_W8 * bn
    col = (np.arange(wn_)[:, None, None, None] * wtn
           + np.arange(wtn // 8)[:, None, None] * 8
           + 2 * t[:, None] + np.arange(2))            # [WN, NT, lane, 2]
    lane = np.arange(32)
    e = np.arange(4)
    for h in range(2):
        row = st[base + h * 4 * bn:base + (h + 1) * 4 * bn]
        if sf32:
            s = row.view("<f4")[col]
        else:
            s = (row[:2 * bn].view("<u2")[col].astype(np.uint32)
                 << np.uint32(16)).view(np.float32)
        z = st[base + 8 * bn + h * bn:][:bn].view(np.int8)[col].astype(
            np.int64)
        x = sx[:, h]                                   # [warp, MT, lane, 2]
        for sh in (1, 2):
            x = x + x[:, :, lane ^ sh]
        wn = np.arange(dot.shape[0]) % wn_
        v = dot[:, h] - z[wn][:, None][..., e & 1] \
            * x[:, :, None][..., e >> 1]              # [warp, MT, NT, lane, 4]
        assert np.abs(v).max(initial=0) < 2 ** 24
        term = v.astype(np.int32).astype(np.float32) \
            * s[wn][:, None][..., e & 1]
        pl[h] = term if first else pl[h] + term
        dot[:, h] = 0
        sx[:, h] = 0


def _fs_fold(acc, lo, hi, order):
    """acc = (acc + lo) + hi in f32 (order "hi_lo": hi first, the
    reordered fold the sensitivity test must catch)."""
    if order == "hi_lo":
        return (acc + hi) + lo
    return (acc + lo) + hi


def _fs_block(xq8, qw, sc8, zr8, sbytes, rows, n0, k, bm, bn, s_begin,
              s_end, gpt, rng, order, store_planes):
    """One block of fs_decode_kernel: FloatScale::run over streamed steps
    [s_begin, s_end) (whole TPU steps) of rows [0, rows) of xq8 (the row
    tile's), with a ring and nibble lines that start as garbage; the
    unpacked lines are checked against the packed weight's nibbles.
    store_planes(i, lo, hi) takes the i-th TPU step's plane sums (tiles
    [BM, BN]) of a later split; split 0 (store_planes None) folds them.
    Returns the folded acc tile [BM, BN] (split 0)."""
    import test_torch_group_dot as tgd
    wm_, wn_ = ttq._warps(bm)
    wtm, wtn = bm // wm_, bn // wn_
    mt, nt = wtm // 16, wtn // 8
    nw = wm_ * wn_
    ring = rng.integers(0, 256, (_S_W8, _fs_stage_bytes(bm, bn)), np.uint8)
    lines = rng.integers(0, 256, (2, bn * _LINE_W8), np.uint8)
    dot = np.zeros((nw, 2, mt, nt, 32, 4), np.int64)
    sx = np.zeros((nw, 2, mt, 32, 2), np.int64)
    pl = [np.zeros((nw, mt, nt, 32, 4), np.float32) for _ in range(2)]
    acc = np.zeros((nw, mt, nt, 32, 4), np.float32)
    n = s_end - s_begin
    assert s_begin % (2 * gpt) == 0 and n % (2 * gpt) == 0
    q_full = np.concatenate([qw & 15, qw >> 4])

    def tile(frag):
        out = np.zeros((bm, bn), frag.dtype)
        g, t = np.arange(32) >> 2, np.arange(32) & 3
        for w in range(nw):
            wm, wn = w // wn_, w % wn_
            for i in range(mt):
                for j in range(nt):
                    for e in range(4):
                        out[wm * wtm + i * 16 + g + 8 * (e >> 1),
                            wn * wtn + j * 8 + 2 * t + (e & 1)] = \
                            frag[w, i, j, :, e]
        return out

    def fetch(j):
        s = s_begin + j
        if j < n:
            ttq._stream_load(ring[j % _S_W8], s, False, xq8, qw, None, None,
                             rows, n0, k, bm, bn)
            if s & 1:
                _fs_load_scales(ring[j % _S_W8], s, sc8, zr8, sbytes, k, n0,
                                bm, bn, 32 * nw)

    def dots(j):
        r0 = (s_begin + j) * _KP_W8
        want = np.concatenate([q_full[r0:r0 + _KP_W8, n0:n0 + bn],
                               q_full[k // 2 + r0:k // 2 + r0 + _KP_W8,
                                      n0:n0 + bn]]).T
        np.testing.assert_array_equal(
            lines[j & 1].reshape(bn, _LINE_W8)[:, :2 * _KP_W8], want)
        d, part = tgd._gd_dots(ring[j % _S_W8], lines[j & 1], bm, bn)
        dot[...] += d
        sx[...] += part

    def group_end(j):
        nonlocal acc
        g = (s_begin + j) >> 1
        gi = g & (gpt - 1)
        _fs_group_terms(dot, sx, pl, ring[j % _S_W8], bm, bn, sbytes == 4,
                        gi == 0)
        if gi != gpt - 1:
            return
        if store_planes is None:
            acc = _fs_fold(acc, pl[0], pl[1], order)
        else:
            store_planes(g // gpt - s_begin // (2 * gpt), tile(pl[0]),
                         tile(pl[1]))

    for j in range(_S_W8 - 1):
        fetch(j)
    tgd._gd_unpack(ring[0], bm, bn, lines[0])
    for j in range(n - 1):
        fetch(j + _S_W8 - 1)
        dots(j)
        tgd._gd_unpack(ring[(j + 1) % _S_W8], bm, bn, lines[(j + 1) & 1])
        if j & 1:
            group_end(j)
    dots(n - 1)
    group_end(n - 1)
    return tile(acc)


def _fs_walk(xq, xs, p, bm, bn, splits, threads, rng, order="lo_hi"):
    """w4a8_decode's launch emulated: grid (ceil(m / BM), N / BN, splits)
    at `splits` K splits on TPU-step boundaries (the launcher's
    normalization: per = ceil(T / splits), every split non-empty), each
    tile's blocks in a random arrival order; later splits' (lo, hi)
    planes and split 0's acc through a buffer of garbage, the last
    arrival's fold from plane 0 in TPU-step order (order "pre_add": lo +
    hi added first, the reordered fold the sensitivity test must catch),
    out = acc * xs in f32. Returns (out, planes written, counters)."""
    ttq._threads(threads)
    m, k = xq.shape
    n = p.out_features
    gpt = tqm.w4a8_step_rows(k) // 128
    tsteps = k // 2 // (gpt * 128)
    per = -(-tsteps // min(splits, tsteps))
    used = -(-tsteps // per)
    rt = -(-m // bm)
    planes = tqm.w4a8_planes(k, used, per)
    part = rng.standard_normal((max(planes, 1), m, n)).astype(np.float32)
    written = np.zeros(max(planes, 1), np.int64)
    counters = np.zeros(rt * (n // bn), np.int64)
    writes = np.zeros((m, n), np.int64)
    out = np.zeros((m, n), np.float32)
    sbytes = p.scales.element_size()
    sc = p.scales.view(torch.int16) if sbytes == 2 else p.scales
    sc8 = sc.numpy().view(np.uint8).reshape(k // 128, n * sbytes)
    zr8 = p.zeros.numpy().view(np.uint8)
    qw = p.qweight.numpy()
    xs_ = xs.numpy().reshape(-1)
    for tile in range(n // bn):
        n0 = tile * bn
        cols = slice(n0, n0 + bn)
        for r in range(rt):
            row0 = r * bm
            rows = min(bm, m - row0)
            rs = slice(row0, row0 + rows)
            xq8 = np.ascontiguousarray(xq[rs]).view(np.uint8)
            for zi in rng.permutation(used):            # arrival order
                t0, t1 = zi * per, min(tsteps, zi * per + per)

                def store(i, lo, hi, t0=t0):
                    pi = 1 + 2 * (t0 + i - per)
                    part[pi, rs, cols] = lo[:rows]
                    part[pi + 1, rs, cols] = hi[:rows]
                    written[pi:pi + 2] += 1
                acc = _fs_block(xq8, qw, sc8, zr8, sbytes, rows, n0, k, bm,
                                bn, t0 * 2 * gpt, t1 * 2 * gpt, gpt, rng,
                                order, None if zi == 0 else store)[:rows]
                if used > 1:
                    if zi == 0:
                        part[0, rs, cols] = acc
                        written[0] += 1
                    c = tile * rt + r
                    counters[c] += 1
                    if counters[c] != used:
                        continue
                    counters[c] = 0
                    acc = part[0, rs, cols].copy()
                    for kk in range(per, tsteps):
                        lo = part[1 + 2 * (kk - per), rs, cols]
                        hi = part[2 + 2 * (kk - per), rs, cols]
                        acc = acc + (lo + hi) if order == "pre_add" \
                            else _fs_fold(acc, lo, hi, order)
                writes[rs, cols] += 1
                out[rs, cols] = acc * xs_[rs, None]
    assert (writes == 1).all()
    return out, written[:planes], counters


def _fs_inputs(m, k, n, seed, sf32, kind="random"):
    """Float-scale params and activations for the walk: q, z uniform over
    0..15 and scales of random sign, mantissa and exponent (bf16 or f32),
    xq uniform over -127..127 ("extreme": q and z at 0 and 15, |q - z| =
    15, xq = +-127 signed so every group's integer is 127 * 15 * 128 in
    magnitude)."""
    rng = np.random.default_rng(seed)
    g = k // 128
    if kind == "extreme":
        z = np.where(rng.random((g, n)) < 0.5, 0, 15)
        q = np.where(np.repeat(z, 128, 0) == 0, 15, 0)
        xq = np.repeat(np.where(rng.random((m, g)) < 0.5, -127, 127), 128,
                       1).astype(np.int8)
    else:
        q = rng.integers(0, 16, (k, n))
        z = rng.integers(0, 16, (g, n))
        xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    s = (rng.choice([-1.0, 1.0], (g, n)) * (1 + rng.random((g, n)))
         * np.exp2(rng.integers(-12, 2, (g, n)))).astype(np.float32)
    p = tq.QuantLinearParams(
        qweight=torch.from_numpy((q[:k // 2] | (q[k // 2:] << 4)).astype(
            np.uint8)),
        scales=torch.from_numpy(s) if sf32
        else torch.from_numpy(s).to(torch.bfloat16),
        zeros=torch.from_numpy(z.astype(np.int8)), bias=None, in_features=k,
        out_features=n, group_size=128)
    xs = torch.from_numpy(rng.uniform(0.5, 1.5, (m, 1)).astype(np.float32))
    return torch.from_numpy(xq), xs, p


# (m, K, N, BM, BN, splits, threads): gpt 1 (K = 256: one TPU step; 768:
# three), 2 (K = 1536) and 4 (K = 4096, 14336); every m of the row tiles'
# edges (1, 17, 33, 64) at all of m and at 16-row tiles; 64-column tiles
# at N = 192 and 128, 128-column ones (16-row tiles only) at N = 256; one
# split, two, three, and counts that do not divide the TPU steps (4 of
# 14: 4, 4, 4, 2) or pass them (5 of 3).
_FS_WALK = []
for _i, (_k, _n) in enumerate(((256, 192), (768, 128), (1536, 192),
                               (4096, 64))):
    for _j, _m in enumerate((1, 17, 33, 64)):
        _full = 16 if _m <= 16 else 32 if _m <= 32 else 64
        _FS_WALK.append((_m, _k, _n, (_full, 16)[(_i + _j) // 2 % 2], 64,
                         (1, 2, 3, 5)[(_i + _j) % 4], (128, 256)[_j % 2]))
_FS_WALK += [(64, 14336, 64, 16, 64, 4, 256), (33, 14336, 64, 64, 64, 3, 128),
             (33, 1536, 256, 16, 128, 2, 128), (1, 4096, 256, 16, 128, 3, 256),
             (64, 768, 256, 16, 128, 1, 256)]


@pytest.mark.parametrize("m,k,n,bm,bn,splits,threads", _FS_WALK,
                         ids=["-".join(map(str, c)) for c in _FS_WALK])
def test_fs_stream_walk_matches_plain(m, k, n, bm, bn, splits, threads):
    """w4a8_decode's blocks on the float-scale form of the streamed loop,
    emulated in numpy (section 6's header), at its row tiles, column
    tiles and K splits: the nibble lines equal the packed weight's, every
    output is written once, by its tile's last arrival (or by the one
    split), the counters are zero again, exactly the plan's planes are
    written once each, and the result equals w4a8_plain bit for bit (bf16
    and f32 scales)."""
    sf32 = (m + k) % 2 == 0
    xq, xs, p = _fs_inputs(m, k, n, 31 * m + k + splits, sf32)
    got, written, counters = _fs_walk(xq, xs, p, bm, bn, splits, threads,
                                      np.random.default_rng(m + k + bm))
    assert not counters.any()
    assert (written == -(-m // bm) * (n // bn)).all()
    want = tqm.w4a8_plain(xq, xs, p, torch.float32)
    assert torch.equal(torch.from_numpy(got), want)


def test_fs_stream_walk_extreme_case():
    """The integer range: |xq| = 127 and |q - z| = 15 at K = 14336, so
    every group's integer is 127 * 15 * 128 in magnitude before its
    scale; bit for bit at three K splits and 16-row tiles."""
    xq, xs, p = _fs_inputs(17, 14336, 64, 5, False, kind="extreme")
    q = tq.unpack_rows(p.qweight).numpy().astype(np.int64)
    z = np.repeat(p.zeros.numpy().astype(np.int64), 128, 0)
    assert (np.abs(q - z) == 15).all() and (xq.abs() == 127).all()
    got, _, _ = _fs_walk(xq, xs, p, 16, 64, 3, 256,
                         np.random.default_rng(2))
    assert torch.equal(torch.from_numpy(got),
                       tqm.w4a8_plain(xq, xs, p, torch.float32))


@pytest.mark.parametrize("order,splits", [("hi_lo", 1), ("pre_add", 2)])
def test_fs_walk_catches_a_reordered_fold(order, splits):
    """The comparison can see the order: the same walk with the high
    plane's sum added before the low one's, or with a later split's lo
    and hi pre-added before they join the accumulator, differs from
    w4a8_plain in some bits (K = 4096: four TPU steps of four groups),
    while the kernel's order equals it."""
    xq, xs, p = _fs_inputs(17, 4096, 64, 11, True)
    want = tqm.w4a8_plain(xq, xs, p, torch.float32)
    right, _, _ = _fs_walk(xq, xs, p, 32, 64, splits, 256,
                           np.random.default_rng(4))
    wrong, _, _ = _fs_walk(xq, xs, p, 32, 64, splits, 256,
                           np.random.default_rng(4), order=order)
    assert torch.equal(torch.from_numpy(right), want)
    assert not torch.equal(torch.from_numpy(wrong), want)


# FloatScale's blocks an SM at 256 threads, (BM, BN): the shared memory
# (_fs_smem) and the register cap each kernel is compiled to
# (fs_min_blocks: 4 / 3 / 2 at 64 columns, 2 at 128) allow.
def _fs_smem(bm, bn, stages=4):
    """FloatScale::kSmemBytes: two nibble-line buffers and the ring."""
    return 2 * bn * _LINE_W8 + stages * _fs_stage_bytes(bm, bn)


_FS_MIN_BLOCKS = {(16, 64): 4, (32, 64): 3, (64, 64): 2, (16, 128): 2,
                  (32, 128): 2}


def _fs_blocks_per_sm(bm, bn):
    return min(H100_SMEM_PER_SM // (_fs_smem(bm, bn)
                                    + H100_SMEM_PER_BLOCK_RESERVED),
               _FS_MIN_BLOCKS[(bm, bn)], 2048 // 256)


def _fs_plan(m, n, k, splits=0, sms=H100_SMS, row_step=0.25,
             narrow_bytes=16 << 20):
    """w4a8_gemm.cu's launcher (fs_decode_any, fs_decode) in Python: 256
    threads; 64 columns where N % 128 != 0 or the packed weight is at
    most 16 MiB, else 128 (row tiles of at most 32 rows there); the (BM,
    splits) of the least waves * (streamed steps a split * (1 + row_step
    * (BM / 16 - 1)) + 2) + (f32 plane bytes written and read + the
    weight bytes each row tile after the first reads again) over the
    weight bytes one step of all resident blocks streams, ties to the
    fewer blocks; splits on TPU-step boundaries. Returns the plan's
    fields as w4a8_decode_plan names them."""
    gpt = tqm.w4a8_step_rows(k) // 128
    tsteps = k // 2 // (gpt * 128)
    bn = 64 if n % 128 or k // 2 * n <= narrow_bytes else 128
    tiles = n // bn
    full = 16 if m <= 16 else 32 if m <= 32 else 64
    hi = min(64 if bn == 64 else 32, full)
    best = None
    for bm in (16, 32, 64):
        if bm > hi:
            continue
        rt = -(-m // bm)
        slots = sms * _fs_blocks_per_sm(bm, bn)
        step = 1.0 + row_step * (bm // 16 - 1)
        for s in ([min(splits, tsteps)] if splits > 0
                  else range(1, tsteps + 1)):
            per = -(-tsteps // s)
            used = -(-tsteps // per)
            if used != s and splits <= 0:
                continue
            blocks = tiles * rt * used
            planes = 1 + 2.0 * (tsteps - per) if used > 1 else 0.0
            cost = (-(-blocks // slots) * (per * 2.0 * gpt * step + 2)
                    + (planes * 8.0 * m * n + (rt - 1) * (k / 2) * n)
                    / (slots * 64 * bn))
            if best is None or cost < best[0] or (cost == best[0]
                                                  and blocks < best[1]):
                best = (cost, blocks, bm, used, per)
    _, _, bm, used, per = best
    return dict(bm=bm, bn=bn, threads=256, stages=4, splits=used,
                tpu_steps_per_split=per,
                blocks_per_sm=_fs_blocks_per_sm(bm, bn),
                row_tiles=-(-m // bm), gpt=gpt,
                planes=tqm.w4a8_planes(k, used, per))


# The launcher's rule lines in csrc/w4a8_gemm.cu (and the two-level
# header's constants it shares) that _fs_plan mirrors.
_FS_RULE_LINES = (
    ("w4a8_gemm.cu", "constexpr int kFsStages = 4;"),
    ("w4a8_gemm.cu", "constexpr int kFsThreads = 256;"),
    ("w4a8_gemm.cu", "constexpr int kFsMinBM = 16;"),
    ("w4a8_gemm.cu", "constexpr int kFsMaxBM = 64;"),
    ("w4a8_gemm.cu", "constexpr double kFsRowStep = 0.25;"),
    ("w4a8_gemm.cu", "if (kThreads == 256) return BN == 128 ? 2 : BM == 16 "
                     "? 4 : BM == 32 ? 3 : 2;"),
    ("w4a8_gemm.cu", "const bool fs_narrow = a.N % 128 != 0 || (long)a.K / 2 "
                     "* a.N <= kNarrowBytes;"),
    ("w4a8_gemm.cu", "while (bkb >= kGroup && (K / 2) % bkb) bkb /= 2;"),
    ("w4a8tl_stream.cuh", "constexpr double kBlockSteps = 2;"),
    ("w4a8tl_stream.cuh", "constexpr long kNarrowBytes = 16L << 20;"),
)

# The served decode shapes of lane C (llama-3.1-8b's four projections at
# m = 1 / 32 / 64) and the plans the rule gives them on an H100 (132 SMs):
# (BN, BM, splits, TPU steps a split, blocks an SM).
_FS_SERVED = {
    ("qkv", 1): (64, 16, 4, 1, 4), ("o", 1): (64, 16, 4, 1, 4),
    ("gate_up", 1): (128, 16, 1, 4, 2), ("down", 1): (128, 16, 7, 2, 2),
    ("qkv", 32): (64, 32, 4, 1, 3), ("o", 32): (64, 32, 4, 1, 3),
    ("gate_up", 32): (128, 32, 1, 4, 2), ("down", 32): (128, 32, 7, 2, 2),
    ("qkv", 64): (64, 32, 2, 2, 3), ("o", 64): (64, 64, 4, 1, 2),
    ("gate_up", 64): (128, 32, 1, 4, 2), ("down", 64): (128, 32, 4, 4, 2),
}
_LLAMA_SITES = {"qkv": (4096, 6144), "o": (4096, 4096),
                "gate_up": (4096, 28672), "down": (14336, 4096)}


def test_fs_launch_rule_lines():
    """The rule the launcher keeps is the one _fs_plan mirrors (its
    constants, register caps, column rule and TPU step rule), and the
    Python TPU step rule is the C one's."""
    import os
    csrc = os.path.join(os.path.dirname(__file__), os.pardir,
                        "ferrum_tpu_torch", "ops", "kernels", "csrc")
    for fname, line in _FS_RULE_LINES:
        src = " ".join(open(os.path.join(csrc, fname)).read().split())
        assert line in src, (fname, line)
    for k in range(256, 16384, 256):
        bkb = tqm.w4a8_step_rows(k)
        assert bkb in (128, 256, 512) and (k // 2) % bkb == 0
        assert all((k // 2) % b for b in (512, 256) if b > bkb)


@pytest.mark.parametrize("shape", list(_FS_SERVED), ids=str)
def test_fs_launch_rule_at_served_shapes(shape):
    """The rule at lane C's decode shapes gives the pinned plan (the plan
    the card reported for each, chip_smoke.py's timed cases): its splits
    fall on TPU-step boundaries (every split non-empty, the last one the
    rest), the planes are split 0's acc and two for each TPU step after
    the first split, and their f32 bytes are as the plan states."""
    site, m = shape
    k, n = _LLAMA_SITES[site]
    plan = _fs_plan(m, n, k)
    assert (plan["bn"], plan["bm"], plan["splits"],
            plan["tpu_steps_per_split"],
            plan["blocks_per_sm"]) == _FS_SERVED[shape]
    gpt = tqm.w4a8_step_rows(k) // 128
    tsteps = k // 2 // (gpt * 128)
    per, splits = plan["tpu_steps_per_split"], plan["splits"]
    bounds = [min(tsteps, z * per) for z in range(splits + 1)]
    assert bounds[-1] == tsteps and all(b1 > b0 for b0, b1
                                        in zip(bounds, bounds[1:]))
    assert plan["planes"] == (0 if splits == 1 else 1 + 2 * (tsteps - per))
    assert plan["row_tiles"] * plan["bm"] >= m > (plan["row_tiles"] - 1) \
        * plan["bm"]
    # Every site's planes at m = 32 stay under half of its weight.
    if m == 32:
        assert 4 * m * n * plan["planes"] < (k // 2) * n / 2
