"""Quantization parity: ferrum_tpu_torch vs ferrum_tpu, bit for bit.

Packing, RTN quantization, two-level requantization, activation
quantization and the plain versions of both w4a8tl GEMM kernels must
equal the JAX package exactly: the integer math is exact and the float
steps run in the same f32 order. Oracles: `quant_matmul_w4a8tl_ref`
and the Pallas kernels themselves in interpret mode (patched as
tests/test_quant.py does).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (thread count)
from ferrum_tpu.ops import quant as jq
from ferrum_tpu.ops.pallas import quant_matmul as jqm
from ferrum_tpu_torch.ops import quant as tq
from ferrum_tpu_torch.ops.kernels import quant_matmul as tqm

K, N = 1024, 512
MS = (1, 7, 32, 64, 96, 256)


def _weights(symmetric=False, scale_dtype="f32", seed=0):
    """Random float weights with per-group offsets (asymmetric groups:
    zeros, scales2 and chan all vary), quantized in both packages."""
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.02, (K, N)) + rng.uniform(
        -0.03, 0.03, (K // 128, 1, N)).repeat(128, 0).reshape(K, N)
    packed, s, z = jq.quantize_weight_np(w.astype(np.float32), 128,
                                         symmetric)
    jdt = jnp.bfloat16 if scale_dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if scale_dtype == "bf16" else torch.float32
    pj = jq.QuantLinearParams(
        qweight=jnp.asarray(packed), scales=jnp.asarray(s, jdt),
        zeros=jnp.asarray(z), bias=None, in_features=K, out_features=N,
        group_size=128)
    pt = tq.QuantLinearParams(
        qweight=torch.from_numpy(packed), scales=torch.from_numpy(s).to(tdt),
        zeros=torch.from_numpy(z), bias=None, in_features=K, out_features=N,
        group_size=128)
    return w.astype(np.float32), pj, pt


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      jnp.asarray(x, jnp.float32))


def test_pack_unpack_match_jax():
    rng = np.random.default_rng(1)
    q = rng.integers(0, 16, (256, 64)).astype(np.uint8)
    packed = tq.pack_rows_np(q, 128)
    np.testing.assert_array_equal(packed, jq.pack_rows_np(q, 128))
    np.testing.assert_array_equal(
        tq.unpack_rows(torch.from_numpy(packed)).numpy(),
        np.asarray(jq.unpack_rows(jnp.asarray(packed), 128)))
    np.testing.assert_array_equal(
        tq.unpack_rows(torch.from_numpy(packed)).numpy(), q)


@pytest.mark.parametrize("symmetric", [True, False])
def test_quantize_weight_matches_jax(symmetric):
    w, _, _ = _weights()
    want = jq.quantize_weight_np(w, 128, symmetric)
    got = tq.quantize_weight_np(w, 128, symmetric)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    p = tq.make_quant_linear(torch.from_numpy(w), 128, symmetric,
                             dtype=torch.float32)
    for a, b in zip(want, (p.qweight, p.scales, p.zeros)):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("scale_dtype", ["f32", "bf16"])
def test_requantize_two_level_matches_jax(scale_dtype):
    _, pj, pt = _weights(scale_dtype=scale_dtype)
    rj, rt = jq.requantize_two_level(pj), tq.requantize_two_level(pt)
    for f in ("qweight", "scales2", "zeros"):
        np.testing.assert_array_equal(np.asarray(getattr(rj, f)),
                                      getattr(rt, f).numpy())
    np.testing.assert_array_equal(_np(rj.scales), _np(rt.scales))
    np.testing.assert_array_equal(_np(rj.chan_scale), _np(rt.chan_scale))
    assert len(np.unique(np.asarray(rj.scales2))) > 1
    assert len(np.unique(np.asarray(rj.zeros))) > 1
    assert tq.requantize_two_level(rt) is rt            # idempotent
    np.testing.assert_array_equal(
        tq.dequantize(rt, torch.float32).numpy(),
        np.asarray(jq.dequantize(rj, jnp.float32)))


@pytest.mark.parametrize("m", MS)
def test_quantize_activation_rows_matches_jax(m):
    x = np.random.default_rng(m).normal(0, 2, (m, K)).astype(np.float32)
    x[0, :5] = [0.5, -0.5, 1.5, 2.5, -2.5]      # round-half-even cases
    xq_j, xs_j = jqm.quantize_activation_rows(jnp.asarray(x))
    xq_t, xs_t = tqm.quantize_activation_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(np.asarray(xq_j), xq_t.numpy())
    np.testing.assert_array_equal(np.asarray(xs_j), xs_t.numpy())


def _case(m, perm=False, bias=False, seed=0):
    _, pj, pt = _weights(seed=seed)
    pj, pt = jq.requantize_two_level(pj), tq.requantize_two_level(pt)
    rng = np.random.default_rng(100 + m)
    if perm:
        order = rng.permutation(K).astype(np.int32)
        pj = dataclasses.replace(pj, input_perm=jnp.asarray(order))
        pt = dataclasses.replace(pt, input_perm=torch.from_numpy(
            order.astype(np.int64)))
    if bias:
        b = rng.normal(0, 0.1, N).astype(np.float32)
        pj = dataclasses.replace(pj, bias=jnp.asarray(b))
        pt = dataclasses.replace(pt, bias=torch.from_numpy(b))
    x = rng.normal(0, 1, (m, K)).astype(np.float32)
    return x, pj, pt


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("perm,bias", [(False, False), (True, True)])
def test_quant_matmul_matches_w4a8tl_ref_exactly(m, perm, bias):
    x, pj, pt = _case(m, perm, bias)
    want = np.asarray(jq.quant_matmul_w4a8tl_ref(jnp.asarray(x), pj))
    got = tqm.quant_matmul(torch.from_numpy(x), pt).numpy()
    np.testing.assert_array_equal(got, want)
    ref = tq.quant_matmul_w4a8tl_ref(torch.from_numpy(x), pt).numpy()
    np.testing.assert_array_equal(ref, want)


def _interpret(fn, *args):
    orig = jqm.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    jqm.pl.pallas_call = patched
    try:
        with jax.disable_jit():
            return fn(*args)
    finally:
        jqm.pl.pallas_call = orig


@pytest.mark.parametrize("m,kernel", [(1, "decode"), (32, "decode"),
                                      (64, "decode"), (96, "prefill"),
                                      (256, "prefill")])
def test_plain_kernels_match_pallas_interpret(m, kernel):
    """The port's plain w4a8tl_decode / w4a8tl_prefill equal the Pallas
    kernels they replace (_qmm_w4a8tl_mxu_kernel / _qmm_w4a8tl_kernel),
    run in interpret mode on the same int8 activations."""
    x, pj, pt = _case(m)
    m_pad = max(32, -(-m // 32) * 32)           # the Pallas int8 tile
    xp = np.zeros((m_pad, K), np.float32)
    xp[:m] = x
    xq, xs = jqm.quantize_activation_rows(jnp.asarray(xp))
    pallas = (jqm._quant_matmul_w4a8tl_mxu if kernel == "decode"
              else jqm._quant_matmul_w4a8tl_2d)
    want = np.asarray(_interpret(pallas, xq, xs, pj, jnp.float32))[:m]
    port = tqm.w4a8tl_decode if kernel == "decode" else tqm.w4a8tl_prefill
    txq, txs = tqm.quantize_activation_rows(torch.from_numpy(x))
    got = port(txq, txs, pt, torch.float32).numpy()
    np.testing.assert_array_equal(got, want)


def test_dispatch_by_m(monkeypatch):
    """m <= 64 takes the decode kernel's function, m > 64 the prefill's."""
    _, _, pt = _case(1)
    calls = []
    for name in ("w4a8tl_decode", "w4a8tl_prefill"):
        orig = getattr(tqm, name)

        def rec(*a, _n=name, _o=orig):
            calls.append((_n, a[0].shape[0]))
            return _o(*a)
        monkeypatch.setattr(tqm, name, rec)
    for lead in ((64,), (2, 32), (65,), (3, 40)):
        x = torch.randn(*lead, K)
        assert tqm.quant_matmul(x, pt).shape == (*lead, N)
    assert calls == [("w4a8tl_decode", 64), ("w4a8tl_decode", 64),
                     ("w4a8tl_prefill", 65), ("w4a8tl_prefill", 120)]


@pytest.mark.parametrize("w4a8,m,route", [
    (True, 4, "w4a8_decode"), (True, 65, "w4a16_gemm"),
    (False, 4, "w4a16_gemm"), (False, 65, "w4a16_gemm")])
def test_params_without_scales2_take_float_scale_routes(monkeypatch, w4a8,
                                                        m, route):
    """Params without scales2 (a checkpoint served without the two-level
    step) take the float-scale w4a8 kernel at decode m with w4a8 on, and
    the w4a16 kernel everywhere else, each computing its plain version."""
    _, _, pt = _weights()
    monkeypatch.setattr(tqm, "_W4A8", w4a8)
    monkeypatch.setattr(tqm, "_W4A8_GD", "mxu")
    calls = []
    for name in ("w4a8tl_decode", "w4a8tl_prefill", "w4a8_decode",
                 "w4a16_gemm"):
        orig = getattr(tqm, name)
        monkeypatch.setattr(tqm, name, lambda *a, _n=name, _o=orig: (
            calls.append(_n), _o(*a))[1])
    x = torch.randn(m, K)
    got = tqm.quant_matmul(x, pt)
    assert calls == [route]
    if route == "w4a16_gemm":
        want = tqm.w4a16_plain(x, pt)
    else:
        xq, xs = tqm.quantize_activation_rows(x)
        want = tqm.w4a8_plain(xq, xs, pt, torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_w4a16_ref_matches_jax():
    """The w4a16 oracle (dequantize + float matmul): f32 sums in another
    order, so 1e-5 of the output scale."""
    x, pj, pt = _case(7, perm=True, bias=True)
    want = np.asarray(jq.quant_matmul_ref(jnp.asarray(x), pj))
    got = tq.quant_matmul_ref(torch.from_numpy(x), pt).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("scale_dtype", ["bf16", "f32"])
def test_packed_bf16_dequant_identity(scale_dtype):
    """The wgmma main loop's dequant (csrc/w4a16_wgmma.cuh), in torch bf16
    on the CPU: a nibble q OR 0x4300 is bf16(128 + q); minus bf16(128 + z)
    is q - z exactly for every int8 z; times the bf16 scale rounds once.
    It must equal w4a16_weight bit for bit for every q in 0..15, every
    int8 z and scales 2^t (1 + u), t = -133 .. 119 (subnormal below
    2^-126); and the JAX kernel's (q - z).astype(bf16) * scale wherever
    scale and product are normal (XLA on the CPU flushes subnormals, as
    the TPU does)."""
    rng = np.random.default_rng(5)
    k = 256                                   # groups 0 (low), 1 (high)
    t = np.arange(-133, 120)
    zs = np.arange(-128, 128)
    n = zs.size * 8
    q = np.tile(np.arange(k)[:, None] % 16, (1, n))            # [K, N]
    z = np.stack([np.tile(zs, 8), np.roll(np.tile(zs, 8), 77)])  # [2, N]
    s = ((1 + rng.random((2, n))) * 2.0 ** rng.choice(t, (2, n))
         ).astype(np.float32)
    s[:, :t.size] = (1.5 * 2.0 ** t).astype(np.float32)   # every exponent
    qt, zt = torch.from_numpy(q), torch.from_numpy(z)
    st = torch.from_numpy(s)
    if scale_dtype == "bf16":
        st = st.to(torch.bfloat16)
    p = tq.QuantLinearParams(
        qweight=(qt[:k // 2] | (qt[k // 2:] << 4)).to(torch.uint8),
        scales=st, zeros=zt.to(torch.int8), bias=None, in_features=k,
        out_features=n, group_size=128)
    q128 = (qt | 0x4300).to(torch.int16).view(torch.bfloat16)
    z128 = (zt + 128).to(torch.bfloat16).repeat_interleave(128, 0)
    sb = st.to(torch.bfloat16).repeat_interleave(128, 0)
    got = (q128 - z128) * sb
    assert got.dtype == torch.bfloat16
    want = tq.w4a16_weight(p)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    assert ((want != 0) & (want.float().abs() < 2.0 ** -126)).any()
    jw = ((jnp.asarray(q) - jnp.repeat(jnp.asarray(z), 128, 0)).astype(
        jnp.bfloat16) * jnp.repeat(jnp.asarray(s).astype(jnp.bfloat16),
                                   128, 0))
    normal = ((sb.float() >= 2.0 ** -126)
              & ((want == 0) | (want.float().abs() >= 2.0 ** -126))).numpy()
    assert normal.mean() > 0.5
    np.testing.assert_array_equal(
        np.asarray(jw).view(np.int16)[normal],
        want.view(torch.int16).numpy()[normal])


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm(a, b, sel) on uint32 arrays: byte i of the
    result is byte (sel >> 4i) & 7 of the 8 bytes b:a."""
    src = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
    out = np.zeros_like(a, dtype=np.uint64)
    for i in range(4):
        j = (sel >> (4 * i)) & 7
        out |= ((src >> np.uint64(8 * j)) & np.uint64(0xFF)) \
            << np.uint64(8 * i)
    return out.astype(np.uint32)


@pytest.mark.parametrize("bn", [128, 256])
def test_packed_int8_dequant_identity(bn):
    """The int8 wgmma main loop's dequant (csrc/w4a8tl_wgmma.cuh), its
    uint32 arithmetic emulated in numpy for every thread of a block: the
    packed tile as cp.async places it (16-byte chunk c of row r at c ^ 2 *
    (r / 16 % 4)); per thread 16 rows x 4 columns, a 4 x 4 byte transpose
    by __byte_perm, then per column and nibble half q * s + (-z * s mod
    256) in two 16-bit lanes; stores into swizzled K-major lines (chunk
    c of line n at c ^ n % 8). Un-swizzled, line n must be the w8 column
    n of the K step, [low half 64 k | high half 64 k], equal to
    two_level_w8 for every q of both halves, every z in 0..15 and every
    scales2 in -cap..cap with cap = 127 // max(z, 15 - z), |w8| <= 127."""
    rng = np.random.default_rng(bn)
    k, kp = 256, 64
    zz, ss = np.meshgrid(np.arange(16), np.arange(-127, 128))
    cap = 127 // np.maximum(zz, 15 - zz)
    pairs = np.stack([zz[np.abs(ss) <= cap], ss[np.abs(ss) <= cap]], 1)
    steps = -(-len(pairs) // bn)
    for step in range(steps):
        pick = pairs[(np.arange(2 * bn) + step * bn) % len(pairs)]
        z = pick[:, 0].reshape(2, bn)                # [half, N]
        s = pick[:, 1].reshape(2, bn)
        z[1], s[1] = np.roll(z[1], 37), np.roll(s[1], 37)
        q = rng.integers(0, 16, (k, bn))
        q[:16] = (np.arange(16)[:, None] + np.arange(bn)) % 16
        packed = (q[:k // 2] | (q[k // 2:] << 4)).astype(np.uint8)
        # the K step of packed rows 0..63 (groups 0 and K/256 + 0 = 1)
        tile = np.zeros((kp, bn), np.uint8)
        for r in range(kp):
            for c in range(bn // 16):
                d = c ^ ((r >> 3) & 6)
                tile[r, 16 * d:16 * d + 16] = packed[r, 16 * c:16 * c + 16]
        words = tile.view("<u4")                     # [64, bn / 4]
        tid = np.arange(bn)
        rb, cu = tid & 3, tid >> 2
        wcol = (((cu >> 2) ^ (2 * rb)) << 2) + (cu & 3)
        sw = np.stack([s[h].astype(np.uint8).view("<u4") for h in (0, 1)])
        zw = np.stack([z[h].astype(np.int8).view("<u4") for h in (0, 1)])
        lines = np.zeros((bn, 128), np.uint8)
        lo, hi = np.zeros((4, 4, bn), np.uint32), np.zeros((4, 4, bn),
                                                             np.uint32)
        for i4 in range(4):
            w = [words[16 * rb + 4 * i4 + i, wcol] for i in range(4)]
            x0, x1 = _byte_perm(w[0], w[1], 0x5140), \
                _byte_perm(w[0], w[1], 0x7362)
            x2, x3 = _byte_perm(w[2], w[3], 0x5140), \
                _byte_perm(w[2], w[3], 0x7362)
            t = [_byte_perm(x0, x2, 0x5410), _byte_perm(x0, x2, 0x7632),
                 _byte_perm(x1, x3, 0x5410), _byte_perm(x1, x3, 0x7632)]
            for j in range(4):
                for h, out in ((0, lo), (1, hi)):
                    sb = (sw[h, cu] >> (8 * j)) & 0xFF
                    zb = ((zw[h, cu] >> (8 * j)) & 0xFF).astype(np.int64)
                    zb = np.where(zb > 127, zb - 256, zb)
                    sv = np.where(sb > 127, sb.astype(np.int64) - 256, sb)
                    c = ((-zb * sv) & 0xFF).astype(np.uint64) * 0x00010001
                    sh = 4 * h
                    e = (((t[j].astype(np.uint64) >> sh) & 0x000F000F) * sb
                         + c) & 0xFFFFFFFF
                    o = (((t[j].astype(np.uint64) >> (sh + 8)) & 0x000F000F)
                         * sb + c) & 0xFFFFFFFF
                    out[j, i4] = _byte_perm(e.astype(np.uint32),
                                            o.astype(np.uint32), 0x6240)
        for j in range(4):
            n = 4 * cu + j
            for h, out in ((0, lo), (1, hi)):
                d = ((4 * h + rb) ^ (n & 7)) * 16
                for i4 in range(4):
                    for b in range(4):
                        lines[n, d + 4 * i4 + b] = (out[j, i4] >> (8 * b)) \
                            & 0xFF
        logical = np.zeros_like(lines)
        for n in range(bn):
            for c in range(8):
                d = c ^ (n & 7)
                logical[n, 16 * c:16 * c + 16] = lines[n, 16 * d:16 * d + 16]
        p = tq.QuantLinearParams(
            qweight=torch.from_numpy(packed),
            scales=torch.ones(2, bn, dtype=torch.bfloat16),
            zeros=torch.from_numpy(z.astype(np.int8)), bias=None,
            in_features=k, out_features=bn, group_size=128,
            scales2=torch.from_numpy(s.astype(np.int8)),
            chan_scale=torch.ones(1, bn))
        w8 = tq.two_level_w8(p).numpy()
        assert np.abs(w8).max() <= 127
        want = np.concatenate([w8[:kp], w8[k // 2:k // 2 + kp]]).T  # [N, 128]
        np.testing.assert_array_equal(logical.view(np.int8), want)
