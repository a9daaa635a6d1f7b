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


# The decode main loop (csrc/w4a8tl_stream.cuh) emulated in numpy, block by
# block: kKP = 64 packed rows a K step, 144-byte padded lines, a ring of
# _S stages (w4a8tl_gemm.cu's kDecodeStages), 128 or 256 threads: dequant
# units of _R packed rows x 4 columns, _RB row blocks a K step.
_KP, _LINE, _S = 64, 144, 4
_R = _RB = None


def _threads(threads):
    """Stream<.., kThreads>'s unit rows R and row blocks."""
    global _R, _RB
    _R = 8 if threads == 256 else 16
    _RB = _KP // _R


def _warps(bm):
    """Stream's warp grid (Warps<BM, kThreads>): (WM, WN)."""
    threads = 256 if _R == 8 else 128
    wm = 2 if threads == 256 and bm >= 32 else 1
    return wm, threads // 32 // wm


def _stream_load(st, s, scales, xq, qw, s2, zr, m, n0, k, bm, bn):
    """Stream::load: the 16-byte chunks every thread's cp.async places in
    stage `st` (flat uint8) for step s; rows >= m zero-filled."""
    k2, r0, chunks = k // 2, s * _KP, bn // 16
    b16 = np.arange(16)
    idx = np.arange(bm * 8)                       # BM lines of 8 chunks
    row, c = idx >> 3, idx & 7
    src = row * k + np.where(c < 4, r0, k2 + r0 - 64) + c * 16
    src = np.minimum(src[:, None] + b16, xq.size - 1)    # rows >= m: any
    vals = np.where((row < m)[:, None], xq.reshape(-1)[src], 0)
    st[(row * _LINE + c * 16)[:, None] + b16] = vals
    a_bytes = bm * _LINE
    idx = np.arange(_KP * chunks)                 # packed rows, swizzled
    row, c = idx // chunks, idx % chunks
    swz = ((row // _R) * (_R // 8)) & (chunks - 1)
    dst = a_bytes + row * bn + ((c ^ swz) << 4)
    st[dst[:, None] + b16] = qw[(r0 + row)[:, None],
                                n0 + c[:, None] * 16 + b16]
    if scales:
        glo = r0 // 128
        ghi = k2 // 128 + glo
        sc = a_bytes + _KP * bn
        for h, rows in enumerate((s2[glo], s2[ghi], zr[glo], zr[ghi])):
            st[sc + h * bn:sc + (h + 1) * bn] = rows[n0:n0 + bn]


def _stream_scales(st, bm, bn):
    """Stream::load_group for the dequant's threads: scales2 bytes and
    -z * s2 mod 256 in both 16-bit fields, per half and column."""
    words = st.view("<u4")
    cu = np.arange(_RB * bn // 4) // _RB
    base = (bm * _LINE + _KP * bn) // 4
    s_ = np.zeros((2, 4, cu.size), np.uint64)
    c_ = np.zeros((2, 4, cu.size), np.uint64)
    for h in range(2):
        sw = words[base + (h * bn) // 4 + cu].astype(np.int64)
        zw = words[base + ((2 + h) * bn) // 4 + cu].astype(np.int64)
        for j in range(4):
            s = (((sw >> (8 * j)) & 0xFF) ^ 0x80) - 0x80
            z = (((zw >> (8 * j)) & 0xFF) ^ 0x80) - 0x80
            s_[h, j] = s & 0xFF
            c_[h, j] = ((-z * s) & 0xFF) * 0x00010001
    return s_, c_


def _stream_dequant(st, sc, bm, bn, w8):
    """Stream::dequant: each unit's _R packed rows x 4 columns, 4 x 4 byte
    transposes, dequant4 per half, _R-byte stores into lines `w8`."""
    words = st.view("<u4")
    out = w8.view("<u4")
    tid = np.arange(_RB * bn // 4)
    rb, cu = tid % _RB, tid // _RB
    swz = (rb * (_R // 8)) & (bn // 16 - 1)
    base = bm * _LINE + (((cu >> 2) ^ swz) << 4) + ((cu & 3) << 2)
    mask = np.uint64(0x000F000F)
    for i4 in range(_R // 4):
        r = _R * rb + 4 * i4
        w = [words[(base + (r + i) * bn) // 4] for i in range(4)]
        x0, x1 = _byte_perm(w[0], w[1], 0x5140), _byte_perm(w[0], w[1], 0x7362)
        x2, x3 = _byte_perm(w[2], w[3], 0x5140), _byte_perm(w[2], w[3], 0x7362)
        t = [_byte_perm(x0, x2, 0x5410), _byte_perm(x0, x2, 0x7632),
             _byte_perm(x1, x3, 0x5410), _byte_perm(x1, x3, 0x7632)]
        for j in range(4):
            line = ((4 * cu + j) * _LINE + _R * rb) // 4 + i4
            for h in range(2):
                tj = t[j].astype(np.uint64)
                e = (((tj >> np.uint64(4 * h)) & mask) * sc[0][h, j]
                     + sc[1][h, j]) & 0xFFFFFFFF
                o = (((tj >> np.uint64(4 * h + 8)) & mask) * sc[0][h, j]
                     + sc[1][h, j]) & 0xFFFFFFFF
                out[line + h * _KP // 4] = _byte_perm(
                    e.astype(np.uint32), o.astype(np.uint32), 0x6240)


def _stream_mma(acc, st, w8, bm, bn):
    """Stream::mma: each lane's A and B fragment words read at the
    kernel's shared-memory offsets, placed per mma.m16n8k32's fragment
    layout, C added into acc [warp, MT, NT, lane, 4] likewise."""
    wm_, wn_ = _warps(bm)
    wtm, wtn = bm // wm_, bn // wn_
    mt, nt = wtm // 16, wtn // 8
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    b4 = np.arange(4)
    sb, wb = st.view(np.int8).astype(np.int64), w8.view(np.int8).astype(
        np.int64)
    for kc in range(4):
        k0 = kc * 32 + t * 4
        amat = np.zeros((wm_, mt, 16, 32), np.int64)
        for wm in range(wm_):
            for i in range(mt):
                ra = (wm * wtm + i * 16 + g) * _LINE + k0
                for roff, koff in ((0, 0), (8, 0), (0, 16), (8, 16)):
                    v = sb[(ra + roff * _LINE + koff)[:, None] + b4]
                    amat[wm, i, (g + roff)[:, None],
                         koff + t[:, None] * 4 + b4] = v
        bmat = np.zeros((wn_, nt, 32, 8), np.int64)
        for wn in range(wn_):
            for j in range(nt):
                cb = (wn * wtn + j * 8 + g) * _LINE + k0
                for koff in (0, 16):
                    v = wb[(cb + koff)[:, None] + b4]
                    bmat[wn, j, koff + t[:, None] * 4 + b4, g[:, None]] = v
        for w in range(wm_ * wn_):
            c = np.einsum("irk,jkn->ijrn", amat[w // wn_], bmat[w % wn_])
            for e in range(4):
                acc[w, ..., e] += c[:, :, g + 8 * (e >> 1), 2 * t + (e & 1)]


def _stream_block(xq, qw, s2, zr, w8_full, m, n0, k, bm, bn, s_begin, s_end,
                  rng):
    """One block of decode_kernel: its main loop over steps [s_begin,
    s_end), a ring and w8 buffers that start as garbage; asserts that each
    step's w8 lines hold two_level_w8's columns. Returns the int sums
    [BM, BN] by Tile::for_each_elem."""
    wm_, wn_ = _warps(bm)
    wtm, wtn = bm // wm_, bn // wn_
    a_bytes = bm * _LINE
    ring = rng.integers(0, 256, (_S, a_bytes + _KP * bn + 4 * bn), np.uint8)
    w8 = rng.integers(0, 256, (2, bn * _LINE), np.uint8)
    acc = np.zeros((wm_ * wn_, wtm // 16, wtn // 8, 32, 4), np.int64)
    n = s_end - s_begin

    def fetch(j):
        s = s_begin + j
        if j < n:
            _stream_load(ring[j % _S], s, s == s_begin or s % 2 == 0, xq, qw,
                         s2, zr, m, n0, k, bm, bn)

    for j in range(_S - 1):
        fetch(j)
    sc = _stream_scales(ring[0], bm, bn)
    _stream_dequant(ring[0], sc, bm, bn, w8[0])

    def mma(j):
        r0 = (s_begin + j) * _KP
        want = np.concatenate([w8_full[r0:r0 + _KP, n0:n0 + bn],
                               w8_full[k // 2 + r0:k // 2 + r0 + _KP,
                                       n0:n0 + bn]]).T
        lines = w8[j & 1].view(np.int8).reshape(bn, _LINE)[:, :2 * _KP]
        np.testing.assert_array_equal(lines, want)
        _stream_mma(acc, ring[j % _S], w8[j & 1], bm, bn)

    for j in range(n - 1):
        fetch(j + _S - 1)
        if (s_begin + j + 1) % 2 == 0:
            sc = _stream_scales(ring[(j + 1) % _S], bm, bn)
        mma(j)
        _stream_dequant(ring[(j + 1) % _S], sc, bm, bn, w8[(j + 1) & 1])
    mma(n - 1)
    tile = np.zeros((bm, bn), np.int64)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for w in range(wm_ * wn_):
        wm, wn = w // wn_, w % wn_
        for i in range(wtm // 16):
            for j in range(wtn // 8):
                for e in range(4):
                    tile[wm * wtm + i * 16 + g + 8 * (e >> 1),
                         wn * wtn + j * 8 + 2 * t + (e & 1)] = \
                        acc[w, i, j, :, e]
    return tile


@pytest.mark.parametrize("threads", [128, 256])
@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("bn", [64, 128])
@pytest.mark.parametrize("k", [256, 4096])
@pytest.mark.parametrize("m", [1, 17, 64])
def test_decode_stream_walk_matches_plain(m, k, bn, splits, threads):
    """w4a8tl_decode's main loop and split-K epilogue (csrc/
    w4a8tl_stream.cuh, csrc/w4a8tl_gemm.cu) emulated block by block in
    numpy, at both thread counts: where cp.async places each 16-byte
    chunk (xq lines, the swizzled packed tile, the scale rows only on a
    split's first step and at group starts), the byte-perm dequant into
    padded w8 lines, the mma.sync fragment reads, the split plan of the
    launcher, the partial planes and the arrival counters. The lines must
    equal two_level_w8, the splits' sums w4a8tl_plain's bit for bit, and
    every output must be written once, by its tile's last arrival (or by
    the one split), with the counters zero again."""
    _threads(threads)
    rng = np.random.default_rng(1000 * m + k + bn + splits + threads)
    n = 3 * bn if bn == 64 else 2 * bn          # N = 192: N % 128 != 0
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    q = rng.integers(0, 16, (k, n))
    z = rng.integers(0, 16, (k // 128, n))
    cap = 127 // np.maximum(z, 15 - z)
    s2 = rng.integers(-127, 128, (k // 128, n))
    s2 = np.clip(s2, -cap, cap)
    qw = (q[:k // 2] | (q[k // 2:] << 4)).astype(np.uint8)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    p = tq.QuantLinearParams(
        qweight=torch.from_numpy(qw),
        scales=torch.ones(k // 128, n, dtype=torch.bfloat16),
        zeros=torch.from_numpy(z.astype(np.int8)), bias=None,
        in_features=k, out_features=n, group_size=128,
        scales2=torch.from_numpy(s2.astype(np.int8)),
        chan_scale=torch.from_numpy(rng.uniform(1e-3, 2e-3, (1, n)).astype(
            np.float32)))
    xs = torch.from_numpy(rng.uniform(0.5, 1.5, (m, 1)).astype(np.float32))
    w8_full = tq.two_level_w8(p).numpy()
    zr8, s28 = z.astype(np.int8).view(np.uint8), s2.astype(np.int8).view(
        np.uint8)
    xq8 = xq.view(np.uint8)
    # the launcher's plan (decode<BM, BN, kThreads>)
    nsteps = (k // 2) // _KP
    per = -(-nsteps // min(splits, nsteps))
    used = -(-nsteps // per)
    part = rng.integers(-2 ** 31, 2 ** 31, (used, m, n))     # any contents
    counters = np.zeros(n // bn, np.int64)
    writes = np.zeros((m, n), np.int64)
    out = torch.zeros(m, n, dtype=torch.float32)
    for tile in range(n // bn):
        n0 = tile * bn
        cols = slice(n0, n0 + bn)
        for zi in rng.permutation(used):            # arrival order
            full = _stream_block(xq8, qw, s28, zr8, w8_full, m, n0, k, bm,
                                 bn, zi * per, min(nsteps, zi * per + per),
                                 rng)[:m]
            if used > 1:
                part[zi, :, cols] = full
                counters[tile] += 1
                if counters[tile] != used:
                    continue
                counters[tile] = 0
                full = part[:, :, cols].sum(0)
            writes[:, cols] += 1
            out[:, cols] = (torch.from_numpy(full).to(torch.float32)
                            * xs) * p.chan_scale[:, cols]
    assert (writes == 1).all() and not counters.any()
    acc = xq.astype(np.int64) @ w8_full.astype(np.int64)
    assert np.abs(acc).max() < 2 ** 31
    want = tqm.w4a8tl_plain(torch.from_numpy(xq), xs, p, torch.float32)
    assert torch.equal(out, want)
