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
The kernel's tile walk on the streamed main loop (csrc/w4a8tl_stream.cuh,
group-dot form) is emulated in numpy, block by block, and held against
`w4a8tl_gd_plain` bit for bit.

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
import test_torch_quant as ttq
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
# 2. the kernel's tile walk, emulated: csrc/w4a8tl_stream.cuh's group-dot
# form (Stream<.., kGD = true>) on test_torch_quant's ring, load and warp
# helpers; its unpack, per-half dots, row sums from the A fragments,
# column scales and rescale below. Registers are 32-bit words, as in the
# kernel.
# ---------------------------------------------------------------------------

_KP, _LINE, _S = ttq._KP, ttq._LINE, ttq._S


def _gd_unpack(st, bm, bn, lines):
    """Stream::unpack: the dequant's units, 4-byte loads of the swizzled
    packed tile and byte-perm transposes; the raw nibbles t & 0x0F0F0F0F
    (low half) and (t >> 4) & 0x0F0F0F0F (high half) into lines `lines`."""
    r, rbs, bp = ttq._R, ttq._RB, ttq._byte_perm
    words = st.view("<u4")
    out = lines.view("<u4")
    tid = np.arange(rbs * bn // 4)
    rb, cu = tid % rbs, tid // rbs
    swz = (rb * (r // 8)) & (bn // 16 - 1)
    base = bm * _LINE + (((cu >> 2) ^ swz) << 4) + ((cu & 3) << 2)
    for i4 in range(r // 4):
        row = r * rb + 4 * i4
        w = [words[(base + (row + i) * bn) // 4] for i in range(4)]
        x0, x1 = bp(w[0], w[1], 0x5140), bp(w[0], w[1], 0x7362)
        x2, x3 = bp(w[2], w[3], 0x5140), bp(w[2], w[3], 0x7362)
        t = [bp(x0, x2, 0x5410), bp(x0, x2, 0x7632),
             bp(x1, x3, 0x5410), bp(x1, x3, 0x7632)]
        for j in range(4):
            line = ((4 * cu + j) * _LINE + r * rb) // 4 + i4
            out[line] = t[j] & np.uint32(0x0F0F0F0F)
            out[line + _KP // 4] = (t[j] >> np.uint32(4)) \
                & np.uint32(0x0F0F0F0F)


def _gd_cols(st, bm, bn):
    """Stream::load_cols: each lane's scales2 and scales2 * zeros at its
    accumulator columns wn * WTN + j * 8 + 2t + e, from the staged rows of
    stage `st`, as uint32 words: two arrays [half, WN, NT, lane, e]."""
    _, wn_ = ttq._warps(bm)
    wtn = bn // wn_
    t = np.arange(32) & 3
    sc = st[bm * _LINE + _KP * bn:].view(np.int8).astype(np.int64)
    col = (np.arange(wn_)[:, None, None, None] * wtn
           + np.arange(wtn // 8)[:, None, None] * 8
           + 2 * t[:, None] + np.arange(2))
    s2 = np.stack([sc[h * bn + col] for h in range(2)])
    z = np.stack([sc[(2 + h) * bn + col] for h in range(2)])
    return s2.astype(np.uint32), (s2 * z).astype(np.uint32)


def _gd_scale(acc, dot, s2):
    """Stream::scale_dot: acc += dot * s2 on every C-fragment element, in
    32-bit words modulo 2^32 as the kernel's uint32_t arithmetic: acc and
    dot [MT, NT, lane, 4], s2 [NT, lane, column 2t / 2t + 1]. The
    registers stay 32-bit words."""
    e = np.arange(4)
    new = acc + dot.astype(np.uint32) * s2[None][..., e & 1]
    np.copyto(acc, new, casting="no")


def _gd_correct(acc, sx, s2z):
    """Stream::correct: the lanes' row-sum parts sx [MT, lane, row g /
    g + 8] summed over each mma group by two xor shuffles (1, 2), then
    acc -= sx * s2z modulo 2^32 (s2z as s2 in _gd_scale)."""
    lane = np.arange(32)
    for x in (1, 2):                                  # __shfl_xor_sync
        sx = sx + sx[:, lane ^ x]
    e = np.arange(4)
    new = acc - sx.astype(np.uint32)[:, None][..., e >> 1] \
        * s2z[None][..., e & 1]
    np.copyto(acc, new, casting="no")


def _gd_dots(st, lines, bm, bn):
    """Stream::dot_half of both halves, every warp: half h reads chunks
    kc = 2h, 2h + 1 of the xq lines (stage `st`) and the nibble lines as
    each lane's fragment words; dot by mma.m16n8k32's layout; each lane's
    part of the row sums by dp4a over its A words (row g: words 0, 2;
    row g + 8: 1, 3). Returns dot [warp, half, MT, NT, lane, 4] and sx
    [warp, half, MT, lane, 2]."""
    wm_, wn_ = ttq._warps(bm)
    wtm, wtn = bm // wm_, bn // wn_
    mt, nt = wtm // 16, wtn // 8
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    b4 = np.arange(4)
    sb = st.view(np.int8).astype(np.int64)
    lb = lines.view(np.int8).astype(np.int64)
    dot = np.zeros((wm_ * wn_, 2, mt, nt, 32, 4), np.int64)
    sx = np.zeros((wm_ * wn_, 2, mt, 32, 2), np.int64)
    for w in range(wm_ * wn_):
        wm, wn = w // wn_, w % wn_
        for h in range(2):
            for kc in (2 * h, 2 * h + 1):
                k0 = kc * 32 + t * 4
                a = np.zeros((mt, 4, 32, 4), np.int64)    # [i, word, lane, byte]
                for i in range(mt):
                    ra = (wm * wtm + i * 16 + g) * _LINE + k0
                    for wd, off in enumerate((0, 8 * _LINE, 16,
                                              8 * _LINE + 16)):
                        a[i, wd] = sb[(ra + off)[:, None] + b4]
                b = np.zeros((nt, 2, 32, 4), np.int64)
                for j in range(nt):
                    cb = (wn * wtn + j * 8 + g) * _LINE + k0
                    for wd, off in enumerate((0, 16)):
                        b[j, wd] = lb[(cb + off)[:, None] + b4]
                sx[w, h, :, :, 0] += a[:, 0].sum(-1) + a[:, 2].sum(-1)
                sx[w, h, :, :, 1] += a[:, 1].sum(-1) + a[:, 3].sum(-1)
                amat = np.zeros((mt, 16, 32), np.int64)
                for wd, (roff, koff) in enumerate(((0, 0), (8, 0), (0, 16),
                                                   (8, 16))):
                    amat[:, (g + roff)[:, None],
                         koff + t[:, None] * 4 + b4] = a[:, wd]
                bmat = np.zeros((nt, 32, 8), np.int64)
                for wd, koff in enumerate((0, 16)):
                    bmat[:, koff + t[:, None] * 4 + b4, g[:, None]] = b[:, wd]
                c = np.einsum("irk,jkn->ijrn", amat, bmat)
                for e in range(4):
                    dot[w, h, ..., e] += c[:, :, g + 8 * (e >> 1),
                                           2 * t + (e & 1)]
    return dot, sx


def _gd_block(xq, qw, s2, zr, q_full, m, n0, k, bm, bn, s_begin, s_end,
              rng):
    """One block of decode_kernel<.., kGD = true, ..>: Stream::run over
    steps [s_begin, s_end) with a ring and line buffers that start as
    garbage. The column scales are read into registers on the step that
    staged them (a group's first step, or the split's) and kept for the
    group's second. Each step's dots are scaled as they come, or at
    BN 128 (where the extra accumulators fit: kPerGroup) kept and scaled
    once a group; the row sums are kept and the zero correction made once
    a group, after its last step here. Asserts that each step's lines
    hold unpack_rows' nibbles. Returns the tile's int32 sums [BM, BN] by
    Tile::for_each_elem."""
    wm_, wn_ = ttq._warps(bm)
    wtm, wtn = bm // wm_, bn // wn_
    mt, nt = wtm // 16, wtn // 8
    per_group = bn >= 128 and mt * nt <= 8
    ring = rng.integers(0, 256, (_S, bm * _LINE + _KP * bn + 4 * bn),
                        np.uint8)
    lines = rng.integers(0, 256, (2, bn * _LINE), np.uint8)
    acc = np.zeros((wm_ * wn_, mt, nt, 32, 4), np.uint32)
    kept = np.zeros((wm_ * wn_, 2, mt, nt, 32, 4), np.int64)
    sx = np.zeros((wm_ * wn_, 2, mt, 32, 2), np.int64)
    n = s_end - s_begin

    def stages_scales(s):
        return s == s_begin or s % 2 == 0

    def fetch(j):
        s = s_begin + j
        if j < n:
            ttq._stream_load(ring[j % _S], s, stages_scales(s), xq, qw, s2,
                             zr, m, n0, k, bm, bn)

    def step(j, cs):
        r0 = (s_begin + j) * _KP
        want = np.concatenate([q_full[r0:r0 + _KP, n0:n0 + bn],
                               q_full[k // 2 + r0:k // 2 + r0 + _KP,
                                      n0:n0 + bn]]).T
        np.testing.assert_array_equal(
            lines[j & 1].reshape(bn, _LINE)[:, :2 * _KP], want)
        dot, part = _gd_dots(ring[j % _S], lines[j & 1], bm, bn)
        sx[...] += part
        if per_group:
            kept[...] += dot
        else:
            for w in range(wm_ * wn_):
                for h in range(2):
                    _gd_scale(acc[w], dot[w, h], cs[0][h, w % wn_])

    def group_end(j, cs):
        s = s_begin + j
        if s % 2 == 1 or s + 1 == s_end:
            for w in range(wm_ * wn_):
                for h in range(2):
                    if per_group:
                        _gd_scale(acc[w], kept[w, h], cs[0][h, w % wn_])
                        kept[w, h] = 0
                    _gd_correct(acc[w], sx[w, h], cs[1][h, w % wn_])
                    sx[w, h] = 0

    for j in range(_S - 1):
        fetch(j)
    _gd_unpack(ring[0], bm, bn, lines[0])
    cs = None
    for j in range(n - 1):
        fetch(j + _S - 1)
        if stages_scales(s_begin + j):
            cs = _gd_cols(ring[j % _S], bm, bn)
        step(j, cs)
        _gd_unpack(ring[(j + 1) % _S], bm, bn, lines[(j + 1) & 1])
        group_end(j, cs)
    if stages_scales(s_end - 1):
        cs = _gd_cols(ring[(n - 1) % _S], bm, bn)
    step(n - 1, cs)
    group_end(n - 1, cs)
    words = acc.view(np.int32)
    tile = np.zeros((bm, bn), np.int32)
    g, t = np.arange(32) >> 2, np.arange(32) & 3
    for w in range(wm_ * wn_):
        wm, wn = w // wn_, w % wn_
        for i in range(mt):
            for j in range(nt):
                for e in range(4):
                    tile[wm * wtm + i * 16 + g + 8 * (e >> 1),
                         wn * wtn + j * 8 + 2 * t + (e & 1)] = \
                        words[w, i, j, :, e]
    return tile


_GD_WALK = [pytest.param("random", m, k, bn, splits, threads,
                         id=f"{m}-{k}-{bn}-{splits}-{threads}")
            for m in (1, 17, 64) for k in (256, 4096) for bn in (64, 128)
            for splits in (1, 3) for threads in (128, 256)]
_GD_WALK += [pytest.param("wrap", 1, 14336, 64, splits, 128,
                          id=f"wrap-{splits}") for splits in (1, 3)]


@pytest.mark.parametrize("case,m,k,bn,splits,threads", _GD_WALK)
def test_gd_stream_walk_matches_plain(case, m, k, bn, splits, threads):
    """w4a8tl_gd_decode's tile walk on the streamed main loop (csrc/
    w4a8tl_stream.cuh's group-dot form, the launcher's split plan, the
    split-K epilogue) emulated block by block in numpy at both thread
    counts: the unpacked lines must equal unpack_rows' nibbles, the sum
    of the splits w4a8tl_gd_plain bit for bit, and every output must be
    written once, by its tile's last arrival (or by the one split), with
    the counters zero again. Three splits of K = 4096 start one split
    mid-group (steps 0, 11, 22). The wrap case (K = 14336, xq = 127,
    q = z = 15, scales2 = 127: every w8 is 0) must give 0."""
    ttq._threads(threads)
    rng = np.random.default_rng(1000 * m + k + bn + splits + threads)
    n = bn if case == "wrap" else 3 * bn if bn == 64 else 2 * bn
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    if case == "wrap":
        q = np.full((k, n), 15)
        z = np.full((k // 128, n), 15)
        s2 = np.full((k // 128, n), 127)
        xq = np.full((m, k), 127, np.int8)
    else:
        q = rng.integers(0, 16, (k, n))
        z = rng.integers(0, 16, (k // 128, n))
        cap = 127 // np.maximum(z, 15 - z)
        s2 = np.clip(rng.integers(-127, 128, (k // 128, n)), -cap, cap)
        xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    qw = (q[:k // 2] | (q[k // 2:] << 4)).astype(np.uint8)
    p = tq.QuantLinearParams(
        qweight=torch.from_numpy(qw),
        scales=torch.ones(k // 128, n, dtype=torch.bfloat16),
        zeros=torch.from_numpy(z.astype(np.int8)), bias=None,
        in_features=k, out_features=n, group_size=128,
        scales2=torch.from_numpy(s2.astype(np.int8)),
        chan_scale=torch.from_numpy(rng.uniform(1e-3, 2e-3, (1, n)).astype(
            np.float32)))
    xs = torch.from_numpy(rng.uniform(0.5, 1.5, (m, 1)).astype(np.float32))
    q_full = tq.unpack_rows(p.qweight).numpy()
    zr8, s28 = z.astype(np.int8).view(np.uint8), s2.astype(np.int8).view(
        np.uint8)
    nsteps = (k // 2) // _KP
    per = -(-nsteps // min(splits, nsteps))
    used = -(-nsteps // per)
    part = rng.integers(-2 ** 31, 2 ** 31, (used, m, n)).astype(np.int32)
    counters = np.zeros(n // bn, np.int64)
    writes = np.zeros((m, n), np.int64)
    out = torch.zeros(m, n, dtype=torch.float32)
    for tile in range(n // bn):
        n0 = tile * bn
        cols = slice(n0, n0 + bn)
        for zi in rng.permutation(used):            # arrival order
            full = _gd_block(xq.view(np.uint8), qw, s28, zr8, q_full, m, n0,
                             k, bm, bn, zi * per,
                             min(nsteps, zi * per + per), rng)[:m]
            if used > 1:
                part[zi, :, cols] = full
                counters[tile] += 1
                if counters[tile] != used:
                    continue
                counters[tile] = 0
                full = part[:, :, cols].sum(0, dtype=np.int32)
            writes[:, cols] += 1
            out[:, cols] = (torch.from_numpy(full).to(torch.float32)
                            * xs) * p.chan_scale[:, cols]
    assert (writes == 1).all() and not counters.any()
    want = tqm.w4a8tl_gd_plain(torch.from_numpy(xq), xs, p, torch.float32)
    assert torch.equal(out, want)
    if case == "wrap":
        assert not want.any()


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
