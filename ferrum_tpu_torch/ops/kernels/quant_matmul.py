"""Quantized int4 matmul: dispatch, Hopper kernels, plain versions.

Counterpart of `ferrum_tpu/ops/pallas/quant_matmul.py`'s dense part.
`quant_matmul` routes as the JAX package's dispatch does (:901-933),
switched by `set_w4a8` / `set_w4a8_gd` (the engine builder sets them
from `EngineConfig.w4a8` / `w4a8_gd`):

  w4a8  gd    params      m      entry                kernel (TPU row)
  on    mxu   two-level   <= 64  quant_matmul_w4a8tl  w4a8tl_decode    (1)
  on    all   two-level   <= 64  quant_matmul_w4a8tl  w4a8tl_gd_decode (7)
  on    down  two-level,  <= 64  quant_matmul_w4a8tl  w4a8tl_gd_decode (7)
              in > out
  on    off   any         <= 64  quant_matmul_w4a8    w4a8_decode      (6)
  on    down  two-level,  <= 64  quant_matmul_w4a8    w4a8_decode      (6)
              in <= out
  on    any   float-scale <= 64  quant_matmul_w4a8    w4a8_decode      (6)
  on    any   two-level   >  64  quant_matmul_w4a8tl  w4a8tl_prefill   (2)
  on    any   float-scale >  64  quant_matmul_w4a16   w4a16_gemm       (5)
  off   any   any         any    quant_matmul_w4a16   w4a16_gemm       (5)

`w4a8tl_prefill_mcache` (TPU row 8, the m-innermost schedule of row 2)
is on no route, as in the JAX package: only its wrapper reaches it.

A weight the JAX kernels cannot tile (`kernel_tiles` false: group size
not 128, K/2 or N not a multiple of 128) leaves the int8 entries for
w4a16, and w4a16 then computes `quant_matmul_ref` (dequantize, one
float matmul) outside any kernel, as the JAX wrappers' `None` and
`quant_matmul_ref` returns do. The predicate is decided before any
launch.

  w4a8tl_*    y = out_t(f32(xq @ w8) * xs * chan), w8 = (q - z) * scales2,
              exactly (csrc/w4a8tl_gemm.cu, w4a8tl_gd.cu in the group-dot
              form, w4a8tl_mcache.cu; m <= 64 of both decode kernels on
              the streamed main loop csrc/w4a8tl_stream.cuh, m > 64 on the
              int8 wgmma main loop csrc/w4a8tl_wgmma.cuh; plain versions
              w4a8tl_plain and w4a8tl_gd_plain)
  w4a8_decode y = out_t(xs * sum_g s[g] * f32(sum_k xq * (q - z[g]))),
              groups summed in the TPU kernel's K-step order, exactly
              (csrc/w4a8_gemm.cu: the float-scale form of the streamed
              main loop csrc/w4a8tl_stream.cuh; row tiles and K splits on
              TPU-step boundaries, `w4a8_decode_plan`)
  w4a16_gemm  y = out_t(x @ w), w = bf16(bf16(q - z) * bf16(s)), f32
              sums (csrc/w4a16_gemm.cu; m <= 64 on the streamed main loop
              in bf16, csrc/w4a16_stream.cuh, m > 64 on the bf16 wgmma
              main loop csrc/w4a16_wgmma.cuh)

On a CUDA tensor a wrapper launches its kernel or raises; on a CPU
tensor it runs the plain version, which takes every dot in float64
(exact for the integer dots; the bf16 products rounded once).

The mode is process-wide, as in the JAX package: building a second
engine with another `w4a8` / `w4a8_gd` changes the first one's route.
The module defaults are `EngineConfig`'s (w4a8 on, gd "mxu").
"""

from __future__ import annotations

import ctypes

import torch

from ..quant import (QuantLinearParams, quant_matmul_ref, two_level_w8,
                     unpack_rows, w4a16_weight)
from . import (W4A8_DECODE, W4A8TL_DECODE, W4A8TL_GD_DECODE, W4A8TL_PREFILL,
               W4A8TL_PREFILL_MCACHE, W4A16_GEMM)
from .build import check, library

GROUP = 128
DECODE_MAX_M = 64
# Split-K arrival counters of the decode kernels, one per (device, stream).
_SCRATCH: dict = {}
# The streamed decode kernels' launch plans by (kernel, device, m, N, K,
# splits).
_DECODE_PLANS: dict = {}


def quantize_activation_rows(x: torch.Tensor):
    """Dynamic per-row int8 quantization: xq = round(x / s), s = amax/127
    (round-half-even, as the JAX package). Returns (xq int8, s f32 [m,1])."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    s = amax.clamp_min(1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return xq, s


def w4a8tl_plain(xq: torch.Tensor, xs: torch.Tensor, p: QuantLinearParams,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch version of w4a8tl_decode, w4a8tl_prefill and
    w4a8tl_prefill_mcache (one function)."""
    acc = xq.to(torch.float64) @ two_level_w8(p).to(torch.float64)
    return _two_level_out(acc, xs, p, out_dtype)


def _two_level_out(acc, xs, p, out_dtype):
    return (acc.to(torch.float32) * xs.to(torch.float32)
            * p.chan_scale.to(torch.float32)).to(out_dtype)


def w4a8tl_gd_plain(xq: torch.Tensor, xs: torch.Tensor,
                    p: QuantLinearParams,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of `w4a8tl_gd_decode`, the group-dot form taken
    literally: per 128-group g in global order (`unpack_rows`: the low
    plane's groups, then the high plane's, each with its own columns of
    xq), dot = xq_g @ q_g on the raw nibbles and sx = sum_k xq_g; then
    acc = sum_g s2[g] * dot - sum_g sx * (s2 * z)[g]; then
    f32(acc) * xs * chan. The sums run in float64, where these integers
    are exact (< 2^53), so acc is w4a8tl_plain's integer dot and the
    result equals it bit for bit."""
    m, k = xq.shape
    n, g = p.out_features, k // GROUP
    q = unpack_rows(p.qweight).to(torch.float64).reshape(g, GROUP, n)
    xg = xq.to(torch.float64).reshape(m, g, GROUP).transpose(0, 1)
    dot = torch.bmm(xg, q)                                   # [G, m, N]
    sx = xg.sum(-1)                                          # [G, m]
    s2 = p.scales2.to(torch.float64)                         # [G, N]
    s2z = s2 * p.zeros.to(torch.float64)
    acc = (s2[:, None, :] * dot).sum(0) - sx.t() @ s2z
    return _two_level_out(acc, xs, p, out_dtype)


def _check_args(xq, xs, p, out_dtype, n_align, align=4):
    m, k = xq.shape
    n = p.out_features
    dev = xq.device
    if xq.dtype != torch.int8 or not xq.is_contiguous():
        raise ValueError("xq must be a contiguous int8 [m, K] tensor")
    if k != p.in_features or k % (2 * GROUP) or p.group_size != GROUP:
        raise ValueError(f"unsupported K={k} / group {p.group_size}: the "
                         f"kernel needs group 128 and K % 256 == 0")
    if n % n_align:
        raise ValueError(f"N={n} must be a multiple of {n_align}")
    if xs.dtype != torch.float32 or xs.numel() != m or not xs.is_contiguous():
        raise ValueError("xs must be a contiguous f32 [m, 1] tensor")
    for name, t, dt, shape in (
            ("qweight", p.qweight, torch.uint8, (k // 2, n)),
            ("scales2", p.scales2, torch.int8, (k // GROUP, n)),
            ("zeros", p.zeros, torch.int8, (k // GROUP, n))):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} {shape}")
        if t.device != dev or t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned on {dev}")
    chan = p.chan_scale
    if chan.dtype != torch.float32 or chan.numel() != n \
            or not chan.is_contiguous() or chan.device != dev:
        raise ValueError("chan_scale must be a contiguous f32 [1, N] tensor")
    if xq.data_ptr() % 16 or xs.device != dev:
        raise ValueError("xq must be 16-byte aligned, xs on the same device")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported output dtype {out_dtype}")
    return m, k, n


def _split_k_scratch(stream: torch.cuda.Stream, n: int) -> int:
    """Pointer to the decode kernels' split-K arrival counters for
    `stream`: int32, one per 64-column tile, all zero, and left all zero
    by every launch, so they are allocated once per stream (and again
    only for a wider N)."""
    key = (stream.device_index, stream.cuda_stream)
    width, buf = _SCRATCH.get(key, (0, None))
    if width < n:                  # zeroed on `stream`, the current one
        width = n
        buf = torch.zeros(width // 64, dtype=torch.int32,
                          device=stream.device)
        _SCRATCH[key] = (width, buf)
    return buf.data_ptr()


def _stream_decode(kernel, lib, entry, plan_fn, xq, xs, p, out_dtype,
                   splits) -> torch.Tensor:
    """Launch a two-level decode kernel on the streamed main loop (C entry
    `entry` of source `lib`, the arguments of ferrum_w4a8tl_decode): K
    split by the launcher's rule (`plan_fn`), or into `splits` parts (a
    test's override); the splits' int32 partial sums go through a
    [splits, m, N] buffer of this call and the stream's split-K
    counters."""
    m, k, n = _check_args(xq, xs, p, out_dtype, 64, align=16)
    if not 1 <= m <= DECODE_MAX_M:
        raise ValueError(f"{kernel.name} takes m <= {DECODE_MAX_M}, got {m}")
    plan = plan_fn(m, n, k, splits)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    stream = torch.cuda.current_stream(xq.device)
    part, counters = None, 0
    if plan["splits"] > 1:
        counters = _split_k_scratch(stream, n)
        part = torch.empty((plan["splits"], m, n), dtype=torch.int32,
                           device=xq.device)
    check(getattr(library(lib), entry)(
        xq.data_ptr(), xs.data_ptr(), p.qweight.data_ptr(),
        p.scales2.data_ptr(), p.zeros.data_ptr(), p.chan_scale.data_ptr(),
        out.data_ptr(), 0 if part is None else part.data_ptr(), counters,
        m, n, k, plan["splits"], int(out_dtype == torch.bfloat16),
        stream.cuda_stream), kernel.name)
    kernel.launches += 1
    return out


_PLAN_KEYS = ("bm", "bn", "threads", "stages", "splits", "steps_per_split",
              "blocks_per_sm")


def _stream_plan(kernel, lib, entry, m, n, k, splits,
                 keys=_PLAN_KEYS) -> dict:
    """The launch a streamed decode kernel makes for [m, K] x [K, N] on
    the current card (asked of its launcher once per shape): tile rows
    and columns, threads a block, ring stages, K splits and steps per
    split, resident blocks per SM."""
    key = (kernel.name, torch.cuda.current_device(), m, n, k, splits)
    plan = _DECODE_PLANS.get(key)
    if plan is None:
        out = (ctypes.c_int * 7)()
        check(getattr(library(lib), entry)(m, n, k, splits, out),
              f"{kernel.name}_plan")
        plan = _DECODE_PLANS[key] = dict(zip(keys, out))
    return plan


def w4a8tl_decode(xq: torch.Tensor, xs: torch.Tensor, p: QuantLinearParams,
                  out_dtype: torch.dtype, splits: int = 0) -> torch.Tensor:
    """Decode-sized (m <= 64) two-level w4a8 GEMM → [m, N] out_dtype, on
    the streamed main loop's w8 form (csrc/w4a8tl_stream.cuh), which
    copies the weight and xq in 16-byte pieces. K is split by the
    launcher's rule (`w4a8tl_decode_plan`), or into `splits` parts."""
    if not xq.is_cuda:
        return w4a8tl_plain(xq, xs, p, out_dtype)
    return _stream_decode(W4A8TL_DECODE, "w4a8tl_gemm",
                          "ferrum_w4a8tl_decode", w4a8tl_decode_plan, xq, xs,
                          p, out_dtype, splits)


def w4a8tl_decode_plan(m: int, n: int, k: int, splits: int = 0) -> dict:
    """The launch `w4a8tl_decode` makes for [m, K] x [K, N] on the current
    card: tile rows and columns, threads a block, ring stages, K splits
    and steps per split, resident blocks per SM."""
    return _stream_plan(W4A8TL_DECODE, "w4a8tl_gemm",
                        "ferrum_w4a8tl_decode_plan", m, n, k, splits)


def w4a8tl_gd_decode(xq: torch.Tensor, xs: torch.Tensor,
                     p: QuantLinearParams, out_dtype: torch.dtype,
                     splits: int = 0) -> torch.Tensor:
    """Decode-sized (m <= 64) two-level w4a8 GEMM in the group-dot form
    (raw nibbles into the mma; scales2 and the zero correction on the
    output side) → [m, N]; the same function as w4a8tl_decode, on the
    streamed main loop's group-dot form (csrc/w4a8tl_stream.cuh) and its
    launcher's plan (`w4a8tl_gd_decode_plan`), or `splits` K parts."""
    if not xq.is_cuda:
        return w4a8tl_gd_plain(xq, xs, p, out_dtype)
    return _stream_decode(W4A8TL_GD_DECODE, "w4a8tl_gd",
                          "ferrum_w4a8tl_gd_decode", w4a8tl_gd_decode_plan,
                          xq, xs, p, out_dtype, splits)


def w4a8tl_gd_decode_plan(m: int, n: int, k: int, splits: int = 0) -> dict:
    """The launch `w4a8tl_gd_decode` makes for [m, K] x [K, N] on the
    current card (the keys of `w4a8tl_decode_plan`)."""
    return _stream_plan(W4A8TL_GD_DECODE, "w4a8tl_gd",
                        "ferrum_w4a8tl_gd_decode_plan", m, n, k, splits)


def _prefill(entry, name, xq, xs, p, out_dtype) -> torch.Tensor:
    """Launch a two-level prefill kernel (C entry `entry`, the arguments
    of ferrum_w4a8tl_prefill): the int8 wgmma main loop
    (csrc/w4a8tl_wgmma.cuh), 128- or 256-column tiles, any m; it copies
    the weight in 16-byte pieces."""
    m, k, n = _check_args(xq, xs, p, out_dtype, 128, align=16)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    check(entry(xq.data_ptr(), xs.data_ptr(), p.qweight.data_ptr(),
                p.scales2.data_ptr(), p.zeros.data_ptr(),
                p.chan_scale.data_ptr(), out.data_ptr(), m, n, k,
                int(out_dtype == torch.bfloat16), stream), name)
    return out


def w4a8tl_prefill(xq: torch.Tensor, xs: torch.Tensor, p: QuantLinearParams,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Prefill-sized (m > 64) two-level w4a8 GEMM → [m, N] out_dtype."""
    if not xq.is_cuda:
        return w4a8tl_plain(xq, xs, p, out_dtype)
    out = _prefill(library("w4a8tl_gemm").ferrum_w4a8tl_prefill,
                   "w4a8tl_prefill", xq, xs, p, out_dtype)
    W4A8TL_PREFILL.launches += 1
    return out


def w4a8tl_prefill_mcache(xq: torch.Tensor, xs: torch.Tensor,
                          p: QuantLinearParams,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """The prefill GEMM's function with the dequantized weight tile shared
    by two 128-row tiles (TPU row 8's schedule: 256 x 128 blocks on
    w4a8tl_prefill's main loop) → [m, N] out_dtype. On no route, as in
    the JAX package: only this wrapper reaches it."""
    if not xq.is_cuda:
        return w4a8tl_plain(xq, xs, p, out_dtype)
    out = _prefill(library("w4a8tl_mcache").ferrum_w4a8tl_prefill_mcache,
                   "w4a8tl_prefill_mcache", xq, xs, p, out_dtype)
    W4A8TL_PREFILL_MCACHE.launches += 1
    return out


# ---------------------------------------------------------------------------
# float-scale w4a8 (TPU row 6) and w4a16 (TPU row 5)
# ---------------------------------------------------------------------------

def kernel_tiles(p: QuantLinearParams) -> bool:
    """Whether the JAX package's dense int4 kernels tile this weight:
    group 128 and K/2, N multiples of 128 (their bkb/bn halving loops
    end at 128; every m tiles once padded). False is where their
    wrappers return None / `quant_matmul_ref`."""
    return (p.group_size == GROUP and p.in_features % (2 * GROUP) == 0
            and p.out_features % 128 == 0)


def w4a8_step_rows(k: int) -> int:
    """Packed rows per K step of `_quant_matmul_w4a8_2d` (its bkb): the
    groups of one step are summed per plane before the step's sums join
    the accumulator, so the step fixes the float order."""
    bkb = 512
    while bkb >= GROUP and (k // 2) % bkb:
        bkb //= 2
    return bkb


def w4a8_plain(xq: torch.Tensor, xs: torch.Tensor, p: QuantLinearParams,
               out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of `w4a8_decode`, in the TPU kernel's order: per K
    step, the low plane's groups summed from the first, added to the
    accumulator, then the high plane's; the result times xs. Each group
    term s[g] * f32(sum_k xq * (q - z[g])) equals the kernel's
    (f32(p32) - z * f32(sum xq)) * s exactly (integers below 2^24)."""
    m, k = xq.shape
    n, g = p.out_features, k // GROUP
    gpt = w4a8_step_rows(k) // GROUP
    half = g // 2
    wz = (unpack_rows(p.qweight).reshape(g, GROUP, n)
          - p.zeros[:, None, :].to(torch.int32)).to(torch.float64)
    xg = xq.to(torch.float64).reshape(m, g, GROUP).transpose(0, 1)
    terms = torch.bmm(xg, wz).to(torch.float32) \
        * p.scales.to(torch.float32)[:, None, :]             # [G, m, N]
    acc = torch.zeros((m, n), dtype=torch.float32, device=xq.device)
    for step in range(half // gpt):
        for g0 in (step * gpt, half + step * gpt):
            part = terms[g0]
            for t in range(1, gpt):
                part = part + terms[g0 + t]
            acc = acc + part
    return (acc * xs.to(torch.float32)).to(out_dtype)


def w4a16_plain(x: torch.Tensor, p: QuantLinearParams) -> torch.Tensor:
    """Plain version of `w4a16_gemm`: x [m, K] (any float dtype) @ the
    bf16 weight, summed in float64 and rounded to x.dtype."""
    w = w4a16_weight(p).to(torch.float64)
    return (x.to(torch.float64) @ w).to(x.dtype)


def check_float_scale(p: QuantLinearParams, k: int, dev: torch.device,
                      n_align: int, lead: tuple = (), align: int = 4) -> int:
    """Raise unless p is a float-scale weight the kernels take (`lead` =
    (E,) for an expert stack; its tensors `align`-byte aligned); returns
    N."""
    n = p.out_features
    if k != p.in_features or k % (2 * GROUP) or p.group_size != GROUP:
        raise ValueError(f"unsupported K={k} / group {p.group_size}: the "
                         f"kernel needs group 128 and K % 256 == 0")
    if n % n_align:
        raise ValueError(f"N={n} must be a multiple of {n_align}")
    for name, t, dts, shape in (
            ("qweight", p.qweight, (torch.uint8,), (*lead, k // 2, n)),
            ("scales", p.scales, (torch.bfloat16, torch.float32),
             (*lead, k // GROUP, n)),
            ("zeros", p.zeros, (torch.int8,), (*lead, k // GROUP, n))):
        if t.dtype not in dts or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dts} {shape}")
        if t.device != dev or t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned on {dev}")
    return n


def w4a8_planes(k: int, splits: int, tpu_steps_per_split: int) -> int:
    """The f32 [m, N] planes a `w4a8_decode` launch writes: none for one
    split; else split 0's running sum and each later TPU K step's low and
    high plane sums."""
    if splits <= 1:
        return 0
    steps = (k // 2) // w4a8_step_rows(k)
    return 1 + 2 * (steps - tpu_steps_per_split)


def w4a8_decode(xq: torch.Tensor, xs: torch.Tensor, p: QuantLinearParams,
                out_dtype: torch.dtype, splits: int = 0) -> torch.Tensor:
    """Decode-sized (m <= 64) float-scale w4a8 GEMM → [m, N] out_dtype, on
    the streamed main loop's float-scale form (csrc/w4a8tl_stream.cuh),
    its row tiles and K splits (on TPU-step boundaries) by the launcher's
    rule (`w4a8_decode_plan`), or `splits` K parts; the splits' f32 plane
    sums go through a buffer of this call sized by the plan and the
    stream's split-K counters."""
    if not xq.is_cuda:
        return w4a8_plain(xq, xs, p, out_dtype)
    m, k = xq.shape
    n = check_float_scale(p, k, xq.device, 64, align=16)
    if not 1 <= m <= DECODE_MAX_M:
        raise ValueError(f"w4a8_decode takes m <= {DECODE_MAX_M}, got {m}")
    if xq.dtype != torch.int8 or not xq.is_contiguous() \
            or xq.data_ptr() % 16:
        raise ValueError("xq must be a contiguous, 16-byte aligned int8 "
                         "[m, K] tensor")
    if xs.dtype != torch.float32 or xs.numel() != m \
            or not xs.is_contiguous() or xs.device != xq.device:
        raise ValueError("xs must be a contiguous f32 [m, 1] tensor")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported output dtype {out_dtype}")
    plan = w4a8_decode_plan(m, n, k, splits)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    stream = torch.cuda.current_stream(xq.device)
    part, counters = None, 0
    if plan["splits"] > 1:
        # Counters for 16-row tiles, the most a launch of m rows takes.
        counters = _split_k_scratch(stream, n * -(-m // 16))
        part = torch.empty((plan["planes"], m, n), dtype=torch.float32,
                           device=xq.device)
    # The plan's split count, which fixes the planes (its row tiles, at
    # that count, are the rule's).
    err = library("w4a8_gemm").ferrum_w4a8_decode(
        xq.data_ptr(), xs.data_ptr(), p.qweight.data_ptr(),
        p.scales.data_ptr(), p.zeros.data_ptr(), out.data_ptr(),
        0 if part is None else part.data_ptr(), counters, m, n, k,
        plan["splits"],
        int(p.scales.dtype == torch.float32),
        int(out_dtype == torch.bfloat16), stream.cuda_stream)
    check(err, "w4a8_decode")
    W4A8_DECODE.launches += 1
    return out


def w4a8_decode_plan(m: int, n: int, k: int, splits: int = 0) -> dict:
    """The launch `w4a8_decode` makes for [m, K] x [K, N] on the current
    card: rows a row tile (`bm`; `row_tiles` of them), columns, threads a
    block, ring stages, K splits and TPU K steps per split (each
    w4a8_step_rows(k) packed rows), resident blocks per SM; with the
    TPU K steps' groups per plane (`gpt`) and the f32 [m, N] `planes` the
    splits write."""
    plan = _stream_plan(
        W4A8_DECODE, "w4a8_gemm", "ferrum_w4a8_decode_plan", m, n, k, splits,
        ("bm", "bn", "threads", "stages", "splits", "tpu_steps_per_split",
         "blocks_per_sm"))
    if "planes" not in plan:            # the cached plan, completed once
        plan.update(row_tiles=-(-m // plan["bm"]),
                    gpt=w4a8_step_rows(k) // GROUP,
                    planes=w4a8_planes(k, plan["splits"],
                                       plan["tpu_steps_per_split"]))
    return plan


def w4a16_gemm(x: torch.Tensor, p: QuantLinearParams,
               splits: int = 0) -> torch.Tensor:
    """w4a16 GEMM: bf16 x [m, K] @ the bf16-dequantized weight → bf16
    [m, N]. m <= 64 runs the streamed main loop in bf16
    (csrc/w4a16_stream.cuh), K split by its launcher's rule
    (`w4a16_decode_plan`), or into `splits` parts, the splits' f32
    partials summed in split order through a [splits, m, N] buffer of the
    call; larger m takes the wgmma main loop's 128-row tiles
    (csrc/w4a16_wgmma.cuh). Both copy x and the weight in 16-byte
    pieces."""
    if not x.is_cuda:
        return w4a16_plain(x, p)
    m, k = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError("w4a16_gemm takes a contiguous, 16-byte aligned "
                         f"bf16 [m, K] x, got {x.dtype}")
    decode = m <= DECODE_MAX_M
    n = check_float_scale(p, k, x.device, 64 if decode else 128, align=16)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    part, counters = None, 0
    if decode:
        splits = w4a16_decode_plan(m, n, k, splits)["splits"]
        if splits > 1:
            counters = _split_k_scratch(stream, n)
            part = torch.empty((splits, m, n), dtype=torch.float32,
                               device=x.device)
    err = library("w4a16_gemm").ferrum_w4a16_gemm(
        x.data_ptr(), p.qweight.data_ptr(), p.scales.data_ptr(),
        p.zeros.data_ptr(), out.data_ptr(),
        0 if part is None else part.data_ptr(), counters, m, n, k, splits,
        int(p.scales.dtype == torch.float32), stream.cuda_stream)
    check(err, "w4a16_gemm")
    W4A16_GEMM.launches += 1
    return out


def w4a16_decode_plan(m: int, n: int, k: int, splits: int = 0) -> dict:
    """The launch `w4a16_gemm` makes at m <= 64 for [m, K] x [K, N] on the
    current card (the keys of `w4a8tl_decode_plan`)."""
    return _stream_plan(W4A16_GEMM, "w4a16_gemm", "ferrum_w4a16_decode_plan",
                        m, n, k, splits)


# ---------------------------------------------------------------------------
# entries and dispatch
# ---------------------------------------------------------------------------

_W4A8 = True
_W4A8_GD = "mxu"


def set_w4a8(enabled: bool) -> None:
    """Route int4 matmuls through the w4a8 entries (or w4a16)."""
    global _W4A8
    _W4A8 = bool(enabled)


def set_w4a8_gd(mode) -> None:
    """Decode-m mode for two-level params: "off" | "all" | "down" | "mxu"
    (bools map to off / all, as in the JAX package)."""
    global _W4A8_GD
    if isinstance(mode, bool):
        mode = "all" if mode else "off"
    if mode not in ("off", "all", "down", "mxu"):
        raise ValueError(f"unknown w4a8_gd mode {mode!r}")
    _W4A8_GD = mode


def w4a8_enabled() -> bool:
    return _W4A8


def _rows(x: torch.Tensor, p: QuantLinearParams):
    if p.input_perm is not None:
        x = x.index_select(-1, p.input_perm)
    return x.reshape(-1, x.shape[-1]), x.shape[:-1]


def _finish(out: torch.Tensor, lead, p: QuantLinearParams) -> torch.Tensor:
    out = out.reshape(*lead, p.out_features)
    if p.bias is not None:
        out = out + p.bias
    return out


def quant_matmul_w4a8tl(x: torch.Tensor, p: QuantLinearParams,
                        gd=False) -> torch.Tensor:
    """Two-level w4a8, kernel by `gd` as the JAX entry (:774-803): False
    the prefill kernel, True the group-dot decode kernel, "mxu" the decode
    kernel (both decode kernels take m <= 64, all the dispatch sends
    them); w4a16 where `kernel_tiles` is false."""
    if not kernel_tiles(p):
        return quant_matmul_w4a16(x, p)
    x2, lead = _rows(x, p)
    xq, xs = quantize_activation_rows(x2)
    kernel = {False: w4a8tl_prefill, True: w4a8tl_gd_decode,
              "mxu": w4a8tl_decode}[gd]
    return _finish(kernel(xq, xs, p, x.dtype), lead, p)


def quant_matmul_w4a8(x: torch.Tensor, p: QuantLinearParams
                      ) -> torch.Tensor:
    """Float-scale w4a8 (group scales `p.scales`); w4a16 where
    `kernel_tiles` is false."""
    if not kernel_tiles(p):
        return quant_matmul_w4a16(x, p)
    x2, lead = _rows(x, p)
    xq, xs = quantize_activation_rows(x2)
    return _finish(w4a8_decode(xq, xs, p, x.dtype), lead, p)


def quant_matmul_w4a16(x: torch.Tensor, p: QuantLinearParams
                       ) -> torch.Tensor:
    """w4a16; `quant_matmul_ref` (no kernel) where `kernel_tiles` is
    false."""
    if not kernel_tiles(p):
        return quant_matmul_ref(x, p)
    x2, lead = _rows(x, p)
    return _finish(w4a16_gemm(x2, p), lead, p)


def quant_matmul(x: torch.Tensor, p: QuantLinearParams) -> torch.Tensor:
    """y = x @ dequant(qweight) (+ bias). x: [..., in] → [..., out] in
    x.dtype, through the route of the module docstring's table."""
    m = 1
    for d in x.shape[:-1]:
        m *= d
    if _W4A8 and m <= DECODE_MAX_M:
        if _W4A8_GD == "mxu" and p.scales2 is not None:
            return quant_matmul_w4a8tl(x, p, gd="mxu")
        gd = _W4A8_GD == "all" or (
            _W4A8_GD == "down" and p.in_features > p.out_features)
        if gd and p.scales2 is not None:
            return quant_matmul_w4a8tl(x, p, gd=True)
        return quant_matmul_w4a8(x, p)
    if _W4A8 and p.scales2 is not None:
        return quant_matmul_w4a8tl(x, p)
    return quant_matmul_w4a16(x, p)
