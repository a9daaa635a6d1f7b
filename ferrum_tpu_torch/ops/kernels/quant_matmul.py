"""Two-level w4a8 quantized matmul: dispatch, Hopper kernels, plain versions.

Counterpart of `ferrum_tpu/ops/pallas/quant_matmul.py` on the served
path (two-level params, `w4a8_gd="mxu"`):

  quant_matmul(x, p)  m <= 64 -> w4a8tl_decode   (_qmm_w4a8tl_mxu_kernel)
                      m >  64 -> w4a8tl_prefill  (_qmm_w4a8tl_kernel)

Both compute y = out_t(f32(xq @ w8) * xs * chan) with int8 per-row
activations and w8 = (q - z) * scales2, exactly (see csrc/w4a8tl_gemm.cu
for the kernels' design and bounds). On a CUDA tensor the wrapper
launches the kernel; on a CPU tensor it runs the plain version, which
takes the integer dot in float64 (exact: every partial sum < 2^53).

Params without `scales2` (the w4a16 and float-scale w4a8 routes, TPU
kernel rows 5-7) are not ported in this slice and raise.
"""

from __future__ import annotations

import torch

from ..quant import QuantLinearParams, two_level_w8
from . import W4A8TL_DECODE, W4A8TL_PREFILL
from .build import check, library

GROUP = 128
DECODE_MAX_M = 64
# Decode splits K until about this many blocks cover the card's 132 SMs.
_DECODE_TARGET_BLOCKS = 264
# Split-K scratch of the decode kernel, one per (device, stream).
_SCRATCH: dict = {}


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
    """Plain PyTorch version of both kernels (the same function)."""
    acc = xq.to(torch.float64) @ two_level_w8(p).to(torch.float64)
    return (acc.to(torch.float32) * xs.to(torch.float32)
            * p.chan_scale.to(torch.float32)).to(out_dtype)


def _check_args(xq, xs, p, out_dtype, n_align):
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
        if t.device != dev or t.data_ptr() % 4:
            raise ValueError(f"{name} must be 4-byte aligned on {dev}")
    chan = p.chan_scale
    if chan.dtype != torch.float32 or chan.numel() != n \
            or not chan.is_contiguous() or chan.device != dev:
        raise ValueError("chan_scale must be a contiguous f32 [1, N] tensor")
    if xq.data_ptr() % 16 or xs.device != dev:
        raise ValueError("xq must be 16-byte aligned, xs on the same device")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported output dtype {out_dtype}")
    return m, k, n


def _split_k_scratch(stream: torch.cuda.Stream, n: int):
    """(counters, ws) pointers of the decode kernel's split-K scratch for
    `stream`: int32, all zero, and left all zero by every launch, so it
    is allocated once per stream (and again only for a wider N)."""
    key = (stream.device_index, stream.cuda_stream)
    width, buf = _SCRATCH.get(key, (0, None))
    if width < n:                  # layout: [width / 64 counters][64 x width]
        width = n                  # zeroed on `stream`, the current one
        buf = torch.zeros(width // 64 + DECODE_MAX_M * width,
                          dtype=torch.int32, device=stream.device)
        _SCRATCH[key] = (width, buf)
    base = buf.data_ptr()
    return base, base + 4 * (width // 64)


def w4a8tl_decode(xq: torch.Tensor, xs: torch.Tensor, p: QuantLinearParams,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Decode-sized (m <= 64) two-level w4a8 GEMM → [m, N] out_dtype."""
    if not xq.is_cuda:
        return w4a8tl_plain(xq, xs, p, out_dtype)
    m, k, n = _check_args(xq, xs, p, out_dtype, 64)
    if m > DECODE_MAX_M:
        raise ValueError(f"w4a8tl_decode takes m <= {DECODE_MAX_M}, got {m}")
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    n_blocks = n // 64
    n_steps = (k // 2) // GROUP
    splits = max(1, min(n_steps, -(-_DECODE_TARGET_BLOCKS // n_blocks)))
    stream = torch.cuda.current_stream(xq.device)
    counters, ws = _split_k_scratch(stream, n)
    err = library("w4a8tl_gemm").ferrum_w4a8tl_decode(
        xq.data_ptr(), xs.data_ptr(), p.qweight.data_ptr(),
        p.scales2.data_ptr(), p.zeros.data_ptr(), p.chan_scale.data_ptr(),
        out.data_ptr(), ws, counters, m, n, k, splits,
        int(out_dtype == torch.bfloat16), stream.cuda_stream)
    check(err, "w4a8tl_decode")
    W4A8TL_DECODE.launches += 1
    return out


def w4a8tl_prefill(xq: torch.Tensor, xs: torch.Tensor, p: QuantLinearParams,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Prefill-sized (m > 64) two-level w4a8 GEMM → [m, N] out_dtype."""
    if not xq.is_cuda:
        return w4a8tl_plain(xq, xs, p, out_dtype)
    m, k, n = _check_args(xq, xs, p, out_dtype, 128)
    out = torch.empty((m, n), dtype=out_dtype, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = library("w4a8tl_gemm").ferrum_w4a8tl_prefill(
        xq.data_ptr(), xs.data_ptr(), p.qweight.data_ptr(),
        p.scales2.data_ptr(), p.zeros.data_ptr(), p.chan_scale.data_ptr(),
        out.data_ptr(), m, n, k, int(out_dtype == torch.bfloat16), stream)
    check(err, "w4a8tl_prefill")
    W4A8TL_PREFILL.launches += 1
    return out


def quant_matmul(x: torch.Tensor, p: QuantLinearParams) -> torch.Tensor:
    """y = x @ dequant(qweight) (+ bias) through the two-level int8 path.
    x: [..., in] → [..., out] in x.dtype."""
    if p.scales2 is None:
        raise NotImplementedError(
            "only two-level w4a8 params are served by this slice of the "
            "port (requantize_two_level first); the w4a16 / float-scale "
            "w4a8 kernels come in a later slice")
    if p.input_perm is not None:
        x = x.index_select(-1, p.input_perm)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq, xs = quantize_activation_rows(x2)
    if x2.shape[0] <= DECODE_MAX_M:
        out = w4a8tl_decode(xq, xs, p, x.dtype)
    else:
        out = w4a8tl_prefill(xq, xs, p, x.dtype)
    out = out.reshape(*lead, p.out_features)
    if p.bias is not None:
        out = out + p.bias
    return out
