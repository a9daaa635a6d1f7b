"""Packed int4 weights: layout, two-level requantization, plain oracles.

Port of `ferrum_tpu/ops/quant.py` (what the served path needs). The
packed format is the interchange format between the two packages, so it
is kept exactly:

  qweight    uint8 [K/2, N]  GLOBAL HALVES: byte row r holds weight row
                             r in its low nibble and row K/2 + r in its
                             high nibble (K/2 a multiple of group_size)
  scales     float [K/g, N]  dequant w = (q - z) * s
  zeros      int8  [K/g, N]
  scales2    int8  [K/g, N]  two-level w4a8: scales == chan * scales2
  chan_scale f32   [1, N]

MoE expert stacks carry a leading expert dim on every tensor
(qweight [E, K/2, N], scales/zeros/scales2 [E, K/g, N], chan_scale
[E, 1, N]); `in_features`/`out_features` are one expert's K and N.

The Hopper kernels (ops/kernels/quant_matmul.py, ops/kernels/moe_gemm.py)
read this layout as is.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass
class QuantLinearParams:
    """Packed int4 linear weights (layout above). `input_perm` (act-order
    checkpoints): y = x[..., input_perm] @ dequant(qweight)."""

    qweight: torch.Tensor            # uint8 [in/2, out]
    scales: torch.Tensor             # float [in/group, out]
    zeros: torch.Tensor              # int8  [in/group, out]
    bias: Optional[torch.Tensor]
    in_features: int
    out_features: int
    group_size: int
    input_perm: Optional[torch.Tensor] = None   # int64 [in]
    scales2: Optional[torch.Tensor] = None      # int8  [in/group, out]
    chan_scale: Optional[torch.Tensor] = None   # f32   [1, out]


def pack_rows_np(q: np.ndarray, group_size: int) -> np.ndarray:
    """Pack uint4 values [in, out] → uint8 [in/2, out] (global halves)."""
    in_f, _ = q.shape
    half = in_f // 2
    assert in_f % 2 == 0 and in_f % group_size == 0, (in_f, group_size)
    low = q[:half].astype(np.uint8)
    high = q[half:].astype(np.uint8)
    return (low & 0xF) | (high << 4)


def unpack_rows(qweight: torch.Tensor) -> torch.Tensor:
    """uint8 [..., in/2, out] → uint4-valued int32 [..., in, out]
    (inverse of pack)."""
    qi = qweight.to(torch.int32)
    return torch.cat([qi & 0xF, qi >> 4], dim=-2)


def quantize_weight_np(
    w: np.ndarray, group_size: int = 128, symmetric: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Round-to-nearest group quantization of a [in, out] f32 weight →
    (packed uint8 [in/2, out], scales f32 [in/g, out], zeros int8)."""
    in_f, out_f = w.shape
    assert in_f % group_size == 0, (in_f, group_size)
    wg = w.reshape(in_f // group_size, group_size, out_f)
    if symmetric:
        amax = np.abs(wg).max(axis=1)
        scale = np.maximum(amax / 7.0, 1e-10)
        zeros = np.full((in_f // group_size, out_f), 8, dtype=np.int8)
        q = np.clip(np.round(wg / scale[:, None, :]) + 8, 0, 15)
    else:
        wmin = wg.min(axis=1)
        wmax = wg.max(axis=1)
        scale = np.maximum((wmax - wmin) / 15.0, 1e-10)
        zeros = np.clip(np.round(-wmin / scale), 0, 15).astype(np.int8)
        q = np.clip(np.round(wg / scale[:, None, :]) + zeros[:, None, :],
                    0, 15)
    packed = pack_rows_np(q.astype(np.uint8).reshape(in_f, out_f),
                          group_size)
    return packed, scale.astype(np.float32), zeros


def make_quant_linear(w: torch.Tensor, group_size: int = 128,
                      symmetric: bool = True,
                      dtype=torch.bfloat16) -> QuantLinearParams:
    """Quantize an [in, out] float weight on its own device: the torch
    form of `quantize_weight_np` (same f32 arithmetic) + packing."""
    in_f, out_f = w.shape
    assert in_f % group_size == 0 and in_f % 2 == 0, (in_f, group_size)
    wg = w.to(torch.float32).reshape(in_f // group_size, group_size, out_f)
    if symmetric:
        scale = (torch.amax(wg.abs(), dim=1) / 7.0).clamp_min(1e-10)
        zeros = torch.full_like(scale, 8.0)
    else:
        wmin = torch.amin(wg, dim=1)
        scale = ((torch.amax(wg, dim=1) - wmin) / 15.0).clamp_min(1e-10)
        zeros = torch.round(-wmin / scale).clamp(0, 15)
    q = (torch.round(wg / scale[:, None, :]) + zeros[:, None, :]).clamp(0, 15)
    q = q.to(torch.uint8).reshape(in_f, out_f)
    half = in_f // 2
    return QuantLinearParams(
        qweight=(q[:half] & 0xF) | (q[half:] << 4),
        scales=scale.to(dtype), zeros=zeros.to(torch.int8), bias=None,
        in_features=in_f, out_features=out_f, group_size=group_size)


def _grouped(p: QuantLinearParams) -> torch.Tensor:
    """Unpacked q as int32 [..., in/g, g, out] (leading expert dims kept)."""
    q = unpack_rows(p.qweight)
    g = p.group_size
    return q.reshape(*q.shape[:-2], p.in_features // g, g, p.out_features)


def dequantize(p: QuantLinearParams, dtype=torch.bfloat16) -> torch.Tensor:
    """Full dequantization [..., in, out] (plain reference path)."""
    qg = _grouped(p)
    w = (qg - p.zeros[..., None, :].to(torch.int32)).to(torch.float32)
    w = w * p.scales[..., None, :].to(torch.float32)
    return w.reshape(*qg.shape[:-3], p.in_features, p.out_features).to(dtype)


def two_level_w8(p: QuantLinearParams) -> torch.Tensor:
    """Integer weights w8 = (q - z) * scales2, int32 [..., in, out],
    |w8| <= 127 (the operand every w4a8tl kernel multiplies against)."""
    qg = _grouped(p)
    w8 = ((qg - p.zeros[..., None, :].to(torch.int32))
          * p.scales2[..., None, :].to(torch.int32))
    return w8.reshape(*qg.shape[:-3], p.in_features, p.out_features)


def _two_level_2d(qweight: torch.Tensor, scales: torch.Tensor,
                  zeros: torch.Tensor, group_size: int):
    """One packed weight → (packed, eff, qs int8, chan), bit for bit the
    JAX package's `_two_level_2d` (f32 arithmetic in the same order):
      cap  = 127 // max(z, 15 - z);  chan = max_g scales / cap
      qs   = clip(ceil(scales / chan - 1e-6), 1, cap);  eff = chan * qs
    and the weights re-rounded against eff."""
    in_f = qweight.shape[0] * 2
    n = qweight.shape[1]
    g = in_f // group_size
    q = unpack_rows(qweight)
    s = scales.to(torch.float32)
    z = zeros.to(torch.int32)
    vmax = torch.maximum(z, 15 - z)
    cap = torch.div(127, vmax.clamp_min(1),
                    rounding_mode="floor").to(torch.float32)
    chan = torch.amax(s / cap, dim=0, keepdim=True)
    chan = chan.clamp_min(1e-12)
    qs = torch.minimum(torch.ceil(s / chan - 1e-6).clamp_min(1.0), cap)
    eff = chan * qs
    qg = q.reshape(g, group_size, n)
    w = (qg - z[:, None]).to(torch.float32) * s[:, None]
    q2 = (torch.round(w / eff[:, None]) + z[:, None]).clamp(0, 15)
    q2 = q2.to(torch.uint8).reshape(in_f, n)
    half = in_f // 2
    packed = q2[:half] | (q2[half:] << 4)
    return packed, eff, qs.to(torch.int8), chan


def requantize_two_level(p: QuantLinearParams) -> QuantLinearParams:
    """Two-level w4a8 form (see module docstring); idempotent. `scales`
    becomes the effective chan * qs, so dequantize stays valid. Expert
    stacks [E, ...] are requantized one expert at a time (the JAX
    package's vmap over E)."""
    if p.scales2 is not None:
        return p
    if p.qweight.dim() == 3:
        parts = [_two_level_2d(qw, s, z, p.group_size)
                 for qw, s, z in zip(p.qweight, p.scales, p.zeros)]
        packed, eff, qs, chan = (torch.stack(t) for t in zip(*parts))
    else:
        packed, eff, qs, chan = _two_level_2d(p.qweight, p.scales, p.zeros,
                                              p.group_size)
    return dataclasses.replace(p, qweight=packed,
                               scales=eff.to(p.scales.dtype),
                               scales2=qs, chan_scale=chan)


def w4a16_weight(p: QuantLinearParams) -> torch.Tensor:
    """The w4a16 kernels' bf16 weight [..., in, out]:
    w = bf16(bf16(q - z) * bf16(s)) per group -- the product of two bf16
    values is exact in f32 and rounded once (`_qmm_kernel`'s dequant;
    `dequantize` instead keeps f32 until one final cast)."""
    qg = _grouped(p)
    qz = (qg - p.zeros[..., None, :].to(torch.int32)).to(torch.float32)
    s = p.scales[..., None, :].to(torch.bfloat16).to(torch.float32)
    w = (qz * s).to(torch.bfloat16)
    return w.reshape(*qg.shape[:-3], p.in_features, p.out_features)


def quant_matmul_w4a8_ref(x: torch.Tensor, p: QuantLinearParams
                          ) -> torch.Tensor:
    """Float-scale w4a8 oracle (port of the JAX package's
    `quant_matmul_w4a8_ref`): per-row int8 activations, one integer dot
    per group, groups summed in index order:
        y[m,n] = sx[m] * sum_g s[g,n] * (sum_k xq*q - z[g,n] * sum_k xq)
    (the kernel sums the groups in its own K-step order instead:
    ops/kernels/quant_matmul.py::w4a8_plain)."""
    from .kernels.quant_matmul import quantize_activation_rows

    if p.input_perm is not None:
        x = x[..., p.input_perm]
    lead = x.shape[:-1]
    xq, sx = quantize_activation_rows(x.reshape(-1, x.shape[-1]))
    q = unpack_rows(p.qweight).to(torch.float64)
    g = p.group_size
    y = torch.zeros((xq.shape[0], p.out_features), dtype=torch.float32,
                    device=x.device)
    for gi in range(p.in_features // g):
        xg = xq[:, gi * g:(gi + 1) * g].to(torch.float64)
        p32 = (xg @ q[gi * g:(gi + 1) * g]).to(torch.float32)   # exact
        xsum = xg.sum(-1, keepdim=True).to(torch.float32)
        zt = p.zeros[gi][None].to(torch.float32)
        st = p.scales[gi][None].to(torch.float32)
        y = y + (p32 - zt * xsum) * st
    out = (y * sx).to(x.dtype).reshape(*lead, p.out_features)
    if p.bias is not None:
        out = out + p.bias
    return out


def quant_matmul_w4a8tl_ref(x: torch.Tensor, p: QuantLinearParams
                            ) -> torch.Tensor:
    """Two-level w4a8 oracle: per-row int8 activations, integer weights
    w8 = (q - z) * scales2, one integer dot over the full K, then
    y = f32(acc) * sx * chan -- the kernels' plain route on any device
    (ops/kernels/quant_matmul.py: the integer dot in float64)."""
    from .kernels.quant_matmul import quantize_activation_rows, w4a8tl_plain

    assert p.scales2 is not None
    if p.input_perm is not None:
        x = x[..., p.input_perm]
    lead = x.shape[:-1]
    xq, xs = quantize_activation_rows(x.reshape(-1, x.shape[-1]))
    out = w4a8tl_plain(xq, xs, p, x.dtype).reshape(*lead, p.out_features)
    if p.bias is not None:
        out = out + p.bias
    return out


def quant_matmul_ref(x: torch.Tensor, p: QuantLinearParams) -> torch.Tensor:
    """w4a16 oracle: dequantize, then a float matmul with f32 sums."""
    if p.input_perm is not None:
        x = x[..., p.input_perm]
    w = dequantize(p, dtype=x.dtype)
    out = (x.to(torch.float32) @ w.to(torch.float32)).to(x.dtype)
    if p.bias is not None:
        out = out + p.bias
    return out
