"""int4 GEMMs over MoE expert stacks: Hopper kernels, plain versions,
and the grouped kernels' device-side tile map.

Counterpart of the MoE part of `ferrum_tpu/ops/pallas/quant_matmul.py`
(:936-1477):

  quant_bmm_all_experts  every expert on every row (decode, t <= 64)
                         <- _qbmm_w4a8tl_mxu_kernel / _qbmm_w4a8tl_kernel
      out[e] = bf16((f32(xq[e|0] @ w8[e]) * xs[e|0]) * chan[e])
  quant_grouped_matmul   rows sorted by expert (prefill, small decode)
                         <- _qgmm_w4a8tl_kernel
      y[r] = out_t((f32(xq[r] @ w8[e(r)]) * chan[e(r)]) * xs[r])
                         two-level stacks with w4a8 on: grouped_w4a8tl
                         <- _qgmm_w4a8tl_kernel
                         everything else: grouped_w4a16 <- _qgmm_kernel
      y[r] = out_t(x[r] @ w[e(r)]), w = bf16(bf16(q - z) * bf16(s))

The w4a8tl kernels keep their TPU kernels' (different) epilogue orders.
On a CUDA tensor a wrapper launches its kernel (csrc/moe_gemm.cu,
csrc/w4a16_gemm.cu: at decode-sized row counts on the streamed main
loop in bf16, csrc/w4a16_stream.cuh); on a CPU tensor it runs the plain
version, which takes every dot in float64 (exact for the integer dots).
Each grouped wrapper builds the tile map and launches on it; `*_on_map`
launches on a map built before (so a caller can time or share the
map). The two-level grouped kernel at decode sizes (<= 256 rows) needs
only the groups' row offsets: `grouped_w4a8tl` builds those alone
there, and `grouped_w4a8tl_on_map` reads the map's.

Stacks the JAX grouped kernels cannot tile (`grouped_tiles` false)
take `grouped_ref` (dequantize, one float matmul per expert) outside any
kernel, as the JAX package's dequantize + ragged_dot fallback.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ..quant import QuantLinearParams, dequantize, two_level_w8, w4a16_weight
from . import MOE_BMM, MOE_GROUPED, MOE_GROUPED_W4A16
from .build import check, library
from .quant_matmul import (check_float_scale, quantize_activation_rows,
                           w4a8_enabled)

GROUP = 128
BMM_MAX_T = 64

TileMap = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def bmm_plain(xq3: torch.Tensor, xs3: torch.Tensor, p: QuantLinearParams,
              out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the all-experts kernel: [1|E, t, K] → [E, t, N]."""
    acc = xq3.to(torch.float64) @ two_level_w8(p).to(torch.float64)
    return ((acc.to(torch.float32) * xs3.to(torch.float32))
            * p.chan_scale.to(torch.float32)).to(out_dtype)


def _per_group(x: torch.Tensor, group_sizes: torch.Tensor, n: int,
               out_dtype: torch.dtype, fn) -> torch.Tensor:
    """[A, N] with rows lo:hi of group e set to fn(e, lo, hi); rows past
    the last group 0. Reads the sizes on the host."""
    out = torch.zeros((x.shape[0], n), dtype=out_dtype, device=x.device)
    lo = 0
    for e, size in enumerate(group_sizes.tolist()):
        if size:
            out[lo:lo + size] = fn(e, lo, lo + size).to(out_dtype)
        lo += size
    return out


def _two_level_rows(xq, xs, p):
    """(e, lo, hi) → rows lo:hi of the two-level grouped function."""
    w8 = two_level_w8(p)
    chan = p.chan_scale.to(torch.float32)

    def one(e, lo, hi):
        acc = xq[lo:hi].to(torch.float64) @ w8[e].to(torch.float64)
        return (acc.to(torch.float32) * chan[e]) \
            * xs[lo:hi].to(torch.float32)
    return one


def _w4a16_rows(x, p):
    """(e, lo, hi) → rows lo:hi of the w4a16 grouped function."""
    w = w4a16_weight(p)                                  # [E, K, N] bf16
    return lambda e, lo, hi: x[lo:hi].to(torch.float64) @ w[e].to(
        torch.float64)


def grouped_plain(xq: torch.Tensor, xs: torch.Tensor, p: QuantLinearParams,
                  group_sizes: torch.Tensor,
                  out_dtype: torch.dtype) -> torch.Tensor:
    """Plain version of the two-level grouped kernel: rows [A, K] sorted
    by expert, `group_sizes[e]` rows each → [A, N]; rows past the last
    group are 0 (the JAX kernel's masked rows)."""
    return _per_group(xq, group_sizes, p.out_features, out_dtype,
                      _two_level_rows(xq, xs, p))


def grouped_w4a16_plain(x: torch.Tensor, p: QuantLinearParams,
                        group_sizes: torch.Tensor) -> torch.Tensor:
    """Plain version of the w4a16 grouped kernel: rows [A, K] sorted by
    expert @ each expert's bf16 weight, float64 sums, → [A, N] x.dtype."""
    return _per_group(x, group_sizes, p.out_features, x.dtype,
                      _w4a16_rows(x, p))


def _on_map_plain(x: torch.Tensor, tile_map, n: int, out_dtype: torch.dtype,
                  fn) -> torch.Tensor:
    """[A, N] as a grouped kernel fills it from a tile map: each valid
    logical tile writes fn(e, lo, hi) for the rows of its expert e inside
    its m-tile; rows no tile writes are 0. Reads the map on the host."""
    gid, mtid, offsets, valid = (t.tolist() for t in tile_map)
    bm = grouped_bm(x.shape[0])
    out = torch.zeros((x.shape[0], n), dtype=out_dtype, device=x.device)
    for e, mt, v in zip(gid, mtid, valid):
        lo, hi = max(offsets[e], mt * bm), min(offsets[e + 1], mt * bm + bm)
        if v and lo < hi:
            out[lo:hi] = fn(e, lo, hi).to(out_dtype)
    return out


def grouped_ref(x: torch.Tensor, p: QuantLinearParams,
                group_sizes: torch.Tensor) -> torch.Tensor:
    """The JAX package's fallback for stacks its kernels cannot tile:
    each expert dequantized to x.dtype, f32 sums (ragged_dot)."""
    w = dequantize(p, x.dtype)
    return _per_group(x, group_sizes, p.out_features, x.dtype,
                      lambda e, lo, hi: x[lo:hi].to(torch.float32)
                      @ w[e].to(torch.float32))


# ---------------------------------------------------------------------------
# grouped kernel: row offsets, tile map
# ---------------------------------------------------------------------------

def group_offsets(group_sizes: torch.Tensor) -> torch.Tensor:
    """int32 [E + 1]: the groups' row bounds (0, then the cumulative sum
    of group_sizes), on group_sizes' device with no host sync."""
    return torch.nn.functional.pad(
        torch.cumsum(group_sizes, 0, dtype=torch.int32), (1, 0))


def group_tile_map(group_sizes: torch.Tensor, bm: int,
                   num_logical: int) -> TileMap:
    """(gid, mtid, offsets, valid), int32, on group_sizes' device with no
    host sync: logical tile i of `num_logical` covers the rows of expert
    gid[i] inside m-tile mtid[i]; offsets [E+1] are the groups' row
    bounds; tiles at and past the active count repeat the last active
    pair with valid 0. Port of `_make_group_metadata`, same values."""
    dev = group_sizes.device
    gs = group_sizes.to(torch.int64)
    e = gs.shape[0]
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(gs, 0)])
    first_tile = offsets[:-1] // bm
    last_tile = (offsets[1:] + bm - 1) // bm                   # exclusive
    tiles_per = torch.where(gs > 0, last_tile - first_tile,
                            torch.zeros_like(gs))
    seq_start = torch.cumsum(tiles_per, 0) - tiles_per
    num_active = tiles_per.sum()
    pos = torch.arange(num_logical, device=dev)
    # group id at pos = largest g with seq_start[g] <= pos; starts at
    # num_logical land in a spare bucket (the JAX scatter's mode="drop").
    bumps = torch.zeros(num_logical + 1, dtype=torch.int64, device=dev)
    bumps.index_add_(0, seq_start.clamp_max(num_logical),
                     torch.ones_like(seq_start))
    gid = (torch.cumsum(bumps[:num_logical], 0) - 1).clamp(0, e - 1)
    mtid = first_tile[gid] + (pos - seq_start[gid])
    last_idx = (num_active - 1).clamp_min(0)
    valid = pos < num_active
    gid = torch.where(valid, gid, gid[last_idx])
    mtid = torch.where(valid, mtid, mtid[last_idx])
    return (gid.to(torch.int32), mtid.to(torch.int32),
            offsets.to(torch.int32), valid.to(torch.int32))


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _require_two_level(p: QuantLinearParams) -> None:
    if p.scales2 is None:
        raise NotImplementedError(
            "the all-experts GEMM takes two-level w4a8 expert stacks "
            "(requantize_two_level first), as the JAX package's")


def _check_stack(p: QuantLinearParams, k: int, dev: torch.device,
                 n_align: int, align: int = 4) -> Tuple[int, int]:
    e, n = p.qweight.shape[0], p.out_features
    if k != p.in_features or k % (2 * GROUP) or p.group_size != GROUP:
        raise ValueError(f"unsupported K={k} / group {p.group_size}: the "
                         f"kernel needs group 128 and K % 256 == 0")
    if n % n_align:
        raise ValueError(f"N={n} must be a multiple of {n_align}")
    for name, t, dt, shape in (
            ("qweight", p.qweight, torch.uint8, (e, k // 2, n)),
            ("scales2", p.scales2, torch.int8, (e, k // GROUP, n)),
            ("zeros", p.zeros, torch.int8, (e, k // GROUP, n)),
            ("chan_scale", p.chan_scale, torch.float32, (e, 1, n))):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dt} {shape}")
        if t.device != dev or t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned on {dev}")
    return e, n


def _check_rows(xq: torch.Tensor, xs: torch.Tensor, rows: int,
                out_dtype: torch.dtype) -> None:
    if xq.dtype != torch.int8 or not xq.is_contiguous() \
            or xq.data_ptr() % 16:
        raise ValueError("xq must be a contiguous, 16-byte aligned int8 "
                         "tensor")
    if xs.dtype != torch.float32 or xs.numel() != rows \
            or not xs.is_contiguous() or xs.device != xq.device:
        raise ValueError("xs must be a contiguous f32 tensor with one "
                         "scale per row of xq, on its device")
    if out_dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported output dtype {out_dtype}")


def quant_bmm_all_experts(xq3: torch.Tensor, xs3: torch.Tensor,
                          p: QuantLinearParams,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """out[e] = xq3[e|0] @ W_e for every expert: xq3 int8 [1|E, t, K]
    (1 = one row block shared by every expert, as gate/up; E = each
    expert its own rows, as down), xs3 f32 [1|E, t, 1] → [E, t, N]. On
    the card, one block per (column tile, expert) on the decode GEMMs'
    streamed main loop (csrc/moe_gemm.cu), tiles, threads and ring
    depth by its launcher's rule (`moe_bmm_plan`)."""
    _require_two_level(p)
    if not xq3.is_cuda:
        return bmm_plain(xq3, xs3, p, out_dtype)
    bx, t, k = xq3.shape
    # The streamed main loop copies the stacks in 16-byte pieces.
    e, n = _check_stack(p, k, xq3.device, 64, align=16)
    if bx not in (1, e) or not 1 <= t <= BMM_MAX_T:
        raise ValueError(f"xq3 must be [1 or {e}, t <= {BMM_MAX_T}, K], "
                         f"got {tuple(xq3.shape)}")
    _check_rows(xq3, xs3, bx * t, out_dtype)
    out = torch.empty((e, t, n), dtype=out_dtype, device=xq3.device)
    stream = torch.cuda.current_stream(xq3.device).cuda_stream
    err = library("moe_gemm").ferrum_moe_bmm(
        xq3.data_ptr(), xs3.data_ptr(), p.qweight.data_ptr(),
        p.scales2.data_ptr(), p.zeros.data_ptr(), p.chan_scale.data_ptr(),
        out.data_ptr(), e, t, n, k, int(bx == 1),
        int(out_dtype == torch.bfloat16), stream)
    check(err, "moe_bmm")
    MOE_BMM.launches += 1
    return out


def moe_bmm_plan(t: int, n: int, k: int, e: int) -> dict:
    """The launch `quant_bmm_all_experts` makes for t rows over e experts
    of [K, N] on the current card, as its launcher plans it: tile rows
    and columns, threads a block, ring stages, resident blocks per SM."""
    out = (ctypes.c_int * 5)()
    check(library("moe_gemm").ferrum_moe_bmm_plan(t, n, k, e, out),
          "moe_bmm_plan")
    return dict(zip(("bm", "bn", "threads", "stages", "blocks_per_sm"), out))


def grouped_bm(a: int) -> int:
    """m-tile rows of the grouped kernels' tile maps for `a` rows: 16
    for decode-sized a <= 256 (the w4a16 kernel's tiles; the two-level
    kernel reads such a map's offsets alone), else 128 (prefill)."""
    return 16 if a <= 256 else 128


def grouped_map(group_sizes: torch.Tensor, a: int) -> TileMap:
    """The grouped kernels' tile map for `a` expert-sorted rows in groups
    of `group_sizes`: ceil(a / bm) + E - 1 logical tiles."""
    bm = grouped_bm(a)
    return group_tile_map(group_sizes, bm,
                          -(-a // bm) + group_sizes.shape[0] - 1)


def _check_sizes(group_sizes: torch.Tensor, e: int,
                 dev: torch.device) -> None:
    if group_sizes.shape != (e,) or group_sizes.device != dev:
        raise ValueError(f"group_sizes must be [{e}] on {dev}")


def _check_map(tile_map, a: int, e: int, dev: torch.device) -> int:
    """Raise unless tile_map is grouped_map's for `a` rows over `e`
    experts on `dev`; returns its logical tile count."""
    n_logical = -(-a // grouped_bm(a)) + e - 1
    for name, t, size in zip(("gid", "mtid", "offsets", "valid"), tile_map,
                             (n_logical, n_logical, e + 1, n_logical)):
        if t.dtype != torch.int32 or t.shape != (size,) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"tile map {name} must be contiguous int32 "
                             f"[{size}] on {dev}")
    return n_logical


def grouped_w4a8tl(xq: torch.Tensor, xs: torch.Tensor, p: QuantLinearParams,
                   group_sizes: torch.Tensor,
                   out_dtype: torch.dtype) -> torch.Tensor:
    """Grouped two-level GEMM over expert-sorted rows xq int8 [A, K], xs
    f32 [A, 1] → [A, N]: at decode sizes (A <= 256) the groups' row
    offsets, else the tile map, then the kernel. The kernel writes the
    rows of the groups (the first sum(group_sizes) rows) and no other."""
    if not xq.is_cuda:
        return grouped_plain(xq, xs, p, group_sizes, out_dtype)
    _check_sizes(group_sizes, p.qweight.shape[0], xq.device)
    a = xq.shape[0]
    if grouped_bm(a) == 16:
        return _grouped_decode(xq, xs, p, group_offsets(group_sizes),
                               out_dtype)
    return grouped_w4a8tl_on_map(xq, xs, p, grouped_map(group_sizes, a),
                                 out_dtype)


def grouped_w4a8tl_on_map(xq: torch.Tensor, xs: torch.Tensor,
                          p: QuantLinearParams, tile_map: TileMap,
                          out_dtype: torch.dtype) -> torch.Tensor:
    """The two-level grouped kernel on a tile map built before
    (`grouped_map` of the rows' group sizes) → [A, N]; at decode sizes
    (A <= 256) the kernel reads the map's offsets alone."""
    if not xq.is_cuda:
        return _on_map_plain(xq, tile_map, p.out_features, out_dtype,
                             _two_level_rows(xq, xs, p))
    a, k = xq.shape
    n_logical = _check_map(tile_map, a, p.qweight.shape[0], xq.device)
    if grouped_bm(a) == 16:
        return _grouped_decode(xq, xs, p, tile_map[2], out_dtype)
    # The prefill main loop copies the stacks in 16-byte pieces.
    e, n = _check_stack(p, k, xq.device, 128, align=16)
    _check_rows(xq, xs, a, out_dtype)
    gid, mtid, offsets, valid = tile_map
    out = torch.empty((a, n), dtype=out_dtype, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = library("moe_gemm").ferrum_moe_grouped(
        xq.data_ptr(), xs.data_ptr(), p.qweight.data_ptr(),
        p.scales2.data_ptr(), p.zeros.data_ptr(), p.chan_scale.data_ptr(),
        gid.data_ptr(), mtid.data_ptr(), offsets.data_ptr(),
        valid.data_ptr(), out.data_ptr(), n_logical, n, k,
        int(out_dtype == torch.bfloat16), stream)
    check(err, "moe_grouped")
    MOE_GROUPED.launches += 1
    return out


def _grouped_decode(xq: torch.Tensor, xs: torch.Tensor, p: QuantLinearParams,
                    offsets: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The two-level grouped kernel at decode sizes on the CUDA rows xq
    [A <= 256, K]: one block per (column tile, expert) on the streamed
    main loop (csrc/moe_gemm.cu), its rows [offsets[e], offsets[e + 1])
    in chunks, tiles, threads and ring depth by its launcher's rule
    (`grouped_plan`)."""
    a, k = xq.shape
    # The streamed main loop copies the stacks in 16-byte pieces.
    e, n = _check_stack(p, k, xq.device, 64, align=16)
    _check_rows(xq, xs, a, out_dtype)
    if offsets.dtype != torch.int32 or offsets.shape != (e + 1,) \
            or not offsets.is_contiguous() or offsets.device != xq.device:
        raise ValueError(f"offsets must be contiguous int32 [{e + 1}] on "
                         f"{xq.device}")
    out = torch.empty((a, n), dtype=out_dtype, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = library("moe_gemm").ferrum_moe_grouped_decode(
        xq.data_ptr(), xs.data_ptr(), p.qweight.data_ptr(),
        p.scales2.data_ptr(), p.zeros.data_ptr(), p.chan_scale.data_ptr(),
        offsets.data_ptr(), out.data_ptr(), a, e, n, k,
        int(out_dtype == torch.bfloat16), stream)
    check(err, "moe_grouped")
    MOE_GROUPED.launches += 1
    MOE_GROUPED.decode_launches += 1
    return out


def grouped_plan(a: int, n: int, k: int, e: int) -> dict:
    """The launch the two-level grouped kernel makes at decode-sized `a`
    <= 256 rows over e experts of [K, N] on the current card, as its
    launcher plans it: chunk rows and tile columns, threads a block, ring
    stages, resident blocks per SM."""
    if grouped_bm(a) != 16:
        raise ValueError(f"{a} rows take the 128-row tiles, planned by no "
                         "launcher rule")
    out = (ctypes.c_int * 5)()
    check(library("moe_gemm").ferrum_moe_grouped_plan(a, n, k, e, out),
          "moe_grouped_plan")
    return dict(zip(("bm", "bn", "threads", "stages", "blocks_per_sm"), out))


def grouped_w4a16(x: torch.Tensor, p: QuantLinearParams,
                  group_sizes: torch.Tensor) -> torch.Tensor:
    """Grouped w4a16 GEMM over expert-sorted bf16 rows x [A, K] → bf16
    [A, N]: the tile map, then the kernel on it. The kernel writes the
    rows of the groups (the first sum(group_sizes) rows) and no other."""
    if not x.is_cuda:
        return grouped_w4a16_plain(x, p, group_sizes)
    _check_sizes(group_sizes, p.qweight.shape[0], x.device)
    return grouped_w4a16_on_map(x, p, grouped_map(group_sizes, x.shape[0]))


def grouped_w4a16_on_map(x: torch.Tensor, p: QuantLinearParams,
                         tile_map: TileMap) -> torch.Tensor:
    """The w4a16 grouped kernel on a tile map built before (`grouped_map`
    of the rows' group sizes) → bf16 [A, N]."""
    if not x.is_cuda:
        return _on_map_plain(x, tile_map, p.out_features, x.dtype,
                             _w4a16_rows(x, p))
    a, k = x.shape
    if x.dtype != torch.bfloat16 or not x.is_contiguous() \
            or x.data_ptr() % 16:
        raise ValueError("grouped_w4a16 takes contiguous, 16-byte aligned "
                         f"bf16 rows, got {x.dtype}")
    bm = grouped_bm(a)
    e = p.qweight.shape[0]
    # Both main loops copy x and the stacks in 16-byte pieces.
    n = check_float_scale(p, k, x.device, 64 if bm == 16 else 128, (e,),
                          align=16)
    n_logical = _check_map(tile_map, a, e, x.device)
    gid, mtid, offsets, valid = tile_map
    out = torch.empty((a, n), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library("w4a16_gemm").ferrum_moe_grouped_w4a16(
        x.data_ptr(), p.qweight.data_ptr(), p.scales.data_ptr(),
        p.zeros.data_ptr(), gid.data_ptr(), mtid.data_ptr(),
        offsets.data_ptr(), valid.data_ptr(), out.data_ptr(), n_logical,
        bm, n, k, int(p.scales.dtype == torch.float32), stream)
    check(err, "moe_grouped_w4a16")
    MOE_GROUPED_W4A16.launches += 1
    return out


def grouped_w4a16_plan(a: int, n: int, k: int, e: int) -> dict:
    """The launch the w4a16 grouped kernel makes at decode-sized `a` <=
    256 rows over e experts of [K, N] (16-row tiles on the streamed main
    loop in bf16, csrc/w4a16_stream.cuh) on the current card, as its
    launcher plans it: the keys of `quant_matmul.w4a16_decode_plan`, one
    split of the full K."""
    if grouped_bm(a) != 16:
        raise ValueError(f"{a} rows take the 128-row tiles, planned by no "
                         "launcher rule")
    out = (ctypes.c_int * 7)()
    check(library("w4a16_gemm").ferrum_moe_grouped_w4a16_plan(
        -(-a // 16) + e - 1, n, k, out), "moe_grouped_w4a16_plan")
    return dict(zip(("bm", "bn", "threads", "stages", "splits",
                     "steps_per_split", "blocks_per_sm"), out))


def grouped_tiles(p: QuantLinearParams) -> bool:
    """Whether the JAX package's grouped kernels tile this expert stack
    (the moe dispatch pads the rows to their m-tile): group 128, K/2 a
    multiple of 128, and N split by their bn rule (N itself up to 2048,
    else halved while N % bn, down to 128). False is where their
    wrappers return None."""
    n = p.out_features
    bn = n
    while bn > 2048 or (bn > 128 and n % bn):
        bn //= 2
    return (p.group_size == GROUP and p.in_features % (2 * GROUP) == 0
            and n % bn == 0)


def quant_grouped_matmul(x: torch.Tensor, p: QuantLinearParams,
                         sorted_ids: torch.Tensor,
                         group_sizes: torch.Tensor,
                         act_quant=None) -> torch.Tensor:
    """Grouped (expert-stacked) int4 matmul over rows x [A, K] sorted by
    expert → [A, N] in x.dtype: two-level stacks with w4a8 on take the
    two-level kernel, every other stack the w4a16 one (the JAX package's
    dispatch, quant_matmul.py:1457-1467). `act_quant` passes a
    precomputed (xq, xs) so gate and up share one activation
    quantization. `sorted_ids` is the JAX signature's; the group sizes
    alone place the rows."""
    del sorted_ids
    if not grouped_tiles(p):
        return grouped_ref(x, p, group_sizes)
    if w4a8_enabled() and p.scales2 is not None:
        xq, xs = act_quant if act_quant is not None \
            else quantize_activation_rows(x)
        return grouped_w4a8tl(xq, xs, p, group_sizes, x.dtype)
    return grouped_w4a16(x, p, group_sizes)
