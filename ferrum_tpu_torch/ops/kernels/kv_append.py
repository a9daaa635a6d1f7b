"""KV-cache appends into the flat [B, page, F] cache, IN PLACE.

Counterpart of `ferrum_tpu/ops/pallas/kv_append.py`. The JAX functions
return a new cache (aliased in place by XLA); these update `cache` in
place and return it, so call sites read the same either way.

  append_rows(cache, rows, block_ids, offsets)  cache[blk, off] = rows[i]
  append_rows_pairs(pairs, block_ids, offsets)  the same for up to four
                                                (cache, rows) pairs, as K
                                                and V, in one launch
  append_pages(cache, pages, block_ids)         cache[blk] = pages[i]
  append_pages_pairs(pairs, block_ids)          the same for up to four
                                                (cache, pages) pairs, as K,
                                                V and int8 KV's two scale
                                                planes, in one launch

A row or page whose block id is >= B (the model's OOB_SENTINEL) is
dropped. (block, offset) pairs are unique within one call. On CUDA
tensors the wrappers launch the kernels of csrc/kv_append.cu; on CPU
tensors they run the plain indexed writes beside them.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from . import KV_APPEND_PAGES, KV_APPEND_ROWS
from .build import check, library


def append_rows_plain(cache: torch.Tensor, rows: torch.Tensor,
                      block_ids: torch.Tensor,
                      offsets: torch.Tensor) -> torch.Tensor:
    b, page, f = cache.shape
    flat = cache.view(b * page, f)
    blk = block_ids.to(torch.int64)
    idx = blk * page + offsets.to(torch.int64)
    keep = (blk >= 0) & (blk < b) & (idx >= 0) & (idx < b * page)
    flat[idx[keep]] = rows[keep].to(cache.dtype)
    return cache


def append_rows_pairs_plain(pairs: Sequence[Tuple[torch.Tensor,
                                                  torch.Tensor]],
                            block_ids: torch.Tensor,
                            offsets: torch.Tensor) -> tuple:
    return tuple(append_rows_plain(cache, rows, block_ids, offsets)
                 for cache, rows in pairs)


def append_pages_plain(cache: torch.Tensor, pages: torch.Tensor,
                       block_ids: torch.Tensor) -> torch.Tensor:
    b = cache.shape[0]
    blk = block_ids.to(torch.int64)
    keep = (blk >= 0) & (blk < b)
    cache[blk[keep]] = pages[keep].to(cache.dtype)
    return cache


def append_pages_pairs_plain(pairs: Sequence[Tuple[torch.Tensor,
                                                   torch.Tensor]],
                             block_ids: torch.Tensor) -> tuple:
    return tuple(append_pages_plain(cache, pages, block_ids)
                 for cache, pages in pairs)


def _check_ids(ids: torch.Tensor, n: int, dev, name: str) -> None:
    if ids.dtype != torch.int32 or ids.shape != (n,) \
            or not ids.is_contiguous() or ids.device != dev:
        raise ValueError(f"{name} must be a contiguous int32 [{n}] tensor "
                         f"on {dev}")


MAX_PAIRS = 4


def append_rows(cache: torch.Tensor, rows: torch.Tensor,
                block_ids: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """cache [B, page, F]; rows [N, F]; block_ids/offsets int32 [N]."""
    return append_rows_pairs([(cache, rows)], block_ids, offsets)[0]


def append_rows_pairs(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                      block_ids: torch.Tensor,
                      offsets: torch.Tensor) -> tuple:
    """append_rows for each (cache [B, page, F_i], rows [N, F_i]) of
    `pairs` (one to four; every cache of one B and page), all at
    block_ids/offsets int32 [N], in one launch on CUDA tensors. Returns
    the caches."""
    if not 1 <= len(pairs) <= MAX_PAIRS:
        raise ValueError(f"1 to {MAX_PAIRS} (cache, rows) pairs, got "
                         f"{len(pairs)}")
    first = pairs[0][0]
    if not first.is_cuda:
        return append_rows_pairs_plain(pairs, block_ids, offsets)
    b, page, _ = first.shape
    n = block_ids.shape[0]
    for cache, rows in pairs:
        f = cache.shape[-1]
        if cache.dim() != 3 or cache.shape[:2] != (b, page) \
                or not cache.is_contiguous() or cache.device != first.device:
            raise ValueError(f"caches must be contiguous [{b}, {page}, F] "
                             f"on {first.device}")
        if rows.dtype != cache.dtype or rows.shape != (n, f) \
                or not rows.is_contiguous() or rows.device != cache.device:
            raise ValueError(f"rows must be contiguous {cache.dtype} "
                             f"[{n}, {f}] on {cache.device}")
    _check_ids(block_ids, n, first.device, "block_ids")
    _check_ids(offsets, n, first.device, "offsets")
    k = len(pairs)
    stream = torch.cuda.current_stream(first.device).cuda_stream
    err = library("kv_append").ferrum_kv_append_rows(
        (ctypes.c_void_p * k)(*(c.data_ptr() for c, _ in pairs)),
        (ctypes.c_void_p * k)(*(r.data_ptr() for _, r in pairs)),
        (ctypes.c_longlong * k)(*(c.shape[-1] * c.element_size()
                                  for c, _ in pairs)),
        k, block_ids.data_ptr(), offsets.data_ptr(), n, b, page, stream)
    check(err, "kv_append_rows")
    KV_APPEND_ROWS.launches += 1
    return tuple(c for c, _ in pairs)


def append_pages(cache: torch.Tensor, pages: torch.Tensor,
                 block_ids: torch.Tensor) -> torch.Tensor:
    """cache [B, page, F]; pages [P, page, F]; block_ids int32 [P]."""
    return append_pages_pairs([(cache, pages)], block_ids)[0]


def append_pages_pairs(pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                       block_ids: torch.Tensor) -> tuple:
    """append_pages for each (cache [B, page, F_i], pages [P, page, F_i])
    of `pairs` (one to four; every cache of one B and page), all at
    block_ids int32 [P], in one launch on CUDA tensors. Returns the
    caches."""
    if not 1 <= len(pairs) <= MAX_PAIRS:
        raise ValueError(f"1 to {MAX_PAIRS} (cache, pages) pairs, got "
                         f"{len(pairs)}")
    first = pairs[0][0]
    if not first.is_cuda:
        return append_pages_pairs_plain(pairs, block_ids)
    b, page, _ = first.shape
    p = block_ids.shape[0]
    for cache, pages in pairs:
        f = cache.shape[-1]
        if cache.dim() != 3 or cache.shape[:2] != (b, page) \
                or not cache.is_contiguous() or cache.device != first.device:
            raise ValueError(f"caches must be contiguous [{b}, {page}, F] "
                             f"on {first.device}")
        if pages.dtype != cache.dtype or pages.shape != (p, page, f) \
                or not pages.is_contiguous() or pages.device != cache.device:
            raise ValueError(f"pages must be contiguous {cache.dtype} "
                             f"[{p}, {page}, {f}] on {cache.device}")
    _check_ids(block_ids, p, first.device, "block_ids")
    k = len(pairs)
    stream = torch.cuda.current_stream(first.device).cuda_stream
    err = library("kv_append").ferrum_kv_append_pages(
        (ctypes.c_void_p * k)(*(c.data_ptr() for c, _ in pairs)),
        (ctypes.c_void_p * k)(*(q.data_ptr() for _, q in pairs)),
        (ctypes.c_longlong * k)(*(page * c.shape[-1] * c.element_size()
                                  for c, _ in pairs)),
        k, block_ids.data_ptr(), p, b, stream)
    check(err, "kv_append_pages")
    KV_APPEND_PAGES.launches += 1
    return tuple(c for c, _ in pairs)
