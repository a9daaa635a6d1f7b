"""KV-cache appends into the flat [B, page, F] cache, IN PLACE.

Counterpart of `ferrum_tpu/ops/pallas/kv_append.py`. The JAX functions
return a new cache (aliased in place by XLA); these update `cache` in
place and return it, so call sites read the same either way.

  append_rows(cache, rows, block_ids, offsets)  cache[blk, off] = rows[i]
  append_pages(cache, pages, block_ids)         cache[blk] = pages[i]

A row or page whose block id is >= B (the model's OOB_SENTINEL) is
dropped. (block, offset) pairs are unique within one call. On CUDA
tensors the wrappers launch the kernels of csrc/kv_append.cu; on CPU
tensors they run the plain indexed writes beside them.
"""

from __future__ import annotations

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


def append_pages_plain(cache: torch.Tensor, pages: torch.Tensor,
                       block_ids: torch.Tensor) -> torch.Tensor:
    b = cache.shape[0]
    blk = block_ids.to(torch.int64)
    keep = (blk >= 0) & (blk < b)
    cache[blk[keep]] = pages[keep].to(cache.dtype)
    return cache


def _check_ids(ids: torch.Tensor, n: int, dev, name: str) -> None:
    if ids.dtype != torch.int32 or ids.shape != (n,) \
            or not ids.is_contiguous() or ids.device != dev:
        raise ValueError(f"{name} must be a contiguous int32 [{n}] tensor "
                         f"on {dev}")


def append_rows(cache: torch.Tensor, rows: torch.Tensor,
                block_ids: torch.Tensor,
                offsets: torch.Tensor) -> torch.Tensor:
    """cache [B, page, F]; rows [N, F]; block_ids/offsets int32 [N]."""
    if not cache.is_cuda:
        return append_rows_plain(cache, rows, block_ids, offsets)
    b, page, f = cache.shape
    n = rows.shape[0]
    if not cache.is_contiguous():
        raise ValueError("cache must be contiguous")
    if rows.dtype != cache.dtype or rows.shape != (n, f) \
            or not rows.is_contiguous() or rows.device != cache.device:
        raise ValueError(f"rows must be contiguous {cache.dtype} [{n}, {f}] "
                         f"on {cache.device}")
    _check_ids(block_ids, n, cache.device, "block_ids")
    _check_ids(offsets, n, cache.device, "offsets")
    stream = torch.cuda.current_stream(cache.device).cuda_stream
    err = library("kv_append").ferrum_kv_append_rows(
        cache.data_ptr(), rows.data_ptr(), block_ids.data_ptr(),
        offsets.data_ptr(), n, b, page, f * cache.element_size(), stream)
    check(err, "kv_append_rows")
    KV_APPEND_ROWS.launches += 1
    return cache


def append_pages(cache: torch.Tensor, pages: torch.Tensor,
                 block_ids: torch.Tensor) -> torch.Tensor:
    """cache [B, page, F]; pages [P, page, F]; block_ids int32 [P]."""
    if not cache.is_cuda:
        return append_pages_plain(cache, pages, block_ids)
    b, page, f = cache.shape
    p = pages.shape[0]
    if not cache.is_contiguous():
        raise ValueError("cache must be contiguous")
    if pages.dtype != cache.dtype or pages.shape != (p, page, f) \
            or not pages.is_contiguous() or pages.device != cache.device:
        raise ValueError(f"pages must be contiguous {cache.dtype} "
                         f"[{p}, {page}, {f}] on {cache.device}")
    _check_ids(block_ids, p, cache.device, "block_ids")
    stream = torch.cuda.current_stream(cache.device).cuda_stream
    err = library("kv_append").ferrum_kv_append_pages(
        cache.data_ptr(), pages.data_ptr(), block_ids.data_ptr(), p, b,
        page * f * cache.element_size(), stream)
    check(err, "kv_append_pages")
    KV_APPEND_PAGES.launches += 1
    return cache
