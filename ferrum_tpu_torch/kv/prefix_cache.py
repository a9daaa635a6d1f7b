"""Block-hash-chain prefix cache over the paged pool.

Port of `ferrum_tpu/kv/prefix_cache.py`. Each FULL block of a prompt is
keyed by the hash chain hash(parent_hash, tokens_in_block) -- the same
blake2b chain as the JAX package, so both give one key to one prefix.
At admission the longest chain of cached full blocks is adopted by
sharing (refcounts), and the prefill starts after the reused prefix.

Eviction reclaims only blocks whose sole owner is the cache (refcount
1), in the order of the policy:
  lru   -- least recently matched first (default)
  fifo  -- oldest inserted first (matches ignored)
  clock -- second chance: a match sets a referenced bit that spares the
           block one sweep

With a host offload tier (kv/compression.py `HostOffloadTier`, the
engine's `prefix_offload_mb`), a reclaimed block is first read to the
host and kept there compressed; a later chain that reaches its hash
restores it into a newly allocated block, only while the pool has a
free block (no eviction cascade), as in the JAX cache.
"""

from __future__ import annotations

import collections
import hashlib
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from .block_pool import BlockPool


def _hash_chain(parent: int, tokens: Sequence[int]) -> int:
    h = hashlib.blake2b(digest_size=8)
    h.update(parent.to_bytes(8, "little", signed=False))
    for t in tokens:
        h.update(int(t).to_bytes(4, "little", signed=False))
    return int.from_bytes(h.digest(), "little")


@dataclass
class PrefixCacheStats:
    hits: int = 0
    misses: int = 0
    saved_prefill_tokens: int = 0
    cached_blocks: int = 0
    evictions: int = 0


class PrefixCache:
    """Cache of full prompt blocks keyed by token hash chain, with an
    eviction policy (lru | fifo | clock)."""

    def __init__(self, pool: BlockPool, enabled: bool = True,
                 policy: str = "lru", offload=None, block_io=None):
        if policy not in ("lru", "fifo", "clock"):
            raise ValueError(f"unknown eviction policy {policy!r}")
        self.pool = pool
        self.enabled = enabled
        self.policy = policy
        # The host tier and its device accessors (read_block(b) → arrays,
        # write_block(b, arrays): runner.read_kv_block / write_kv_block).
        self.offload = offload
        self._read_block, self._write_block = block_io or (None, None)
        # hash → physical block id (the cache holds one refcount on
        # each); order = insertion (fifo / clock) or recency (lru).
        self._by_hash: "collections.OrderedDict[int, int]" = \
            collections.OrderedDict()
        self._hash_of_block: Dict[int, int] = {}
        self._referenced: Dict[int, bool] = {}     # clock second chance
        self.stats = PrefixCacheStats()

    def _touch(self, h: int) -> None:
        if self.policy == "lru":
            self._by_hash.move_to_end(h)
        elif self.policy == "clock":
            self._referenced[h] = True

    def match_prefix(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached block chain of a prompt → (block_ids,
        covered_tokens). Never the whole prompt: at least one token is
        left to prefill, whose hidden state samples the first output."""
        if not self.enabled:
            return [], 0
        page = self.pool.page_size
        usable = len(tokens) - 1
        blocks: List[int] = []
        parent = 0
        covered = 0
        for start in range(0, usable - page + 1, page):
            h = _hash_chain(parent, tokens[start:start + page])
            b = self._by_hash.get(h)
            if b is None and self.offload is not None and h in self.offload:
                b = self._restore_from_offload(h)
            if b is None:
                break
            self._touch(h)
            blocks.append(b)
            covered += page
            parent = h
        if covered:
            self.stats.hits += 1
            self.stats.saved_prefill_tokens += covered
        else:
            self.stats.misses += 1
        return blocks, covered

    def insert(self, tokens: Sequence[int], block_ids: Sequence[int]) -> None:
        """Register a sequence's FULL prompt blocks after prefill; the
        cache takes one share of each new block, so it outlives the
        sequence (freed on eviction)."""
        if not self.enabled:
            return
        page = self.pool.page_size
        parent = 0
        for i, start in enumerate(range(0, len(tokens) - page + 1, page)):
            h = _hash_chain(parent, tokens[start:start + page])
            parent = h
            if h in self._by_hash:
                self._touch(h)
                continue
            b = block_ids[i]
            self.pool.share(b)
            self._by_hash[h] = b
            self._hash_of_block[b] = h
        self.stats.cached_blocks = len(self._by_hash)

    def evict(self, min_free_target: int) -> int:
        """Evict cached blocks until the pool has `min_free_target` free,
        in policy order; shared blocks (refcount > 1) stay."""
        freed = 0
        if not self._by_hash:
            return 0
        if self.policy == "clock":
            # Up to two sweeps: the first clears referenced bits, the
            # second reclaims.
            for _sweep in range(2):
                for h in list(self._by_hash.keys()):
                    if self.pool.num_free >= min_free_target:
                        break
                    if self._referenced.pop(h, False):
                        continue
                    freed += self._reclaim(h)
                if self.pool.num_free >= min_free_target:
                    break
        else:
            for h in list(self._by_hash.keys()):
                if self.pool.num_free >= min_free_target:
                    break
                freed += self._reclaim(h)
        self.stats.cached_blocks = len(self._by_hash)
        return freed

    def _reclaim(self, h: int) -> int:
        b = self._by_hash[h]
        if self.pool.refcount(b) != 1:
            return 0
        if self.offload is not None and self._read_block is not None \
                and h not in self.offload:
            # Spill to the host tier before the device block dies.
            self.offload.put(h, self._read_block(b))
        del self._by_hash[h]
        del self._hash_of_block[b]
        self._referenced.pop(h, None)
        self.pool.free(b)
        self.stats.evictions += 1
        return 1

    def _restore_from_offload(self, h: int):
        """An offloaded block back on the device, in a block allocated
        now (the cache holds its one refcount); None without a free
        block or without the entry."""
        if self._write_block is None or self.pool.num_free == 0:
            return None
        arrays = self.offload.get(h)
        if arrays is None:
            return None
        b = self.pool.allocate(1)[0]
        self._write_block(b, arrays)
        self._by_hash[h] = b
        self._hash_of_block[b] = h
        self.stats.cached_blocks = len(self._by_hash)
        return b

    def clear(self) -> None:
        for b in list(self._by_hash.values()):
            self.pool.free(b)
        self._by_hash.clear()
        self._hash_of_block.clear()
        self._referenced.clear()
        self.stats.cached_blocks = 0
