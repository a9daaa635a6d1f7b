"""Prefix cache of the linear (slot-contiguous) KV layout.

Port of `ferrum_tpu/kv/linear_prefix.py`. The linear layout gives each
slot an identity-mapped region, so blocks cannot be shared; reuse is by
COPIES through a device-side "prefix store" (runner.prefix_store) with
the pool's (layer, page, head) geometry:
  - at a sequence's finish its full prompt blocks are queued to be
    copied slot → store, and the engine flushes the queue as one copy
    each iteration before admission (`flush_pending`);
  - at admission with a prefix hit, the matched blocks are copied
    store → slot and the prefill starts after the reused prefix.
The copies are issued on the one stream the engine uses, ordered with
the windows and prefills that touch the same rows, so no host sync is
needed. Eviction is the PrefixCache policy family over the store's own
BlockPool; the cache is every store block's sole owner.
"""

from __future__ import annotations

from typing import List, Sequence

from .block_pool import BlockPool
from .prefix_cache import PrefixCache, _hash_chain


class LinearPrefixCache(PrefixCache):
    """Copy-based prefix cache over a dedicated store."""

    def __init__(self, runner, num_blocks: int, page_size: int,
                 enabled: bool = True, policy: str = "lru"):
        super().__init__(BlockPool(num_blocks, page_size),
                         enabled=enabled, policy=policy)
        self.runner = runner
        runner.ensure_prefix_store(num_blocks)
        # Queued slot → store copies (src, dst), flushed as one copy an
        # iteration, before any admission of that iteration can
        # overwrite a source region or restore a still-queued block.
        self._pending_save: List[tuple] = []

    def flush_pending(self) -> None:
        """Issue every queued slot → store copy as one copy."""
        if not self._pending_save:
            return
        # Last wins by destination: an evicted and reallocated store
        # block may be queued twice.
        ordered = {d: s for s, d in self._pending_save}
        self._pending_save.clear()
        self.runner.copy_prefix_blocks(
            list(ordered.values()), list(ordered.keys()), to_store=True)

    def insert(self, tokens: Sequence[int],
               block_ids: Sequence[int]) -> None:
        """Register a finished sequence's full prompt blocks: allocate
        store blocks for the hashes not cached yet and queue their
        slot → store copies."""
        if not self.enabled:
            return
        page = self.pool.page_size
        parent = 0
        src: List[int] = []
        dst: List[int] = []
        for i, start in enumerate(range(0, len(tokens) - page + 1, page)):
            h = _hash_chain(parent, tokens[start:start + page])
            parent = h
            if h in self._by_hash:
                self._touch(h)
                continue
            if self.pool.num_free < 1:
                self.evict(min_free_target=1)
                if self.pool.num_free < 1:
                    break               # store full of just-matched blocks
            b = self.pool.allocate(1)[0]
            self._by_hash[h] = b
            self._hash_of_block[b] = h
            src.append(block_ids[i])
            dst.append(b)
        self._pending_save.extend(zip(src, dst))
        self.stats.cached_blocks = len(self._by_hash)
