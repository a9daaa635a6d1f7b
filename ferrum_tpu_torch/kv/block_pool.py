"""Physical KV block pool + per-sequence block tables (host bookkeeping).

Port of `ferrum_tpu/kv/block_pool.py`: the device holds one flat KV
pool ([L, num_blocks, page, F]); this module owns which physical blocks
belong to which sequence -- the free list, refcounts for shared prefix
blocks, and allocation stats. `SequenceBlocks` is the paged layout's
table (blocks anywhere in the pool, prefix blocks shared); `SlotBlocks`
the linear layout's, where slot s owns exactly the blocks
[s * max_pages, (s + 1) * max_pages) and prefix reuse is a copy.

Pure host state: it runs once per scheduler iteration.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

from ..types import CapacityError


@dataclass
class BlockPoolStats:
    allocated_total: int = 0
    freed_total: int = 0
    cow_shares: int = 0


class BlockPool:
    """Free list of physical block ids with refcounts (prefix sharing)."""

    def __init__(self, num_blocks: int, page_size: int):
        self.num_blocks = num_blocks
        self.page_size = page_size
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._refcount: Dict[int, int] = {}
        self.stats = BlockPoolStats()

    @property
    def num_free(self) -> int:
        return len(self._free)

    def allocate(self, n: int = 1) -> List[int]:
        if n > len(self._free):
            raise CapacityError(
                f"KV pool exhausted: need {n} blocks, {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refcount[b] = 1
        self.stats.allocated_total += n
        return out

    def share(self, block_id: int) -> int:
        """One more owner of a block (a shared prefix block)."""
        self._refcount[block_id] += 1
        self.stats.cow_shares += 1
        return block_id

    def free(self, block_id: int) -> None:
        rc = self._refcount.get(block_id)
        if rc is None:
            raise ValueError(f"double free of block {block_id}")
        if rc == 1:
            del self._refcount[block_id]
            self._free.append(block_id)
            self.stats.freed_total += 1
        else:
            self._refcount[block_id] = rc - 1

    def refcount(self, block_id: int) -> int:
        return self._refcount.get(block_id, 0)


class SequenceBlocks:
    """One sequence's logical → physical block table (paged layout)."""

    def __init__(self, pool: BlockPool):
        self.pool = pool
        self.blocks: List[int] = []
        self.num_tokens = 0

    def blocks_needed_for(self, num_tokens: int) -> int:
        need = -(-num_tokens // self.pool.page_size)
        return max(0, need - len(self.blocks))

    def ensure_capacity(self, num_tokens: int) -> List[int]:
        """Allocate blocks so `num_tokens` positions fit; returns new ids."""
        need = self.blocks_needed_for(num_tokens)
        if need == 0:
            return []
        new = self.pool.allocate(need)
        self.blocks.extend(new)
        return new

    def append_shared_prefix(self, block_ids: List[int], tokens: int) -> None:
        """Adopt already-filled blocks (a prefix-cache hit) at the front."""
        assert not self.blocks, "shared prefix must come first"
        for b in block_ids:
            self.pool.share(b)
        self.blocks.extend(block_ids)
        self.num_tokens = tokens

    def release(self) -> None:
        for b in self.blocks:
            self.pool.free(b)
        self.blocks.clear()
        self.num_tokens = 0

    def flat_slot(self, position: int) -> int:
        """Position → flat device index (block * page + offset)."""
        page = self.pool.page_size
        return self.blocks[position // page] * page + position % page


class SlotBlocks(SequenceBlocks):
    """The linear layout's table: slot s owns exactly blocks
    [s * max_pages, (s + 1) * max_pages), with no pool interaction and
    no sharing; the device slices each slot's region of the pool."""

    def __init__(self, pool: BlockPool, slot: int, max_pages: int):
        super().__init__(pool)
        self.slot = slot
        self.max_pages = max_pages
        self.is_linear = True

    def ensure_capacity(self, num_tokens: int) -> List[int]:
        need_total = -(-num_tokens // self.pool.page_size)
        if need_total > self.max_pages:
            raise CapacityError(
                f"slot {self.slot}: {num_tokens} tokens exceed the "
                f"reserved region ({self.max_pages} pages)")
        base = self.slot * self.max_pages
        new = [base + i for i in range(len(self.blocks), need_total)]
        self.blocks.extend(new)
        return new

    def append_shared_prefix(self, block_ids: List[int], tokens: int) -> None:
        raise CapacityError("linear kv_layout does not support block "
                            "sharing (prefix reuse is copy-based: "
                            "adopt_copied_prefix)")

    def adopt_copied_prefix(self, tokens: int) -> None:
        """Reserve the slot-region blocks a restored prefix will occupy
        (the engine copies store → slot at admission; see
        kv/linear_prefix.py)."""
        assert not self.blocks, "copied prefix must come first"
        self.ensure_capacity(tokens)
        self.num_tokens = tokens

    def release(self) -> None:
        self.blocks.clear()
        self.num_tokens = 0
