"""Per-sequence KV block tables of the linear layout (host bookkeeping).

Port of `ferrum_tpu/kv/block_pool.py::SlotBlocks`, trimmed to the
linear ("slot-contiguous") layout: slot s owns exactly the blocks
[s * max_pages, (s + 1) * max_pages), so there is no free list, no
sharing and no pool pressure. The paged pool (free list, refcounts,
copy-on-write prefix sharing) comes with the paged-layout slice.
"""

from __future__ import annotations

from typing import List

from ..types import CapacityError


class SlotBlocks:
    def __init__(self, slot: int, max_pages: int, page_size: int):
        self.slot = slot
        self.max_pages = max_pages
        self.page_size = page_size
        self.blocks: List[int] = []

    def ensure_capacity(self, num_tokens: int) -> List[int]:
        """Reserve the slot-region blocks `num_tokens` positions need;
        returns the new block ids."""
        need_total = -(-num_tokens // self.page_size)
        if need_total > self.max_pages:
            raise CapacityError(
                f"slot {self.slot}: {num_tokens} tokens exceed the reserved "
                f"region ({self.max_pages} pages)")
        base = self.slot * self.max_pages
        new = [base + i for i in range(len(self.blocks), need_total)]
        self.blocks.extend(new)
        return new

    def flat_slot(self, position: int) -> int:
        """Position → flat device index (block * page + offset)."""
        page = self.page_size
        return self.blocks[position // page] * page + position % page

    def release(self) -> None:
        self.blocks.clear()
