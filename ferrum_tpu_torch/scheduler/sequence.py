"""Per-request sequence state (host side).

Port of `ferrum_tpu/scheduler/sequence.py`, trimmed to the served path:
the linear layout reserves each slot's capacity, so there is no
preemption and no recompute; prefix reuse, guided decoding and prompt
scoring come with later slices.
"""

from __future__ import annotations

import enum
from typing import FrozenSet, List, Optional

from ..kv.block_pool import SlotBlocks
from ..types import InferenceRequest


class Phase(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"


class Sequence:
    def __init__(self, request: InferenceRequest, prompt_tokens: List[int]):
        self.request = request
        self.prompt_tokens: List[int] = list(prompt_tokens)
        self.output_tokens: List[int] = []
        self.phase = Phase.WAITING
        self.slot: Optional[int] = None
        self.blocks: Optional[SlotBlocks] = None
        self.prefilled = 0            # prompt tokens whose KV is written
        self.detok_prefix_offset = 0
        self.detok_read_offset = 0
        self.eos_cache: Optional[FrozenSet[int]] = None

    @property
    def num_prompt_tokens(self) -> int:
        return len(self.prompt_tokens)

    @property
    def num_output_tokens(self) -> int:
        return len(self.output_tokens)

    @property
    def total_tokens(self) -> int:
        return self.num_prompt_tokens + self.num_output_tokens

    @property
    def all_tokens(self) -> List[int]:
        return self.prompt_tokens + self.output_tokens

    @property
    def prefill_remaining(self) -> int:
        return self.num_prompt_tokens - self.prefilled

    @property
    def is_prefill_done(self) -> bool:
        return self.prefilled >= self.num_prompt_tokens

    def next_position(self) -> int:
        """Absolute position of the next token to decode."""
        return self.total_tokens - 1
