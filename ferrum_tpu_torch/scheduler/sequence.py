"""Per-request sequence state (host side).

Port of `ferrum_tpu/scheduler/sequence.py`: tokens, phase, block table,
prefix reuse, recompute after a preemption, the text emitted so far
(stop strings), prompt scoring's rows and the guided processor and FSM.
"""

from __future__ import annotations

import enum
from typing import FrozenSet, List, Optional

from ..kv.block_pool import SequenceBlocks
from ..types import InferenceRequest


class Phase(enum.Enum):
    WAITING = "waiting"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    PREEMPTED = "preempted"
    FINISHED = "finished"


class Sequence:
    def __init__(self, request: InferenceRequest, prompt_tokens: List[int]):
        self.request = request
        self.prompt_tokens: List[int] = list(prompt_tokens)
        self.output_tokens: List[int] = []
        self.phase = Phase.WAITING
        self.slot: Optional[int] = None
        self.blocks: Optional[SequenceBlocks] = None
        # Tokens of the prefill target whose KV is written or adopted.
        self.prefilled = 0
        # True from a preemption of a sequence with output until its
        # recompute prefill ends: the KV of prompt AND outputs is rebuilt.
        self.recompute = False
        # Prefix reuse at admission; on the linear layout
        # pending_prefix_copy holds (store block ids, covered tokens)
        # until the engine issues the store → slot copy.
        self.prefix_reused_tokens = 0
        self.pending_prefix_copy = None
        self.preempt_count = 0
        self.detok_prefix_offset = 0
        self.detok_read_offset = 0
        self.emitted_text_len = 0
        self.eos_cache: Optional[FrozenSet[int]] = None
        # Prompt scoring (echo + logprobs): per-chunk rows keyed by the
        # chunk's start -- (target logprob, argmax id, argmax logprob).
        self.score_mode = bool(request.echo
                               and request.sampling.logprobs is not None)
        self.score_parts: dict = {}
        # Guided decoding: the host processor (sampling/guided.py), and
        # on the device-FSM path its TokenFsm (sampling/token_fsm.py)
        # and the FSM's first row in the runner's stacked tables. A
        # processor with no FSM is the host-masked path.
        self.guided_processor = None
        self.guided_fsm = None
        self.guided_fsm_offset: Optional[int] = None

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
    def prefill_target(self) -> List[int]:
        """Tokens whose KV the prefill must produce: the prompt, or after
        a recompute preemption prompt + outputs (decode resumes at
        total_tokens - 1, and the last chunk samples a new token)."""
        return self.all_tokens if self.recompute else self.prompt_tokens

    @property
    def prefill_remaining(self) -> int:
        return len(self.prefill_target) - self.prefilled

    @property
    def is_prefill_done(self) -> bool:
        return self.prefilled >= len(self.prefill_target)

    def next_position(self) -> int:
        """Absolute position of the next token to decode."""
        return self.total_tokens - 1

    def reset_for_recompute(self) -> None:
        """Preemption: the KV is dropped; prompt and generated tokens are
        prefilled again at re-admission."""
        self.prefilled = 0
        self.prefix_reused_tokens = 0
        self.pending_prefix_copy = None
        self.slot = None
        self.phase = Phase.PREEMPTED
        self.preempt_count += 1
        self.recompute = bool(self.output_tokens)
