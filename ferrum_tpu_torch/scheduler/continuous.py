"""Continuous-batching scheduler: token budget, chunked prefill, admission.

Port of `ferrum_tpu/scheduler/continuous.py` for the linear KV layout
and the arrival-order policy. One `next_batch()` per engine iteration:
  1. every decoding sequence (one budget token each), with its slot
     region grown to cover the next decode window;
  2. the next chunk of every prefilling sequence;
  3. admission of waiting requests while slots and budget remain.
Chunks are full-size or the whole remainder (the JAX package's rule,
kept so both engines schedule the same chunks). Linear slots reserve
their capacity, so KV-pressure preemption never happens here.

Host-only code; it runs once per iteration.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List

from ..config import EngineConfig
from ..kv.block_pool import SlotBlocks
from ..types import CapacityError
from .sequence import Phase, Sequence


@dataclass
class PrefillChunk:
    seq: Sequence
    start: int            # first prompt position in this chunk
    tokens: List[int]
    # True when this chunk completes the prompt → its last hidden state
    # samples the first output token.
    is_last: bool = False


@dataclass
class ScheduledBatch:
    prefill_chunks: List[PrefillChunk] = field(default_factory=list)
    decode_seqs: List[Sequence] = field(default_factory=list)
    admitted: List[Sequence] = field(default_factory=list)

    @property
    def is_empty(self) -> bool:
        return not self.prefill_chunks and not self.decode_seqs


class ContinuousBatchScheduler:
    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.decode_lookahead = max(1, cfg.decode_multi_step)
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []     # admission order
        self._free_slots: List[int] = list(range(cfg.num_slots - 1, -1, -1))

    def submit(self, seq: Sequence) -> None:
        if seq.num_prompt_tokens + seq.request.sampling.max_tokens \
                > self.cfg.max_model_len:
            raise CapacityError(
                f"prompt ({seq.num_prompt_tokens}) + max_tokens "
                f"({seq.request.sampling.max_tokens}) exceeds max_model_len "
                f"{self.cfg.max_model_len}")
        seq.phase = Phase.WAITING
        self.waiting.append(seq)

    def finish(self, seq: Sequence) -> None:
        """Release a finished sequence's slot and region."""
        if seq in self.running:
            self.running.remove(seq)
        if seq in self.waiting:
            self.waiting.remove(seq)
        if seq.slot is not None:
            self._free_slots.append(seq.slot)
            seq.slot = None
        if seq.blocks is not None:
            seq.blocks.release()
            seq.blocks = None
        seq.phase = Phase.FINISHED

    def _grow(self, seq: Sequence, tokens: int) -> None:
        seq.blocks.ensure_capacity(min(tokens, self.cfg.max_model_len))

    def next_batch(self) -> ScheduledBatch:
        cfg = self.cfg
        batch = ScheduledBatch()
        budget = cfg.max_num_batched_tokens

        # --- 1. decode set ---
        for seq in self.running:
            if seq.phase != Phase.DECODING or budget <= 0:
                continue
            self._grow(seq, seq.total_tokens + self.decode_lookahead)
            batch.decode_seqs.append(seq)
            budget -= 1

        # --- 2. ongoing prefills (chunked) ---
        chunk_cap = cfg.prefill_chunk_size
        for seq in self.running:
            if seq.phase != Phase.PREFILLING or budget <= 0:
                continue
            t = min(seq.prefill_remaining, chunk_cap, budget)
            if t < seq.prefill_remaining and t < chunk_cap:
                continue          # only full-cap chunks or the remainder
            batch.prefill_chunks.append(self._chunk(seq, t))
            budget -= t

        # --- 3. admit waiting requests while slots + budget remain ---
        while self.waiting and self._free_slots and budget > 0:
            seq = self.waiting[0]
            first = min(seq.prefill_remaining, chunk_cap, budget)
            if first < seq.prefill_remaining and first < chunk_cap:
                break             # no odd-sized chunks: wait for budget
            self.waiting.popleft()
            seq.slot = self._free_slots.pop()
            seq.blocks = SlotBlocks(seq.slot, cfg.max_blocks_per_seq,
                                    cfg.kv_block_size)
            seq.phase = Phase.PREFILLING
            self.running.append(seq)
            batch.admitted.append(seq)
            batch.prefill_chunks.append(self._chunk(seq, first))
            budget -= first
        return batch

    def _chunk(self, seq: Sequence, t: int) -> PrefillChunk:
        self._grow(seq, seq.prefilled + t)
        return PrefillChunk(
            seq=seq, start=seq.prefilled,
            tokens=seq.prompt_tokens[seq.prefilled:seq.prefilled + t],
            is_last=seq.prefilled + t == seq.num_prompt_tokens)

    def note_prefill_done(self, chunk: PrefillChunk) -> None:
        """Engine callback after a chunk's device step ran."""
        seq = chunk.seq
        seq.prefilled += len(chunk.tokens)
        if seq.is_prefill_done:
            seq.phase = Phase.DECODING
