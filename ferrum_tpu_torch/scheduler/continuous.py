"""Continuous-batching scheduler: token budget, chunked prefill, admission.

Port of `ferrum_tpu/scheduler/continuous.py` for the linear KV layout
and the arrival-order policy. One `next_batch(pinned, inflight_steps)`
per engine iteration:
  1. every decoding sequence (one budget token each), with its slot
     region grown to cover the windows still in flight and the next;
  2. the next chunk of every prefilling sequence;
  3. admission of waiting requests while slots and budget remain.
Chunks are full-size or the whole remainder (the JAX package's rule,
kept so both engines schedule the same chunks). Linear slots reserve
their capacity, so KV-pressure preemption never happens here. The
JAX package's minimum-progress path (one step past the in-flight
windows' exact write horizon, `inflight_steps`; `deferred_decodes`,
`decode_steps`) is ported with the loop that reads it; the linear
layout never takes it (a region holds max_model_len), the paged
layout's slice will.

Host-only code; it runs once per iteration.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

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
    # Decodes whose region could not cover even one step past the
    # windows in flight: the engine breaks the pipeline chain.
    deferred_decodes: List[Sequence] = field(default_factory=list)
    # Set to 1 when some region covers only one more step: the whole
    # batch's window is clamped to it (minimum progress). None = full.
    decode_steps: Optional[int] = None

    @property
    def is_empty(self) -> bool:
        return not self.prefill_chunks and not self.decode_seqs


class ContinuousBatchScheduler:
    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        # Positions a decoding sequence may write past its host-visible
        # length: the windows in flight (up to pipeline_depth of them)
        # plus the one being scheduled. The JAX package counts
        # decode_multi_step steps a window; the port counts the longest
        # window any bucket runs (decode_t_spec), so a bucket with longer
        # windows never has its last positions' K/V dropped.
        steps = max(cfg.t_for_bucket(b) for b in cfg.decode_buckets)
        depth = cfg.pipeline_depth if cfg.pipeline_decode else 0
        self.decode_lookahead = steps * (1 + depth)
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

    def _grow(self, seq: Sequence, tokens: int) -> bool:
        """Reserve the region `tokens` positions need (at most
        max_model_len); False if the region cannot hold them."""
        try:
            seq.blocks.ensure_capacity(min(tokens, self.cfg.max_model_len))
        except CapacityError:
            return False
        return True

    def next_batch(self, pinned: frozenset = frozenset(),
                   inflight_steps: int = -1) -> ScheduledBatch:
        """`pinned`: request ids riding windows in flight;
        `inflight_steps`: those windows' steps (their exact write
        horizon; -1 = unknown, take depth * decode_multi_step)."""
        cfg = self.cfg
        batch = ScheduledBatch()
        budget = cfg.max_num_batched_tokens

        # --- 1. decode set ---
        for seq in self.running:
            if seq.phase != Phase.DECODING:
                continue
            if budget <= 0:
                break
            if not self._grow(seq, seq.total_tokens + self.decode_lookahead):
                if seq.request.request_id not in pinned:
                    inflight = 0
                elif inflight_steps >= 0:
                    inflight = inflight_steps
                else:
                    inflight = cfg.decode_multi_step * cfg.pipeline_depth
                if not self._grow(seq, seq.total_tokens + inflight + 1):
                    batch.deferred_decodes.append(seq)
                    continue
                batch.decode_steps = 1
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
