"""Continuous-batching scheduler: token budget, chunked prefill, admission,
prefix reuse and preemption.

Port of `ferrum_tpu/scheduler/continuous.py` with its three policies
(`EngineConfig.scheduler`): "continuous" admits in arrival order,
"priority" inserts a request ahead of every waiting one of lower
`priority` (then arrival order), and "fifo" never chunks a prompt that
fits one batch (its admission waits for the budget instead).
`enable_chunked_prefill=False` caps a chunk at the whole token budget
instead of `prefill_chunk_size`. With `scheduler_trace_path` set, each
`next_batch` appends one JSON line (`_trace`, the JAX package's keys).
One `next_batch(pinned, inflight_steps)` per engine iteration:
  1. every decoding sequence (one budget token each), its blocks grown
     to cover the windows (or speculative rounds) still in flight and
     the next; on the paged layout, KV pressure first evicts
     prefix-cache blocks, then
     preempts the most recently admitted sequence not riding a window
     in flight (recompute: its KV is dropped and prompt + outputs are
     prefilled again at re-admission; also, where prefilling sequences
     alone hold the pool and none can take a chunk, the newest of
     them, `_break_prefill_stall`); when no victim is free, one step
     past the in-flight windows' exact write horizon (`inflight_steps`,
     minimum progress: `decode_steps` = 1), else the decode is deferred
     (`deferred_decodes`) and the engine breaks the pipeline chain;
  2. the next chunk of every prefilling sequence;
  3. admission of waiting requests while slots and budget remain, with
     the longest cached prefix reused: copied into the slot's region on
     the linear layout (the engine issues the copy), shared blocks on
     the paged one.
Chunks are full-size or the whole remainder (the JAX package's rule,
kept so both engines schedule the same chunks). Linear slots reserve
their capacity, so they never meet KV pressure. Slots number
`num_slots` = max_num_seqs + slot_slack: the slack lanes admit a
replacement while a paged predecessor's release waits for the window
in flight (engine.py `_retire`).

Host-only code; it runs once per iteration.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

from ..config import EngineConfig
from ..kv.block_pool import BlockPool, SequenceBlocks, SlotBlocks
from ..kv.prefix_cache import PrefixCache
from ..utils import profile as _prof
from .sequence import Phase, Sequence
from ..types import CapacityError


@dataclass
class PrefillChunk:
    seq: Sequence
    start: int            # first prefill-target position in this chunk
    tokens: List[int]
    # True when this chunk completes the prefill target → its last
    # hidden state samples the next output token.
    is_last: bool = False


@dataclass
class ScheduledBatch:
    prefill_chunks: List[PrefillChunk] = field(default_factory=list)
    decode_seqs: List[Sequence] = field(default_factory=list)
    preempted: List[Sequence] = field(default_factory=list)
    admitted: List[Sequence] = field(default_factory=list)
    # Decodes KV pressure left out while every victim was pinned by a
    # window in flight: the engine breaks the pipeline chain.
    deferred_decodes: List[Sequence] = field(default_factory=list)
    # Set to 1 when some sequence's blocks cover only one more step: the
    # whole batch's window is clamped to it (minimum progress).
    decode_steps: Optional[int] = None

    @property
    def is_empty(self) -> bool:
        return not self.prefill_chunks and not self.decode_seqs


@dataclass
class SchedulerStats:
    iterations: int = 0
    submitted: int = 0
    finished: int = 0
    preemptions: int = 0
    tokens_prefilled_scheduled: int = 0
    tokens_decoded_scheduled: int = 0


class ContinuousBatchScheduler:
    def __init__(self, cfg: EngineConfig, pool: Optional[BlockPool] = None,
                 prefix_cache: Optional[PrefixCache] = None):
        self.cfg = cfg
        self.linear = cfg.kv_layout == "linear"
        self.pool = pool or BlockPool(
            cfg.num_slots * cfg.max_blocks_per_seq, cfg.kv_block_size)
        self.prefix_cache = prefix_cache
        self.policy = cfg.scheduler
        # Positions a decoding sequence may write past its host-visible
        # length: the windows in flight (up to pipeline_depth of them)
        # plus the one being scheduled. The JAX package counts
        # decode_multi_step steps a window; the port counts the longest
        # window the engine can dispatch (a bucket's decode_t_spec
        # length, or adaptive windows' doubled one), so a longer window
        # never has its last positions' K/V dropped (ROADMAP Queue 3).
        steps = max(cfg.t_for_bucket(b) for b in cfg.decode_buckets) \
            if cfg.spec_draft_model else max(cfg.window_lengths())
        depth = cfg.pipeline_depth if cfg.pipeline_decode else 0
        # Speculative rounds: a round writes K+1 positions, and the one
        # scheduled is chained on the one in flight, so a sequence may
        # write 2 (K+1) positions past its host-visible length (rounds
        # pipeline at depth 1 whatever pipeline_decode says). 2 (K+1)
        # alone would do; the port keeps the JAX scheduler's
        # max(steps, K+1) * (1 + depth) above it, so that the paged
        # pool hands out the JAX engine's blocks: the draft attends to
        # the stale rows in them (ROADMAP Queue 3), and its acceptance
        # counts equal the JAX engine's only on the same blocks.
        self.spec_steps = cfg.spec_num_tokens + 1 \
            if cfg.spec_draft_model else 0
        steps = max(steps, self.spec_steps)
        self.decode_lookahead = max(steps * (1 + depth),
                                    2 * self.spec_steps)
        self.waiting: Deque[Sequence] = deque()
        self.running: List[Sequence] = []     # admission order
        self._free_slots: List[int] = list(range(cfg.num_slots - 1, -1, -1))
        self.stats = SchedulerStats()
        self._trace_fh = open(cfg.scheduler_trace_path, "a") \
            if cfg.scheduler_trace_path else None

    @property
    def lanes_in_use(self) -> int:
        """Slots held: running sequences and deferred releases."""
        return self.cfg.num_slots - len(self._free_slots)

    def close(self) -> None:
        """Close the trace file (the engine's stop)."""
        if self._trace_fh is not None:
            self._trace_fh.close()
            self._trace_fh = None

    def submit(self, seq: Sequence) -> None:
        if seq.num_prompt_tokens + seq.request.sampling.max_tokens \
                > self.cfg.max_model_len:
            raise CapacityError(
                f"prompt ({seq.num_prompt_tokens}) + max_tokens "
                f"({seq.request.sampling.max_tokens}) exceeds max_model_len "
                f"{self.cfg.max_model_len}")
        seq.phase = Phase.WAITING
        if self.policy == "priority":
            # Ahead of the first waiting request of lower priority.
            idx = next((i for i, s in enumerate(self.waiting)
                        if seq.request.priority > s.request.priority),
                       len(self.waiting))
            self.waiting.insert(idx, seq)
        else:
            self.waiting.append(seq)
        self.stats.submitted += 1

    def finish(self, seq: Sequence) -> None:
        """Release a finished sequence's slot and blocks; its full prompt
        blocks go to the prefix cache once the prompt is prefilled."""
        if seq in self.running:
            self.running.remove(seq)
        if seq in self.waiting:
            self.waiting.remove(seq)
        if seq.slot is not None:
            self._free_slots.append(seq.slot)
            seq.slot = None
        if seq.blocks is not None:
            if self.prefix_cache is not None \
                    and seq.num_prompt_tokens >= self.pool.page_size \
                    and seq.prefilled >= seq.num_prompt_tokens:
                # An aborted sequence's later blocks were never written.
                self.prefix_cache.insert(seq.prompt_tokens, seq.blocks.blocks)
            seq.blocks.release()
            seq.blocks = None
        seq.phase = Phase.FINISHED
        self.stats.finished += 1

    def _try_alloc(self, seq: Sequence, tokens: int) -> bool:
        """Blocks for `tokens` positions (at most max_model_len), evicting
        prefix-cache blocks under pool pressure; False if they do not
        fit."""
        tokens = min(tokens, self.cfg.max_model_len)
        if self.linear:
            try:
                seq.blocks.ensure_capacity(tokens)
            except CapacityError:
                return False
            return True
        need = seq.blocks.blocks_needed_for(tokens)
        if need == 0:
            return True
        if need > self.pool.num_free and self.prefix_cache is not None:
            self.prefix_cache.evict(min_free_target=need)
        if need > self.pool.num_free:
            return False
        seq.blocks.ensure_capacity(tokens)
        return True

    def _preempt_victim(self, batch: ScheduledBatch, exclude: Sequence,
                        pinned: frozenset = frozenset()
                        ) -> Optional[Sequence]:
        """Drop the most recently admitted running sequence that no
        window in flight still writes (pinned), for recompute later."""
        for victim in reversed(self.running):
            if victim is exclude \
                    or victim.request.request_id in pinned:
                continue
            self.running.remove(victim)
            if victim.slot is not None:
                self._free_slots.append(victim.slot)
            victim.blocks.release()
            victim.blocks = None
            victim.reset_for_recompute()
            self.waiting.appendleft(victim)
            batch.preempted.append(victim)
            self.stats.preemptions += 1
            _prof.emit_instant("engine.preempt", {
                "request_id": victim.request.request_id,
                "recompute_tokens": victim.total_tokens})
            return victim
        return None

    def next_batch(self, pinned: frozenset = frozenset(),
                   inflight_steps: int = -1) -> ScheduledBatch:
        """`pinned`: request ids riding windows in flight;
        `inflight_steps`: those windows' steps (their exact write
        horizon; -1 = unknown, take depth * decode_multi_step)."""
        cfg = self.cfg
        batch = ScheduledBatch()
        budget = cfg.max_num_batched_tokens
        self.stats.iterations += 1

        # --- 1. decode set ---
        for seq in [s for s in self.running if s.phase == Phase.DECODING]:
            if seq.phase != Phase.DECODING or seq.blocks is None:
                continue          # preempted as a victim this iteration
            if budget <= 0:
                break
            scheduled = True
            while not self._try_alloc(
                    seq, seq.total_tokens + self.decode_lookahead):
                if self._preempt_victim(batch, seq, pinned) is not None:
                    continue
                if seq.request.request_id not in pinned:
                    inflight = 0
                elif inflight_steps >= 0:
                    inflight = inflight_steps
                else:
                    inflight = cfg.decode_multi_step * cfg.pipeline_depth
                # Minimum progress: one step, or under speculation one
                # whole round (its rows past the blocks would be lost).
                if self._try_alloc(seq, seq.total_tokens + inflight
                                   + max(1, self.spec_steps)):
                    batch.decode_steps = 1
                else:
                    batch.deferred_decodes.append(seq)
                    scheduled = False
                break
            if scheduled:
                batch.decode_seqs.append(seq)
                budget -= 1
        self.stats.tokens_decoded_scheduled += len(batch.decode_seqs)

        # --- 2. ongoing prefills (chunked) ---
        chunk_cap = cfg.chunk_cap
        for seq in [s for s in self.running if s.phase == Phase.PREFILLING]:
            if budget <= 0:
                break
            t = min(seq.prefill_remaining, chunk_cap, budget)
            if t < seq.prefill_remaining and t < chunk_cap:
                continue          # only full-cap chunks or the remainder
            if t <= 0 or not self._try_alloc(seq, seq.prefilled + t):
                continue          # retried next iteration
            batch.prefill_chunks.append(self._chunk(seq, t))
            budget -= t

        # --- 3. admit waiting requests while slots + budget remain ---
        while self.waiting and self._free_slots and budget > 0:
            seq = self.waiting[0]
            # fifo: a prompt that fits one batch goes whole.
            cap = cfg.max_num_batched_tokens if self.policy == "fifo" \
                and seq.prefill_remaining <= cfg.max_num_batched_tokens \
                else chunk_cap
            first = min(seq.prefill_remaining, cap, budget)
            if first < seq.prefill_remaining and first < cap:
                break             # no odd-sized chunks: wait for budget
            if first <= 0:
                break
            blocks = SlotBlocks(self.pool, self._free_slots[-1],
                                cfg.max_blocks_per_seq) if self.linear \
                else SequenceBlocks(self.pool)
            seq.blocks = blocks
            reused_blocks: List[int] = []
            reused = 0
            # A scored prompt needs every position prefilled.
            if self.prefix_cache is not None and seq.prefilled == 0 \
                    and not seq.score_mode:
                reused_blocks, reused = self.prefix_cache.match_prefix(
                    seq.prompt_tokens)
            if reused:
                if self.linear:
                    blocks.adopt_copied_prefix(reused)
                    seq.pending_prefix_copy = (reused_blocks, reused)
                else:
                    blocks.append_shared_prefix(reused_blocks, reused)
                seq.prefilled = reused
                seq.prefix_reused_tokens = reused
                first = min(seq.prefill_remaining, cap, budget)
                if first < seq.prefill_remaining and first < cap:
                    # No odd-sized chunks: stay at the queue's head with
                    # the prefix released.
                    blocks.release()
                    seq.blocks = None
                    seq.prefilled = 0
                    seq.prefix_reused_tokens = 0
                    seq.pending_prefix_copy = None
                    break
            if not self._try_alloc(seq, seq.prefilled + first):
                blocks.release()  # no KV room for the first chunk
                seq.blocks = None
                seq.prefilled = 0
                break
            self.waiting.popleft()
            seq.slot = self._free_slots.pop()
            seq.phase = Phase.PREFILLING
            self.running.append(seq)
            batch.admitted.append(seq)
            batch.prefill_chunks.append(self._chunk(seq, first))
            budget -= first
        self.stats.tokens_prefilled_scheduled += sum(
            len(c.tokens) for c in batch.prefill_chunks)
        if batch.is_empty and not pinned:
            self._break_prefill_stall(batch)
        self._trace(batch, budget)
        return batch

    def _break_prefill_stall(self, batch: ScheduledBatch) -> None:
        """Two or more prefilling sequences hold blocks, none can take its
        next chunk, and nothing decodes or rides a window to free any:
        the newest goes back to the queue (recompute), so the others
        proceed. (The JAX scheduler preempts only for a decode, and
        waits here forever: ROADMAP Queue 3.)"""
        stuck = [s for s in self.running if s.phase == Phase.PREFILLING]
        if len(stuck) >= 2 and len(stuck) == len(self.running):
            self._preempt_victim(batch, stuck[0])

    def _trace(self, batch: ScheduledBatch, budget_left: int) -> None:
        """One JSON line of this iteration's batch (the JAX keys)."""
        if self._trace_fh is None:
            return
        self._trace_fh.write(json.dumps({
            "t": time.time(),
            "iteration": self.stats.iterations,
            "decode": len(batch.decode_seqs),
            "prefill_chunks": [[c.seq.request.request_id, c.start,
                                len(c.tokens)] for c in batch.prefill_chunks],
            "admitted": [s.request.request_id for s in batch.admitted],
            "preempted": [s.request.request_id for s in batch.preempted],
            "waiting": len(self.waiting),
            "running": len(self.running),
            "free_blocks": self.pool.num_free,
            "budget_left": budget_left,
        }) + "\n")
        self._trace_fh.flush()

    def _chunk(self, seq: Sequence, t: int) -> PrefillChunk:
        target = seq.prefill_target
        return PrefillChunk(
            seq=seq, start=seq.prefilled,
            tokens=target[seq.prefilled:seq.prefilled + t],
            is_last=seq.prefilled + t == len(target))

    def note_prefill_done(self, chunk: PrefillChunk) -> None:
        """Engine callback after a chunk's device step ran."""
        seq = chunk.seq
        seq.prefilled += len(chunk.tokens)
        if seq.is_prefill_done:
            seq.phase = Phase.DECODING
            seq.recompute = False
