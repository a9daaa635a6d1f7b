"""ContinuousBatchEngine — the serving core (prefill + decode windows).

Port of `ferrum_tpu/engine/engine.py` for the served path: requests are
submitted from any thread and consumed through per-request queues; one
background loop runs `run_iteration`, the JAX package's pipelined loop:
  (a) accept the first tokens of last iteration's batched prefills;
  (b) schedule (sequences riding windows in flight are pinned);
  (c) dispatch the prefill chunks as batched prefills, holding one back
      to ride the decode window (mixed prefill), unless refill-first
      holds decode for this iteration;
  (d) dispatch window W+1 (chained on the device from W), then fetch
      and accept the oldest windows until at most `pipeline_depth` (1
      at <= 4 decoding sequences) stay in flight.
Tokens are accepted a window at a time (EOS / max_tokens finishes),
with one incremental detokenization and one chunk a window. A request
with stop strings takes the JAX engine's per-token path instead
(`_accept_token`: the text is cut before the first match), and streams
every token.

Also the JAX engine's `submit` validation (empty prompt, max_tokens
clamped to max_model_len, a prompt over it, the echo + logprobs rules,
max_tokens == 0), `abort(request_id)` (drained at the head of the next
iteration: the final chunk says ABORT; a linear slot is freed at once,
a paged sequence's blocks after the window in flight, as `_retire`
does), and prompt scoring: a scored request's chunks are dispatched
alone with the runner's score rows, read the iteration after, and the
request ends after its prefill with the assembled per-position
logprobs (`_finish_prompt_only`).

Counters: `metrics` (`metrics_snapshot()`), the JAX engine's
EngineMetricsSnapshot at the JAX sites: iterations that scheduled work,
requests submitted and completed, prompt tokens dispatched to prefill,
tokens accepted from decode windows (a prompt's first token, sampled by
its prefill, is not a decode token). Each iteration emits an
`engine.iteration` span, and every 256th an `engine.memory` snapshot
(utils/profile.py).

Prefix reuse by layout, as the JAX engine: on the linear layout a
`LinearPrefixCache` over a device store (its queued saves flushed as
one copy each iteration before admission; a hit's store → slot copy
and the reused tokens' repetition counts issued at admission), on the
paged layout a `PrefixCache` of shared blocks, with the host offload
tier under `prefix_offload_mb` (evicted blocks kept compressed in host
RAM and restored on a later chain hit; kv/compression.py). Paged
sequences preempted under block pressure are prefilled again
(recompute) at re-admission; when every victim rides a window in
flight, the loop breaks the pipeline chain so the next iteration can
preempt.

Guided decoding, as the JAX engine: `submit` builds the request's host
processor (sampling/guided.py) and compiles its DFA into device-FSM
tables (sampling/token_fsm.py, cached per pattern), which the runner
stacks; such a sequence rides the normal windows, masked and advanced
on the device, its processor kept in step as the host shadow (state for
a recompute re-admission, `is_complete`). An FSM `build_token_fsm`
refuses (too many states, or codepoints >= 256 told apart) takes the
host-masked path: one `run_decode` step a token with the logits read
back and `sample_host` under the processor's mask. That path still runs
the model on the card; only the draw is on the host. Guided sequences
accept token by token; a guided chunk never rides a window.

Speculative decoding (`spec`, engine/spec_decode.py), as the JAX
engine: rounds of a draft model's K proposals and one target verify
replace the decode windows of the plain (and device-FSM guided)
sequences, pipelined at depth 1 (round R+1 dispatched, chained on the
device, before round R is read); mixed prefill and refill-first are
off. A round's variable per-slot token lists are accepted token by
token (every token streamed), up to a finished sequence; `spec.stats`
counts proposals, drafted and accepted tokens. No round starts while
KV pressure defers a decode and every victim rides the round in flight
(the chain breaks so the next iteration can preempt).

Adaptive window lengths (`adaptive_windows`, the JAX default), at the
JAX engine's conditions: without decode_t_spec, a pipelined window at
<= 4 decoding sequences with no prefill chunk scheduled and nothing
waiting runs twice as long (at most 16 steps); while chunks prefill and
requests wait (an admission pile-up) it runs half as long (at least 4).
Slack lanes (`slot_slack`): the scheduler's slots number max_num_seqs
+ slot_slack, so a replacement is admitted while a paged predecessor's
release waits for the window in flight (one ended by EOS, a stop or an
abort; the port dispatches no window past max_tokens, so a request
ending there is released when its last window is read);
`slack_admissions` counts the admissions that took the lanes past
max_num_seqs while such a release waited.

Everything runs on ONE CUDA stream; the loop leans on its order (see
`_retire`).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
import traceback
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ..config import EngineConfig, adaptive_window_steps
from ..kv.block_pool import BlockPool
from ..kv.compression import HostOffloadTier, make_strategy
from ..kv.linear_prefix import LinearPrefixCache
from ..kv.prefix_cache import PrefixCache
from ..sampling.guided import build_guided_processor
from ..sampling.host import sample_host
from ..sampling.token_fsm import build_token_fsm, vocab_table
from ..scheduler.continuous import ContinuousBatchScheduler
from ..scheduler.sequence import Phase, Sequence
from ..tokenizer import Tokenizer
from ..types import (EngineMetricsSnapshot, EngineStoppedError,
                     FinishReason, GuidedOptions, InferenceRequest,
                     InferenceResponse, InvalidRequestError,
                     NotSupportedError, StreamChunk)
from ..utils import profile as _prof
from .runner import DecodeWindow, ModelRunner
from .spec_decode import SpecDecoder, SpecWindow

# Refill-first holds decode for at most this many iterations in a row.
MAX_HOLD_STREAK = 8

# How long stop() waits for the loop thread to end.
STOP_JOIN_S = 60.0


class _RequestState:
    def __init__(self, seq: Sequence):
        self.seq = seq
        self.out_queue: "queue.Queue[StreamChunk]" = queue.Queue()
        self.aborted = False


class ContinuousBatchEngine:
    def __init__(self, cfg: EngineConfig, runner: ModelRunner,
                 tokenizer: Tokenizer, spec: Optional[SpecDecoder] = None):
        self.cfg = cfg
        self.runner = runner
        self.tokenizer = tokenizer
        self.spec = spec
        self.pool = None
        self.prefix_cache = None
        if runner is not None:
            self.pool = BlockPool(runner.kv.num_blocks, cfg.kv_block_size)
            store = self._linear_store_blocks(cfg, runner) \
                if cfg.kv_layout == "linear" and cfg.enable_prefix_cache \
                else 0
            if store > 0:
                self.prefix_cache = LinearPrefixCache(
                    runner, store, cfg.kv_block_size,
                    policy=cfg.prefix_cache_policy)
            else:
                # The host offload tier: the paged layout with the prefix
                # cache only, as in the JAX engine.
                offload = block_io = None
                if cfg.kv_layout == "paged" and cfg.enable_prefix_cache \
                        and cfg.prefix_offload_mb > 0:
                    offload = HostOffloadTier(
                        cfg.prefix_offload_mb << 20,
                        make_strategy(cfg.prefix_offload_algo))
                    block_io = (runner.read_kv_block, runner.write_kv_block)
                self.prefix_cache = PrefixCache(
                    self.pool, enabled=cfg.enable_prefix_cache
                    and cfg.kv_layout == "paged",
                    policy=cfg.prefix_cache_policy, offload=offload,
                    block_io=block_io)
        self.scheduler = ContinuousBatchScheduler(cfg, self.pool,
                                                  self.prefix_cache)
        self._requests: Dict[str, _RequestState] = {}
        self._lock = threading.Lock()
        self._work_event = threading.Event()
        self._stop = False
        self._loop_thread: Optional[threading.Thread] = None
        self._loop_error: Optional[BaseException] = None
        # Windows dispatched and not yet fetched, oldest first; prefills
        # whose first tokens are fetched next iteration.
        self._inflight_q: "collections.deque[DecodeWindow]" = \
            collections.deque()
        self._pending_first: List = []
        # Scored chunks whose rows are read next iteration.
        self._pending_scores: List = []
        self._hold_streak = 0
        # The most windows in flight at once, over the engine's life.
        self.max_inflight = 0
        # Admissions that took the occupied lanes past max_num_seqs while
        # a release waited for a window in flight.
        self.slack_admissions = 0
        self.metrics = EngineMetricsSnapshot()
        self._mem_profile_tick = 0
        # Compiled device FSMs by pattern: (TokenFsm, its DFA, VocabTable),
        # or Nones where build_token_fsm refused (the host-masked path).
        self._fsm_cache: Dict[tuple, tuple] = {}
        self._fsm_lock = threading.Lock()

    # ------------------------------------------------------------------
    # Public API
    # ------------------------------------------------------------------
    def submit(self, request: InferenceRequest
               ) -> "queue.Queue[StreamChunk]":
        if self._stop:
            raise EngineStoppedError("engine is stopped")
        request.sampling.validate()
        if request.prompt_token_ids is not None:
            ids = list(request.prompt_token_ids)
        elif request.prompt is not None:
            ids = self.tokenizer.encode(request.prompt)
        else:
            raise InvalidRequestError("prompt or prompt_token_ids required",
                                      param="prompt")
        if not ids:
            raise InvalidRequestError("empty prompt", param="prompt")
        sp = request.sampling
        if len(ids) + sp.max_tokens > self.cfg.max_model_len:
            # Clamp the generation budget rather than reject.
            sp.max_tokens = max(1, self.cfg.max_model_len - len(ids))
        if len(ids) >= self.cfg.max_model_len:
            raise InvalidRequestError(
                f"prompt length {len(ids)} exceeds max_model_len "
                f"{self.cfg.max_model_len}", param="prompt")
        if request.echo and sp.logprobs is not None:
            # Prompt scoring: prefill only.
            if sp.max_tokens != 0:
                raise InvalidRequestError(
                    "echo+logprobs is supported for max_tokens=0 "
                    "scoring only", param="echo")
            if request.guided is not None:
                raise InvalidRequestError(
                    "echo+logprobs cannot be combined with guided "
                    "decoding", param="echo")
        elif sp.max_tokens == 0:
            raise InvalidRequestError(
                "max_tokens=0 requires echo+logprobs scoring",
                param="max_tokens")
        seq = Sequence(request, ids)
        if request.guided is not None:
            seq.guided_processor = build_guided_processor(request.guided,
                                                          self.tokenizer)
            self._setup_device_guided(seq, request.guided)
        state = _RequestState(seq)
        with self._lock:
            self._requests[request.request_id] = state
            self.scheduler.submit(seq)
            self.metrics.requests_submitted += 1
        self.ensure_loop()
        self._work_event.set()
        return state.out_queue

    def _setup_device_guided(self, seq: Sequence,
                             opts: GuidedOptions) -> None:
        """Compile the request's DFA into device-FSM tables (cached per
        pattern) and register them with the runner, so the sequence
        rides the windows. Where build_token_fsm refuses the FSM, the
        sequence keeps no FSM: the host-masked path."""
        key = (opts.regex, opts.json_schema is not None
               and str(opts.json_schema), bool(opts.json_mode))
        with self._fsm_lock:
            hit = self._fsm_cache.get(key)
            if hit is None:
                vocab = self.runner.model_cfg.vocab_size
                try:
                    vt = vocab_table(self.tokenizer, vocab)
                    fsm = build_token_fsm(seq.guided_processor.dfa, vt,
                                          vocab)
                    # DFA state ids are per instance: later requests'
                    # processors share the DFA the FSM was built from.
                    hit = (fsm, seq.guided_processor.dfa, vt)
                except NotSupportedError:
                    hit = (None, None, None)
                self._fsm_cache[key] = hit
        fsm, dfa, vt = hit
        if fsm is None:
            return
        if seq.guided_processor.dfa is not dfa:
            seq.guided_processor.dfa = dfa
            seq.guided_processor.state = dfa.start
        seq.guided_fsm_offset = self.runner.register_guided_fsm(fsm, vt)
        seq.guided_fsm = fsm

    def infer_stream(self, request: InferenceRequest
                     ) -> Iterator[StreamChunk]:
        q = self.submit(request)
        while True:
            chunk = q.get()
            if self._loop_error is not None:
                raise self._loop_error
            yield chunk
            if chunk.finished:
                return

    def infer(self, request: InferenceRequest) -> InferenceResponse:
        t0 = time.monotonic()
        text: List[str] = []
        token_ids: List[int] = []
        ttft = None
        last = None
        for chunk in self.infer_stream(request):
            if chunk.token_ids and ttft is None:
                ttft = time.monotonic() - t0
            text.append(chunk.text)
            token_ids.extend(chunk.token_ids)
            last = chunk
        return InferenceResponse(
            request_id=request.request_id, text="".join(text),
            token_ids=token_ids,
            finish_reason=last.finish_reason or FinishReason.STOP,
            prompt_tokens=last.prompt_tokens,
            completion_tokens=last.completion_tokens, ttft=ttft,
            e2e_latency=time.monotonic() - t0, logprobs=last.logprobs)

    def abort(self, request_id: str) -> None:
        """Finish a request with ABORT at the head of the next iteration
        (a no-op once it has finished)."""
        with self._lock:
            state = self._requests.get(request_id)
            if state is not None:
                state.aborted = True
        self._work_event.set()

    def stop(self) -> None:
        """Stop the loop, accept what the windows and prefills in flight
        produced, and finish every waiting consumer with ABORT. Raises
        (and drains and sweeps nothing) if the loop thread is still
        running STOP_JOIN_S seconds later: it could still emit chunks
        and finish sequences meanwhile. A later call retries."""
        self._stop = True
        self._work_event.set()
        thread = self._loop_thread
        if thread is not None:
            thread.join(timeout=STOP_JOIN_S)
            if thread.is_alive():
                raise RuntimeError(
                    f"engine loop still running {STOP_JOIN_S} s after "
                    f"stop(); no request was aborted")
        if self._loop_error is None:
            self._drain()
        self.scheduler.close()
        with self._lock:
            states = list(self._requests.values())
            self._requests.clear()
        for state in states:
            state.out_queue.put(StreamChunk(
                request_id=state.seq.request.request_id, text="",
                token_ids=[], finished=True,
                finish_reason=FinishReason.ABORT))

    @staticmethod
    def _linear_store_blocks(cfg: EngineConfig, runner: ModelRunner) -> int:
        """Blocks of the linear layout's prefix store: under auto (-1)
        capped by the card's free memory, and 0 when that cannot hold
        one full prompt; an explicit prefix_cache_blocks passes."""
        blocks = cfg.resolved_prefix_cache_blocks
        if cfg.prefix_cache_blocks < 0:
            blocks = min(blocks, runner.prefix_store_budget_blocks())
            if blocks < cfg.max_blocks_per_seq:
                return 0
        return blocks

    def metrics_snapshot(self) -> EngineMetricsSnapshot:
        m = self.metrics
        m.kv_blocks_total = self.runner.kv.num_blocks
        with self._lock:
            running = list(self.scheduler.running)
            m.waiting_requests = len(self.scheduler.waiting)
            free = self.pool.num_free
        m.running_requests = len(running)
        if self.cfg.kv_layout == "linear":   # regions never leave the pool
            free = m.kv_blocks_total - sum(
                len(s.blocks.blocks) for s in running if s.blocks is not None)
        m.kv_blocks_free = free
        st = self.prefix_cache.stats
        m.prefix_cache_hits = st.hits
        m.prefix_cache_misses = st.misses
        m.prefix_cache_saved_tokens = st.saved_prefill_tokens
        return m

    # ------------------------------------------------------------------
    # Background loop
    # ------------------------------------------------------------------
    def ensure_loop(self) -> None:
        with self._lock:
            if self._loop_thread is None or not self._loop_thread.is_alive():
                self._loop_thread = threading.Thread(
                    target=self._loop, name="ferrum-torch-engine-loop",
                    daemon=True)
                self._loop_thread.start()

    def _loop(self) -> None:
        try:
            while not self._stop:
                if not self.run_iteration():
                    self._work_event.wait(timeout=0.05)
                    self._work_event.clear()
        except BaseException as e:    # report to every waiter, then stop
            self._loop_error = e
            traceback.print_exc()
            with self._lock:
                for state in self._requests.values():
                    state.out_queue.put(StreamChunk(
                        request_id=state.seq.request.request_id, text="",
                        token_ids=[], finished=True,
                        finish_reason=FinishReason.ERROR))
            raise

    def run_iteration(self) -> bool:
        """One scheduler + device iteration; False when idle."""
        cfg = self.cfg
        iter_t0 = time.monotonic()
        self._drain_aborts()
        did_work = self._accept_first_tokens()

        # --- (b) schedule; sequences riding windows in flight pinned ---
        pinned = frozenset().union(*(w.covered for w in self._inflight_q))
        with self._lock:
            # Queued prefix-store saves go first, as one copy: no
            # admission below may overwrite a source region or restore a
            # block still queued.
            if isinstance(self.prefix_cache, LinearPrefixCache):
                self.prefix_cache.flush_pending()
            batch = self.scheduler.next_batch(
                pinned=pinned,
                inflight_steps=sum(w.num_steps for w in self._inflight_q))
        if batch.admitted and self.scheduler.lanes_in_use \
                > cfg.max_num_seqs and any(w.deferred
                                           for w in self._inflight_q):
            self.slack_admissions += len(batch.admitted)
        for seq in batch.admitted:
            self.runner.admit_slot(seq)
            if seq.pending_prefix_copy is not None:
                # Linear prefix hit: the cached blocks into the slot's
                # region, issued before the sequence's first chunk.
                store_blocks, _covered = seq.pending_prefix_copy
                self.runner.copy_prefix_blocks(
                    store_blocks, seq.blocks.blocks[:len(store_blocks)],
                    to_store=False)
                seq.pending_prefix_copy = None
            if seq.prefix_reused_tokens:
                self.runner.add_prompt_counts(
                    seq.slot, seq.prompt_tokens[:seq.prefix_reused_tokens])
            # The slot's FSM state: FREE for an unguided sequence (a
            # guided window masks every lane by its slot's row), else the
            # FSM's start, or the processor's state after a recompute.
            if seq.guided_fsm is None:
                self.runner.set_guided_state(seq.slot, 0)
            else:
                local = seq.guided_fsm.dfa_to_local.get(
                    seq.guided_processor.state, seq.guided_fsm.dead)
                self.runner.set_guided_state(
                    seq.slot, seq.guided_fsm_offset + local)
        if not batch.is_empty:
            self.metrics.iterations_total += 1
        decoding = [s for s in batch.decode_seqs
                    if s.phase == Phase.DECODING]
        # Host-masked guided sequences take one step a token with the
        # logits read back; the rest (device-FSM guided too) ride windows.
        host_guided = [s for s in decoding if self._host_masked(s)]
        plain = [s for s in decoding if not self._host_masked(s)]
        # A sequence whose windows in flight reach its max_tokens finishes
        # when they are read: another window would only make tokens past
        # its end (the JAX engine dispatches it anyway; at c = 1 that is
        # a whole 32-step window a request). Rounds take every plain
        # sequence, as the JAX engine's (its acceptance counts with them).
        spec = self.spec
        decode_seqs = plain if spec is not None else [
            s for s in plain
            if self._tokens_ahead(s) < s.request.sampling.max_tokens]
        t_steps = batch.decode_steps or max(1, cfg.decode_multi_step)
        if not batch.decode_steps and decode_seqs:
            t_steps = cfg.t_for_bucket(
                self.runner.lane_bucket(len(decode_seqs)))
        # Adaptive lengths (decode_t_spec, when set, is the length rule).
        if not batch.decode_steps and cfg.adaptive_windows \
                and not cfg.decode_t_spec:
            if cfg.pipeline_decode and not batch.prefill_chunks \
                    and not self.scheduler.waiting:
                t_steps = adaptive_window_steps(t_steps,
                                                len(batch.decode_seqs))
            elif batch.prefill_chunks and self.scheduler.waiting:
                t_steps = max(4, t_steps // 2)

        # --- (c) prefill: one chunk may ride the window ---
        pf_chunk = None
        if batch.prefill_chunks and cfg.mixed_prefill and decode_seqs \
                and cfg.pipeline_decode and spec is None \
                and self.runner.attn_impl == "linear":
            pf_chunk = next(
                (c for c in batch.prefill_chunks
                 if c.seq.num_output_tokens == 0 and not c.seq.score_mode
                 and c.seq.guided_processor is None
                 and len(c.tokens) <= 128 * t_steps), None)
        # Refill-first: while a wave of >= 2 prompts prefills at low
        # occupancy, hold decode so the next windows run fuller; at most
        # MAX_HOLD_STREAK iterations in a row. The streak resets only in
        # an iteration whose hold conditions are false (the JAX package
        # resets it on the forced iteration too, so a steady admission
        # stream held decode 8 iterations of every 9).
        # Never under KV pressure or with a recompute in the wave: the
        # held decodes are what frees blocks.
        hold_conds = (cfg.refill_first and spec is None
                      and len(batch.prefill_chunks) >= 2
                      and 0 < len(plain) <= self.runner.num_slots // 2
                      and not batch.deferred_decodes
                      and not any(c.seq.recompute
                                  for c in batch.prefill_chunks))
        hold = hold_conds and self._hold_streak < MAX_HOLD_STREAK
        if hold:
            self._hold_streak += 1
            pf_chunk = None
        elif not hold_conds:
            self._hold_streak = 0
        rest = [c for c in batch.prefill_chunks if c is not pf_chunk]
        if rest:
            self._dispatch_prefill(rest)

        # --- (d) dispatch W+1, then fetch and accept the oldest ---
        new_window = None
        newest = self._inflight_q[-1] if self._inflight_q else None
        if spec is not None:
            # Rounds replace windows (pipelined whatever pipeline_decode
            # says, as the JAX engine's).
            if decode_seqs and not (batch.deferred_decodes and pinned):
                new_window = spec.start_round(decode_seqs, prev=newest)
        elif decode_seqs and cfg.pipeline_decode and not hold \
                and not (batch.deferred_decodes and pinned):
            new_window = self.runner.start_decode_window(
                decode_seqs, t_steps, prev=newest, pf_chunk=pf_chunk)
            if pf_chunk is not None:
                self.scheduler.note_prefill_done(pf_chunk)
                self.metrics.tokens_prefilled += len(pf_chunk.tokens)
                pf_chunk = None
        if pf_chunk is not None:       # found no window to ride
            self._dispatch_prefill([pf_chunk])
        if new_window is not None:
            self._inflight_q.append(new_window)
            self.max_inflight = max(self.max_inflight,
                                    len(self._inflight_q))
            depth = 1 if spec is not None or len(batch.decode_seqs) <= 4 \
                else cfg.pipeline_depth
        else:
            depth = 0                  # nothing dispatched: drain
        while len(self._inflight_q) > depth:
            self._process_window(self._inflight_q.popleft())
            did_work = True
        if decode_seqs and not cfg.pipeline_decode and not hold \
                and spec is None:
            self._accept_window_tokens(
                decode_seqs, self.runner.run_decode_multi(decode_seqs,
                                                          t_steps), t_steps)
        if host_guided:
            # One step with the logits read back (a window in flight keeps
            # the card busy meanwhile); the host samples under the mask.
            _toks, logits = self.runner.run_decode(host_guided,
                                                   return_logits=True)
            for seq in host_guided:
                self._accept_token(seq, self._guided_sample(
                    seq, logits[seq.request.request_id]), True)
        _prof.emit("engine.iteration", time.monotonic() - iter_t0, {
            "decode": len(decode_seqs),
            "prefill_chunks": len(batch.prefill_chunks)})
        self._mem_profile_tick += 1
        if self._mem_profile_tick % 256 == 1:
            _prof.emit_memory({"iterations": self.metrics.iterations_total,
                               "running": len(self.scheduler.running),
                               "waiting": len(self.scheduler.waiting)})
        return did_work or not batch.is_empty or bool(self._inflight_q) \
            or bool(batch.deferred_decodes)

    @staticmethod
    def _host_masked(seq: Sequence) -> bool:
        return seq.guided_processor is not None and seq.guided_fsm is None

    def _tokens_ahead(self, seq: Sequence) -> int:
        """Tokens accepted plus those the windows in flight will give."""
        rid = seq.request.request_id
        n = seq.num_output_tokens
        for w in self._inflight_q:
            if rid in w.lanes:
                n += w.num_steps
            elif w.pf_seq is seq and w.pf_is_last:
                n += 1
        return n

    def _accept_first_tokens(self) -> bool:
        """(a) The score rows, then the first tokens, of the prefills
        dispatched last iteration: one wait per batched prefill. A
        request with max_tokens == 0 finishes here instead."""
        if not self._pending_first and not self._pending_scores:
            return False
        scores, self._pending_scores = self._pending_scores, []
        for chunk, res in scores:
            seq = chunk.seq
            if seq.phase == Phase.FINISHED or seq.blocks is None:
                continue
            row = res.rows[seq.request.request_id]
            n = len(chunk.tokens)
            lp = res.score_lp.numpy()
            seq.score_parts[chunk.start] = (
                lp[0, row, :n], res.score_argmax.numpy()[row, :n],
                lp[1, row, :n])
        pending, self._pending_first = self._pending_first, []
        fetched: Dict[int, object] = {}
        for seq, res in pending:
            if seq.phase == Phase.FINISHED or seq.blocks is None:
                continue
            if seq.request.sampling.max_tokens == 0:
                self._finish_prompt_only(seq)
                continue
            row = res.rows[seq.request.request_id]
            if self._host_masked(seq):
                # Sampled on the host under the mask (the device's token
                # ignored it).
                key = ("logits", id(res))
                lg = fetched.get(key)
                if lg is None:
                    lg = fetched[key] = res.logits.numpy()
                self._accept_tokens(seq, [self._guided_sample(seq,
                                                              lg[row])])
                continue
            toks = fetched.get(id(res))
            if toks is None:
                toks = fetched[id(res)] = res.tokens.numpy()
            self._accept_tokens(seq, [int(toks[row])])
        return True

    def _dispatch_prefill(self, chunks) -> None:
        """Chunks sharing a (chunk, context) bucket go in one batched
        prefill; final chunks' first tokens are fetched next iteration.
        A scored chunk goes alone, its rows fetched next iteration too."""
        groups: Dict[tuple, list] = {}
        for chunk in [c for c in chunks if c.seq.score_mode]:
            res = self.runner.run_prefill_batch([chunk], score=True)
            self.scheduler.note_prefill_done(chunk)
            self.metrics.tokens_prefilled += len(chunk.tokens)
            self._pending_scores.append((chunk, res))
            if chunk.is_last:
                self._pending_first.append((chunk.seq, res))
        for chunk in [c for c in chunks if not c.seq.score_mode]:
            key = (self.runner.chunk_bucket(len(chunk.tokens)),
                   self.runner.ctx_bucket(chunk.start + len(chunk.tokens)))
            groups.setdefault(key, []).append(chunk)
        for group in groups.values():
            # A host-masked request ending its prompt needs the logits.
            logits = any(self._host_masked(c.seq) and c.is_last
                         for c in group)
            res = self.runner.run_prefill_batch(
                group, **({"return_logits": True} if logits else {}))
            for chunk in group:
                self.scheduler.note_prefill_done(chunk)
                self.metrics.tokens_prefilled += len(chunk.tokens)
                if chunk.is_last:
                    self._pending_first.append((chunk.seq, res))

    def _process_window(self, window) -> None:
        """Fetch a window's tokens and accept them; a mixed-prefill chunk
        that ended its prompt gives its sequence's first token. A round
        (SpecWindow) gives each lane 1..K+1 tokens, accepted one by one
        until its sequence finishes."""
        if isinstance(window, SpecWindow):
            lists = self.spec.sync_round(window)
            for seq in window.seqs:
                for tok in lists[seq.request.request_id]:
                    if seq.phase != Phase.DECODING:
                        break
                    self._accept_token(seq, tok, True)
            for seq in window.deferred:
                with self._lock:
                    self.scheduler.finish(seq)
            return
        lists = self.runner.sync_window(window)
        self._accept_window_tokens(window.seqs, lists, window.num_steps)
        pf = window.pf_seq
        if pf is not None and window.pf_is_last \
                and pf.phase == Phase.DECODING and not pf.output_tokens:
            self._accept_tokens(pf, lists[pf.request.request_id][-1:])
        for seq in window.deferred:
            with self._lock:
                self.scheduler.finish(seq)

    def _accept_window_tokens(self, seqs, lists, t_steps) -> None:
        for seq in seqs:
            if seq.phase == Phase.DECODING:   # else finished earlier
                self._accept_tokens(
                    seq, lists[seq.request.request_id][:t_steps],
                    decoded=True)

    def _drain(self) -> None:
        """Accept everything in flight (the loop has ended)."""
        self._accept_first_tokens()
        while self._inflight_q:
            self._process_window(self._inflight_q.popleft())

    # ------------------------------------------------------------------
    def _accept_tokens(self, seq: Sequence, toks: List[int],
                       decoded: bool = False) -> None:
        """Accept a window of tokens: stop at EOS (past min_tokens) or at
        max_tokens, detokenize once, emit one chunk. `decoded`: the
        tokens came from a decode window (counted in tokens_decoded).
        A request with stop strings or guided options takes
        `_accept_token` token by token (the JAX engine's per-token path)
        until it finishes."""
        sp = seq.request.sampling
        if sp.stop or seq.guided_processor is not None:
            for tok in toks:
                if seq.phase != Phase.DECODING:
                    break
                self._accept_token(seq, tok, decoded)
            return
        if seq.eos_cache is None:
            seq.eos_cache = frozenset(self.tokenizer.eos_token_ids) \
                | frozenset(sp.stop_token_ids)
        n0 = seq.num_output_tokens
        finish: Optional[FinishReason] = None
        n_acc = 0
        for tok in toks:
            n_acc += 1
            n = n0 + n_acc
            if not sp.ignore_eos and tok in seq.eos_cache \
                    and n >= sp.min_tokens:
                finish = FinishReason.STOP
                break
            if n >= sp.max_tokens:
                finish = FinishReason.LENGTH
                break
        accepted = list(toks[:n_acc])
        seq.output_tokens.extend(accepted)
        if decoded:
            self.metrics.tokens_decoded += n_acc
        visible = seq.output_tokens[:-1] if finish == FinishReason.STOP \
            else seq.output_tokens
        text = ""
        if len(visible) > n0:
            text, seq.detok_prefix_offset, seq.detok_read_offset = \
                self.tokenizer.decode_incremental(
                    visible, seq.detok_prefix_offset, seq.detok_read_offset)
        state = self._requests.get(seq.request.request_id)
        if state is not None:
            state.out_queue.put(StreamChunk(
                request_id=seq.request.request_id, text=text,
                token_ids=accepted, finished=finish is not None,
                finish_reason=finish, prompt_tokens=seq.num_prompt_tokens,
                completion_tokens=seq.num_output_tokens))
        if finish is not None:
            with self._lock:
                self._requests.pop(seq.request.request_id, None)
                self.metrics.requests_completed += 1
            self._retire(seq)

    def _accept_token(self, seq: Sequence, token: int,
                      decoded: bool) -> None:
        """One token, as the JAX engine's `_accept_token`: EOS (past
        min_tokens) or max_tokens finishes, an EOS token's text is
        dropped, and the first stop string found in the decoded output
        (searched from just before the text emitted so far) cuts the
        text before it and finishes with STOP. A guided request whose
        processor completes finishes with STOP; on the device-FSM path
        the token advances the host shadow processor first. Every token
        is streamed (the JAX engine streams one only with text or a
        finish)."""
        sp = seq.request.sampling
        if seq.eos_cache is None:
            seq.eos_cache = frozenset(self.tokenizer.eos_token_ids) \
                | frozenset(sp.stop_token_ids)
        seq.output_tokens.append(token)
        if decoded:
            self.metrics.tokens_decoded += 1
        if seq.guided_fsm is not None:
            seq.guided_processor.advance(seq, token)
        finish: Optional[FinishReason] = None
        if not sp.ignore_eos and token in seq.eos_cache \
                and seq.num_output_tokens >= sp.min_tokens:
            finish = FinishReason.STOP
        elif seq.num_output_tokens >= sp.max_tokens:
            finish = FinishReason.LENGTH
        elif seq.guided_processor is not None \
                and seq.guided_processor.is_complete(seq):
            finish = FinishReason.STOP
        text = ""
        if finish is None or token not in seq.eos_cache:
            text, seq.detok_prefix_offset, seq.detok_read_offset = \
                self.tokenizer.decode_incremental(
                    seq.output_tokens, seq.detok_prefix_offset,
                    seq.detok_read_offset)
        if finish is None and sp.stop and text:
            emitted = seq.emitted_text_len
            candidate = self.tokenizer.decode(seq.output_tokens)
            for stop_s in sp.stop:
                idx = candidate.find(stop_s, max(0, emitted - len(stop_s)))
                if idx >= 0:
                    text = candidate[emitted:idx]
                    finish = FinishReason.STOP
                    break
        seq.emitted_text_len += len(text)
        state = self._requests.get(seq.request.request_id)
        if state is not None:
            state.out_queue.put(StreamChunk(
                request_id=seq.request.request_id, text=text,
                token_ids=[token], finished=finish is not None,
                finish_reason=finish, prompt_tokens=seq.num_prompt_tokens,
                completion_tokens=seq.num_output_tokens))
        if finish is not None:
            with self._lock:
                self._requests.pop(seq.request.request_id, None)
                self.metrics.requests_completed += 1
            self._retire(seq)

    def _guided_sample(self, seq: Sequence, logits_row: np.ndarray) -> int:
        """The host-masked draw, as the JAX engine's: sample_host under
        the processor's mask with an rng seeded by the request's seed
        (else the engine's) plus the tokens so far; the processor
        advances. Where the model's vocabulary runs past the
        tokenizer's, the mask is widened as the device tables are built
        (token_fsm.py): the extra rows disallowed, an EOS id there
        allowed iff the state accepts. (The JAX engine passes the
        tokenizer-wide mask on, which numpy cannot broadcast: ROADMAP
        Queue 3.)"""
        proc = seq.guided_processor
        mask = proc.allowed_mask(seq)
        if len(mask) < len(logits_row):
            wide = np.zeros(len(logits_row), bool)
            wide[:len(mask)] = mask
            if proc.dfa.is_accepting(proc.state):
                for eid in self.tokenizer.eos_token_ids:
                    if eid < len(wide):
                        wide[eid] = True
            mask = wide
        rng = np.random.default_rng(
            (seq.request.sampling.seed or self.cfg.seed)
            + seq.num_output_tokens)
        tok = sample_host(logits_row, seq.request.sampling, seq.all_tokens,
                          rng, mask=mask)
        proc.advance(seq, tok)
        return tok

    def _finish_prompt_only(self, seq: Sequence) -> None:
        """End a max_tokens == 0 request after its prefill: one final
        chunk (LENGTH) with the assembled prompt logprobs when scored."""
        logprobs = self._assemble_prompt_logprobs(seq) \
            if seq.score_mode else None
        state = self._requests.get(seq.request.request_id)
        if state is not None:
            state.out_queue.put(StreamChunk(
                request_id=seq.request.request_id, text="", token_ids=[],
                finished=True, finish_reason=FinishReason.LENGTH,
                prompt_tokens=seq.num_prompt_tokens, completion_tokens=0,
                logprobs=logprobs))
        with self._lock:
            self._requests.pop(seq.request.request_id, None)
            self.metrics.requests_completed += 1
        self._retire(seq)

    @staticmethod
    def _assemble_prompt_logprobs(seq: Sequence) -> List[Dict[str, Any]]:
        """The chunks' score rows as one entry a prompt token: entry p
        holds the logprob of token p given the tokens before it (None at
        p = 0) and the argmax there with its logprob. The chunk at
        `start` scored the targets start + 1 .. start + len."""
        n = seq.num_prompt_tokens
        lp = np.full(n, np.nan, np.float64)
        am = np.full(n, -1, np.int64)
        am_lp = np.full(n, np.nan, np.float64)
        for start in sorted(seq.score_parts):
            t_lp, t_am, t_am_lp = seq.score_parts[start]
            m = min(len(t_lp), n - 1 - start)   # the last has no target
            if m <= 0:
                continue
            lp[start + 1:start + 1 + m] = t_lp[:m]
            am[start + 1:start + 1 + m] = t_am[:m]
            am_lp[start + 1:start + 1 + m] = t_am_lp[:m]
        out = []
        for p in range(n):
            if p == 0 or np.isnan(lp[p]):
                out.append({"token_id": seq.prompt_tokens[p],
                            "logprob": None, "argmax_id": None,
                            "argmax_logprob": None})
            else:
                out.append({"token_id": seq.prompt_tokens[p],
                            "logprob": float(lp[p]),
                            "argmax_id": int(am[p]),
                            "argmax_logprob": float(am_lp[p])})
        return out

    def _drain_aborts(self) -> None:
        """Finish every aborted request with ABORT and release it (as
        `_retire` does: at once, or past the window in flight)."""
        with self._lock:
            dead = [st for st in self._requests.values() if st.aborted]
            for st in dead:
                self._requests.pop(st.seq.request.request_id, None)
        for st in dead:
            seq = st.seq
            if seq.phase != Phase.FINISHED:
                self._retire(seq)
            st.out_queue.put(StreamChunk(
                request_id=seq.request.request_id, text="", token_ids=[],
                finished=True, finish_reason=FinishReason.ABORT,
                prompt_tokens=seq.num_prompt_tokens,
                completion_tokens=seq.num_output_tokens))

    def _retire(self, seq: Sequence) -> None:
        """Release a finished sequence's slot and blocks.

        Linear layout: at once, even while a window in flight still runs
        its lane (the JAX package's rule). That is safe only because
        everything runs on ONE CUDA stream: the zombie lane writes
        inside the slot's own region, and a replacement's admission,
        prefill and K/V writes are issued after the window, so the
        stream orders them after it. Issue nothing of the engine on a
        side stream.

        Paged layout: the blocks go back to a shared pool, so their
        release waits for the newest window in flight that covers the
        sequence (it still writes them); its full prompt blocks, which
        no window writes, go to the prefix cache now."""
        infl = next((w for w in reversed(self._inflight_q)
                     if seq.request.request_id in w.covered), None)
        if infl is None or self.cfg.kv_layout == "linear":
            with self._lock:
                self.scheduler.finish(seq)
            return
        seq.phase = Phase.FINISHED        # out of every later schedule
        if seq.blocks is not None \
                and seq.num_prompt_tokens >= self.pool.page_size:
            with self._lock:
                self.prefix_cache.insert(seq.prompt_tokens,
                                         seq.blocks.blocks)
        infl.deferred.append(seq)
