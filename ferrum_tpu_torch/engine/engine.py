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
with one incremental detokenization and one chunk a window.

Everything runs on ONE CUDA stream; the loop leans on its order (see
`_retire`). Not yet ported (later slices): adaptive window lengths,
slack slots, prefix reuse, guided decoding, stop strings, speculative
decoding and prompt scoring.
"""

from __future__ import annotations

import collections
import queue
import threading
import time
import traceback
from typing import Dict, Iterator, List, Optional

from ..config import EngineConfig
from ..scheduler.continuous import ContinuousBatchScheduler
from ..scheduler.sequence import Phase, Sequence
from ..tokenizer import ByteTokenizer
from ..types import (EngineStoppedError, FinishReason, InferenceRequest,
                     InferenceResponse, InvalidRequestError, StreamChunk)
from .runner import DecodeWindow, ModelRunner

# Refill-first holds decode for at most this many iterations in a row.
MAX_HOLD_STREAK = 8

# How long stop() waits for the loop thread to end.
STOP_JOIN_S = 60.0


class _RequestState:
    def __init__(self, seq: Sequence):
        self.seq = seq
        self.out_queue: "queue.Queue[StreamChunk]" = queue.Queue()


class ContinuousBatchEngine:
    def __init__(self, cfg: EngineConfig, runner: ModelRunner,
                 tokenizer: ByteTokenizer):
        self.cfg = cfg
        self.runner = runner
        self.tokenizer = tokenizer
        self.scheduler = ContinuousBatchScheduler(cfg)
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
        self._hold_streak = 0
        # The most windows in flight at once, over the engine's life.
        self.max_inflight = 0

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
        if len(ids) >= self.cfg.max_model_len:
            raise InvalidRequestError(
                f"prompt length {len(ids)} exceeds max_model_len "
                f"{self.cfg.max_model_len}", param="prompt")
        if len(ids) + request.sampling.max_tokens > self.cfg.max_model_len:
            # Clamp the generation budget rather than reject.
            request.sampling.max_tokens = self.cfg.max_model_len - len(ids)
        seq = Sequence(request, ids)
        state = _RequestState(seq)
        with self._lock:
            self._requests[request.request_id] = state
            self.scheduler.submit(seq)
        self.ensure_loop()
        self._work_event.set()
        return state.out_queue

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
            e2e_latency=time.monotonic() - t0)

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
        with self._lock:
            states = list(self._requests.values())
            self._requests.clear()
        for state in states:
            state.out_queue.put(StreamChunk(
                request_id=state.seq.request.request_id, text="",
                token_ids=[], finished=True,
                finish_reason=FinishReason.ABORT))

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
        did_work = self._accept_first_tokens()

        # --- (b) schedule; sequences riding windows in flight pinned ---
        pinned = frozenset().union(*(w.covered for w in self._inflight_q))
        with self._lock:
            batch = self.scheduler.next_batch(
                pinned=pinned,
                inflight_steps=sum(w.num_steps for w in self._inflight_q))
        for seq in batch.admitted:
            self.runner.admit_slot(seq)
        decoding = [s for s in batch.decode_seqs
                    if s.phase == Phase.DECODING]
        # A sequence whose windows in flight reach its max_tokens finishes
        # when they are read: another window would only make tokens past
        # its end (the JAX engine dispatches it anyway; at c = 1 that is
        # a whole 32-step window a request).
        decode_seqs = [s for s in decoding if self._tokens_ahead(s)
                       < s.request.sampling.max_tokens]
        t_steps = batch.decode_steps or max(1, cfg.decode_multi_step)
        if not batch.decode_steps and decode_seqs:
            t_steps = cfg.t_for_bucket(
                self.runner.lane_bucket(len(decode_seqs)))

        # --- (c) prefill: one chunk may ride the window ---
        pf_chunk = None
        if batch.prefill_chunks and cfg.mixed_prefill and decode_seqs \
                and cfg.pipeline_decode:
            pf_chunk = next(
                (c for c in batch.prefill_chunks
                 if c.seq.num_output_tokens == 0
                 and len(c.tokens) <= 128 * t_steps), None)
        # Refill-first: while a wave of >= 2 prompts prefills at low
        # occupancy, hold decode so the next windows run fuller; at most
        # MAX_HOLD_STREAK iterations in a row. The streak resets only in
        # an iteration whose hold conditions are false (the JAX package
        # resets it on the forced iteration too, so a steady admission
        # stream held decode 8 iterations of every 9).
        hold_conds = (cfg.refill_first and len(batch.prefill_chunks) >= 2
                      and 0 < len(decoding) <= self.runner.num_slots // 2
                      and not batch.deferred_decodes)
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
        if decode_seqs and cfg.pipeline_decode and not hold \
                and not (batch.deferred_decodes and pinned):
            new_window = self.runner.start_decode_window(
                decode_seqs, t_steps,
                prev=self._inflight_q[-1] if self._inflight_q else None,
                pf_chunk=pf_chunk)
            if pf_chunk is not None:
                self.scheduler.note_prefill_done(pf_chunk)
                pf_chunk = None
        if pf_chunk is not None:       # found no window to ride
            self._dispatch_prefill([pf_chunk])
        if new_window is not None:
            self._inflight_q.append(new_window)
            self.max_inflight = max(self.max_inflight,
                                    len(self._inflight_q))
            depth = 1 if len(batch.decode_seqs) <= 4 \
                else cfg.pipeline_depth
        else:
            depth = 0                  # nothing dispatched: drain
        while len(self._inflight_q) > depth:
            self._process_window(self._inflight_q.popleft())
            did_work = True
        if decode_seqs and not cfg.pipeline_decode and not hold:
            self._accept_window_tokens(
                decode_seqs, self.runner.run_decode_multi(decode_seqs,
                                                          t_steps), t_steps)
        return did_work or not batch.is_empty or bool(self._inflight_q) \
            or bool(batch.deferred_decodes)

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
        """(a) The first tokens of the prefills dispatched last iteration:
        one wait per batched prefill."""
        if not self._pending_first:
            return False
        pending, self._pending_first = self._pending_first, []
        fetched: Dict[int, object] = {}
        for seq, res in pending:
            if seq.phase == Phase.FINISHED or seq.blocks is None:
                continue
            toks = fetched.get(id(res))
            if toks is None:
                toks = fetched[id(res)] = res.tokens.numpy()
            self._accept_tokens(seq, [int(toks[res.rows[
                seq.request.request_id]])])
        return True

    def _dispatch_prefill(self, chunks) -> None:
        """Chunks sharing a (chunk, context) bucket go in one batched
        prefill; final chunks' first tokens are fetched next iteration."""
        groups: Dict[tuple, list] = {}
        for chunk in chunks:
            key = (self.runner.chunk_bucket(len(chunk.tokens)),
                   self.runner.ctx_bucket(chunk.start + len(chunk.tokens)))
            groups.setdefault(key, []).append(chunk)
        for group in groups.values():
            res = self.runner.run_prefill_batch(group)
            for chunk in group:
                self.scheduler.note_prefill_done(chunk)
                if chunk.is_last:
                    self._pending_first.append((chunk.seq, res))

    def _process_window(self, window: DecodeWindow) -> None:
        """Fetch a window's tokens and accept them; a mixed-prefill chunk
        that ended its prompt gives its sequence's first token."""
        lists = self.runner.sync_window(window)
        self._accept_window_tokens(window.seqs, lists, window.num_steps)
        pf = window.pf_seq
        if pf is not None and window.pf_is_last \
                and pf.phase == Phase.DECODING and not pf.output_tokens:
            self._accept_tokens(pf, lists[pf.request.request_id][-1:])

    def _accept_window_tokens(self, seqs, lists, t_steps) -> None:
        for seq in seqs:
            if seq.phase == Phase.DECODING:   # else finished earlier
                self._accept_tokens(
                    seq, lists[seq.request.request_id][:t_steps])

    def _drain(self) -> None:
        """Accept everything in flight (the loop has ended)."""
        self._accept_first_tokens()
        while self._inflight_q:
            self._process_window(self._inflight_q.popleft())

    # ------------------------------------------------------------------
    def _accept_tokens(self, seq: Sequence, toks: List[int]) -> None:
        """Accept a window of tokens: stop at EOS (past min_tokens) or at
        max_tokens, detokenize once, emit one chunk."""
        sp = seq.request.sampling
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
            self._retire(seq)

    def _retire(self, seq: Sequence) -> None:
        """Release a finished sequence's slot and region at once, even
        while a window in flight still runs its lane (the JAX package's
        linear-layout rule). That is safe only because everything runs
        on ONE CUDA stream: the zombie lane writes inside the slot's own
        region, and a replacement's admission, prefill and K/V writes
        are issued after the window, so the stream orders them after
        it. Issue nothing of the engine on a side stream."""
        with self._lock:
            self.scheduler.finish(seq)
