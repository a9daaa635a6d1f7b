"""ContinuousBatchEngine — the serving core (prefill + decode windows).

Port of `ferrum_tpu/engine/engine.py` for the served path: requests are
submitted from any thread and consumed through per-request queues; one
background loop runs `run_iteration`: scheduler → one batched prefill
of this iteration's chunks (first tokens accepted right after) → one
decode window of T steps over the decoding sequences → token acceptance
(EOS / max_tokens finishes), incremental detokenization and emission.

Not yet ported (later slices): the dispatch-ahead window pipeline, the
mixed prefill-in-window path, prefix reuse, guided decoding, stop
strings, speculative decoding and prompt scoring.
"""

from __future__ import annotations

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
from .runner import ModelRunner

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
        """Stop the loop and finish every waiting consumer with ABORT.
        Raises (and sweeps nothing) if the loop thread is still running
        STOP_JOIN_S seconds later: it could still emit chunks and finish
        sequences while the sweep ran. A later call retries."""
        self._stop = True
        self._work_event.set()
        thread = self._loop_thread
        if thread is not None:
            thread.join(timeout=STOP_JOIN_S)
            if thread.is_alive():
                raise RuntimeError(
                    f"engine loop still running {STOP_JOIN_S} s after "
                    f"stop(); no request was aborted")
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
        with self._lock:
            batch = self.scheduler.next_batch()
        for seq in batch.admitted:
            self.runner.admit_slot(seq)
        decode_seqs = [s for s in batch.decode_seqs
                       if s.phase == Phase.DECODING]
        if batch.prefill_chunks:
            toks = self.runner.run_prefill_batch(batch.prefill_chunks)
            for chunk, tok in zip(batch.prefill_chunks, toks):
                self.scheduler.note_prefill_done(chunk)
                if chunk.is_last:
                    self._accept_tokens(chunk.seq, [int(tok)])
        if decode_seqs:
            lists = self.runner.run_decode_window(
                decode_seqs, self.cfg.decode_multi_step)
            for seq in decode_seqs:
                if seq.phase == Phase.DECODING:
                    self._accept_tokens(seq, lists[seq.request.request_id])
        return not batch.is_empty

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
                self.scheduler.finish(seq)
