"""ModelRunner: device state, batched prefill and fused decode windows.

Port of `ferrum_tpu/engine/runner.py` for the linear layout. The JAX
runner compiles one XLA program per (phase, bucket); PyTorch runs
eagerly, so each call here issues the kernels directly:

  run_prefill_batch    B sequences' chunks through one trunk pass (every
                       projection at m = B*T: the prefill GEMM kernel),
                       first tokens sampled on the device; returns
                       without waiting for them (BatchPrefillResult).
  start_decode_window  T decode steps over the sequences packed into
                       the lanes of the smallest bucket that fits
                       (EngineConfig.decode_buckets), optionally with
                       one slot's prefill chunk riding the steps; each
                       step's sampled token feeds the next on the
                       device, the cache stays read-only and the
                       window's K/V land with one append at its end.
                       Returns without waiting (DecodeWindow).
  sync_window          waits for one window's tokens alone.

Windows chain on the device through the slot-indexed `last_toks`: a
window reads the input token of every lane its predecessor covered
from there, so window W+1 is dispatched before W's tokens are read.
Nothing here synchronizes the stream: host rows go up from pinned
memory without blocking, and results come back into pinned memory with
an event recorded after the copy, which `HostCopy.numpy()` waits on
alone (a stream sync would also wait for every window dispatched
since).

Per-slot state has one row past the slots, the sink at index
`num_slots`: pad lanes carry that slot id, so their gathers read the
sink and their scatters write it, with no mask and no host sync.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import EngineConfig
from ..models.configs import ModelConfig
from ..models.llama_family import (
    OOB_SENTINEL, ModelParams, PagedKvCache, append_window_kv,
    decode_forward, logits_from_hidden, make_inv_freq,
    prefill_forward_batched)
from ..sampling.device import SlotSamplingParams, sample_step, update_counts
from ..scheduler.continuous import PrefillChunk
from ..scheduler.sequence import Sequence


def _round_up_pow2(x: int, lo: int, hi: int) -> int:
    x = max(x, lo)
    return min(1 << (x - 1).bit_length(), hi)


class HostCopy:
    """A device tensor's copy into host memory, started at once. On a
    card it goes into pinned memory without blocking, and `numpy()`
    waits on the event recorded after that copy, not on the stream."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            t = host
        self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._host.numpy()


@dataclass
class BatchPrefillResult:
    """One batched prefill's sampled tokens (meaningful for final
    chunks), still on their way to the host."""

    tokens: HostCopy                  # int64 [B]
    rows: Dict[str, int]              # request id -> row


@dataclass
class DecodeWindow:
    """A dispatched decode window whose tokens have not been read."""

    seqs: List[Sequence]              # the lanes' sequences
    covered: frozenset                # request ids riding this window
    toks: HostCopy                    # int64 [T, s_pad]
    end_pos: Dict[int, int]           # slot -> position after the window
    num_steps: int
    lanes: Dict[str, int]             # request id -> lane
    s_pad: int                        # the lane bucket
    # Mixed prefill: the chunk that rode the window; when it was the
    # prompt's last, its first token.
    pf_seq: Optional[Sequence] = None
    pf_is_last: bool = False
    pf_tok: Optional[HostCopy] = None


class ModelRunner:
    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params: ModelParams, kv: PagedKvCache,
                 device: torch.device):
        self.model_cfg = model_cfg
        self.cfg = engine_cfg
        self.params = params
        self.kv = kv
        self.device = device
        s = engine_cfg.num_slots
        v = model_cfg.vocab_size
        self.num_slots = s
        self.page = kv.page
        self.max_pages = engine_cfg.max_blocks_per_seq
        # Row s is the pad lanes' sink.
        self.counts = torch.zeros((s + 1, v), dtype=torch.int32,
                                  device=device)
        self.samp = {
            "temps": torch.zeros(s + 1, dtype=torch.float32, device=device),
            "top_ks": torch.zeros(s + 1, dtype=torch.int64, device=device),
            "top_ps": torch.ones(s + 1, dtype=torch.float32, device=device),
            "pens": torch.ones(s + 1, dtype=torch.float32, device=device),
        }
        # Slot-indexed final tokens of the latest window: the chain carry.
        self.last_toks = torch.zeros(s + 1, dtype=torch.int64, device=device)
        self._temps = np.zeros(s, np.float32)      # host mirror (greedy)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(engine_cfg.seed)
        self.inv_freq = make_inv_freq(model_cfg, device)
        self.eos_mask = torch.zeros(v, dtype=torch.bool, device=device)
        self.eos_mask[list(model_cfg.eos_token_ids)] = True
        # Counters read by callers: windows by lane bucket, windows that
        # carried a prefill block, decode steps.
        self.windows_by_bucket: Dict[int, int] = {}
        self.mixed_windows = 0
        self.decode_steps = 0
        # "error" makes every dispatch fail on a host sync of the stream
        # (torch.cuda.set_sync_debug_mode), to prove the pipeline free
        # of them.
        self.sync_debug: Optional[str] = None

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host rows to the device without blocking the host: a pinned
        copy (the caching host allocator reuses its block only after
        this copy's event), then an asynchronous transfer."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    @contextlib.contextmanager
    def sync_guard(self):
        """Around each dispatch: torch.cuda.set_sync_debug_mode at
        `sync_debug` (when set), restored after."""
        if self.sync_debug is None:
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(self.sync_debug)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    # ------------------------------------------------------------------
    def admit_slot(self, seq: Sequence) -> None:
        sp = seq.request.sampling
        slot = seq.slot
        self._temps[slot] = sp.temperature
        self.counts[slot].zero_()
        self.samp["temps"][slot] = sp.temperature
        self.samp["top_ks"][slot] = sp.top_k
        self.samp["top_ps"][slot] = sp.top_p
        self.samp["pens"][slot] = sp.repetition_penalty

    def ctx_bucket(self, max_len: int) -> int:
        return _round_up_pow2(max_len, max(2 * self.page, 16),
                              self.cfg.max_model_len)

    def lane_bucket(self, n: int) -> int:
        """Smallest decode lane bucket >= n."""
        for b in self.cfg.decode_buckets:
            if b >= n:
                return b
        return self.cfg.decode_buckets[-1]

    def chunk_bucket(self, t: int) -> int:
        # A page multiple (whole-page appends).
        lo = max(8, self.page, min(64, self.cfg.prefill_chunk_size))
        return _round_up_pow2(t, lo, max(self.cfg.prefill_chunk_size, lo))

    def _sampling(self, slots: torch.Tensor,
                  min_active: torch.Tensor) -> SlotSamplingParams:
        return SlotSamplingParams(
            self.samp["temps"][slots], self.samp["top_ks"][slots],
            self.samp["top_ps"][slots], self.samp["pens"][slots],
            min_active)

    def _flat_rows(self, seq: Sequence, start: int, n: int) -> np.ndarray:
        """Flat cache slots of positions start .. start+n-1 of a sequence,
        OOB_SENTINEL past its reserved blocks."""
        blocks = np.asarray(seq.blocks.blocks, np.int64)
        p = start + np.arange(n)
        blk = blocks[np.minimum(p // self.page, len(blocks) - 1)]
        return np.where(p < len(blocks) * self.page,
                        blk * self.page + p % self.page, OOB_SENTINEL)

    # ------------------------------------------------------------------
    def run_prefill_batch(self, chunks: List[PrefillChunk]
                          ) -> BatchPrefillResult:
        """One trunk pass over every chunk (one per sequence); the token
        sampled at each chunk's last position is on its way to the host
        when this returns."""
        with self.sync_guard():
            return self._prefill(chunks)

    def _prefill(self, chunks: List[PrefillChunk]) -> BatchPrefillResult:
        b = len(chunks)
        t_pad = self.chunk_bucket(max(len(c.tokens) for c in chunks))
        ctx_pad = max(self.ctx_bucket(c.start + len(c.tokens))
                      for c in chunks)
        # int rows: tokens, positions (pads past the context), flat slots
        # (pads dropped), count tokens (pads = vocab, dropped); per-row
        # scalars: slot, last index, total length, min_tokens active,
        # final-chunk slot (else the sink).
        v = self.model_cfg.vocab_size
        packed = np.zeros((4, b, t_pad), np.int64)
        packed[1] = self.cfg.max_model_len + ctx_pad
        packed[2] = OOB_SENTINEL
        packed[3] = v
        scal = np.zeros((5, b), np.int64)
        rows: Dict[str, int] = {}
        for i, c in enumerate(chunks):
            seq = c.seq
            n = len(c.tokens)
            total = c.start + n
            packed[0, i, :n] = c.tokens
            packed[1, i, :n] = np.arange(c.start, total)
            packed[2, i, :n] = self._flat_rows(seq, c.start, n)
            packed[3, i, :n] = c.tokens
            scal[:, i] = (seq.slot, n - 1, total,
                          int(seq.num_output_tokens
                              < seq.request.sampling.min_tokens),
                          seq.slot if c.is_last else self.num_slots)
            rows[seq.request.request_id] = i
        dev = self._upload(np.concatenate([packed.reshape(-1),
                                           scal.reshape(-1)]))
        pk = dev[:packed.size].view(4, b, t_pad)
        sc = dev[packed.size:].view(5, b)
        slots = sc[0]
        h, _ = prefill_forward_batched(
            self.params, self.model_cfg, self.kv, pk[0], pk[1],
            self._tables(slots), sc[2], pk[2], ctx_pad=ctx_pad,
            inv_freq=self.inv_freq)
        update_counts(self.counts, slots[:, None].expand(b, t_pad), pk[3])
        hs = h[torch.arange(b, device=self.device), sc[1]]      # [B, H]
        logits = logits_from_hidden(self.params, self.model_cfg, hs)
        greedy = bool(all(self._temps[c.seq.slot] == 0 for c in chunks))
        toks = sample_step(logits, self._sampling(slots, sc[3] == 1),
                           self.counts[slots], self.eos_mask,
                           greedy_only=greedy, generator=self.generator)
        # Final chunks count their token (other rows add to the sink
        # row).
        update_counts(self.counts, sc[4], toks)
        return BatchPrefillResult(tokens=HostCopy(toks), rows=rows)

    def _tables(self, slots: torch.Tensor) -> torch.Tensor:
        """Identity block tables of the linear layout for these slots."""
        return (slots.to(torch.int64)[:, None] * self.max_pages
                + torch.arange(self.max_pages, device=self.device)[None])

    # ------------------------------------------------------------------
    def start_decode_window(self, seqs: List[Sequence], num_steps: int,
                            prev: Optional[DecodeWindow] = None,
                            pf_chunk: Optional[PrefillChunk] = None
                            ) -> DecodeWindow:
        """Dispatch one decode window of `num_steps` steps for `seqs`
        without waiting for it.

        The sequences take lanes 0..n-1 of the smallest bucket s_pad that
        fits (lane == slot when s_pad is the slot count: the regions are
        then views of the cache, not gathers). A sequence that `prev`
        (the newest window still in flight) covered takes its input
        token from `last_toks` on the device and its position from
        prev.end_pos; the others take host rows.

        pf_chunk: one slot's prefill chunk riding the window, split into
        T blocks of P rows (mixed prefill). When it ends the prompt, its
        first token is sampled after the steps, written to `last_toks`
        (the next window chains from it) and returned as `pf_tok`."""
        with self.sync_guard():
            return self._window(seqs, num_steps, prev, pf_chunk)

    def _window(self, seqs, num_steps, prev, pf_chunk) -> DecodeWindow:
        s = self.num_slots
        t = num_steps
        s_pad = self.lane_bucket(max(1, len(seqs)))
        ident = s_pad == s
        # Lane rows: tokens, positions, cache lens, slots (the sink for
        # pads), min_tokens active, token from the carry; then the flat
        # slots of every step [T, s_pad].
        lrows = np.zeros((6, s_pad), np.int64)
        lrows[3] = s
        flat = np.full((t, s_pad), OOB_SENTINEL, np.int64)
        max_len = 2
        end_pos: Dict[int, int] = {}
        lanes: Dict[str, int] = {}
        for i, seq in enumerate(seqs):
            lane = seq.slot if ident else i
            sl = seq.slot
            rid = seq.request.request_id
            lanes[rid] = lane
            if prev is not None and rid in prev.covered \
                    and sl in prev.end_pos:
                pos = prev.end_pos[sl]
                lrows[5, lane] = 1
            else:
                pos = seq.next_position()
                lrows[0, lane] = seq.all_tokens[-1]
            lrows[1, lane] = pos
            lrows[2, lane] = pos + 1
            lrows[3, lane] = sl
            # Suppress EOS through the whole window while under
            # min_tokens (may overshoot by <= T-1, never under).
            lrows[4, lane] = int(seq.num_output_tokens
                                 < seq.request.sampling.min_tokens)
            flat[:, lane] = self._flat_rows(seq, pos, t)
            end_pos[sl] = pos + t
            max_len = max(max_len, pos + 1)
        covered = {seq.request.request_id for seq in seqs}

        parts = [lrows.reshape(-1), flat.reshape(-1)]
        p_rows = 0
        if pf_chunk is not None:
            seq_p = pf_chunk.seq
            n = len(pf_chunk.tokens)
            start = pf_chunk.start
            p_rows = _round_up_pow2(-(-n // t), 8, 512)
            # Rows: tokens, count tokens (pads = vocab), positions (pads
            # past every context), flat slots (pads dropped).
            pf = np.zeros((4, t * p_rows), np.int64)
            pf[1] = self.model_cfg.vocab_size
            pf[2] = self.cfg.max_model_len + (1 << 16)
            pf[3] = OOB_SENTINEL
            pf[0, :n] = pf_chunk.tokens
            pf[1, :n] = pf_chunk.tokens
            pf[2, :n] = np.arange(start, start + n)
            pf[3, :n] = self._flat_rows(seq_p, start, n)
            parts.append(pf.reshape(-1))
            max_len = max(max_len, start + n)
            if pf_chunk.is_last:
                covered.add(seq_p.request.request_id)
                end_pos[seq_p.slot] = start + n
        dev = self._upload(np.concatenate(parts))
        ctx_pad = self.ctx_bucket(max_len + t)
        greedy = bool(all(self._temps[q.slot] == 0 for q in seqs)
                      and (pf_chunk is None
                           or self._temps[pf_chunk.seq.slot] == 0))

        lr = dev[:6 * s_pad].view(6, s_pad)
        flat_dev = dev[6 * s_pad:(6 + t) * s_pad].view(t, s_pad)
        lane_slots = lr[3]
        tokens = torch.where(lr[5] == 1, self.last_toks[lane_slots], lr[0])
        positions, cache_len = lr[1], lr[2]
        lane_ids = torch.where(lane_slots < s,
                               torch.arange(s_pad, device=self.device),
                               torch.full_like(lane_slots, s_pad))
        # Lane state: the slots' own rows at the full frame (pad lanes'
        # counts updates drop), gathered copies otherwise.
        counts_l = self.counts[:s] if ident else self.counts[lane_slots]
        samp = self._sampling(lane_slots, lr[4] == 1)
        kv = self.kv
        f = kv.kv_heads * kv.head_dim
        n_layers = kv.k.shape[0]
        lc = lane_slots.clamp_max(s - 1)

        def region(cache, li):
            frame = cache[li].view(s, -1, f)
            return frame[:, :ctx_pad] if ident else frame[lc, :ctx_pad]

        win = {"k": torch.zeros((n_layers, t, s_pad, kv.kv_heads,
                                 kv.head_dim), dtype=kv.k.dtype,
                                device=self.device),
               "cache_len": cache_len,
               "k_lins": [region(kv.k, li) for li in range(n_layers)],
               "v_lins": [region(kv.v, li) for li in range(n_layers)]}
        win["v"] = torch.zeros_like(win["k"])
        steps_valid = torch.arange(t, device=self.device)
        pf_toks = pf_pos = None
        if p_rows:
            pfd = dev[(6 + t) * s_pad:].view(4, t, p_rows)
            pf_toks, pf_pos = pfd[0], pfd[2]
            psl = seq_p.slot
            win["pk"] = torch.zeros((n_layers, t, p_rows, kv.kv_heads,
                                     kv.head_dim), dtype=kv.k.dtype,
                                    device=self.device)
            win["pv"] = torch.zeros_like(win["pk"])
            win["pf"] = {
                "chunk_start": start, "valid_len": n,
                "k_ctx": [kv.k[li].view(s, -1, f)[psl, :ctx_pad]
                          for li in range(n_layers)],
                "v_ctx": [kv.v[li].view(s, -1, f)[psl, :ctx_pad]
                          for li in range(n_layers)]}
            last_t, last_j = (n - 1) // p_rows, (n - 1) % p_rows
        h_last = None
        steps = []
        for step in range(t):
            win["step"] = step
            win["valid"] = (steps_valid < step)[None, :].expand(s_pad, t)
            fwd_tok, fwd_pos = tokens, positions + step
            if p_rows:
                win["pf"]["positions"] = pf_pos[step]
                fwd_tok = torch.cat([tokens, pf_toks[step]])
                fwd_pos = torch.cat([fwd_pos, pf_pos[step]])
            h, win = decode_forward(
                self.params, self.model_cfg, kv, fwd_tok, fwd_pos, None,
                cache_len + step, None, ctx_pad=ctx_pad,
                inv_freq=self.inv_freq, win=win)
            if p_rows:
                if step == last_t:
                    h_last = h[s_pad + last_j:s_pad + last_j + 1]
                h = h[:s_pad]
            logits = logits_from_hidden(self.params, self.model_cfg, h)
            tokens = sample_step(logits, samp, counts_l, self.eos_mask,
                                 greedy_only=greedy,
                                 generator=self.generator)
            update_counts(counts_l, lane_ids, tokens)
            steps.append(tokens)
        all_toks = torch.stack(steps)                          # [T, s_pad]

        # ONE append for the whole window (the chunk's rows too).
        win_k, win_v, flat_all = win["k"], win["v"], flat_dev
        if p_rows:
            win_k = torch.cat([win_k, win["pk"]], dim=2)
            win_v = torch.cat([win_v, win["pv"]], dim=2)
            flat_all = torch.cat([flat_dev, pfd[3]], dim=1)
        append_window_kv(kv, win_k, win_v, flat_all)

        # Lane state back to the slots (pad lanes: the sink row).
        if not ident:
            self.counts.index_copy_(0, lane_slots, counts_l)
        self.last_toks.index_copy_(0, lane_slots, all_toks[t - 1])

        pf_tok = None
        if p_rows:
            # The chunk's prompt tokens count; when it ends the prompt,
            # its first token is sampled as the standalone prefill does,
            # after the lanes' scatters (the slot is never a lane).
            update_counts(self.counts,
                          torch.full_like(pfd[1], psl).reshape(-1),
                          pfd[1].reshape(-1))
            if pf_chunk.is_last:
                slot_t = lane_slots.new_full((1,), psl)
                min_act = torch.full(
                    (1,), seq_p.num_output_tokens
                    < seq_p.request.sampling.min_tokens,
                    dtype=torch.bool, device=self.device)
                logits_p = logits_from_hidden(self.params, self.model_cfg,
                                              h_last)
                tok_p = sample_step(logits_p,
                                    self._sampling(slot_t, min_act),
                                    self.counts[psl:psl + 1], self.eos_mask,
                                    greedy_only=greedy,
                                    generator=self.generator)
                update_counts(self.counts, slot_t, tok_p)
                self.last_toks[psl:psl + 1] = tok_p
                pf_tok = HostCopy(tok_p)
            self.mixed_windows += 1
        self.windows_by_bucket[s_pad] = self.windows_by_bucket.get(
            s_pad, 0) + 1
        self.decode_steps += t
        return DecodeWindow(
            seqs=list(seqs), covered=frozenset(covered),
            toks=HostCopy(all_toks), end_pos=end_pos, num_steps=t,
            lanes=lanes, s_pad=s_pad,
            pf_seq=pf_chunk.seq if pf_chunk is not None else None,
            pf_is_last=bool(pf_chunk is not None and pf_chunk.is_last),
            pf_tok=pf_tok)

    def sync_window(self, window: DecodeWindow) -> Dict[str, List[int]]:
        """A window's tokens per request id; waits for that window alone.
        A completed mixed-prefill chunk's sequence gets a list whose
        last entry is its first token."""
        host = window.toks.numpy()                            # [T, s_pad]
        out = {seq.request.request_id:
               host[:, window.lanes[seq.request.request_id]].tolist()
               for seq in window.seqs}
        if window.pf_tok is not None:
            out[window.pf_seq.request.request_id] = \
                [0] * (window.num_steps - 1) + [int(window.pf_tok.numpy()[0])]
        return out

    def run_decode_multi(self, seqs: List[Sequence], num_steps: int
                         ) -> Dict[str, List[int]]:
        """One window, waited for (the unpipelined loop)."""
        return self.sync_window(self.start_decode_window(seqs, num_steps))
