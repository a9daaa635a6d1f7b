"""ModelRunner: device state, batched prefill and fused decode windows.

Port of `ferrum_tpu/engine/runner.py` for the linear layout. The JAX
runner compiles one XLA program per (phase, bucket); PyTorch runs
eagerly, so each call here issues the kernels directly:

  run_prefill_batch   B sequences' chunks through one trunk pass (every
                      projection at m = B*T: the prefill GEMM kernel),
                      first tokens sampled on device, one host sync.
  run_decode_window   T decode steps over every slot of the frame (lane
                      == slot, m = num_slots: the decode GEMM kernel);
                      each step's sampled token feeds the next step on
                      the device, and the host syncs once per window.

Inactive slots ride the frame with their KV writes dropped (flat slot =
OOB_SENTINEL) and their tokens ignored. CUDA graphs per bucket, the
mixed prefill-in-window and the dispatch-ahead pipeline of the JAX
runner are later slices.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..config import EngineConfig
from ..models.configs import ModelConfig
from ..models.llama_family import (
    OOB_SENTINEL, ModelParams, PagedKvCache, decode_forward,
    logits_from_hidden, make_inv_freq, prefill_forward_batched)
from ..sampling.device import SlotSamplingParams, sample_step, update_counts
from ..scheduler.continuous import PrefillChunk
from ..scheduler.sequence import Sequence


def _round_up_pow2(x: int, lo: int, hi: int) -> int:
    x = max(x, lo)
    return min(1 << (x - 1).bit_length(), hi)


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
        self.counts = torch.zeros((s, v), dtype=torch.int32, device=device)
        self.samp = {
            "temps": torch.zeros(s, dtype=torch.float32, device=device),
            "top_ks": torch.zeros(s, dtype=torch.int64, device=device),
            "top_ps": torch.ones(s, dtype=torch.float32, device=device),
            "pens": torch.ones(s, dtype=torch.float32, device=device),
        }
        self._temps = np.zeros(s, np.float32)      # host mirror (greedy)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(engine_cfg.seed)
        # Linear layout: slot s owns blocks [s*max_pages, (s+1)*max_pages).
        self.tables = (torch.arange(s, device=device)[:, None]
                       * self.max_pages
                       + torch.arange(self.max_pages, device=device)[None])
        self.inv_freq = make_inv_freq(model_cfg, device)
        self.eos_mask = torch.zeros(v, dtype=torch.bool, device=device)
        self.eos_mask[list(model_cfg.eos_token_ids)] = True

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(arr).to(self.device)

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

    def chunk_bucket(self, t: int) -> int:
        # A page multiple (whole-page appends).
        lo = max(8, self.page, min(64, self.cfg.prefill_chunk_size))
        return _round_up_pow2(t, lo, max(self.cfg.prefill_chunk_size, lo))

    def _sampling(self, slots: torch.Tensor, min_active: np.ndarray):
        return SlotSamplingParams(
            self.samp["temps"][slots], self.samp["top_ks"][slots],
            self.samp["top_ps"][slots], self.samp["pens"][slots],
            self._upload(min_active))

    # ------------------------------------------------------------------
    def run_prefill_batch(self, chunks: List[PrefillChunk]) -> np.ndarray:
        """One trunk pass over every chunk; returns the token sampled at
        each chunk's last position (meaningful for final chunks)."""
        b = len(chunks)
        t_pad = self.chunk_bucket(max(len(c.tokens) for c in chunks))
        ctx_pad = max(self.ctx_bucket(c.start + len(c.tokens))
                      for c in chunks)
        # int rows: tokens, positions (pads past the context), flat slots
        # (pads dropped); per-row scalars: slot, last index, total length.
        packed = np.zeros((3, b, t_pad), np.int64)
        packed[1] = self.cfg.max_model_len + ctx_pad
        packed[2] = OOB_SENTINEL
        scal = np.zeros((3, b), np.int64)
        min_active = np.zeros(b, bool)
        is_last = np.zeros(b, bool)
        count_slots, count_toks = [], []
        for i, c in enumerate(chunks):
            seq = c.seq
            n = len(c.tokens)
            total = c.start + n
            packed[0, i, :n] = c.tokens
            packed[1, i, :n] = np.arange(c.start, total)
            packed[2, i, :n] = [seq.blocks.flat_slot(p)
                                for p in range(c.start, total)]
            scal[:, i] = (seq.slot, n - 1, total)
            min_active[i] = (seq.num_output_tokens
                             < seq.request.sampling.min_tokens)
            is_last[i] = c.is_last
            count_slots += [seq.slot] * n
            count_toks += c.tokens
        dev = self._upload(packed)
        sc = self._upload(scal)
        slots = sc[0]
        h, _ = prefill_forward_batched(
            self.params, self.model_cfg, self.kv, dev[0], dev[1],
            self.tables[slots], sc[2], dev[2], ctx_pad=ctx_pad,
            inv_freq=self.inv_freq)
        update_counts(self.counts,
                      self._upload(np.asarray(count_slots, np.int64)),
                      self._upload(np.asarray(count_toks, np.int64)))
        hs = h[torch.arange(b, device=self.device), sc[1]]      # [B, H]
        logits = logits_from_hidden(self.params, self.model_cfg, hs)
        greedy = bool(all(self._temps[c.seq.slot] == 0 for c in chunks))
        toks = sample_step(logits, self._sampling(slots, min_active),
                           self.counts[slots], self.eos_mask,
                           greedy_only=greedy, generator=self.generator)
        last = np.nonzero(is_last)[0]
        if len(last):
            rows = self._upload(last)
            update_counts(self.counts, slots[rows], toks[rows])
        return toks.cpu().numpy()

    # ------------------------------------------------------------------
    def run_decode_window(self, seqs: List[Sequence],
                          num_steps: int) -> Dict[str, List[int]]:
        """`num_steps` decode steps for `seqs` (lane == slot); returns
        each request's sampled tokens (callers drop the overshoot past a
        finish). One host sync for the whole window."""
        s = self.num_slots
        # rows: tokens, positions, context lens, position limit (region
        # capacity), active flag, min_tokens active
        packed = np.zeros((6, s), np.int64)
        packed[2] = 1
        for seq in seqs:
            sl = seq.slot
            pos = seq.next_position()
            packed[:, sl] = (seq.all_tokens[-1], pos, pos + 1,
                             len(seq.blocks.blocks) * self.page, 1,
                             int(seq.num_output_tokens
                                 < seq.request.sampling.min_tokens))
        max_len = int(packed[2].max())
        ctx_pad = self.ctx_bucket(max_len + num_steps)
        dev = self._upload(packed)
        tokens, positions, ctx_lens = dev[0], dev[1].clone(), dev[2].clone()
        active = dev[4] == 1
        pos_limit = dev[3]
        lanes = self._upload(np.asarray([q.slot for q in seqs], np.int64))
        slot_ids = torch.arange(s, device=self.device)
        samp = SlotSamplingParams(self.samp["temps"], self.samp["top_ks"],
                                  self.samp["top_ps"], self.samp["pens"],
                                  dev[5] == 1)
        greedy = bool(all(self._temps[q.slot] == 0 for q in seqs))
        steps = []
        for _ in range(num_steps):
            page_idx = torch.div(positions, self.page,
                                 rounding_mode="floor").clamp_max(
                                     self.max_pages - 1)
            flat = self.tables[slot_ids, page_idx] * self.page \
                + positions % self.page
            flat = torch.where(active & (positions < pos_limit), flat,
                               torch.full_like(flat, OOB_SENTINEL))
            h, _ = decode_forward(
                self.params, self.model_cfg, self.kv, tokens, positions,
                self.tables, ctx_lens, flat, ctx_pad=ctx_pad,
                inv_freq=self.inv_freq)
            logits = logits_from_hidden(self.params, self.model_cfg, h)
            tokens = sample_step(logits, samp, self.counts, self.eos_mask,
                                 greedy_only=greedy,
                                 generator=self.generator)
            update_counts(self.counts, lanes, tokens[lanes])
            steps.append(tokens)
            positions = positions + 1
            ctx_lens = ctx_lens + 1
        host = torch.stack(steps).cpu().numpy()               # [T, S]
        return {q.request.request_id: host[:, q.slot].tolist()
                for q in seqs}
