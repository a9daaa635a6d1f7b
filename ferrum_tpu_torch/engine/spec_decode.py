"""Speculative decoding: one round a dispatch, draft and verify on the card.

Port of `ferrum_tpu/engine/spec_decode.py`. A round replaces a decode
window for the engine's plain sequences and runs over all `num_slots`
lanes (lane = slot; a lane with no sequence is a dead lane: its writes
go to OOB_SENTINEL and its outputs are dropped):

  1. draft: K+1 chained `decode_forward` steps of the draft model on
     its own cache (`draft_kv`, the target's block geometry and KV
     dtype, read through the target's block tables). They propose
     d_1..d_K; the +1 step writes d_K's K/V, so the next round needs
     no catch-up pass. The draft's repetition penalty is 1; on sampled
     rounds each step's distribution q comes from `processed_probs`.
  2. verify: the target scores [t_last, d_1..d_K] at K+1 positions in
     one `prefill_forward_batched(append="rows")` pass (every
     projection at m = S*(K+1); the L*S*(K+1) K/V rows in one
     `kv_append_rows` launch), then `logits_from_hidden` over the rows.
  3. accept/reject on the card: greedy rounds take the target argmax
     with a cumprod prefix; sampled ones accept d_i while u*q < p, draw
     the first rejection's token from the residual max(0, p - q) (from
     p where the residual sums to <= 1e-9) and, when all K are
     accepted, the bonus token from p[K].
  4. state: repetition counts for the accepted tokens, the carry (next
     token and position) that round R+1 reads before round R is
     fetched, and on a guided round each lane's FSM state advanced
     along its accepted tokens.

Nothing in a round waits for the card (it runs under the runner's
`sync_guard`); the accepted tokens [S, K+1] and their counts [S] come
back through one `HostCopy`.

Randomness: the port has no threefry. Unseeded lanes draw the draft's
noise, the accept uniforms and the residual noise from the engine's
`torch.Generator`; a seeded request's lanes draw all three from the
counter-based hash of `seeded_gumbel` / `seeded_uniform`, keyed on
(seed, position of the token drawn, draw kind, rank), so its tokens do
not depend on the batch or the slot.

Guided requests compose as in the JAX round: the draft samples under
the FSM mask advanced along its own proposals; verify position i is
masked with the state after d_1..d_i; Leviathan accept/reject over the
masked p and q keeps the masked target law. The runner's stacked tables
and queued slot resets are used as a window uses them.

Kept from the JAX round, its faults included (ROADMAP Queue 3):
  - min_tokens is not applied: no draft step and no verify position
    masks EOS, so a request with min_tokens can get EOS as an ordinary
    token inside its first min_tokens tokens, where the plain engine
    masks it. This changes the output.
  - The repetition counts are frozen at the round's start.
  - The draft cache is written by rounds only, never prefilled with
    the prompt, so the draft attends to zero or stale rows at prompt
    positions. This lowers acceptance and leaves the output law as it
    is.
Rejected positions' K/V rows are overwritten by the next round
(positions only move forward).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models.configs import ModelConfig
from ..models.llama_family import (OOB_SENTINEL, ModelParams, PagedKvCache,
                                   decode_forward, logits_from_hidden,
                                   make_inv_freq, make_local_inv_freq,
                                   prefill_forward_batched)
from ..sampling.device import (DRAW_ACCEPT, DRAW_DRAFT, DRAW_RESIDUAL,
                               SlotSamplingParams, gumbel_noise,
                               guided_advance, guided_mask_rows, lane_noise,
                               processed_probs, sample_step, seeded_gumbel,
                               seeded_uniform, update_counts)
from ..scheduler.sequence import Sequence
from ..utils import profile as _prof
from .runner import HostCopy
from .speculative import SpeculativeStats

PAD_TOKEN = -1


@dataclass
class SpecWindow:
    """A dispatched round whose tokens have not been read."""

    seqs: List[Sequence]
    covered: frozenset                # request ids riding this round
    result: HostCopy                  # int64 [S, K+2]: tokens, PAD past
                                      # the count; the count (1..K+1)
    lanes: Dict[str, int]             # request id -> lane (its slot)
    carry_tok: torch.Tensor           # int64 [S] next input token
    carry_pos: torch.Tensor           # int64 [S] its position
    num_steps: int                    # K+1 (most tokens a lane a round)
    # Paged layout: sequences that finished while this round could
    # still write their blocks; released when it is read.
    deferred: List[Sequence] = field(default_factory=list)


class SpecDecoder:
    """The draft model's weights and cache beside a ModelRunner (the
    target), and the rounds. The draft shares the target's block tables,
    so one allocation covers both caches."""

    def __init__(self, runner, draft_cfg: ModelConfig,
                 draft_params: ModelParams, k: int):
        self.runner = runner
        self.draft_cfg = draft_cfg
        self.draft_params = draft_params
        self.k = int(k)
        kv = runner.kv
        dev = runner.device
        self.draft_kv = PagedKvCache.create(draft_cfg, kv.num_blocks,
                                            kv.page, dtype=kv.k.dtype,
                                            device=dev)
        self.inv_freq = make_inv_freq(draft_cfg, dev)
        self.inv_freq_local = make_local_inv_freq(draft_cfg, dev)
        s = runner.num_slots
        # Linear layout: the identity tables of every slot.
        self._ident = runner._tables(torch.arange(s, device=dev))
        self._keys: set = set()
        self.stats = SpeculativeStats()
        self.rounds = 0

    # ------------------------------------------------------------------
    def start_round(self, seqs: List[Sequence],
                    prev: Optional[SpecWindow] = None) -> SpecWindow:
        """Dispatch one round for `seqs` without waiting for it. A
        sequence `prev` (the round in flight) covered takes its input
        token and position from prev's carry on the card."""
        r = self.runner
        t0 = time.perf_counter()
        with r.sync_guard():
            window = self._round(seqs, prev)
        dt = time.perf_counter() - t0
        r.decode_device_time += dt
        self.rounds += 1
        _prof.emit("window.dispatch", dt, {
            "steps": self.k + 1, "lanes": len(seqs), "bucket": r.num_slots,
            "p_rows": 0, "spec": True})
        r._note_kernel_builds()
        return window

    def _round(self, seqs: List[Sequence],
               prev: Optional[SpecWindow]) -> SpecWindow:
        r = self.runner
        s, k, page = r.num_slots, self.k, r.page
        v = r.model_cfg.vocab_size
        dev = r.device
        paged = r.attn_impl == "ref"
        # Lane rows: input token, its position, the position limit (the
        # blocks reserved), the slot (s: a dead lane), from the carry.
        packed = np.zeros((5, s), np.int64)
        packed[3] = s
        max_len = 2
        lanes: Dict[str, int] = {}
        for seq in seqs:
            sl = seq.slot
            rid = seq.request.request_id
            lanes[rid] = sl
            if prev is not None and rid in prev.covered:
                packed[4, sl] = 1
                hint = seq.total_tokens - 1 + 2 * (k + 1)
            else:
                packed[0, sl] = seq.all_tokens[-1]
                packed[1, sl] = seq.next_position()
                hint = packed[1, sl] + k + 1
            packed[2, sl] = len(seq.blocks.blocks) * page
            packed[3, sl] = sl
            max_len = max(max_len, int(hint))
        parts = [packed]
        if paged:
            tab = np.zeros((s, r.max_pages), np.int64)
            for seq in seqs:
                ids = seq.blocks.blocks
                tab[seq.slot, :len(ids)] = ids
            parts.append(tab)
        ctx_pad = r.ctx_bucket(max_len + k + 1)
        greedy = bool(all(r._temps[q.slot] == 0 for q in seqs))
        guided = any(q.guided_fsm_offset is not None for q in seqs)
        seeded = not greedy and any(r._seeded[q.slot] for q in seqs)
        grows = 0
        if guided:
            gtrans, gmask, gcps, grows = r._guided_tables()
            parts.append(r._ginit_row(drain=True))
        views = r._upload_rows(parts)
        r._note_key(self._keys, "spec", (ctx_pad, k, greedy, guided, grows))

        pk = views[0].view(5, s)
        tok0, pos0 = pk[0], pk[1]
        if prev is not None:
            carry = pk[4] == 1
            tok0 = torch.where(carry, prev.carry_tok, tok0)
            pos0 = torch.where(carry, prev.carry_pos, pos0)
        pos_limit, lane_slots = pk[2], pk[3]
        live = lane_slots < s
        tables = views[1].view(s, r.max_pages) if paged else self._ident

        def flat_for(pos: torch.Tensor) -> torch.Tensor:
            """Flat cache slots of positions [S, n] through the lanes'
            tables; OOB past the position limit and on dead lanes."""
            blk = torch.gather(tables, 1,
                               (pos // page).clamp(0, r.max_pages - 1))
            ok = (pos < pos_limit[:, None]) & live[:, None]
            return torch.where(ok, blk * page + pos % page,
                               torch.full_like(pos, OOB_SENTINEL))

        samp = r.samp
        temps = samp["temps"][lane_slots]
        top_ks, top_ps = samp["top_ks"][lane_slots], samp["top_ps"][lane_slots]
        # min_tokens is not applied in a round, as in the JAX round: a
        # fault of the reference (ROADMAP Queue 3).
        no_min = torch.zeros(s, dtype=torch.bool, device=dev)
        sp_draft = SlotSamplingParams(temps, top_ks, top_ps,
                                      torch.ones_like(temps), no_min)
        counts_l = r.counts[lane_slots]
        seeds = samp["seeds"][lane_slots]
        own = samp["seeded"][lane_slots]
        st0 = None
        if guided:
            # Queued resets first; dead lanes read the sink, FREE.
            r._drain_ginit(views[-1])
            st0 = r.gstates[lane_slots]

        # --- 1. draft: K+1 chained steps (the +1 writes d_K's K/V) ---
        tok, pos, st = tok0, pos0, st0
        d_toks: List[torch.Tensor] = []
        q_steps: List[torch.Tensor] = []
        st_steps: List[torch.Tensor] = []
        for j in range(k + 1):
            h, _ = decode_forward(
                self.draft_params, self.draft_cfg, self.draft_kv, tok, pos,
                tables, pos + 1, flat_for(pos[:, None])[:, 0],
                ctx_pad=ctx_pad, inv_freq=self.inv_freq,
                inv_freq_local=self.inv_freq_local, attn_impl=r.attn_impl)
            logits = logits_from_hidden(self.draft_params, self.draft_cfg, h)
            mask = guided_mask_rows(gmask, st, v) if guided else None
            noise = lane_noise(lane_slots, pos + 1, samp["seeds"],
                               samp["seeded"], v, r.generator,
                               kind=DRAW_DRAFT) if seeded else None
            nxt = sample_step(logits, sp_draft, counts_l, r.eos_mask,
                              greedy_only=greedy, generator=r.generator,
                              noise=noise, allowed_mask=mask)
            if not greedy and j < k:
                q_steps.append(processed_probs(logits, sp_draft, counts_l,
                                               r.eos_mask, allowed_mask=mask))
            if guided:
                # The PRE-advance state: verify position j's mask.
                st_steps.append(st)
                st = guided_advance(gtrans, gcps, st, nxt)
            d_toks.append(nxt)
            tok, pos = nxt, pos + 1
        drafts = torch.stack(d_toks[:k], dim=1)                 # [S, K]

        # --- 2. verify: the target scores K+1 positions in one pass ---
        offs = torch.arange(k + 1, device=dev)
        tokens_t = torch.cat([tok0[:, None], drafts], dim=1)   # [S, K+1]
        positions_t = pos0[:, None] + offs[None, :]
        h, _ = prefill_forward_batched(
            r.params, r.model_cfg, r.kv, tokens_t, positions_t, tables,
            pos0 + k + 1, flat_for(positions_t), ctx_pad=ctx_pad,
            inv_freq=r.inv_freq, inv_freq_local=r.inv_freq_local,
            attn_impl=r.attn_impl, append="rows")
        logits_t = logits_from_hidden(
            r.params, r.model_cfg, h.reshape(s * (k + 1), -1)
        ).reshape(s, k + 1, v)

        # --- 3. accept/reject on the card ---
        if guided:
            masks = torch.stack([guided_mask_rows(gmask, st_i, v)
                                 for st_i in st_steps], dim=1)
            logits_t = torch.where(masks, logits_t, float("-inf"))
        if greedy:
            tgt = torch.argmax(logits_t, dim=-1)                # [S, K+1]
            accept = tgt[:, :k] == drafts
            n = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)
            # The correction and the bonus are both the argmax at n.
            extra = torch.gather(tgt, 1, n[:, None])[:, 0]
        else:
            extra, n = self._accept_sampled(
                logits_t, drafts, torch.stack(q_steps, dim=1), counts_l,
                SlotSamplingParams(temps, top_ks, top_ps,
                                   samp["pens"][lane_slots], no_min),
                pos0, seeds, own, seeded)

        # out[:, i] = d_{i+1} while i < n, the corrected / bonus token at
        # i == n, PAD beyond.
        d_cols = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
        pos_i = offs[None, :]
        out = torch.where(pos_i < n[:, None], d_cols,
                          torch.where(pos_i == n[:, None], extra[:, None],
                                      torch.full_like(d_cols, PAD_TOKEN)))

        # --- 4. state: counts of the accepted tokens; the carry ---
        safe = torch.where(pos_i <= n[:, None], out,
                           torch.full_like(out, v))
        update_counts(r.counts, lane_slots[:, None].expand_as(safe), safe)
        n_out = n + 1
        if guided:
            # Each lane's FSM along its accepted tokens, back to its slot
            # (dead lanes: FREE, which loops, back to the sink).
            st = st0
            for j in range(k + 1):
                stepped = guided_advance(gtrans, gcps, st,
                                         out[:, j].clamp(0, v - 1))
                st = torch.where(j < n_out, stepped, st)
            r.gstates.index_copy_(0, lane_slots, st)
        return SpecWindow(
            seqs=list(seqs), covered=frozenset(lanes), lanes=lanes,
            result=HostCopy(torch.cat([out, n_out[:, None]], dim=1)),
            carry_tok=extra, carry_pos=pos0 + n_out, num_steps=k + 1)

    def _accept_sampled(self, logits_t, drafts, q_skv, counts_l, sp_target,
                        pos0, seeds, own, seeded):
        """Leviathan accept/reject over the target's distributions p
        [S, K+1, V] (processed_probs, the round's counts) and the draft's
        q [S, K, V] → (the correction or bonus token [S], accepted
        proposals n [S])."""
        r = self.runner
        s, k1, v = logits_t.shape
        k = k1 - 1
        dev = logits_t.device

        def rep(x):
            return x.repeat_interleave(k1, dim=0)

        p_full = processed_probs(
            logits_t.reshape(s * k1, v),
            SlotSamplingParams(*(rep(x) for x in sp_target)),
            rep(counts_l), r.eos_mask).view(s, k1, v)
        p_d = torch.gather(p_full[:, :k], 2, drafts[:, :, None])[:, :, 0]
        q_d = torch.gather(q_skv, 2, drafts[:, :, None])[:, :, 0]
        u = torch.rand((s, k), generator=r.generator, device=dev)
        if seeded:
            at = pos0[:, None] + 1 + torch.arange(k, device=dev)[None, :]
            u_own = seeded_uniform(seeds.repeat_interleave(k), at.reshape(-1),
                                   1, DRAW_ACCEPT).view(s, k)
            u = torch.where(own[:, None], u_own, u)
        accept = u * q_d < p_d
        n = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)
        # The residual at the first rejected position; on full acceptance
        # row K selects the bonus distribution p[K] with q = 0.
        q_pad = torch.cat([q_skv, torch.zeros_like(q_skv[:, :1])], dim=1)
        at_n = n[:, None, None].expand(s, 1, v)
        p_n = torch.gather(p_full, 1, at_n)[:, 0]
        q_n = torch.gather(q_pad, 1, at_n)[:, 0]
        res = (p_n - q_n).clamp_min(0.0)
        # A degenerate residual (p ~ q): draw from p itself.
        res = torch.where(res.sum(dim=-1, keepdim=True) > 1e-9, res, p_n)
        g = gumbel_noise((s, v), r.generator, dev)
        if seeded:
            g = torch.where(own[:, None],
                            seeded_gumbel(seeds, pos0 + 1 + n, v,
                                          DRAW_RESIDUAL), g)
        logres = torch.where(res > 0, torch.log(res),
                             torch.full_like(res, float("-inf")))
        return torch.argmax(logres + g, dim=-1), n

    # ------------------------------------------------------------------
    def sync_round(self, window: SpecWindow) -> Dict[str, List[int]]:
        """A round's accepted tokens per request id (one wait, on this
        round's copy alone); the stats count every lane of the round, as
        the JAX package's do."""
        r = self.runner
        t0 = time.perf_counter()
        host = window.result.numpy()                         # [S, K+2]
        dt = time.perf_counter() - t0
        r.decode_sync_time += dt
        _prof.emit("window.fetch", dt, {
            "steps": window.num_steps, "lanes": len(window.seqs)})
        out: Dict[str, List[int]] = {}
        for seq in window.seqs:
            rid = seq.request.request_id
            row = host[window.lanes[rid]]
            n = int(row[-1])
            out[rid] = row[:n].tolist()
            self.stats.proposals += 1
            self.stats.drafted_tokens += self.k
            self.stats.accepted_tokens += n - 1
        return out
