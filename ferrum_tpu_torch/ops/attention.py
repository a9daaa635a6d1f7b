"""Deferred-append attention over the KV cache's flat layout, and the
paged layout's gather-based reference forms.

Port of `ferrum_tpu/ops/attention.py`: `flat_decode_attention` (with its
decode-window terms and int8 KV), `flat_prefill_window_attention`,
`flat_prefill_attention`, and the paged layout's `gather_kv`,
`paged_decode_attention_ref` and `paged_prefill_attention_ref`, each
with a sliding window and a logit softcap. They are plain XLA in the
JAX package, so they are plain PyTorch here.

Sliding window `sw`, as the JAX package masks it: a decode query at
context length `ctx` sees the cached positions >= ctx - sw (its own
token always); a prefill query at position p the keys at positions
> p - sw. The one departure: a decode window's in-window terms (the
tokens of its earlier steps, not cached yet) are windowed like the
history, where the JAX package lets every one of them in (ROADMAP
Queue 3). The two agree while a window's steps stay within sw, as they
do at every published window; the port's window form then also equals
its per-step form at any length.

Softcap `cap`: scores -> cap * tanh(scores / cap) after the scale (and
an int8 cache's k_scale), before the mask.

INT8 KV: the cache holds int8 values with f32 scales per (token, kv
head). A scale is constant within a head's F segment and each masked q
row meets one segment, so the dequant commutes out of both products:
scores *= k_scale after q.K, probabilities *= v_scale before x V. The
tokens not cached yet (this step's, a window's, a chunk's) stay in full
precision with a scale of 1.

Layout: the cache is flat [C, F] per sequence with F = Hkv * D. A q
head is masked into its own kv head's lane block ("masked q", [.., Hq,
F]) so one batched product against the flat cache yields every head's
scores with no cache reshape or copy; the JAX package's design.

Precision, as the JAX package's preferred_element_type=f32: the score
product q.K and the probabilities x V product take bf16 (or f32)
operands and return their f32 sums unrounded; softmax runs in f32, and
the probabilities are rounded to the operand dtype before the V product.
"""

from __future__ import annotations

from typing import Optional

import torch

from .linear import matmul_f32

NEG_INF = -1e30


def _mask_q_flat(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """q [..., Hq, D] → block-diagonal [..., Hq, Hkv*D]."""
    *lead, hq, d = q.shape
    rep = hq // hkv
    sel = (torch.arange(hq, device=q.device)[:, None] // rep
           == torch.arange(hkv, device=q.device)[None, :])     # [Hq, Hkv]
    qt = torch.where(sel[:, :, None], q[..., :, None, :],
                     torch.zeros((), dtype=q.dtype, device=q.device))
    return qt.reshape(*lead, hq, hkv * d)


def _unmask_out_flat(out_all: torch.Tensor, hq: int, hkv: int,
                     d: int) -> torch.Tensor:
    """out_all [..., Hq, Hkv*D] → [..., Hq, D] (each head's own block)."""
    *lead, _, _ = out_all.shape
    rep = hq // hkv
    o4 = out_all.reshape(*lead, hq, hkv, d)
    head = torch.arange(hq, device=out_all.device) // rep          # [Hq]
    idx = head.view(*([1] * len(lead)), hq, 1, 1).expand(*lead, hq, 1, d)
    return torch.gather(o4, -2, idx).squeeze(-2)


def _head_scales(scale: torch.Tensor, rep: int) -> torch.Tensor:
    """Scales [..., C, Hkv] → per q head [..., Hq, C]."""
    return scale.transpose(-1, -2).repeat_interleave(rep, dim=-2)


def _dequant_operand(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An int8 cache operand in the product's dtype (values, unscaled)."""
    return x.to(dtype) if x.dtype == torch.int8 else x


def _maybe_softcap(scores: torch.Tensor, cap: Optional[float]
                   ) -> torch.Tensor:
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def flat_decode_attention(
    q: torch.Tensor,              # [S, Hq, D]
    k_flat: torch.Tensor,         # [S, C, F] slot-contiguous cache view
    v_flat: torch.Tensor,
    context_lens: torch.Tensor,   # int [S] incl. the current token
    k_self: torch.Tensor,         # [S, Hkv, D] this step's K (not cached)
    v_self: torch.Tensor,
    *,
    hkv: int,
    scale: float,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
    k_win: Optional[torch.Tensor] = None,     # [W, S, Hkv, D] in-window K
    v_win: Optional[torch.Tensor] = None,
    win_valid: Optional[torch.Tensor] = None,  # bool [S, W]
    cache_len: Optional[torch.Tensor] = None,  # int [S] the cache's lens
    k_scale: Optional[torch.Tensor] = None,   # f32 [S, C, Hkv] (int8 KV)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Decode attention: the cached history (positions < len - 1) plus the
    current token as an explicit self term (its K/V are appended after
    the step). In a decode window the cache is frozen at `cache_len`
    (history < cache_len - 1), and the tokens generated earlier in the
    window, not cached yet, join as the `win_valid` rows of k_win/v_win:
    their scores extend the history's, under one softmax (one mask, max
    and sum over both, where the JAX package takes three of each).
    With a sliding window, the history and the window's rows before
    position len - sw drop out (module docstring)."""
    s, hq, d = q.shape
    ctx_pad = k_flat.shape[1]
    rep = hq // hkv
    qf = (q.to(torch.float32) * scale).to(q.dtype)
    qt = _mask_q_flat(qf, hkv)                               # [S, Hq, F]
    scores = matmul_f32(qt, _dequant_operand(k_flat, qt.dtype)
                        .transpose(1, 2))                    # [S, Hq, C]
    if k_scale is not None:
        scores = scores * _head_scales(k_scale, rep)
    hist_src = context_lens if cache_len is None else cache_len
    hist_len = hist_src.to(torch.int64)[:, None] - 1
    pos = torch.arange(ctx_pad, device=q.device)[None, :]
    valid = pos < hist_len
    if k_win is not None:
        kw = k_win.movedim(0, 1).reshape(s, -1, hkv * d).to(qt.dtype)
        scores = torch.cat([scores, matmul_f32(qt, kw.transpose(1, 2))],
                           dim=-1)                           # [S, Hq, C+W]
        # Window row j holds the token at position cache_len - 1 + j.
        pos = torch.cat([pos.expand(s, ctx_pad), hist_len + torch.arange(
            k_win.shape[0], device=q.device)[None, :]], dim=-1)
        valid = torch.cat([valid, win_valid], dim=-1)
    if sliding_window is not None:
        valid = valid & (pos >= context_lens.to(torch.int64)[:, None]
                         - sliding_window)
    scores = _maybe_softcap(scores, softcap)
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    self_sc = _maybe_softcap(matmul_f32(
        qt, k_self.reshape(s, hkv * d, 1))[..., 0], softcap)  # [S, Hq]

    m = torch.maximum(torch.amax(scores, dim=-1), self_sc)
    e_hist = torch.exp(scores - m[:, :, None])
    e_self = torch.exp(self_sc - m)
    denom = torch.sum(e_hist, dim=-1) + e_self
    p_all = e_hist / denom[:, :, None]
    p_hist = p_all[..., :ctx_pad]
    if v_scale is not None:
        p_hist = p_hist * _head_scales(v_scale, rep)
    out_all = matmul_f32(p_hist.to(qt.dtype),
                         _dequant_operand(v_flat, qt.dtype))  # [S, Hq, F]
    if k_win is not None:
        vw = v_win.movedim(0, 1).reshape(s, -1, hkv * d).to(qt.dtype)
        out_all = out_all + matmul_f32(p_all[..., ctx_pad:].to(qt.dtype),
                                       vw)
    out = _unmask_out_flat(out_all, hq, hkv, d)
    v_rep = torch.repeat_interleave(v_self.to(torch.float32), rep, dim=1)
    out = out + (e_self / denom)[:, :, None] * v_rep
    return out.to(q.dtype)


def flat_prefill_window_attention(
    q: torch.Tensor,              # [P, Hq, D] step-t block of one chunk
    k_ctx: torch.Tensor,          # [C, F] the slot's region (prefix)
    v_ctx: torch.Tensor,
    ctx_len: int,                 # tokens of the region before the chunk
    win_k: torch.Tensor,          # [T, P, Hkv, D] the chunk's window K
    win_v: torch.Tensor,
    step: int,                    # blocks of steps < step are visible
    chunk_start: int,             # position of window row 0
    valid_len: int,               # real rows of the chunk
    k_new: torch.Tensor,          # [P, Hkv, D] this block's K
    v_new: torch.Tensor,
    q_positions: torch.Tensor,    # int [P] (pad rows: large, increasing)
    *,
    hkv: int,
    scale: float,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # f32 [C, Hkv] (int8 KV)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked-prefill attention of a P-row block riding a decode window
    (mixed prefill-in-window): one softmax over the slot's cached prefix
    (< ctx_len), the chunk's blocks of earlier steps (not cached yet)
    and the block itself, causally. Pad rows with no valid key get a
    uniform softmax, as in the JAX package."""
    p, hq, d = q.shape
    c_pad = k_ctx.shape[0]
    t_steps = win_k.shape[0]
    f = hkv * d
    rep = hq // hkv
    dev = q.device
    qf = (q.to(torch.float32) * scale).to(q.dtype)
    qt = _mask_q_flat(qf, hkv)                               # [P, Hq, F]
    k_all = torch.cat([k_ctx.to(qt.dtype),
                       win_k.reshape(t_steps * p, f).to(qt.dtype),
                       k_new.reshape(p, f).to(qt.dtype)])    # [C+T*P+P, F]
    v_all = torch.cat([v_ctx.to(qt.dtype),
                       win_v.reshape(t_steps * p, f).to(qt.dtype),
                       v_new.reshape(p, f).to(qt.dtype)])
    c_iota = torch.arange(c_pad, device=dev)
    w_idx = torch.arange(t_steps * p, device=dev)
    qpos = q_positions.to(torch.int64)
    kpos = torch.cat([c_iota, chunk_start + w_idx, qpos])
    valid_base = torch.cat([c_iota < ctx_len,
                            (w_idx < step * p) & (w_idx < valid_len),
                            qpos < chunk_start + valid_len])
    valid = valid_base[None, :] & (kpos[None, :] <= qpos[:, None])
    if sliding_window is not None:
        valid = valid & (kpos[None, :] > qpos[:, None] - sliding_window)
    scores = matmul_f32(qt.reshape(1, p * hq, f),
                        k_all.t()[None])[0].reshape(p, hq, -1)
    ones = torch.ones(t_steps * p + p, hkv, dtype=torch.float32, device=dev)
    if k_scale is not None:
        scores = scores * _head_scales(torch.cat([k_scale, ones]), rep)
    scores = _maybe_softcap(scores, softcap)
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    any_valid = valid.any(dim=-1)
    scores = torch.where(any_valid[:, None, None], scores, 0.0)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * _head_scales(torch.cat([v_scale, ones]), rep)
    probs = probs.to(qt.dtype)
    out_all = matmul_f32(probs.reshape(1, p * hq, -1), v_all[None])[0]
    out = _unmask_out_flat(out_all.reshape(p, hq, f), hq, hkv, d)
    return out.to(q.dtype)


def flat_prefill_attention(
    q: torch.Tensor,              # [(B,) T, Hq, D] one chunk per sequence
    k_flat: torch.Tensor,         # [(B,) C, F] slot region (prefix only)
    v_flat: torch.Tensor,
    q_positions: torch.Tensor,    # int [(B,) T]
    total_len: torch.Tensor,      # int [(B,)] prefix + real chunk tokens
    k_new: torch.Tensor,          # [(B,) T, Hkv, D] chunk K (not cached)
    v_new: torch.Tensor,
    *,
    hkv: int,
    scale: float,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
    k_scale: Optional[torch.Tensor] = None,   # f32 [(B,) C, Hkv] (int8)
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Chunked-prefill attention: the chunk attends to the cached prefix
    (positions < total_len - real chunk tokens) and to itself causally.
    Takes one sequence or a leading batch of B sequences (the JAX
    package vmaps the one-sequence form)."""
    if q.dim() == 3:
        return flat_prefill_attention(
            q[None], k_flat[None], v_flat[None], q_positions[None],
            total_len.reshape(1), k_new[None], v_new[None], hkv=hkv,
            scale=scale, sliding_window=sliding_window, softcap=softcap,
            k_scale=None if k_scale is None else k_scale[None],
            v_scale=None if v_scale is None else v_scale[None])[0]
    b, t, hq, d = q.shape
    ctx_pad = k_flat.shape[1]
    rep = hq // hkv
    dev = q.device
    qf = (q.to(torch.float32) * scale).to(q.dtype)
    qt = _mask_q_flat(qf, hkv)                               # [B, T, Hq, F]
    k_flat = _dequant_operand(k_flat, qt.dtype)
    v_flat = _dequant_operand(v_flat, qt.dtype)
    k_all = torch.cat([k_flat, k_new.reshape(b, t, hkv * d)
                       .to(k_flat.dtype)], dim=1)            # [B, C+T, F]
    v_all = torch.cat([v_flat, v_new.reshape(b, t, hkv * d)
                       .to(v_flat.dtype)], dim=1)
    qpos = q_positions.to(torch.int64)
    tl = total_len.to(torch.int64).reshape(b, 1)
    hist_len = tl - (qpos < tl).sum(dim=1, keepdim=True)     # [B, 1]
    iota = torch.arange(ctx_pad, device=dev)[None, :].expand(b, ctx_pad)
    kpos = torch.cat([iota, qpos], dim=1)                    # [B, C+T]
    valid_base = torch.cat([iota < hist_len, qpos < tl], dim=1)
    valid = valid_base[:, None, :] & (kpos[:, None, :] <= qpos[:, :, None])
    if sliding_window is not None:
        valid = valid & (kpos[:, None, :] > qpos[:, :, None] - sliding_window)
    scores = matmul_f32(qt.reshape(b, t * hq, hkv * d),
                        k_all.transpose(1, 2)).reshape(b, t, hq, -1)
    ones = torch.ones(b, t, hkv, dtype=torch.float32, device=dev)
    if k_scale is not None:
        scores = scores * _head_scales(
            torch.cat([k_scale, ones], dim=1), rep)[:, None]
    scores = _maybe_softcap(scores, softcap)
    scores = torch.where(valid[:, :, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * _head_scales(
            torch.cat([v_scale, ones], dim=1), rep)[:, None]
    probs = probs.to(qt.dtype)
    out_all = matmul_f32(probs.reshape(b, t * hq, -1), v_all)  # [B, T*Hq, F]
    out = _unmask_out_flat(out_all.reshape(b, t, hq, hkv * d), hq, hkv, d)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# The paged layout: block-table gathers (f32 reference math, as the JAX
# package's paged path)
# ---------------------------------------------------------------------------

def gather_kv(cache: torch.Tensor, block_tables: torch.Tensor,
              ctx_pad: int, page: int) -> torch.Tensor:
    """The first ctx_pad cached tokens of each sequence: cache [NB, page,
    ...], block_tables int [S, max_pages] → [S, ctx_pad, ...]."""
    tables = block_tables[:, :ctx_pad // page].to(torch.int64)
    g = cache[tables]                               # [S, n_pages, page, ..]
    return g.reshape(tables.shape[0], ctx_pad, *cache.shape[2:])


def paged_decode_attention_ref(
    q: torch.Tensor,              # [S, Hq, D]
    k_cache: torch.Tensor,        # [NB, page, Hkv, D]
    v_cache: torch.Tensor,
    block_tables: torch.Tensor,   # int [S, max_pages]
    context_lens: torch.Tensor,   # int [S] incl. the new token
    *,
    ctx_pad: int,
    scale: float,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
    k_self: Optional[torch.Tensor] = None,    # [S, Hkv, D] (deferred)
    v_self: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """GQA decode attention over the paged cache, in f32 → [S, Hq, D].
    Without k_self/v_self the new token's K/V are already cached; with
    them the cache holds the history and the token joins as a self
    term."""
    s, hq, d = q.shape
    page, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    k = gather_kv(k_cache, block_tables, ctx_pad, page).to(torch.float32)
    v = gather_kv(v_cache, block_tables, ctx_pad, page).to(torch.float32)
    qf = q.to(torch.float32).reshape(s, hkv, rep, d) * scale
    scores = torch.einsum("shrd,schd->shrc", qf, k)          # [S,Hkv,rep,C]
    hist_len = context_lens.to(torch.int64)[:, None] \
        - (0 if k_self is None else 1)
    pos = torch.arange(ctx_pad, device=q.device)[None, :]
    valid = pos < hist_len
    if sliding_window is not None:
        valid = valid & (pos >= context_lens.to(torch.int64)[:, None]
                         - sliding_window)
    scores = _maybe_softcap(scores, softcap)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    if k_self is None:
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("shrc,schd->shrd", probs, v)
        return out.reshape(s, hq, d).to(q.dtype)
    self_sc = _maybe_softcap(torch.einsum(
        "shrd,shd->shr", qf, k_self.to(torch.float32)), softcap)
    m = torch.maximum(torch.amax(scores, dim=-1), self_sc)
    e_hist = torch.exp(scores - m[..., None])
    e_self = torch.exp(self_sc - m)
    denom = torch.sum(e_hist, dim=-1) + e_self
    out = torch.einsum("shrc,schd->shrd", e_hist / denom[..., None], v)
    out = out + (e_self / denom)[..., None] \
        * v_self.to(torch.float32)[:, :, None, :]
    return out.reshape(s, hq, d).to(q.dtype)


def paged_prefill_attention_ref(
    q: torch.Tensor,              # [T, Hq, D] one sequence's chunk
    k_cache: torch.Tensor,        # [NB, page, Hkv, D]
    v_cache: torch.Tensor,
    block_table: torch.Tensor,    # int [max_pages]
    q_positions: torch.Tensor,    # int [T] absolute (pads: large)
    total_len: torch.Tensor,      # int scalar: prefix + real chunk tokens
    *,
    ctx_pad: int,
    scale: float,
    sliding_window: Optional[int] = None,
    softcap: Optional[float] = None,
) -> torch.Tensor:
    """Chunked-prefill attention of one sequence whose chunk K/V are
    already cached, in f32 → [T, Hq, D]: a query at position p attends
    to the cached positions <= p."""
    t, hq, d = q.shape
    page, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    k = gather_kv(k_cache, block_table[None], ctx_pad, page)[0].to(
        torch.float32)
    v = gather_kv(v_cache, block_table[None], ctx_pad, page)[0].to(
        torch.float32)
    qf = q.to(torch.float32).reshape(t, hkv, rep, d) * scale
    scores = torch.einsum("thrd,chd->thrc", qf, k)
    kpos = torch.arange(ctx_pad, device=q.device)[None, :]
    qpos = q_positions.to(torch.int64)[:, None]
    valid = (kpos <= qpos) & (kpos < total_len.to(torch.int64))
    if sliding_window is not None:
        valid = valid & (kpos > qpos - sliding_window)
    scores = _maybe_softcap(scores, softcap)
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    out = torch.einsum("thrc,chd->thrd", torch.softmax(scores, dim=-1), v)
    return out.reshape(t, hq, d).to(q.dtype)
