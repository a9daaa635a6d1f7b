"""Deferred-append attention over the linear (slot-contiguous) KV layout.

Port of `ferrum_tpu/ops/attention.py::flat_decode_attention` (with its
decode-window terms; without softcap, sliding windows and int8 KV),
`flat_prefill_window_attention` and `flat_prefill_attention`. They are
plain XLA in the JAX package, so they are plain PyTorch here.

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
    k_win: Optional[torch.Tensor] = None,     # [W, S, Hkv, D] in-window K
    v_win: Optional[torch.Tensor] = None,
    win_valid: Optional[torch.Tensor] = None,  # bool [S, W]
    cache_len: Optional[torch.Tensor] = None,  # int [S] the cache's lens
) -> torch.Tensor:
    """Decode attention: the cached history (positions < len - 1) plus the
    current token as an explicit self term (its K/V are appended after
    the step). In a decode window the cache is frozen at `cache_len`
    (history < cache_len - 1), and the tokens generated earlier in the
    window, not cached yet, join as the `win_valid` rows of k_win/v_win:
    their scores extend the history's, under one softmax (one mask, max
    and sum over both, where the JAX package takes three of each)."""
    s, hq, d = q.shape
    ctx_pad = k_flat.shape[1]
    rep = hq // hkv
    qf = (q.to(torch.float32) * scale).to(q.dtype)
    qt = _mask_q_flat(qf, hkv)                               # [S, Hq, F]
    scores = matmul_f32(qt, k_flat.transpose(1, 2))          # [S, Hq, C]
    hist_src = context_lens if cache_len is None else cache_len
    hist_len = hist_src.to(torch.int64)[:, None] - 1
    valid = torch.arange(ctx_pad, device=q.device)[None, :] < hist_len
    if k_win is not None:
        kw = k_win.movedim(0, 1).reshape(s, -1, hkv * d).to(qt.dtype)
        scores = torch.cat([scores, matmul_f32(qt, kw.transpose(1, 2))],
                           dim=-1)                           # [S, Hq, C+W]
        valid = torch.cat([valid, win_valid], dim=-1)
    scores = torch.where(valid[:, None, :], scores, NEG_INF)
    self_sc = matmul_f32(qt, k_self.reshape(s, hkv * d, 1))[..., 0]  # [S, Hq]

    m = torch.maximum(torch.amax(scores, dim=-1), self_sc)
    e_hist = torch.exp(scores - m[:, :, None])
    e_self = torch.exp(self_sc - m)
    denom = torch.sum(e_hist, dim=-1) + e_self
    p_hist = (e_hist / denom[:, :, None]).to(qt.dtype)
    out_all = matmul_f32(p_hist[..., :ctx_pad], v_flat)      # [S, Hq, F]
    if k_win is not None:
        vw = v_win.movedim(0, 1).reshape(s, -1, hkv * d).to(qt.dtype)
        out_all = out_all + matmul_f32(p_hist[..., ctx_pad:], vw)
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
    scores = matmul_f32(qt.reshape(1, p * hq, f), k_all.t()[None])[0]
    scores = torch.where(valid[:, None, :], scores.reshape(p, hq, -1),
                         NEG_INF)
    any_valid = valid.any(dim=-1)
    scores = torch.where(any_valid[:, None, None], scores, 0.0)
    probs = torch.softmax(scores, dim=-1).to(qt.dtype)
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
) -> torch.Tensor:
    """Chunked-prefill attention: the chunk attends to the cached prefix
    (positions < total_len - real chunk tokens) and to itself causally.
    Takes one sequence or a leading batch of B sequences (the JAX
    package vmaps the one-sequence form)."""
    if q.dim() == 3:
        return flat_prefill_attention(
            q[None], k_flat[None], v_flat[None], q_positions[None],
            total_len.reshape(1), k_new[None], v_new[None], hkv=hkv,
            scale=scale)[0]
    b, t, hq, d = q.shape
    ctx_pad = k_flat.shape[1]
    dev = q.device
    qf = (q.to(torch.float32) * scale).to(q.dtype)
    qt = _mask_q_flat(qf, hkv)                               # [B, T, Hq, F]
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
    scores = matmul_f32(qt.reshape(b, t * hq, hkv * d),
                        k_all.transpose(1, 2))
    scores = torch.where(valid[:, :, None, :],
                         scores.reshape(b, t, hq, -1), NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(qt.dtype)
    out_all = matmul_f32(probs.reshape(b, t * hq, -1), v_all)  # [B, T*Hq, F]
    out = _unmask_out_flat(out_all.reshape(b, t, hq, hkv * d), hq, hkv, d)
    return out.to(q.dtype)
