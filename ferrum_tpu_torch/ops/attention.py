"""Deferred-append attention over the linear (slot-contiguous) KV layout.

Port of `ferrum_tpu/ops/attention.py::flat_decode_attention` (without
the decode-window and int8-KV arguments, which later slices bring) and
`flat_prefill_attention`. Both are plain XLA in the JAX package, so
they are plain PyTorch here.

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
) -> torch.Tensor:
    """Decode attention: the cached history (positions < len - 1) plus the
    current token as an explicit self term (its K/V are appended after
    the step)."""
    s, hq, d = q.shape
    ctx_pad = k_flat.shape[1]
    rep = hq // hkv
    qf = (q.to(torch.float32) * scale).to(q.dtype)
    qt = _mask_q_flat(qf, hkv)                               # [S, Hq, F]
    scores = matmul_f32(qt, k_flat.transpose(1, 2))          # [S, Hq, C]
    hist_len = context_lens.to(torch.int64)[:, None] - 1
    pos = torch.arange(ctx_pad, device=q.device)[None, :]
    scores = torch.where((pos < hist_len)[:, None, :], scores, NEG_INF)
    self_sc = matmul_f32(qt, k_self.reshape(s, hkv * d, 1))[..., 0]  # [S, Hq]

    m = torch.maximum(torch.amax(scores, dim=-1), self_sc)
    e_hist = torch.exp(scores - m[:, :, None])
    e_self = torch.exp(self_sc - m)
    denom = torch.sum(e_hist, dim=-1) + e_self
    p_hist = (e_hist / denom[:, :, None]).to(qt.dtype)
    out_all = matmul_f32(p_hist, v_flat)                     # [S, Hq, F]
    out = _unmask_out_flat(out_all, hq, hkv, d)
    v_rep = torch.repeat_interleave(v_self.to(torch.float32), rep, dim=1)
    out = out + (e_self / denom)[:, :, None] * v_rep
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
