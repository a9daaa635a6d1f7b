"""Llama-family decoder (GQA + SwiGLU + RoPE) as plain functions on tensors.

Port of `ferrum_tpu/models/llama_family.py` for the served paths (dense
llama, and qwen3-moe's sparse MLP through ops/moe.py): the linear
(slot-contiguous) KV layout, decode steps (`attn_impl="linear"`) in
either form -- the per-step form (`win=None`), which appends its K/V
after the trunk, and the window form (`win`), whose cache stays
read-only while K/V collect in the window's accumulator and land with
one `append_window_kv` after the window, optionally with one slot's
prefill block riding the steps -- and batched chunked prefill with
whole-page appends (`append="pages"`).

The KV cache is [L, NB, page, F = Hkv*D] per K and V, seen by the
append kernels as the layer-merged flat [L*NB, page, F]. Where the JAX
package returns a new cache (updated in place by XLA buffer donation),
the port writes the cache tensors IN PLACE and returns the same object.

The decode window (T steps with on-device token feedback) is a Python
loop of `decode_forward` calls in engine/runner.py. Its `win` form
keeps the JAX package's design for the launch count: the window's K/V
of every layer, step and lane land in one `kv_append_rows` launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional

import torch

from ..ops.attention import (flat_decode_attention, flat_prefill_attention,
                             flat_prefill_window_attention)
from ..ops.kernels.kv_append import append_pages, append_rows_pairs
from ..ops.linear import LinearParams, apply_linear, matmul_f32
from ..ops.moe import moe_mlp
from ..ops.norms import fused_add_rms_norm, rms_norm
from ..ops.rope import apply_rope, rope_cos_sin, rope_inv_freq
from .configs import ModelConfig

# Flat-slot / block id that drops a write; stays out of range after the
# per-layer base offset is added.
OOB_SENTINEL = 1 << 30


@dataclass
class MoeLayerParams:
    """Sparse-MoE MLP params (Qwen3-30B-A3B style).

    router:  DenseLinearParams [hidden, E]
    gate/up: stacked expert weights -- a QuantLinearParams with a leading
             expert dim ([E, hidden/2, I] packed), or dense [E, hidden, I]
             tensors (moe_mlp_ref only).
    down:    [E, I, hidden] likewise.
    gate_up: gate|up fused along the out dim (off by default, as in the
             JAX package: gate and up share one activation quantization
             instead).
    """

    router: LinearParams
    gate: Any
    up: Any
    down: Any
    gate_up: Any = None


@dataclass
class LayerParams:
    input_norm: torch.Tensor
    q: Optional[LinearParams]
    k: Optional[LinearParams]
    v: Optional[LinearParams]
    o: LinearParams
    q_norm: Optional[torch.Tensor]         # qwen3 per-head RMS [head_dim]
    k_norm: Optional[torch.Tensor]
    pre_mlp_norm: torch.Tensor
    gate: Optional[LinearParams]
    up: Optional[LinearParams]
    down: Optional[LinearParams]           # None in a MoE layer
    # Build-time fusions (engine/builder.fuse_projections).
    qkv: Optional[LinearParams] = None
    gate_up: Optional[LinearParams] = None
    moe: Optional[MoeLayerParams] = None


@dataclass
class ModelParams:
    embed: torch.Tensor                    # [vocab, hidden]
    layers: List[LayerParams]
    final_norm: torch.Tensor
    lm_head: Optional[LinearParams]        # None = tied to embed


@dataclass
class PagedKvCache:
    """Device KV pool: k/v [L, num_blocks, page, kv_heads*head_dim]."""

    k: torch.Tensor
    v: torch.Tensor
    page: int
    kv_heads: int
    head_dim: int

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @classmethod
    def create(cls, cfg: ModelConfig, num_blocks: int, page: int,
               dtype=torch.bfloat16, device=None) -> "PagedKvCache":
        shape = (cfg.num_layers, num_blocks, page, cfg.kv_size)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   page=page, kv_heads=cfg.num_kv_heads,
                   head_dim=cfg.head_dim)


def embed_lookup(embed: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embed[tokens]


def make_inv_freq(cfg: ModelConfig, device) -> torch.Tensor:
    return torch.from_numpy(rope_inv_freq(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(device)


def _mlp(x: torch.Tensor, lp: LayerParams, cfg: ModelConfig,
         layer_idx: int) -> torch.Tensor:
    if lp.moe is not None and cfg.layer_is_moe(layer_idx):
        return moe_mlp(x, lp.moe, cfg)
    if lp.gate_up is not None:
        g, u = torch.chunk(apply_linear(lp.gate_up, x), 2, dim=-1)
    else:
        g = apply_linear(lp.gate, x)
        u = apply_linear(lp.up, x)
    return apply_linear(lp.down, torch.nn.functional.silu(g) * u)


AttnFn = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]
# attn_fn(layer_idx, q[N,Hq,D], k_new[N,Hkv,D], v_new[N,Hkv,D]) -> [N,Hq,D]


def forward_hidden(params: ModelParams, cfg: ModelConfig,
                   tokens: torch.Tensor, positions: torch.Tensor,
                   attn_fn: AttnFn, *, inv_freq: torch.Tensor
                   ) -> torch.Tensor:
    """Token ids [N] → final-norm hidden states [N, hidden]; the phase's
    attention (and its KV bookkeeping) is injected as `attn_fn`."""
    h = embed_lookup(params.embed, tokens)
    cos, sin = rope_cos_sin(positions, inv_freq)
    kv_sz = cfg.kv_size
    residual = h
    for li, lp in enumerate(params.layers):
        x = rms_norm(residual, lp.input_norm, cfg.rms_norm_eps)
        if lp.qkv is not None:
            qkv = apply_linear(lp.qkv, x)
            q_sz = qkv.shape[-1] - 2 * kv_sz
            q_flat = qkv[..., :q_sz]
            k = qkv[..., q_sz:q_sz + kv_sz]
            v = qkv[..., q_sz + kv_sz:]
        else:
            q_flat = apply_linear(lp.q, x)
            k = apply_linear(lp.k, x)
            v = apply_linear(lp.v, x)
        q = q_flat.reshape(-1, cfg.num_heads, cfg.head_dim)
        k = k.reshape(-1, cfg.num_kv_heads, cfg.head_dim)
        v = v.reshape(-1, cfg.num_kv_heads, cfg.head_dim)
        if lp.q_norm is not None:
            q = rms_norm(q, lp.q_norm, cfg.rms_norm_eps)
            k = rms_norm(k, lp.k_norm, cfg.rms_norm_eps)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attn_fn(li, q, k, v).reshape(-1, cfg.q_size)
        attn = apply_linear(lp.o, attn)
        x, residual = fused_add_rms_norm(attn, residual, lp.pre_mlp_norm,
                                         cfg.rms_norm_eps)
        mlp = _mlp(x, lp, cfg, li)
        residual = (residual.to(torch.float32)
                    + mlp.to(torch.float32)).to(residual.dtype)
    return rms_norm(residual, params.final_norm, cfg.rms_norm_eps)


def logits_from_hidden(params: ModelParams, cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    """hidden [N, H] → logits f32 [N, vocab]."""
    if params.lm_head is not None:
        return apply_linear(params.lm_head, h).to(torch.float32)
    return matmul_f32(h, params.embed.t())


def _layer_block_ids(blk: torch.Tensor, valid: torch.Tensor, layers: int,
                     nb: int) -> torch.Tensor:
    """Per-layer block ids [L * n] (layer-merged cache), OOB where invalid."""
    bases = torch.arange(layers, device=blk.device)[:, None] * nb
    ids = torch.where(valid[None, :], bases + blk[None, :],
                      torch.full_like(bases + blk[None, :], OOB_SENTINEL))
    return ids.reshape(-1).to(torch.int32)


def _append_kv_rows(kv: PagedKvCache, k_rows: torch.Tensor,
                    v_rows: torch.Tensor, flat: torch.Tensor) -> None:
    """Rows [L, n, Hkv, D] of K and V (every layer at the flat slots
    [n], >= OOB_SENTINEL dropped) into the cache: one launch."""
    nb, page = kv.num_blocks, kv.page
    f = kv.kv_heads * kv.head_dim
    n_layers = kv.k.shape[0]
    fl = flat.to(torch.int64)
    blk_all = _layer_block_ids(fl // page, fl < OOB_SENTINEL, n_layers, nb)
    off_all = (fl % page).to(torch.int32).repeat(n_layers)
    append_rows_pairs(
        [(kv.k.view(n_layers * nb, page, f),
          k_rows.reshape(-1, f).to(kv.k.dtype).contiguous()),
         (kv.v.view(n_layers * nb, page, f),
          v_rows.reshape(-1, f).to(kv.v.dtype).contiguous())],
        blk_all, off_all)


def decode_forward(
    params: ModelParams, cfg: ModelConfig, kv: PagedKvCache,
    tokens: torch.Tensor,         # int [S] (+ [P] window prefill rows)
    positions: torch.Tensor,      # int [S] (== context_lens - 1) (+ [P])
    block_tables: Optional[torch.Tensor],  # int [S, max_pages] (identity)
    context_lens: torch.Tensor,   # int [S] incl. the new token
    flat_slots: Optional[torch.Tensor],    # int [S]; >= OOB_SENTINEL = drop
    *, ctx_pad: int, inv_freq: Optional[torch.Tensor] = None,
    win: Optional[dict] = None,
):
    """One batched decode step over S lanes of the linear layout.

    Per-step form (`win=None`) → (hidden [S, H], kv): this step's K/V
    join attention as the self term and are appended to the cache after
    the trunk, one `append_rows_pairs` of L*S rows of K and of V.

    Window form → (hidden [S (+P), H], win), the cache untouched. `win`:
      "k"/"v"      [L, T, S, Hkv, D] the window's accumulators; this
                   step's K/V are written at index "step"
      "step"       int; "valid" bool [S, T] (the steps before it);
      "cache_len"  int [S] the cache's lengths at the window's start
      "k_lins"/"v_lins"  optional per-layer [S, ctx_pad, F] views of
                   the lanes' regions, taken once a window (else sliced
                   here from the frame of block_tables' S slots)
      "pk"/"pv", "pf"  optional mixed prefill: tokens/positions carry P
                   rows of one slot's chunk after the S lanes; the trunk
                   runs once over S+P rows and attention splits by
                   phase. "pf": "chunk_start", "valid_len" (ints),
                   "positions" [P], "k_ctx"/"v_ctx" per-layer [C, F]
                   views of the slot's region.
    The caller lands the window with `append_window_kv`."""
    if inv_freq is None:
        inv_freq = make_inv_freq(cfg, tokens.device)
    f = kv.kv_heads * kv.head_dim
    if win is not None:
        return _decode_forward_win(params, cfg, kv, tokens, positions,
                                   block_tables, context_lens, ctx_pad,
                                   inv_freq, win)
    s_slots = block_tables.shape[0]
    new_ks: List[torch.Tensor] = []
    new_vs: List[torch.Tensor] = []

    def attn(li, q, k_new, v_new):
        new_ks.append(k_new)
        new_vs.append(v_new)
        k_lin = kv.k[li].reshape(s_slots, -1, f)[:, :ctx_pad]
        v_lin = kv.v[li].reshape(s_slots, -1, f)[:, :ctx_pad]
        return flat_decode_attention(
            q, k_lin, v_lin, context_lens, k_new, v_new,
            hkv=kv.kv_heads, scale=cfg.attn_scale)

    h = forward_hidden(params, cfg, tokens, positions, attn,
                       inv_freq=inv_freq)
    _append_kv_rows(kv, torch.stack(new_ks), torch.stack(new_vs),
                    flat_slots)
    return h, kv


def _decode_forward_win(params, cfg, kv, tokens, positions, block_tables,
                        context_lens, ctx_pad, inv_freq, win):
    f = kv.kv_heads * kv.head_dim
    s = win["k"].shape[2]
    step = win["step"]
    pf = win.get("pf")

    def attn(li, q, k_new, v_new):
        if "k_lins" in win:
            k_lin, v_lin = win["k_lins"][li], win["v_lins"][li]
        else:
            frame = block_tables.shape[0]
            k_lin = kv.k[li].reshape(frame, -1, f)[:, :ctx_pad]
            v_lin = kv.v[li].reshape(frame, -1, f)[:, :ctx_pad]
        q_d, kn_d, vn_d = q[:s], k_new[:s], v_new[:s]
        # The window's K/V stay out of the cache until the window ends.
        win["k"][li, step] = kn_d
        win["v"][li, step] = vn_d
        # Step 0 has no earlier window rows: no window terms.
        out_d = flat_decode_attention(
            q_d, k_lin, v_lin, context_lens, kn_d, vn_d,
            hkv=kv.kv_heads, scale=cfg.attn_scale,
            k_win=win["k"][li] if step else None, v_win=win["v"][li],
            win_valid=win["valid"], cache_len=win["cache_len"])
        if pf is None:
            return out_d
        kn_p, vn_p = k_new[s:], v_new[s:]
        win["pk"][li, step] = kn_p
        win["pv"][li, step] = vn_p
        out_p = flat_prefill_window_attention(
            q[s:], pf["k_ctx"][li], pf["v_ctx"][li], pf["chunk_start"],
            win["pk"][li], win["pv"][li], step, pf["chunk_start"],
            pf["valid_len"], kn_p, vn_p, pf["positions"],
            hkv=kv.kv_heads, scale=cfg.attn_scale)
        return torch.cat([out_d, out_p])

    h = forward_hidden(params, cfg, tokens, positions, attn,
                       inv_freq=inv_freq)
    return h, win


def append_window_kv(kv: PagedKvCache, win_k: torch.Tensor,
                     win_v: torch.Tensor,
                     flat_mat: torch.Tensor) -> PagedKvCache:
    """A whole decode window's K/V -- win_k/win_v [L, W, S, Hkv, D] at
    the flat slots flat_mat int [W, S] (>= OOB_SENTINEL dropped) -- into
    the cache in ONE `kv_append_rows` launch, in place."""
    n_layers, w, s = win_k.shape[:3]
    _append_kv_rows(kv, win_k.reshape(n_layers, w * s, -1),
                    win_v.reshape(n_layers, w * s, -1), flat_mat.reshape(-1))
    return kv


def prefill_forward_batched(
    params: ModelParams, cfg: ModelConfig, kv: PagedKvCache,
    tokens: torch.Tensor,         # int [B, T] — one chunk per sequence
    positions: torch.Tensor,      # int [B, T] absolute; pads past total_len
    block_tables: torch.Tensor,   # int [B, max_pages]
    total_lens: torch.Tensor,     # int [B]: prefix + real chunk tokens
    flat_slots: torch.Tensor,     # int [B, T] (>= OOB_SENTINEL = drop)
    *, ctx_pad: int, inv_freq: Optional[torch.Tensor] = None,
):
    """Chunked prefill of B sequences in one trunk pass (m = B*T for every
    projection) → (hidden [B, T, H], kv). Each chunk starts on a page
    boundary and T is a page multiple, so its K/V land as whole pages
    (`append_pages`); pages whose first token is a pad are dropped."""
    if inv_freq is None:
        inv_freq = make_inv_freq(cfg, tokens.device)
    nb, page = kv.num_blocks, kv.page
    f = kv.kv_heads * kv.head_dim
    n_layers = kv.k.shape[0]
    b, t_pad = tokens.shape
    if t_pad % page:
        raise ValueError(f"chunk pad {t_pad} is not a multiple of the page "
                         f"size {page}")
    new_ks: List[torch.Tensor] = []
    new_vs: List[torch.Tensor] = []
    rows = nb * page
    starts = (block_tables[:, 0].to(torch.int64) * page).clamp(
        0, rows - ctx_pad)                          # dynamic_slice clamps
    window = starts[:, None] + torch.arange(ctx_pad, device=tokens.device)

    def attn(li, q, k_new, v_new):
        new_ks.append(k_new)
        new_vs.append(v_new)
        kl = kv.k[li].reshape(rows, f)[window]          # [B, ctx_pad, F]
        vl = kv.v[li].reshape(rows, f)[window]
        out = flat_prefill_attention(
            q.reshape(b, t_pad, *q.shape[1:]), kl, vl, positions,
            total_lens, k_new.reshape(b, t_pad, *k_new.shape[1:]),
            v_new.reshape(b, t_pad, *v_new.shape[1:]),
            hkv=kv.kv_heads, scale=cfg.attn_scale)
        return out.reshape(b * t_pad, *out.shape[2:])

    h = forward_hidden(params, cfg, tokens.reshape(-1),
                       positions.reshape(-1), attn, inv_freq=inv_freq)

    n_pg = (b * t_pad) // page
    first = flat_slots.reshape(n_pg, page)[:, 0].to(torch.int64)
    blk_all = _layer_block_ids(first // page, first < OOB_SENTINEL,
                               n_layers, nb)
    k_pages = torch.stack(new_ks).reshape(n_layers * n_pg, page, f)
    v_pages = torch.stack(new_vs).reshape(n_layers * n_pg, page, f)
    append_pages(kv.k.view(n_layers * nb, page, f),
                 k_pages.to(kv.k.dtype).contiguous(), blk_all)
    append_pages(kv.v.view(n_layers * nb, page, f),
                 v_pages.to(kv.v.dtype).contiguous(), blk_all)
    return h.reshape(b, t_pad, -1), kv
