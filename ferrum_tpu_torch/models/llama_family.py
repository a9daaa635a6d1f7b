"""Llama-family decoder (GQA + SwiGLU + RoPE) as plain functions on tensors.

Port of `ferrum_tpu/models/llama_family.py` for the served paths (dense
llama / mistral / qwen2 / qwen3, qwen3-moe's sparse MLP through
ops/moe.py, and gemma3: (1 + w) norms, sandwich norms around attention
and MLP, GeGLU, the sqrt(hidden) embedding scale, a local RoPE table
for its sliding-window layers and the logit softcaps), on both KV
layouts: decode steps in either form -- the per-step form (`win=None`),
which appends its K/V after the trunk, on the linear layout
(`attn_impl="linear"`, slot regions sliced) or the paged one
(`attn_impl="ref"`, pages gathered through block tables, f32 reference
attention), and the window form (`win`, linear only), whose cache stays
read-only while K/V collect in the window's accumulator and land with
one `append_window_kv` after the window, optionally with one slot's
prefill block riding the steps -- and batched chunked prefill with
whole-page appends (or row appends at any start: speculative
verification), the context sliced or gathered by layout, and the
single-sequence `prefill_forward`.

The KV cache is [L, NB, page, F = Hkv*D] per K and V, seen by the
append kernels as the layer-merged flat [L*NB, page, F]; an int8 cache
(`kv_dtype="int8"`) adds f32 scale planes [L, NB, page, Hkv], written
with K and V in the same launch (`quantize_kv`). Where the JAX
package returns a new cache (updated in place by XLA buffer donation),
the port writes the cache tensors IN PLACE and returns the same object.

The decode window (T steps with on-device token feedback) is a Python
loop of `decode_forward` calls in engine/runner.py. Its `win` form
keeps the JAX package's design for the launch count: the window's K/V
of every layer, step and lane land in one `kv_append_rows` launch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.attention import (flat_decode_attention, flat_prefill_attention,
                             flat_prefill_window_attention,
                             paged_decode_attention_ref)
from ..ops.kernels.kv_append import append_pages_pairs, append_rows_pairs
from ..ops.linear import (DenseLinearParams, LinearParams, apply_linear,
                          matmul_f32)
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
    # gemma3 sandwich norms: norm(attn out), norm(mlp out).
    post_attn_norm: Optional[torch.Tensor] = None
    post_mlp_norm: Optional[torch.Tensor] = None


@dataclass
class QuantEmbedding:
    """int8 per-row symmetric embedding table (`squeeze_embeddings`):
    151936 x 2048 drops from 0.58 to 0.29 GiB. A lookup dequantizes the
    gathered rows only; tied logits contract against the int8 table and
    rescale per vocab row (the row scale commutes out of the dot)."""

    q: torch.Tensor                        # int8 [vocab, hidden]
    scale: torch.Tensor                    # f32 [vocab, 1]

    @property
    def device(self) -> torch.device:
        return self.q.device


@dataclass
class ModelParams:
    embed: Union[torch.Tensor, QuantEmbedding]   # [vocab, hidden]
    layers: List[LayerParams]
    final_norm: torch.Tensor
    lm_head: Optional[LinearParams]        # None = tied to embed


@dataclass
class PagedKvCache:
    """Device KV pool: k/v [L, num_blocks, page, kv_heads*head_dim].

    INT8: k/v hold symmetric per-(token, kv head) int8 values, with f32
    scales k_scale/v_scale [L, num_blocks, page, kv_heads]."""

    k: torch.Tensor
    v: torch.Tensor
    page: int
    kv_heads: int
    head_dim: int
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def num_blocks(self) -> int:
        return self.k.shape[1]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @classmethod
    def create(cls, cfg: ModelConfig, num_blocks: int, page: int,
               dtype=torch.bfloat16, device=None) -> "PagedKvCache":
        shape = (cfg.num_layers, num_blocks, page, cfg.kv_size)
        ks = vs = None
        if dtype == torch.int8:
            sshape = (cfg.num_layers, num_blocks, page, cfg.num_kv_heads)
            ks = torch.zeros(sshape, dtype=torch.float32, device=device)
            vs = torch.zeros(sshape, dtype=torch.float32, device=device)
        return cls(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   page=page, kv_heads=cfg.num_kv_heads,
                   head_dim=cfg.head_dim, k_scale=ks, v_scale=vs)

    def flat_arrays(self) -> List[torch.Tensor]:
        """The cache's arrays as the append kernels see them, layer-merged
        [L*NB, page, w]: K, V (and the two scale planes)."""
        n = self.k.shape[0] * self.num_blocks
        out = [self.k.view(n, self.page, -1), self.v.view(n, self.page, -1)]
        if self.quantized:
            out += [self.k_scale.view(n, self.page, -1),
                    self.v_scale.view(n, self.page, -1)]
        return out


def quantize_kv(x: torch.Tensor):
    """Symmetric per-(row, kv head) int8 quantization for KV appends, the
    JAX package's bit for bit: x [..., Hkv, D] → (int8 [..., Hkv, D], f32
    scale [..., Hkv]); f32 amax / 127, round half to even, clip ±127."""
    xf = x.to(torch.float32)
    scale = torch.clamp_min(xf.abs().amax(dim=-1), 1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def embed_lookup(embed, tokens: torch.Tensor,
                 dtype=torch.bfloat16) -> torch.Tensor:
    """Gather embedding rows; an int8 table's rows are dequantized in f32
    and cast to `dtype` (bf16 whatever the model's dtype, as the JAX
    package's lookup)."""
    if isinstance(embed, QuantEmbedding):
        return (embed.q[tokens].to(torch.float32)
                * embed.scale[tokens]).to(dtype)
    return embed[tokens]


# Vocabulary rows a tied int8 logits product widens to the activations'
# dtype at a time (a 8192 x 4096 bf16 block is 64 MiB).
TIED_INT8_ROWS = 8192


def tied_int8_logits(h: torch.Tensor, embed: QuantEmbedding) -> torch.Tensor:
    """h [N, H] . bf16(q)^T with f32 sums, times each vocab row's scale
    → f32 [N, vocab]: the JAX package's tied int8 logits. Widening int8
    to h's dtype is exact, so the product runs over TIED_INT8_ROWS rows
    of the table at a time instead of widening all of it each call."""
    v = embed.q.shape[0]
    out = torch.empty((h.shape[0], v), dtype=torch.float32, device=h.device)
    for a in range(0, v, TIED_INT8_ROWS):
        b = min(v, a + TIED_INT8_ROWS)
        out[:, a:b] = matmul_f32(h, embed.q[a:b].to(h.dtype).t()) \
            * embed.scale[a:b].t()
    return out


def make_inv_freq(cfg: ModelConfig, device) -> torch.Tensor:
    """The global RoPE table (with the config's rope scaling)."""
    return torch.from_numpy(rope_inv_freq(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling)).to(device)


def make_local_inv_freq(cfg: ModelConfig, device) -> Optional[torch.Tensor]:
    """gemma3's table for its sliding-window layers (`rope_local_theta`,
    no scaling); None for the other families."""
    if cfg.family != "gemma3":
        return None
    return torch.from_numpy(rope_inv_freq(
        cfg.head_dim, cfg.rope_local_theta)).to(device)


def _rope_tables(cfg: ModelConfig, device, inv_freq, inv_freq_local):
    """(global, local) tables: those given, the missing ones made."""
    if inv_freq is None:
        inv_freq = make_inv_freq(cfg, device)
    if inv_freq_local is None:
        inv_freq_local = make_local_inv_freq(cfg, device)
    return inv_freq, inv_freq_local


def _activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "silu":
        return torch.nn.functional.silu(x)
    if kind == "gelu_tanh":
        return torch.nn.functional.gelu(x, approximate="tanh")
    raise ValueError(kind)


def _mlp(x: torch.Tensor, lp: LayerParams, cfg: ModelConfig,
         layer_idx: int) -> torch.Tensor:
    if lp.moe is not None and cfg.layer_is_moe(layer_idx):
        return moe_mlp(x, lp.moe, cfg)
    if lp.gate_up is not None:
        g, u = torch.chunk(apply_linear(lp.gate_up, x), 2, dim=-1)
    else:
        g = apply_linear(lp.gate, x)
        u = apply_linear(lp.up, x)
    return apply_linear(lp.down, _activation(g, cfg.activation) * u)


AttnFn = Callable[[int, torch.Tensor, torch.Tensor, torch.Tensor],
                  torch.Tensor]
# attn_fn(layer_idx, q[N,Hq,D], k_new[N,Hkv,D], v_new[N,Hkv,D]) -> [N,Hq,D]


def forward_hidden(params: ModelParams, cfg: ModelConfig,
                   tokens: torch.Tensor, positions: torch.Tensor,
                   attn_fn: AttnFn, *, inv_freq: torch.Tensor,
                   inv_freq_local: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """Token ids [N] → final-norm hidden states [N, hidden]; the phase's
    attention (and its KV bookkeeping) is injected as `attn_fn`. gemma3's
    sliding-window layers rotate with `inv_freq_local` where given."""
    # gemma3 stores zero-centred norm weights, applied as (1 + w).
    gemma = cfg.family == "gemma3"
    h = embed_lookup(params.embed, tokens)
    if cfg.embedding_multiplier is not None:
        h = (h.to(torch.float32) * cfg.embedding_multiplier).to(h.dtype)
    cos_g, sin_g = rope_cos_sin(positions, inv_freq)
    if inv_freq_local is not None:
        cos_l, sin_l = rope_cos_sin(positions, inv_freq_local)
    eps = cfg.rms_norm_eps
    kv_sz = cfg.kv_size
    residual = h
    for li, lp in enumerate(params.layers):
        x = rms_norm(residual, lp.input_norm, eps, gemma_style=gemma)
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
            q = rms_norm(q, lp.q_norm, eps, gemma_style=gemma)
            k = rms_norm(k, lp.k_norm, eps, gemma_style=gemma)
        local = gemma and inv_freq_local is not None \
            and cfg.layer_sliding_window(li) is not None
        cos, sin = (cos_l, sin_l) if local else (cos_g, sin_g)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        attn = attn_fn(li, q, k, v).reshape(-1, cfg.q_size)
        attn = apply_linear(lp.o, attn)
        if lp.post_attn_norm is not None:
            attn = rms_norm(attn, lp.post_attn_norm, eps, gemma_style=gemma)
        x, residual = fused_add_rms_norm(attn, residual, lp.pre_mlp_norm,
                                         eps, gemma_style=gemma)
        mlp = _mlp(x, lp, cfg, li)
        if lp.post_mlp_norm is not None:
            mlp = rms_norm(mlp, lp.post_mlp_norm, eps, gemma_style=gemma)
        residual = (residual.to(torch.float32)
                    + mlp.to(torch.float32)).to(residual.dtype)
    return rms_norm(residual, params.final_norm, eps, gemma_style=gemma)


def logits_from_hidden(params: ModelParams, cfg: ModelConfig,
                       h: torch.Tensor) -> torch.Tensor:
    """hidden [N, H] → logits f32 [N, vocab] (softcapped where the
    config says)."""
    if params.lm_head is not None:
        logits = apply_linear(params.lm_head, h).to(torch.float32)
    elif isinstance(params.embed, QuantEmbedding):
        logits = tied_int8_logits(h, params.embed)
    else:
        logits = matmul_f32(h, params.embed.t())
    cap = cfg.final_logit_softcap
    if cap:
        logits = cap * torch.tanh(logits / cap)
    return logits


def _layer_block_ids(blk: torch.Tensor, valid: torch.Tensor, layers: int,
                     nb: int) -> torch.Tensor:
    """Per-layer block ids [L * n] (layer-merged cache), OOB where invalid."""
    bases = torch.arange(layers, device=blk.device)[:, None] * nb
    ids = torch.where(valid[None, :], bases + blk[None, :],
                      torch.full_like(bases + blk[None, :], OOB_SENTINEL))
    return ids.reshape(-1).to(torch.int32)


def _kv_parts(kv: PagedKvCache, k_new: torch.Tensor,
              v_new: torch.Tensor) -> List[torch.Tensor]:
    """New K and V [..., Hkv, D] as the cache stores them, flattened to
    [rows, w] each: K, V (and their scales, quantized)."""
    f = kv.kv_heads * kv.head_dim
    if not kv.quantized:
        return [k_new.reshape(-1, f).to(kv.k.dtype).contiguous(),
                v_new.reshape(-1, f).to(kv.v.dtype).contiguous()]
    kq, ks = quantize_kv(k_new)
    vq, vs = quantize_kv(v_new)
    return [kq.reshape(-1, f), vq.reshape(-1, f),
            ks.reshape(-1, kv.kv_heads), vs.reshape(-1, kv.kv_heads)]


def _append_kv_rows(kv: PagedKvCache, k_rows: torch.Tensor,
                    v_rows: torch.Tensor, flat: torch.Tensor) -> None:
    """Rows [L, n, Hkv, D] of K and V (every layer at the flat slots
    [n], >= OOB_SENTINEL dropped) into the cache: one launch, with the
    scale planes of an int8 cache."""
    nb, page = kv.num_blocks, kv.page
    n_layers = kv.k.shape[0]
    fl = flat.to(torch.int64)
    blk_all = _layer_block_ids(fl // page, fl < OOB_SENTINEL, n_layers, nb)
    off_all = (fl % page).to(torch.int32).repeat(n_layers)
    append_rows_pairs(list(zip(kv.flat_arrays(),
                               _kv_parts(kv, k_rows, v_rows))),
                      blk_all, off_all)


def _paged_cache(kv: PagedKvCache, li: int, tables: torch.Tensor,
                 ctx_pad: int, dtype: torch.dtype):
    """Layer li's K and V pages behind `tables` [S, max_pages] as a
    cache [S * n, page, Hkv, D] and its block tables [S, n] (n =
    ctx_pad / page). An int8 cache is dequantized to `dtype` -- the JAX
    package dequantizes the whole pool first; the gathered pages are the
    same values."""
    page, hkv, d = kv.page, kv.kv_heads, kv.head_dim
    if not kv.quantized:
        return (kv.k[li].view(-1, page, hkv, d),
                kv.v[li].view(-1, page, hkv, d), tables)
    n = ctx_pad // page
    tb = tables[:, :n].to(torch.int64)
    s = tb.shape[0]

    def deq(vals, sc):
        g = vals[li][tb].to(torch.float32) * sc[li][tb][..., None]
        return g.to(dtype).view(s * n, page, hkv, d)

    idx = torch.arange(s * n, device=tables.device).view(s, n)
    return (deq(kv.k.view(*kv.k.shape[:3], hkv, d), kv.k_scale),
            deq(kv.v.view(*kv.v.shape[:3], hkv, d), kv.v_scale), idx)


def decode_forward(
    params: ModelParams, cfg: ModelConfig, kv: PagedKvCache,
    tokens: torch.Tensor,         # int [S] (+ [P] window prefill rows)
    positions: torch.Tensor,      # int [S] (== context_lens - 1) (+ [P])
    block_tables: Optional[torch.Tensor],  # int [S, max_pages] (identity)
    context_lens: torch.Tensor,   # int [S] incl. the new token
    flat_slots: Optional[torch.Tensor],    # int [S]; >= OOB_SENTINEL = drop
    *, ctx_pad: int, inv_freq: Optional[torch.Tensor] = None,
    inv_freq_local: Optional[torch.Tensor] = None,
    win: Optional[dict] = None, attn_impl: str = "linear",
):
    """One batched decode step over S lanes.

    Per-step form (`win=None`) → (hidden [S, H], kv): this step's K/V
    join attention as the self term and are appended to the cache after
    the trunk, one `append_rows_pairs` of L*S rows of K and of V (and
    their scales). attn_impl "linear": block_tables' S slots frame the
    cache into slot regions; "ref" (the paged layout): each lane's pages
    are gathered through its row of block_tables.

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
                   views of the slot's region (+ "ks_ctx"/"vs_ctx").
    The caller lands the window with `append_window_kv`. Each layer
    attends through its own sliding window and the config's softcap;
    `inv_freq` / `inv_freq_local` are the RoPE tables (made here where
    not given)."""
    ropes = _rope_tables(cfg, tokens.device, inv_freq, inv_freq_local)
    f = kv.kv_heads * kv.head_dim
    if win is not None:
        return _decode_forward_win(params, cfg, kv, tokens, positions,
                                   block_tables, context_lens, ctx_pad,
                                   ropes, win)
    if attn_impl not in ("linear", "ref"):
        raise ValueError(f"unknown attn_impl {attn_impl!r}")
    s_slots = block_tables.shape[0]
    new_ks: List[torch.Tensor] = []
    new_vs: List[torch.Tensor] = []

    def attn(li, q, k_new, v_new):
        new_ks.append(k_new)
        new_vs.append(v_new)
        mask = dict(sliding_window=cfg.layer_sliding_window(li),
                    softcap=cfg.attn_logit_softcap)
        if attn_impl == "ref":
            kc, vc, tables = _paged_cache(kv, li, block_tables, ctx_pad,
                                          q.dtype)
            return paged_decode_attention_ref(
                q, kc, vc, tables, context_lens, ctx_pad=ctx_pad,
                scale=cfg.attn_scale, k_self=k_new, v_self=v_new, **mask)
        k_lin = kv.k[li].reshape(s_slots, -1, f)[:, :ctx_pad]
        v_lin = kv.v[li].reshape(s_slots, -1, f)[:, :ctx_pad]
        ks_lin = vs_lin = None
        if kv.quantized:
            ks_lin = kv.k_scale[li].reshape(s_slots, -1, kv.kv_heads)[
                :, :ctx_pad]
            vs_lin = kv.v_scale[li].reshape(s_slots, -1, kv.kv_heads)[
                :, :ctx_pad]
        return flat_decode_attention(
            q, k_lin, v_lin, context_lens, k_new, v_new,
            hkv=kv.kv_heads, scale=cfg.attn_scale, k_scale=ks_lin,
            v_scale=vs_lin, **mask)

    h = forward_hidden(params, cfg, tokens, positions, attn,
                       inv_freq=ropes[0], inv_freq_local=ropes[1])
    _append_kv_rows(kv, torch.stack(new_ks), torch.stack(new_vs),
                    flat_slots)
    return h, kv


def _decode_forward_win(params, cfg, kv, tokens, positions, block_tables,
                        context_lens, ctx_pad, ropes, win):
    f = kv.kv_heads * kv.head_dim
    s = win["k"].shape[2]
    step = win["step"]
    pf = win.get("pf")

    quant = kv.quantized

    def attn(li, q, k_new, v_new):
        mask = dict(sliding_window=cfg.layer_sliding_window(li),
                    softcap=cfg.attn_logit_softcap)
        ks_lin = vs_lin = None
        if "k_lins" in win:
            k_lin, v_lin = win["k_lins"][li], win["v_lins"][li]
            if quant:
                ks_lin, vs_lin = win["ks_lins"][li], win["vs_lins"][li]
        else:
            frame = block_tables.shape[0]
            k_lin = kv.k[li].reshape(frame, -1, f)[:, :ctx_pad]
            v_lin = kv.v[li].reshape(frame, -1, f)[:, :ctx_pad]
            if quant:
                hkv = kv.kv_heads
                ks_lin = kv.k_scale[li].reshape(frame, -1, hkv)[:, :ctx_pad]
                vs_lin = kv.v_scale[li].reshape(frame, -1, hkv)[:, :ctx_pad]
        q_d, kn_d, vn_d = q[:s], k_new[:s], v_new[:s]
        # The window's K/V stay out of the cache until the window ends
        # (in the accumulator's dtype: bf16 under an int8 cache).
        win["k"][li, step] = kn_d
        win["v"][li, step] = vn_d
        # Step 0 has no earlier window rows: no window terms.
        out_d = flat_decode_attention(
            q_d, k_lin, v_lin, context_lens, kn_d, vn_d,
            hkv=kv.kv_heads, scale=cfg.attn_scale,
            k_win=win["k"][li] if step else None, v_win=win["v"][li],
            win_valid=win["valid"], cache_len=win["cache_len"],
            k_scale=ks_lin, v_scale=vs_lin, **mask)
        if pf is None:
            return out_d
        kn_p, vn_p = k_new[s:], v_new[s:]
        win["pk"][li, step] = kn_p
        win["pv"][li, step] = vn_p
        out_p = flat_prefill_window_attention(
            q[s:], pf["k_ctx"][li], pf["v_ctx"][li], pf["chunk_start"],
            win["pk"][li], win["pv"][li], step, pf["chunk_start"],
            pf["valid_len"], kn_p, vn_p, pf["positions"],
            hkv=kv.kv_heads, scale=cfg.attn_scale,
            k_scale=pf["ks_ctx"][li] if quant else None,
            v_scale=pf["vs_ctx"][li] if quant else None, **mask)
        return torch.cat([out_d, out_p])

    h = forward_hidden(params, cfg, tokens, positions, attn,
                       inv_freq=ropes[0], inv_freq_local=ropes[1])
    return h, win


def append_window_kv(kv: PagedKvCache, win_k: torch.Tensor,
                     win_v: torch.Tensor,
                     flat_mat: torch.Tensor) -> PagedKvCache:
    """A whole decode window's K/V -- win_k/win_v [L, W, S, Hkv, D] at
    the flat slots flat_mat int [W, S] (>= OOB_SENTINEL dropped) -- into
    the cache in ONE `kv_append_rows` launch, in place (quantized, with
    the scale planes, for an int8 cache)."""
    n_layers, w, s = win_k.shape[:3]
    _append_kv_rows(kv, win_k.reshape(n_layers, w * s, *win_k.shape[3:]),
                    win_v.reshape(n_layers, w * s, *win_v.shape[3:]),
                    flat_mat.reshape(-1))
    return kv


def prefill_forward_batched(
    params: ModelParams, cfg: ModelConfig, kv: PagedKvCache,
    tokens: torch.Tensor,         # int [B, T] — one chunk per sequence
    positions: torch.Tensor,      # int [B, T] absolute; pads past total_len
    block_tables: torch.Tensor,   # int [B, max_pages]
    total_lens: torch.Tensor,     # int [B]: prefix + real chunk tokens
    flat_slots: torch.Tensor,     # int [B, T] (>= OOB_SENTINEL = drop)
    *, ctx_pad: int, inv_freq: Optional[torch.Tensor] = None,
    inv_freq_local: Optional[torch.Tensor] = None,
    attn_impl: str = "linear", append: str = "pages",
):
    """Chunked prefill of B sequences in one trunk pass (m = B*T for every
    projection) → (hidden [B, T, H], kv). The context: each slot's
    region sliced from its first block ("linear"), or its pages gathered
    through block_tables ("ref", the paged layout). append "pages": each
    chunk starts on a page boundary and T is a page multiple, so its K/V
    land as whole pages, K, V (and an int8 cache's scales) in one
    `append_pages_pairs` launch; pages whose first token is a pad are
    dropped. append "rows" (speculative verification): chunks start at
    any position and T is any length; the L*B*T rows land at their flat
    slots in one `append_rows_pairs` launch, rows at >= OOB_SENTINEL
    dropped. Each layer attends through its own sliding window and the
    config's softcap."""
    ropes = _rope_tables(cfg, tokens.device, inv_freq, inv_freq_local)
    nb, page = kv.num_blocks, kv.page
    n_layers = kv.k.shape[0]
    b, t_pad = tokens.shape
    if append not in ("pages", "rows"):
        raise ValueError(f"unknown append {append!r}")
    if append == "pages" and t_pad % page:
        raise ValueError(f"chunk pad {t_pad} is not a multiple of the page "
                         f"size {page}")
    new_ks: List[torch.Tensor] = []
    new_vs: List[torch.Tensor] = []
    rows = nb * page
    if attn_impl == "linear":
        starts = (block_tables[:, 0].to(torch.int64) * page).clamp(
            0, rows - ctx_pad)                      # dynamic_slice clamps
        window = starts[:, None] + torch.arange(ctx_pad,
                                                device=tokens.device)
    elif attn_impl == "ref":
        tables = block_tables[:, :ctx_pad // page].to(torch.int64)
        window = (tables[:, :, None] * page + torch.arange(
            page, device=tokens.device)).reshape(b, ctx_pad)
    else:
        raise ValueError(f"unknown attn_impl {attn_impl!r}")

    def ctx(arr, li):
        """Layer li's context rows [B, ctx_pad, w] of a cache array."""
        return arr[li].reshape(rows, -1)[window]

    def attn(li, q, k_new, v_new):
        new_ks.append(k_new)
        new_vs.append(v_new)
        out = flat_prefill_attention(
            q.reshape(b, t_pad, *q.shape[1:]), ctx(kv.k, li), ctx(kv.v, li),
            positions, total_lens,
            k_new.reshape(b, t_pad, *k_new.shape[1:]),
            v_new.reshape(b, t_pad, *v_new.shape[1:]),
            hkv=kv.kv_heads, scale=cfg.attn_scale,
            sliding_window=cfg.layer_sliding_window(li),
            softcap=cfg.attn_logit_softcap,
            k_scale=ctx(kv.k_scale, li) if kv.quantized else None,
            v_scale=ctx(kv.v_scale, li) if kv.quantized else None)
        return out.reshape(b * t_pad, *out.shape[2:])

    h = forward_hidden(params, cfg, tokens.reshape(-1),
                       positions.reshape(-1), attn, inv_freq=ropes[0],
                       inv_freq_local=ropes[1])
    if append == "rows":
        _append_kv_rows(kv, torch.stack(new_ks), torch.stack(new_vs),
                        flat_slots.reshape(-1))
        return h.reshape(b, t_pad, -1), kv

    n_pg = (b * t_pad) // page
    first = flat_slots.reshape(n_pg, page)[:, 0].to(torch.int64)
    blk_all = _layer_block_ids(first // page, first < OOB_SENTINEL,
                               n_layers, nb)
    parts = _kv_parts(kv, torch.stack(new_ks), torch.stack(new_vs))
    append_pages_pairs(
        [(cache, part.view(n_layers * n_pg, page, -1))
         for cache, part in zip(kv.flat_arrays(), parts)], blk_all)
    return h.reshape(b, t_pad, -1), kv


def prefill_forward(
    params: ModelParams, cfg: ModelConfig, kv: PagedKvCache,
    tokens: torch.Tensor,         # int [T] one sequence's chunk (padded)
    positions: torch.Tensor,      # int [T] absolute; pads past total_len
    block_table: torch.Tensor,    # int [max_pages]
    total_len: torch.Tensor,      # int scalar: prefix + real chunk tokens
    flat_slots: torch.Tensor,     # int [T] (>= OOB_SENTINEL = drop)
    *, ctx_pad: int, attn_impl: str = "ref",
    inv_freq: Optional[torch.Tensor] = None,
    inv_freq_local: Optional[torch.Tensor] = None,
):
    """One sequence's chunked prefill → (hidden [T, H], kv): the batched
    form at B = 1 (page-aligned chunk, whole-page appends). As in the
    JAX package, an int8 cache is refused here (the engine's path,
    `prefill_forward_batched`, takes it)."""
    if kv.quantized:
        raise NotImplementedError(
            "single-sequence prefill_forward does not support int8 KV; "
            "the engine path (prefill_forward_batched) does")
    h, kv = prefill_forward_batched(
        params, cfg, kv, tokens[None], positions[None], block_table[None],
        total_len.reshape(1), flat_slots[None], ctx_pad=ctx_pad,
        inv_freq=inv_freq, inv_freq_local=inv_freq_local,
        attn_impl=attn_impl)
    return h[0], kv


# ---------------------------------------------------------------------------
# Random init (benches, tests; real weights come from loaders)
# ---------------------------------------------------------------------------

def init_random_params(cfg: ModelConfig, seed: int = 0,
                       dtype=torch.bfloat16,
                       device: Optional[Union[str, torch.device]] = None
                       ) -> ModelParams:
    """The JAX package's `init_random_params` (llama_family.py:981), bit
    for bit: the same draws from np.random.default_rng(seed) in the same
    order (a layer's MLP, then q, k, v, o; the embedding, then an untied
    lm_head), each a float64 normal cast to float32 and then to `dtype`
    (round to nearest even, as jnp.asarray). Dense linears, and dense
    expert stacks [E, ...] in MoE layers; norms are ones, or zeros where
    they apply as (1 + w) (the sandwich-norm family, gemma3). Each tensor
    goes to the device as it is drawn, so the host holds one at a time.
    On the card unless `device` says otherwise."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)

    def normal(*shape) -> torch.Tensor:
        a = rng.normal(0.0, 0.02, shape).astype(np.float32)
        return torch.from_numpy(a).to(dev).to(dtype)

    def lin(i: int, o: int) -> DenseLinearParams:
        return DenseLinearParams(w=normal(i, o), bias=None)

    # Zero-centred (1 + w) norms store the identity as zeros.
    unit = 0.0 if cfg.sandwich_norms else 1.0

    def ones(n: int) -> torch.Tensor:
        return torch.full((n,), unit, dtype=dtype, device=dev)

    def sandwich(n: int) -> Optional[torch.Tensor]:
        return ones(n) if cfg.sandwich_norms else None

    h = cfg.hidden_size
    layers = []
    for li in range(cfg.num_layers):
        moe = None
        gate = up = down = None
        if cfg.layer_is_moe(li):
            m = cfg.moe
            e, mi = m.num_experts, m.moe_intermediate_size
            router = lin(h, e)
            moe = MoeLayerParams(router=router, gate=normal(e, h, mi),
                                 up=normal(e, h, mi), down=normal(e, mi, h))
        else:
            gate = lin(h, cfg.intermediate_size)
            up = lin(h, cfg.intermediate_size)
            down = lin(cfg.intermediate_size, h)
        q, k = lin(h, cfg.q_size), lin(h, cfg.kv_size)
        v, o = lin(h, cfg.kv_size), lin(cfg.q_size, h)
        layers.append(LayerParams(
            input_norm=ones(h), q=q, k=k, v=v, o=o,
            q_norm=ones(cfg.head_dim) if cfg.qk_norm else None,
            k_norm=ones(cfg.head_dim) if cfg.qk_norm else None,
            pre_mlp_norm=ones(h), gate=gate, up=up, down=down, moe=moe,
            post_attn_norm=sandwich(h), post_mlp_norm=sandwich(h)))
    embed = normal(cfg.vocab_size, h)
    lm_head = None if cfg.tie_word_embeddings else lin(h, cfg.vocab_size)
    return ModelParams(embed=embed, layers=layers, final_norm=ones(h),
                       lm_head=lm_head)
