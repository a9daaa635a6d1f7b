"""Sparse MoE MLP: top-k routing, expert dispatch and the combine.

Port of `ferrum_tpu/ops/moe.py`. Int4 expert stacks take one of two
routes, chosen as the TPU chooses them (moe.py:228-237), on every
device:

  all-experts  w4a8 on, two-level stacks, t*k >= E and t <= 64 (decode
               batches): every expert on every row through
               quant_bmm_all_experts (gate, up, down), then each token's
               k routed rows are gathered and summed
               (moe_mlp_dense_decode)
  sort         everything else (prefill, small decode, and every batch
               under w4a16 or with float-scale stacks): assignments
               sorted by expert, grouped GEMMs over the sorted rows
               (quant_grouped_matmul: the two-level kernel with w4a8 on
               and two-level stacks, the w4a16 kernel otherwise; the
               activations quantized once for gate and up only on the
               former), weighted rows summed back per token

Dense stacks (bf16 or f32 tensors gate / up [E, H, I], down [E, I, H],
or a fused gate_up [E, H, 2I]) take the sort route through
`ragged_dot`, `jax.lax.ragged_dot`'s function in plain PyTorch: each
expert's rows times its matrix, the operands as they are (bf16 on the
card), f32 sums. It reads the group sizes on the host, one sync a
call; the JAX package computes this route outside any Pallas kernel.

The combines sum a token's k weighted rows one at a time in ascending
expert order -- the order of the JAX package's `.at[token_of].add` over
expert-sorted rows -- so the result does not depend on atomics or a
reduction's split. The int4 routes make no host sync.

`moe_mlp_gather_decode` (the routed experts' stacks gathered, then the
all-experts kernel over them) is ported with its test only: the JAX
package leaves it unwired (moe.py:238-241).
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Tuple

import torch
import torch.nn.functional as F

from .kernels.moe_gemm import quant_bmm_all_experts, quant_grouped_matmul
from .kernels.quant_matmul import quantize_activation_rows, w4a8_enabled
from .linear import apply_linear, matmul_f32
from .quant import QuantLinearParams

if TYPE_CHECKING:
    from ..models.configs import ModelConfig
    from ..models.llama_family import MoeLayerParams


def route_topk(router_logits: torch.Tensor, k: int,
               renorm: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax routing → (weights [T, k] f32, expert ids [T, k] int64).
    Equal probabilities keep the lower expert id first, as
    `jax.lax.top_k` does (a stable descending sort; `torch.topk` promises
    no order for ties, and bf16 router logits tie often)."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :k], ids[:, :k]
    if renorm:
        weights = weights / weights.sum(dim=-1, keepdim=True)
    return weights, ids


def _sum_in_order(rows: torch.Tensor) -> torch.Tensor:
    """[T, k, H] → [T, H], adding the k rows one at a time in order."""
    out = rows[:, 0]
    for j in range(1, rows.shape[1]):
        out = out + rows[:, j]
    return out


def moe_mlp_ref(x: torch.Tensor, p: "MoeLayerParams",
                cfg: "ModelConfig") -> torch.Tensor:
    """One-hot reference over dense stacks (gate/up [E, H, I], down
    [E, I, H]): computes every expert for every token. O(T·E·…),
    test-sized configs only -- the correctness oracle."""
    m = cfg.moe
    logits = apply_linear(p.router, x)
    weights, ids = route_topk(logits, m.num_experts_per_tok,
                              m.norm_topk_prob)
    combine = torch.zeros((x.shape[0], m.num_experts), dtype=torch.float32,
                          device=x.device)
    combine.scatter_add_(1, ids, weights)
    xf = x.to(torch.float32)
    g = torch.einsum("th,ehi->tei", xf, p.gate.to(torch.float32))
    u = torch.einsum("th,ehi->tei", xf, p.up.to(torch.float32))
    y = torch.einsum("tei,eih->teh", F.silu(g) * u,
                     p.down.to(torch.float32))
    return torch.einsum("te,teh->th", combine, y).to(x.dtype)


def _silu_mul(g: torch.Tensor, u: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    return (F.silu(g.to(torch.float32)) * u.to(torch.float32)).to(dtype)


def moe_mlp_dense_decode(x: torch.Tensor, p: "MoeLayerParams",
                         cfg: "ModelConfig") -> torch.Tensor:
    """All-experts decode route: every expert on every row of x [t, H]
    (t <= 64). At decode batch sizes t*k >= E the sort route reads the
    whole packed stack anyway, so computing all experts costs no more
    weight traffic and drops the sort, the gather and the grouped
    kernel's tile map: three batched kernels (gate, up, down)."""
    m = cfg.moe
    t = x.shape[0]
    e = m.num_experts
    logits = apply_linear(p.router, x)
    weights, ids = route_topk(logits, m.num_experts_per_tok,
                              m.norm_topk_prob)
    xq, xs = quantize_activation_rows(x)
    xq3, xs3 = xq[None], xs[None]
    if p.gate_up is not None:
        g, u = torch.chunk(quant_bmm_all_experts(
            xq3, xs3, p.gate_up, torch.bfloat16), 2, dim=-1)
    else:
        g = quant_bmm_all_experts(xq3, xs3, p.gate, torch.bfloat16)
        u = quant_bmm_all_experts(xq3, xs3, p.up, torch.bfloat16)
    act = _silu_mul(g, u, torch.bfloat16)                   # [E, t, I]
    inter = act.shape[-1]
    aq, a_s = quantize_activation_rows(act.reshape(e * t, inter))
    y = quant_bmm_all_experts(aq.reshape(e, t, inter),
                              a_s.reshape(e, t, 1), p.down,
                              torch.bfloat16)               # [E, t, H]
    # Each token's k rows, in ascending expert order, weighted.
    ids_up, perm = torch.sort(ids, dim=-1)
    w_up = weights.gather(1, perm)
    rows = y[ids_up, torch.arange(t, device=x.device)[:, None]]
    rows = rows.to(torch.float32) * w_up[..., None]
    return _sum_in_order(rows).to(x.dtype)


def moe_mlp_gather_decode(x: torch.Tensor, p: "MoeLayerParams",
                          cfg: "ModelConfig"):
    """Routed-experts-only decode (unwired, as in the JAX package, where
    it measured slower than the all-experts route on the TPU): the t*k
    routed experts' fused gate|up and down stacks gathered, each
    assignment's row through the all-experts kernel at E' = t*k, the
    rows weighted and summed per token. None without a fused gate_up.
    The JAX form pads each assignment to 32 rows for the TPU's int8
    tile; rows are independent, so one row each computes its row 0."""
    import dataclasses

    if p.gate_up is None:
        return None
    m = cfg.moe
    t, k = x.shape[0], m.num_experts_per_tok
    a = t * k
    weights, ids = route_topk(apply_linear(p.router, x), k,
                              m.norm_topk_prob)                  # [t, k]
    flat_ids = ids.reshape(-1)                                   # [A]

    def gather(q: QuantLinearParams) -> QuantLinearParams:
        return dataclasses.replace(
            q, qweight=q.qweight[flat_ids], scales=q.scales[flat_ids],
            zeros=q.zeros[flat_ids],
            scales2=None if q.scales2 is None else q.scales2[flat_ids],
            chan_scale=None if q.chan_scale is None
            else q.chan_scale[flat_ids])

    xq, xs = quantize_activation_rows(x)
    token_of = torch.arange(t, device=x.device).repeat_interleave(k)
    g, u = torch.chunk(quant_bmm_all_experts(
        xq[token_of][:, None], xs[token_of][:, None], gather(p.gate_up),
        torch.bfloat16), 2, dim=-1)                              # [A, 1, I]
    act = _silu_mul(g, u, torch.bfloat16)
    inter = act.shape[-1]
    aq, a_s = quantize_activation_rows(act.reshape(a, inter))
    y = quant_bmm_all_experts(aq[:, None], a_s[:, None], gather(p.down),
                              torch.bfloat16)[:, 0]              # [A, H]
    rows = y.to(torch.float32) * weights.reshape(-1)[:, None]
    # The JAX scatter-add over token_of adds each token's k rows in
    # routing order.
    return _sum_in_order(rows.reshape(t, k, -1)).to(x.dtype)


def ragged_dot(x: torch.Tensor, w: torch.Tensor,
               sizes: List[int]) -> torch.Tensor:
    """`jax.lax.ragged_dot` with f32 sums: x [A, K] holds the rows of
    expert 0, then 1, ... (`sizes` of each); row r of the result is
    x[r] @ w[expert of r], f32 [A, N] (0 past the last group)."""
    out = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    lo = 0
    for e, n in enumerate(sizes):
        if n:
            out[lo:lo + n] = matmul_f32(x[lo:lo + n], w[e])
        lo += n
    return out


def moe_mlp(x: torch.Tensor, p: "MoeLayerParams",
            cfg: "ModelConfig") -> torch.Tensor:
    """Sparse MoE MLP over x [t, H] → [t, H] (int4 or dense expert
    stacks)."""
    m = cfg.moe
    t = x.shape[0]
    k = m.num_experts_per_tok
    e = m.num_experts
    first = p.gate_up if p.gate_up is not None else p.gate
    dense = not isinstance(first, QuantLinearParams)
    if (not dense and w4a8_enabled() and first.scales2 is not None
            and p.down.scales2 is not None and t * k >= e and t <= 64):
        return moe_mlp_dense_decode(x, p, cfg)

    logits = apply_linear(p.router, x)
    weights, ids = route_topk(logits, k, m.norm_topk_prob)   # [t, k]
    flat_ids = ids.reshape(-1)                               # [A], A = t*k
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    group_sizes = torch.searchsorted(
        sorted_ids, torch.arange(e + 1, device=x.device)).diff().to(
            torch.int32)
    xs = x[order // k]                                       # [A, H]
    if dense:
        sizes = group_sizes.tolist()
        if p.gate_up is not None:
            g, u = torch.chunk(ragged_dot(xs, p.gate_up, sizes), 2, dim=-1)
        else:
            g = ragged_dot(xs, p.gate, sizes)
            u = ragged_dot(xs, p.up, sizes)
        act = (F.silu(g) * u).to(x.dtype)
        y = ragged_dot(act, p.down, sizes)
    else:
        # gate and up consume the same rows: quantize once (two-level).
        aq = quantize_activation_rows(xs) \
            if w4a8_enabled() and first.scales2 is not None else None
        if p.gate_up is not None:
            g, u = torch.chunk(quant_grouped_matmul(
                xs, p.gate_up, sorted_ids, group_sizes, act_quant=aq), 2,
                dim=-1)
        else:
            g = quant_grouped_matmul(xs, p.gate, sorted_ids, group_sizes,
                                     act_quant=aq)
            u = quant_grouped_matmul(xs, p.up, sorted_ids, group_sizes,
                                     act_quant=aq)
        act = _silu_mul(g, u, x.dtype)
        y = quant_grouped_matmul(act, p.down, sorted_ids, group_sizes)
    # Weighted combine back to token order: token i's rows sit at the
    # sorted positions of assignments i*k .. i*k+k-1, which ascend with
    # the expert id.
    yw = y.to(torch.float32) * weights.reshape(-1)[order][:, None]
    where = torch.empty_like(order)
    where[order] = torch.arange(order.numel(), device=x.device)
    slots, _ = torch.sort(where.reshape(t, k), dim=-1)
    return _sum_in_order(yw[slots]).to(x.dtype)
