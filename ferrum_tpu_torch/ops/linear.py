"""One `apply_linear` over the weight formats of the served path.

Port of `ferrum_tpu/ops/linear.py`: dense weights stored [in, out]
(y = x @ w) and packed int4 weights (ops/kernels/quant_matmul.py).
LoRA adapters belong to a later slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch

from .quant import QuantLinearParams


@dataclass
class DenseLinearParams:
    """Dense weight stored [in, out] (x @ w)."""

    w: torch.Tensor
    bias: Optional[torch.Tensor]


LinearParams = Union[DenseLinearParams, QuantLinearParams]


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] @ [K, N], or batched [B, M, K] @ [B, K, N], → f32 sums never
    rounded to the operands' dtype (XLA's preferred_element_type=f32).
    bf16 operands stay bf16 on the card (a bf16 GEMM with an f32 output);
    elsewhere they are widened to f32 first, which is exact."""
    if a.dim() == 2:
        return matmul_f32(a[None], b[None])[0]
    if a.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.is_cuda:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def apply_linear(p: LinearParams, x: torch.Tensor) -> torch.Tensor:
    """y = x @ W (+ bias). x: [..., in] → [..., out] in x.dtype.

    Dense: f32 sums (on the card a bf16 product accumulates in f32 and
    rounds once to bf16, as XLA's preferred_element_type=f32 path does)."""
    if isinstance(p, DenseLinearParams):
        if x.dtype == torch.float32:
            y = x @ p.w.to(torch.float32)
        else:
            y = torch.matmul(x, p.w)
        if p.bias is not None:
            y = y + p.bias
        return y
    if isinstance(p, QuantLinearParams):
        from .kernels.quant_matmul import quant_matmul
        return quant_matmul(x, p)
    raise TypeError(f"unknown linear params type {type(p)!r}")


def concat_linears(ps: Sequence[LinearParams]) -> Optional[LinearParams]:
    """Fuse linears that share one input into one wider linear (output
    features concatenated). None when unsupported (mixed types, act-order
    perms, mismatched quant geometry): callers keep the split path."""
    if all(isinstance(p, DenseLinearParams) for p in ps):
        bias = None
        if any(p.bias is not None for p in ps):
            bias = torch.cat([p.bias if p.bias is not None
                              else torch.zeros(p.w.shape[-1], dtype=p.w.dtype,
                                               device=p.w.device)
                              for p in ps])
        return DenseLinearParams(w=torch.cat([p.w for p in ps], dim=-1),
                                 bias=bias)
    if all(isinstance(p, QuantLinearParams) for p in ps):
        p0 = ps[0]
        if any(p.in_features != p0.in_features
               or p.group_size != p0.group_size
               or p.input_perm is not None for p in ps):
            return None
        two_level = [p.scales2 is not None for p in ps]
        if any(two_level) != all(two_level):
            return None

        def cat(f):
            return torch.cat([getattr(p, f) for p in ps], dim=-1)

        bias = None
        if any(p.bias is not None for p in ps):
            bias = torch.cat([p.bias if p.bias is not None
                              else torch.zeros(p.out_features,
                                               dtype=p0.scales.dtype,
                                               device=p0.scales.device)
                              for p in ps])
        return QuantLinearParams(
            qweight=cat("qweight"), scales=cat("scales"), zeros=cat("zeros"),
            bias=bias, in_features=p0.in_features,
            out_features=sum(p.out_features for p in ps),
            group_size=p0.group_size,
            scales2=cat("scales2") if all(two_level) else None,
            chan_scale=cat("chan_scale") if all(two_level) else None)
    return None
