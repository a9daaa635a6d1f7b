"""RMSNorm and fused residual-add RMSNorm (plain PyTorch).

Port of `ferrum_tpu/ops/norms.py`. These are plain XLA in the JAX
package (no Pallas kernel), so they stay plain tensor code here.
Accumulation is in f32 whatever the activation dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             *, gemma_style: bool = False) -> torch.Tensor:
    """RMSNorm over the last axis. gemma_style: the weight is stored as
    (w - 1) and applied as (1 + w), added in f32 after the cast (Gemma
    checkpoints)."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.reciprocal(torch.sqrt(var + eps))
    w = weight.to(torch.float32)
    if gemma_style:
        w = 1.0 + w
    return (xf * w).to(dtype)


def fused_add_rms_norm(x: torch.Tensor, residual: torch.Tensor,
                       weight: torch.Tensor, eps: float,
                       *, gemma_style: bool = False):
    """(x + residual) then RMSNorm; returns (normed, new_residual)."""
    s = (x.to(torch.float32) + residual.to(torch.float32)).to(x.dtype)
    return rms_norm(s, weight, eps, gemma_style=gemma_style), s
