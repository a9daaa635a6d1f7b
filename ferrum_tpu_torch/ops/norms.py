"""RMSNorm and fused residual-add RMSNorm (plain PyTorch).

Port of `ferrum_tpu/ops/norms.py`. These are plain XLA in the JAX
package (no Pallas kernel), so they stay plain tensor code here.
Accumulation is in f32 whatever the activation dtype.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMSNorm over the last axis."""
    dtype = x.dtype
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.reciprocal(torch.sqrt(var + eps))
    return (xf * weight.to(torch.float32)).to(dtype)


def fused_add_rms_norm(x: torch.Tensor, residual: torch.Tensor,
                       weight: torch.Tensor, eps: float):
    """(x + residual) then RMSNorm; returns (normed, new_residual)."""
    s = (x.to(torch.float32) + residual.to(torch.float32)).to(x.dtype)
    return rms_norm(s, weight, eps), s
