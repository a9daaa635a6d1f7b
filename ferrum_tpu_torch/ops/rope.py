"""Rotary position embeddings, NeoX/HF half-split layout (plain PyTorch).

Port of `ferrum_tpu/ops/rope.py`, including Llama-3.1 frequency-band
rope scaling and linear scaling (gemma3's global layers). Frequencies are computed on the host in float64 and kept
in f32, exactly as the JAX package does.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..models.configs import RopeScaling


def rope_inv_freq(head_dim: int, theta: float,
                  scaling: Optional[RopeScaling] = None) -> np.ndarray:
    """Per-pair inverse frequencies [head_dim // 2], f32 (host-side)."""
    inv = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                           / head_dim))
    if scaling is not None and scaling.rope_type == "llama3":
        orig = scaling.original_max_position_embeddings
        low_wl = orig / scaling.low_freq_factor
        high_wl = orig / scaling.high_freq_factor
        wavelen = 2.0 * math.pi / inv
        scaled = np.where(wavelen > low_wl, inv / scaling.factor, inv)
        smooth = (orig / wavelen - scaling.low_freq_factor) / (
            scaling.high_freq_factor - scaling.low_freq_factor)
        mid = (1.0 - smooth) * inv / scaling.factor + smooth * inv
        is_mid = (wavelen <= low_wl) & (wavelen >= high_wl)
        inv = np.where(is_mid, mid, scaled)
    elif scaling is not None and scaling.rope_type == "linear":
        inv = inv / scaling.factor
    elif scaling is not None and scaling.rope_type != "default":
        # The JAX package computes other types as unscaled RoPE
        # (ROADMAP Queue 3); the config mapping refuses them.
        raise NotImplementedError(f"rope scaling {scaling.rope_type!r}")
    return inv.astype(np.float32)


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor):
    """positions int [...] → (cos, sin) each f32 [..., head_dim // 2]."""
    angles = positions.to(torch.float32)[..., None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """Rotate q or k. x: [..., heads, head_dim]; cos/sin: [..., head_dim/2]."""
    d2 = x.shape[-1] // 2
    x1 = x[..., :d2].to(torch.float32)
    x2 = x[..., d2:].to(torch.float32)
    c = cos[..., None, :]
    s = sin[..., None, :]
    r1 = x1 * c - x2 * s
    r2 = x2 * c + x1 * s
    return torch.cat([r1, r2], dim=-1).to(x.dtype)
