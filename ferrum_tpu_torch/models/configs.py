"""Model architecture configs and the presets of the served path.

Port of `ferrum_tpu/models/configs.py` (the port keeps its own copy: it
imports nothing of the JAX package). This slice serves the dense GQA +
SwiGLU + RoPE trunk (llama, and qwen3's per-head QK-norm); the presets
are `llama-3.1-8b` (the served model), `tiny-quant` and `tiny-test`
(hardware-free parity tests). Field names and defaults follow the JAX
package so a config crosses between the two packages unchanged.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class RopeScaling:
    """Llama-3 style rope scaling (config.json `rope_scaling`)."""

    rope_type: str = "default"          # default | llama3
    factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192


@dataclass
class ModelConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    intermediate_size: int = 14336
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: Optional[RopeScaling] = None
    tie_word_embeddings: bool = False
    qk_norm: bool = False               # qwen3: per-head RMSNorm on q, k
    eos_token_ids: Tuple[int, ...] = (2,)

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def attn_scale(self) -> float:
        return 1.0 / math.sqrt(self.head_dim)


def preset(name: str) -> ModelConfig:
    n = name.lower()
    if n in ("tiny-test", "test-tiny"):
        return ModelConfig(
            vocab_size=512, hidden_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
            qk_norm=True, tie_word_embeddings=True, rope_theta=10000.0,
            eos_token_ids=(257,))
    if n in ("tiny-quant", "tiny-test-quant"):
        # Smallest shape the int4-g128 pack layout supports.
        return ModelConfig(
            vocab_size=1024, hidden_size=512,
            num_layers=2, num_heads=8, num_kv_heads=4, head_dim=64,
            intermediate_size=1024, tie_word_embeddings=True,
            rope_theta=10000.0, eos_token_ids=(2,))
    if n in ("llama-3.1-8b", "llama3.1:8b", "llama-8b"):
        return ModelConfig(
            vocab_size=128256, hidden_size=4096,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            intermediate_size=14336, rope_theta=500000.0,
            rope_scaling=RopeScaling(rope_type="llama3", factor=8.0,
                                     low_freq_factor=1.0,
                                     high_freq_factor=4.0,
                                     original_max_position_embeddings=8192),
            eos_token_ids=(128001, 128008, 128009))
    raise ValueError(f"unknown model preset {name!r} (this slice of the "
                     f"port has llama-3.1-8b, tiny-quant and tiny-test)")
