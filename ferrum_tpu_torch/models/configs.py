"""Model architecture configs and the presets of the served path.

Port of `ferrum_tpu/models/configs.py` (the port keeps its own copy: it
imports nothing of the JAX package). The port serves the GQA + SwiGLU +
RoPE trunk (llama, and qwen3's per-head QK-norm) with a dense or a
sparse-MoE MLP; the presets are `llama-3.1-8b` and `qwen3-30b-a3b` (the
served models), `qwen3-15b-a3b` (the 64-expert variant), `tiny-quant`
and `tiny-test` (hardware-free parity tests). Field names and defaults
follow the JAX package so a config crosses between the two packages
unchanged.
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
class MoeConfig:
    num_experts: int = 128
    num_experts_per_tok: int = 8
    moe_intermediate_size: int = 768
    norm_topk_prob: bool = True
    # Layers listed here use a dense MLP instead of MoE.
    mlp_only_layers: Tuple[int, ...] = ()
    decoder_sparse_step: int = 1


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
    moe: Optional[MoeConfig] = None

    @property
    def q_size(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_size(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def attn_scale(self) -> float:
        return 1.0 / math.sqrt(self.head_dim)

    def layer_is_moe(self, layer_idx: int) -> bool:
        m = self.moe
        if m is None:
            return False
        if layer_idx in m.mlp_only_layers:
            return False
        return (layer_idx + 1) % m.decoder_sparse_step == 0


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
    if n in ("qwen3-30b-a3b", "qwen3:30b-a3b", "qwen3-moe"):
        return _qwen3_moe(num_experts=128)
    if n in ("qwen3-15b-a3b", "qwen3-moe-half"):
        # The 30B-A3B architecture with half the experts (same per-token
        # active compute: 8 routed experts of the same size).
        return _qwen3_moe(num_experts=64)
    raise ValueError(f"unknown model preset {name!r} (the port has "
                     f"llama-3.1-8b, qwen3-30b-a3b, qwen3-15b-a3b, "
                     f"tiny-quant and tiny-test)")


def _qwen3_moe(num_experts: int) -> ModelConfig:
    return ModelConfig(
        vocab_size=151936, hidden_size=2048, num_layers=48, num_heads=32,
        num_kv_heads=4, head_dim=128, intermediate_size=6144,
        rope_theta=1000000.0, qk_norm=True, rms_norm_eps=1e-6,
        moe=MoeConfig(num_experts=num_experts, num_experts_per_tok=8,
                      moe_intermediate_size=768, norm_topk_prob=True),
        eos_token_ids=(151645, 151643))
