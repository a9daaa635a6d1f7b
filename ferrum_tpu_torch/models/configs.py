"""Model architecture configs, HF config.json mapping and presets.

Port of `ferrum_tpu/models/configs.py` (the port keeps its own copy: it
imports nothing of the JAX package). The port serves the GQA + SwiGLU +
RoPE trunk (llama, qwen2's q/k/v bias, qwen3's per-head QK-norm) with a
dense or a sparse-MoE MLP; the presets are `llama-3.1-8b` and
`qwen3-30b-a3b` (the served models), `qwen3-15b-a3b` (the 64-expert
variant), `tiny-quant` and `tiny-test` (hardware-free parity tests).
Field names and defaults follow the JAX package so a config crosses
between the two packages unchanged.

`config_from_hf_dict` maps a HuggingFace config.json onto the families
the trunk runs: llama, mistral (without a sliding window), qwen2, qwen3
and qwen3_moe. What the trunk does not run yet raises ModelLoadError
naming the field and its ROADMAP item, where the JAX package would load
it: gemma3, a sliding window or a logit softcap (item 8), qwen3_next,
linear-attention `layer_types` and MoE shared experts (item 11), rope
scaling other than llama3.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..types import ModelLoadError


@dataclass
class RopeScaling:
    """Llama-3 style rope scaling (config.json `rope_scaling`)."""

    rope_type: str = "default"          # default | llama3
    factor: float = 1.0
    low_freq_factor: float = 1.0
    high_freq_factor: float = 4.0
    original_max_position_embeddings: int = 8192

    @classmethod
    def from_hf(cls, d: Optional[Dict[str, Any]]) -> Optional["RopeScaling"]:
        if not d:
            return None
        return cls(
            rope_type=d.get("rope_type", d.get("type", "default")),
            factor=float(d.get("factor", 1.0)),
            low_freq_factor=float(d.get("low_freq_factor", 1.0)),
            high_freq_factor=float(d.get("high_freq_factor", 4.0)),
            original_max_position_embeddings=int(
                d.get("original_max_position_embeddings", 8192)),
        )


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
    family: str = "llama"               # llama | mistral | qwen2 | qwen3 | qwen3_moe
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
    max_position_embeddings: int = 8192
    tie_word_embeddings: bool = False
    qk_norm: bool = False               # qwen3: per-head RMSNorm on q, k
    moe: Optional[MoeConfig] = None
    bos_token_id: Optional[int] = 1
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
            family="qwen3", vocab_size=512, hidden_size=64, num_layers=2,
            num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
            qk_norm=True, tie_word_embeddings=True, rope_theta=10000.0,
            max_position_embeddings=2048, eos_token_ids=(257,))
    if n in ("tiny-quant", "tiny-test-quant"):
        # Smallest shape the int4-g128 pack layout supports.
        return ModelConfig(
            family="llama", vocab_size=1024, hidden_size=512,
            num_layers=2, num_heads=8, num_kv_heads=4, head_dim=64,
            intermediate_size=1024, tie_word_embeddings=True,
            rope_theta=10000.0, max_position_embeddings=4096,
            eos_token_ids=(2,))
    if n in ("llama-3.1-8b", "llama3.1:8b", "llama-8b"):
        return ModelConfig(
            family="llama", vocab_size=128256, hidden_size=4096,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            intermediate_size=14336, rope_theta=500000.0,
            max_position_embeddings=131072,
            rope_scaling=RopeScaling(rope_type="llama3", factor=8.0,
                                     low_freq_factor=1.0,
                                     high_freq_factor=4.0,
                                     original_max_position_embeddings=8192),
            bos_token_id=128000, eos_token_ids=(128001, 128008, 128009))
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
        family="qwen3_moe", vocab_size=151936, hidden_size=2048,
        num_layers=48, num_heads=32, num_kv_heads=4, head_dim=128,
        intermediate_size=6144, rope_theta=1000000.0, qk_norm=True,
        rms_norm_eps=1e-6, max_position_embeddings=40960,
        moe=MoeConfig(num_experts=num_experts, num_experts_per_tok=8,
                      moe_intermediate_size=768, norm_topk_prob=True),
        bos_token_id=151643, eos_token_ids=(151645, 151643))


# ---------------------------------------------------------------------------
# HF config.json -> ModelConfig
# ---------------------------------------------------------------------------

_HF_ARCH_FAMILY = {
    "LlamaForCausalLM": "llama",
    "MistralForCausalLM": "mistral",
    "Qwen2ForCausalLM": "qwen2",
    "Qwen3ForCausalLM": "qwen3",
    "Gemma3ForCausalLM": "gemma3",
    "Gemma3ForConditionalGeneration": "gemma3",
    "Qwen3MoeForCausalLM": "qwen3_moe",
    "Qwen3NextForCausalLM": "qwen3_next",
}
# Families the JAX package maps that the port's trunk does not run yet,
# with their ROADMAP Queue 1 item.
_NOT_PORTED_FAMILY = {"gemma3": 8, "qwen3_next": 11}


def family_from_hf_architectures(archs: List[str]) -> str:
    for a in archs:
        if a in _HF_ARCH_FAMILY:
            return _HF_ARCH_FAMILY[a]
    raise ModelLoadError(
        f"unsupported architectures {archs!r}; supported: "
        f"{sorted(_HF_ARCH_FAMILY)}", param="architectures")


def _not_ported(field: str, value: Any, item: int) -> ModelLoadError:
    return ModelLoadError(
        f"config.json {field}={value!r} is not yet ported (ROADMAP Queue 1 "
        f"item {item})", param=field)


def _check_ported(d: Dict[str, Any], family: str) -> None:
    """Raise on what the JAX package maps and the port's trunk cannot
    run (the port never drops a field silently)."""
    if family in _NOT_PORTED_FAMILY:
        raise _not_ported("architectures", d.get("architectures"),
                          _NOT_PORTED_FAMILY[family])
    if family == "mistral" and d.get("sliding_window") is not None:
        raise _not_ported("sliding_window", d["sliding_window"], 8)
    if d.get("use_sliding_window"):
        raise _not_ported("use_sliding_window", True, 8)
    for key in ("final_logit_softcapping", "attn_logit_softcapping"):
        if d.get(key) is not None:
            raise _not_ported(key, d[key], 8)
    kinds = set(d.get("layer_types") or ()) - {"full_attention"}
    if kinds:
        raise _not_ported("layer_types", sorted(kinds),
                          11 if "linear_attention" in kinds else 8)
    if int(d.get("shared_expert_intermediate_size", 0) or 0):
        raise _not_ported("shared_expert_intermediate_size",
                          d["shared_expert_intermediate_size"], 11)
    rs = RopeScaling.from_hf(d.get("rope_scaling"))
    if rs is not None and rs.rope_type not in ("default", "llama3"):
        raise _not_ported("rope_scaling.rope_type", rs.rope_type, 8)


def config_from_hf_dict(d: Dict[str, Any]) -> ModelConfig:
    """Map a HuggingFace config.json dict to ModelConfig, as the JAX
    package's `config_from_hf_dict` does for the families the port runs;
    the others raise ModelLoadError (`_check_ported`)."""
    if "text_config" in d:  # Gemma3ForConditionalGeneration wraps text config
        inner = dict(d["text_config"])
        inner.setdefault("architectures", d.get("architectures", []))
        d = inner
    family = family_from_hf_architectures(d.get("architectures", []))
    _check_ported(d, family)
    hidden = int(d["hidden_size"])
    heads = int(d["num_attention_heads"])
    eos = d.get("eos_token_id", 2)
    cfg = ModelConfig(
        family=family,
        vocab_size=int(d["vocab_size"]),
        hidden_size=hidden,
        num_layers=int(d["num_hidden_layers"]),
        num_heads=heads,
        num_kv_heads=int(d.get("num_key_value_heads", heads)),
        head_dim=int(d.get("head_dim") or hidden // heads),
        intermediate_size=int(d["intermediate_size"]),
        rms_norm_eps=float(d.get("rms_norm_eps", 1e-6)),
        rope_theta=float(d.get("rope_theta", 10000.0)),
        rope_scaling=RopeScaling.from_hf(d.get("rope_scaling")),
        max_position_embeddings=int(d.get("max_position_embeddings", 8192)),
        tie_word_embeddings=bool(d.get("tie_word_embeddings", False)),
        qk_norm=family in ("qwen3", "qwen3_moe"),
        bos_token_id=d.get("bos_token_id"),
        eos_token_ids=tuple(eos) if isinstance(eos, list) else (int(eos),),
    )
    if family == "qwen3_moe":
        cfg.moe = MoeConfig(
            num_experts=int(d.get("num_experts", 128)),
            num_experts_per_tok=int(d.get("num_experts_per_tok", 8)),
            moe_intermediate_size=int(d.get("moe_intermediate_size", 768)),
            norm_topk_prob=bool(d.get("norm_topk_prob", True)),
            mlp_only_layers=tuple(d.get("mlp_only_layers", []) or []),
            decoder_sparse_step=int(d.get("decoder_sparse_step", 1)),
        )
    return cfg


def config_from_hf_json(path: str) -> ModelConfig:
    with open(path) as f:
        return config_from_hf_dict(json.load(f))
