"""Model architecture configs, HF config.json mapping and presets.

Port of `ferrum_tpu/models/configs.py` (the port keeps its own copy: it
imports nothing of the JAX package). The port serves the GQA + SwiGLU +
RoPE trunk (llama, qwen2's q/k/v bias, qwen3's per-head QK-norm) with a
dense or a sparse-MoE MLP; the presets are `llama-3.1-8b` and
`qwen3-30b-a3b` (the served models), `qwen3-15b-a3b` (the 64-expert
variant), `llama-3.3-70b`, `qwen3-0.6b`, `qwen3-4b` and `qwen3-8b` (the
JAX package's other presets), `tiny-quant` and `tiny-test`
(hardware-free parity tests).
Field names and defaults follow the JAX package so a config crosses
between the two packages unchanged.

`config_from_hf_dict` maps a HuggingFace config.json onto the families
the trunk runs: llama, mistral (with its sliding window), qwen2, qwen3,
qwen3_moe and gemma3 (5:1 local/global attention, dual RoPE, GeGLU,
sandwich norms, the embedding scale and both logit softcaps). What the
trunk does not run yet raises ModelLoadError naming the field and its
ROADMAP item, where the JAX package would load it: qwen3_next,
linear-attention `layer_types` and MoE shared experts (item 11). What
the JAX mapping reads and then computes as another model raises too,
naming ROADMAP Queue 3: `use_sliding_window` on qwen2/qwen3,
`sliding_attention` layer types on a family whose mapping sets no
window, a logit softcap outside gemma3, and rope type yarn (computed
as unscaled RoPE).
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from ..types import ModelLoadError


@dataclass
class RopeScaling:
    """Rope scaling (config.json `rope_scaling`): llama3 frequency bands,
    or linear (positions divided by `factor`)."""

    rope_type: str = "default"          # default | llama3 | linear
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
    family: str = "llama"   # llama | mistral | qwen2 | qwen3 | qwen3_moe | gemma3
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
    sliding_window: Optional[int] = None
    # gemma3: every Nth layer is global, the others sliding-window local.
    sliding_window_pattern: int = 0     # 0 = uniform (all global or all SWA)
    # Explicit per-layer attention kinds (HF `layer_types`):
    # "full_attention" | "sliding_attention"; overrides the pattern.
    layer_types: Optional[Tuple[str, ...]] = None
    activation: str = "silu"            # silu | gelu_tanh
    # gemma3 extras
    query_pre_attn_scalar: Optional[float] = None
    sandwich_norms: bool = False        # pre+post norms around attn and mlp
    embedding_multiplier: Optional[float] = None  # sqrt(hidden) for gemma
    rope_local_theta: float = 10000.0   # gemma3 local-layer rope base
    final_logit_softcap: Optional[float] = None
    attn_logit_softcap: Optional[float] = None
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
        if self.query_pre_attn_scalar is not None:
            return 1.0 / math.sqrt(self.query_pre_attn_scalar)
        return 1.0 / math.sqrt(self.head_dim)

    def layer_sliding_window(self, layer_idx: int) -> Optional[int]:
        """A layer's sliding window (gemma3's 5:1 pattern), None for
        full attention."""
        if self.sliding_window is None:
            return None
        if self.layer_types is not None:
            return self.sliding_window \
                if self.layer_types[layer_idx] == "sliding_attention" else None
        # gemma3: every `pattern`-th layer (1-indexed) is global.
        p = self.sliding_window_pattern
        if p > 0 and (layer_idx + 1) % p == 0:
            return None
        return self.sliding_window

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
    if n in ("llama-3.3-70b", "llama3.3:70b", "llama-70b"):
        return ModelConfig(
            family="llama", vocab_size=128256, hidden_size=8192,
            num_layers=80, num_heads=64, num_kv_heads=8, head_dim=128,
            intermediate_size=28672, rope_theta=500000.0,
            max_position_embeddings=131072,
            rope_scaling=RopeScaling(rope_type="llama3", factor=8.0,
                                     low_freq_factor=1.0,
                                     high_freq_factor=4.0,
                                     original_max_position_embeddings=8192),
            bos_token_id=128000, eos_token_ids=(128001, 128008, 128009))
    if n in ("qwen3-0.6b", "qwen3:0.6b"):
        return _qwen3_dense(hidden=1024, layers=28, heads=16, inter=3072,
                            tied=True)
    if n in ("qwen3-4b", "qwen3:4b"):
        return _qwen3_dense(hidden=2560, layers=36, heads=32, inter=9728,
                            tied=True)
    if n in ("qwen3-8b", "qwen3:8b"):
        return _qwen3_dense(hidden=4096, layers=36, heads=32, inter=12288,
                            tied=False)
    if n in ("qwen3-30b-a3b", "qwen3:30b-a3b", "qwen3-moe"):
        return _qwen3_moe(num_experts=128)
    if n in ("qwen3-15b-a3b", "qwen3-moe-half"):
        # The 30B-A3B architecture with half the experts (same per-token
        # active compute: 8 routed experts of the same size).
        return _qwen3_moe(num_experts=64)
    raise ValueError(f"unknown model preset {name!r} (the port has "
                     f"llama-3.1-8b, llama-3.3-70b, qwen3-0.6b, qwen3-4b, "
                     f"qwen3-8b, qwen3-30b-a3b, qwen3-15b-a3b, tiny-quant "
                     f"and tiny-test)")


def _qwen3_dense(hidden: int, layers: int, heads: int, inter: int,
                 tied: bool) -> ModelConfig:
    return ModelConfig(
        family="qwen3", vocab_size=151936, hidden_size=hidden,
        num_layers=layers, num_heads=heads, num_kv_heads=8, head_dim=128,
        intermediate_size=inter, rope_theta=1000000.0, qk_norm=True,
        tie_word_embeddings=tied, rms_norm_eps=1e-6,
        max_position_embeddings=40960,
        bos_token_id=151643, eos_token_ids=(151645, 151643))


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
_NOT_PORTED_FAMILY = {"qwen3_next": 11}
# Families whose mapping sets `sliding_window` (gemma3 always, mistral
# from config.json), and so honours `sliding_attention` layer types.
_WINDOW_FAMILIES = ("mistral", "gemma3")
_ROPE_TYPES = ("default", "llama3", "linear")


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


def _misread(field: str, value: Any, family: str) -> ModelLoadError:
    return ModelLoadError(
        f"config.json {field}={value!r} on {family}: the JAX package's "
        f"mapping computes another model from it (ROADMAP Queue 3), so the "
        f"port refuses it", param=field)


def _check_ported(d: Dict[str, Any], family: str) -> None:
    """Raise on what the JAX package maps and the port's trunk cannot
    run, and on what the JAX mapping reads and drops (the port never
    drops a field silently)."""
    if family in _NOT_PORTED_FAMILY:
        raise _not_ported("architectures", d.get("architectures"),
                          _NOT_PORTED_FAMILY[family])
    if d.get("use_sliding_window") and family not in _WINDOW_FAMILIES:
        raise _misread("use_sliding_window", True, family)
    if family != "gemma3":
        for key in ("final_logit_softcapping", "attn_logit_softcapping"):
            if d.get(key) is not None:
                raise _misread(key, d[key], family)
    kinds = set(d.get("layer_types") or ()) - {"full_attention"}
    if "linear_attention" in kinds:
        raise _not_ported("layer_types", sorted(kinds), 11)
    windowed = family == "gemma3" or (
        family == "mistral" and d.get("sliding_window") is not None)
    if kinds - {"sliding_attention"} or (kinds and not windowed):
        raise _misread("layer_types", sorted(kinds), family)
    if int(d.get("shared_expert_intermediate_size", 0) or 0):
        raise _not_ported("shared_expert_intermediate_size",
                          d["shared_expert_intermediate_size"], 11)
    rs = RopeScaling.from_hf(d.get("rope_scaling"))
    if rs is not None and rs.rope_type not in _ROPE_TYPES:
        raise _misread("rope_scaling.rope_type", rs.rope_type, family)


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
    head_dim = int(d.get("head_dim") or hidden // heads)
    eos = d.get("eos_token_id", 2)
    cfg = ModelConfig(
        family=family,
        vocab_size=int(d["vocab_size"]),
        hidden_size=hidden,
        num_layers=int(d["num_hidden_layers"]),
        num_heads=heads,
        num_kv_heads=int(d.get("num_key_value_heads", heads)),
        head_dim=head_dim,
        intermediate_size=int(d["intermediate_size"]),
        rms_norm_eps=float(d.get("rms_norm_eps", 1e-6)),
        rope_theta=float(d.get("rope_theta", 10000.0)),
        rope_scaling=RopeScaling.from_hf(d.get("rope_scaling")),
        max_position_embeddings=int(d.get("max_position_embeddings", 8192)),
        tie_word_embeddings=bool(d.get("tie_word_embeddings", False)),
        qk_norm=family in ("qwen3", "qwen3_moe", "gemma3"),
        bos_token_id=d.get("bos_token_id"),
        eos_token_ids=tuple(eos) if isinstance(eos, list) else (int(eos),),
    )
    if family == "mistral":
        cfg.sliding_window = d.get("sliding_window")
    if d.get("layer_types"):
        cfg.layer_types = tuple(d["layer_types"])
    if family == "gemma3":
        cfg.activation = "gelu_tanh"
        cfg.sandwich_norms = True
        cfg.sliding_window = d.get("sliding_window", 1024)
        cfg.sliding_window_pattern = int(d.get("sliding_window_pattern", 6))
        cfg.query_pre_attn_scalar = float(d.get("query_pre_attn_scalar",
                                                head_dim))
        cfg.embedding_multiplier = math.sqrt(hidden)
        cfg.rope_local_theta = float(d.get("rope_local_base_freq", 10000.0))
        cfg.final_logit_softcap = d.get("final_logit_softcapping")
        cfg.attn_logit_softcap = d.get("attn_logit_softcapping")
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
