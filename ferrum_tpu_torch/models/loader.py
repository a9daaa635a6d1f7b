"""Checkpoint loaders: HF safetensors (bf16 / f16 / f32) and GPTQ int4.

Port of `ferrum_tpu/models/loader.py`: safetensors shards (the port's own
reader, models/safetensors_io.py: the card's machine has no
`safetensors`) -> ModelParams on a device, with GPTQ detected from
quantize_config.json / config.json and repacked on load into the packed
int4 layout (ops/quant.py::repack_from_gptq, on the device), or a dense
checkpoint quantized on load (`quantization="gptq_int4"`). Every tensor
goes to the device as it is read, so host memory holds one tensor.

Weight convention: HF stores linear weights [out, in]; the port stores
[in, out] (x @ W), so dense weights transpose on load. GPTQ stores
[in/8, out] packed, no transpose.

BF16 shards, the form Llama-3.1 and Qwen3 checkpoints ship in, are read
without numpy's missing bfloat16 (an int16 view, safetensors_io.py).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from ..config import EngineConfig
from ..device import resolve_device
from ..ops.linear import DenseLinearParams
from ..ops.quant import (QuantLinearParams, make_quant_linear,
                         repack_from_gptq)
from ..tokenizer import FerrumTokenizer
from ..types import ModelLoadError
from .configs import ModelConfig, config_from_hf_json
from .llama_family import LayerParams, ModelParams, MoeLayerParams
from .quantize import _quant_expert_stack
from .safetensors_io import SafetensorsFile

Device = Union[str, torch.device]


class TensorSource:
    """Named CPU tensors: a dict (tests) or safetensors shards read
    lazily (`from_dir`)."""

    def __init__(self, tensors: Mapping[str, Any]):
        self._t = tensors

    def __contains__(self, name: str) -> bool:
        return name in self._t

    def get(self, name: str) -> torch.Tensor:
        try:
            t = self._t[name]
        except KeyError:
            raise ModelLoadError(f"missing tensor {name!r}") from None
        if isinstance(t, np.ndarray):
            t = torch.from_numpy(np.ascontiguousarray(t))
        return t

    def keys(self):
        return self._t.keys()

    @classmethod
    def from_dir(cls, model_dir: str) -> "TensorSource":
        """Every *.safetensors under `model_dir`, in sorted order; a name
        in two shards takes the later shard's tensor."""
        files = sorted(glob.glob(os.path.join(model_dir, "*.safetensors")))
        if not files:
            raise ModelLoadError(f"no .safetensors under {model_dir}")
        return cls(_Shards([SafetensorsFile(f) for f in files]))


class _Shards:
    """name -> the shard holding it; a tensor is read when asked for."""

    def __init__(self, shards):
        self._where = {k: s for s in shards for k in s.keys()}

    def __contains__(self, name: str) -> bool:
        return name in self._where

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._where[name].get(name)

    def keys(self):
        return self._where.keys()


def _norm(src: TensorSource, name: str, dtype, device) -> torch.Tensor:
    return src.get(name).to(device).to(dtype)


def _maybe(src: TensorSource, name: str, dtype, device
           ) -> Optional[torch.Tensor]:
    return _norm(src, name, dtype, device) if name in src else None


def _dense(src: TensorSource, prefix: str, dtype, device
           ) -> DenseLinearParams:
    w = _norm(src, prefix + ".weight", dtype, device)
    return DenseLinearParams(w=w.t().contiguous(),
                             bias=_maybe(src, prefix + ".bias", dtype, device))


def _gptq_parts(src: TensorSource, prefix: str, device):
    """(packed, scales f32, zeros, group, perm, in, out) of one GPTQ
    linear, repacked on `device`."""
    qweight = src.get(prefix + ".qweight").to(device)
    g_idx = src.get(prefix + ".g_idx").to(device) \
        if (prefix + ".g_idx") in src else None
    packed, sc, z, group, perm = repack_from_gptq(
        qweight, src.get(prefix + ".qzeros").to(device),
        src.get(prefix + ".scales").to(device), g_idx)
    return packed, sc, z, group, perm, qweight.shape[0] * 8, qweight.shape[1]


def _gptq(src: TensorSource, prefix: str, dtype, device) -> QuantLinearParams:
    packed, sc, z, group, perm, in_f, out_f = _gptq_parts(src, prefix, device)
    return QuantLinearParams(
        qweight=packed, scales=sc.to(dtype), zeros=z,
        bias=_maybe(src, prefix + ".bias", dtype, device),
        in_features=in_f, out_features=out_f, group_size=group,
        input_perm=perm)


def _linear(src: TensorSource, prefix: str, dtype, device,
            quantize_rtn: bool = False) -> Any:
    """GPTQ tensors when present, else dense (quantized on load, int4
    g128 symmetric, when `quantize_rtn` and in_features allow)."""
    if (prefix + ".qweight") in src:
        return _gptq(src, prefix, dtype, device)
    d = _dense(src, prefix, dtype, device)
    if quantize_rtn and d.w.shape[0] % 128 == 0:
        q = make_quant_linear(d.w.to(torch.float32), group_size=128,
                              dtype=dtype)
        q.bias = d.bias
        return q
    return d


def _expert_stack(src: TensorSource, layer_prefix: str, proj: str,
                  num_experts: int, dtype, device, quantize_rtn: bool):
    """MoE expert weights -> one stack with a leading expert dim: GPTQ
    experts repacked one at a time (act-order ones raise: per-expert
    input permutations cannot share one activation gather in the grouped
    kernels), dense experts quantized on load
    (models/quantize.py::_quant_expert_stack), or a dense [E, in, out]
    stack (`quantization="none"`: ops/moe.py's dense route)."""
    names = [f"{layer_prefix}.mlp.experts.{e}.{proj}"
             for e in range(num_experts)]
    if f"{names[0]}.qweight" in src:
        packs, scs, zs = [], [], []
        for ep in names:
            packed, sc, z, group, perm, _, out_f = _gptq_parts(src, ep, device)
            if perm is not None:
                raise ModelLoadError(
                    "act-order (desc_act) GPTQ MoE experts are not "
                    "supported: per-expert activation permutations "
                    f"({ep}.g_idx)")
            packs.append(packed)
            scs.append(sc)
            zs.append(z)
        return QuantLinearParams(
            qweight=torch.stack(packs), scales=torch.stack(scs).to(dtype),
            zeros=torch.stack(zs), bias=None,
            in_features=packs[0].shape[0] * 2, out_features=out_f,
            group_size=group)
    stack = torch.stack([src.get(f"{ep}.weight").to(device).t()
                         for ep in names])
    if quantize_rtn and stack.shape[1] % 256 == 0:
        return _quant_expert_stack(stack, group_size=128, dtype=dtype)
    return stack.to(dtype)


def params_from_hf(cfg: ModelConfig, src: TensorSource, dtype=torch.bfloat16,
                   quantize_rtn: bool = False,
                   device: Optional[Device] = None) -> ModelParams:
    """HF tensor names -> ModelParams on `device` (the families
    `config_from_hf_dict` admits; None = the CUDA card, raising without
    one)."""
    device = resolve_device(device)
    # gemma3: post_attention_layernorm is the attention's sandwich norm;
    # pre_/post_feedforward_layernorm wrap the MLP.
    gemma = cfg.family == "gemma3"
    layers = []
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        a = f"{p}.self_attn"
        moe = None
        gate = up = down = None
        if cfg.layer_is_moe(i):
            m = cfg.moe
            moe = MoeLayerParams(
                router=_dense(src, f"{p}.mlp.gate", dtype, device),
                **{name: _expert_stack(src, p, f"{name}_proj", m.num_experts,
                                       dtype, device, quantize_rtn)
                   for name in ("gate", "up", "down")})
        else:
            gate, up, down = (
                _linear(src, f"{p}.mlp.{name}_proj", dtype, device,
                        quantize_rtn) for name in ("gate", "up", "down"))
        q, k, v, o = (_linear(src, f"{a}.{name}_proj", dtype, device,
                              quantize_rtn) for name in "qkvo")
        layers.append(LayerParams(
            input_norm=_norm(src, f"{p}.input_layernorm.weight", dtype,
                             device),
            q=q, k=k, v=v, o=o,
            q_norm=_maybe(src, f"{a}.q_norm.weight", dtype, device),
            k_norm=_maybe(src, f"{a}.k_norm.weight", dtype, device),
            pre_mlp_norm=_norm(
                src, f"{p}.pre_feedforward_layernorm.weight" if gemma
                else f"{p}.post_attention_layernorm.weight", dtype, device),
            gate=gate, up=up, down=down, moe=moe,
            post_attn_norm=_maybe(
                src, f"{p}.post_attention_layernorm.weight", dtype, device)
            if gemma else None,
            post_mlp_norm=_maybe(
                src, f"{p}.post_feedforward_layernorm.weight", dtype, device)
            if gemma else None))
    lm_head = None
    if not cfg.tie_word_embeddings:
        if "lm_head.qweight" in src:
            raise ModelLoadError("a quantized lm_head (lm_head.qweight) is "
                                 "not yet ported", param="lm_head")
        if "lm_head.weight" in src:
            lm_head = _dense(src, "lm_head", dtype, device)
    return ModelParams(
        embed=_norm(src, "model.embed_tokens.weight", dtype, device),
        layers=layers,
        final_norm=_norm(src, "model.norm.weight", dtype, device),
        lm_head=lm_head)


def detect_quantization(model_dir: str) -> str:
    """"gptq_int4" for a 4-bit GPTQ directory, else "none"; another
    quantization method, bit width or GPTQ storage format raises."""
    if os.path.exists(os.path.join(model_dir, "quantize_config.json")):
        with open(os.path.join(model_dir, "quantize_config.json")) as f:
            _check_gptq(json.load(f))
        return "gptq_int4"
    cfg_path = os.path.join(model_dir, "config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            q = json.load(f).get("quantization_config")
        if q:
            if q.get("quant_method") != "gptq":
                raise ModelLoadError(
                    f"quantization_config.quant_method="
                    f"{q.get('quant_method')!r}: only GPTQ is supported",
                    param="quant_method")
            _check_gptq(q)
            return "gptq_int4"
    return "none"


def _check_gptq(q: Dict[str, Any]) -> None:
    if int(q.get("bits", 4)) != 4:
        raise ModelLoadError("only 4-bit GPTQ supported", param="bits")
    fmt = q.get("checkpoint_format", "gptq")
    if fmt != "gptq":
        # gptq_v2 stores the zeros without AutoGPTQ's - 1.
        raise ModelLoadError(f"GPTQ checkpoint_format={fmt!r}: only 'gptq'",
                             param="checkpoint_format")


def load_checkpoint(model_dir: str, engine_cfg: EngineConfig,
                    device: Optional[Device] = None
                    ) -> Tuple[ModelConfig, ModelParams, Any]:
    """A local HF checkpoint directory -> (ModelConfig, ModelParams on
    `device`, its tokenizer or None without a tokenizer.json). `device`
    None takes `engine_cfg.device`, and that None the CUDA card
    (raising without one). The tokenizer's eos ids, where it has any,
    become the config's."""
    device = resolve_device(engine_cfg.device if device is None else device)
    cfg_path = os.path.join(model_dir, "config.json")
    if not os.path.exists(cfg_path):
        raise ModelLoadError(f"no config.json under {model_dir}")
    model_cfg = config_from_hf_json(cfg_path)
    dtype = torch.bfloat16 if engine_cfg.dtype == "bf16" else torch.float32
    quantize_rtn = engine_cfg.quantization == "gptq_int4" \
        and detect_quantization(model_dir) == "none"
    params = params_from_hf(model_cfg, TensorSource.from_dir(model_dir),
                            dtype=dtype, quantize_rtn=quantize_rtn,
                            device=device)
    tok = None
    if os.path.exists(os.path.join(model_dir, "tokenizer.json")):
        tok = FerrumTokenizer.from_pretrained(model_dir)
        if tok.eos_token_ids:
            model_cfg.eos_token_ids = tuple(tok.eos_token_ids)
    return model_cfg, params, tok
