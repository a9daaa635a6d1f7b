"""EngineBuilder: weights → two-level requantize → fusion → KV → engine.

Port of `ferrum_tpu/engine/builder.py` for the served path: explicit
model config + params (`with_model`), the linear KV layout (every slot
reserves a full max_model_len region), q|k|v and gate|up fusion, the
quantized-matmul mode (`EngineConfig.w4a8`, and `w4a8_gd`: the decode
kernel of two-level weights, mxu | all | down | off, routed as
ops/kernels/quant_matmul.py's table says) and, under
w4a8 with `w4a8_two_level`, the two-level requantization (dense linears
and MoE expert stacks). Without it the checkpoint's group scales are
served as they are: float-scale w4a8 at decode m, w4a16 elsewhere.
Checkpoint loading, the paged layout and its HBM autosizing come with
later slices.

The mode is a process-wide switch, as in the JAX package: `build()`
sets both switches, so building a second engine with another `w4a8` or
`w4a8_gd` changes the route of the first one too.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..config import EngineConfig
from ..device import resolve_device
from ..models.configs import ModelConfig
from ..models.llama_family import ModelParams, PagedKvCache
from ..ops.kernels.quant_matmul import set_w4a8, set_w4a8_gd
from ..ops.linear import concat_linears
from ..ops.quant import QuantLinearParams, requantize_two_level
from ..tokenizer import ByteTokenizer, make_byte_tokenizer
from ..types import ModelLoadError
from .engine import ContinuousBatchEngine
from .runner import ModelRunner


def fuse_projections(params: ModelParams) -> ModelParams:
    """q|k|v and gate|up fused into one linear each (one kernel launch
    per site instead of 2-3), layer by layer and in place, so the split
    weights are freed as each layer is fused. MoE layers have no dense
    gate/up; their expert stacks stay split (the JAX package's default
    fuse sites), sharing one activation quantization instead."""
    for lp in params.layers:
        if lp.qkv is None and lp.q is not None:
            qkv = concat_linears([lp.q, lp.k, lp.v])
            if qkv is not None:
                lp.qkv, lp.q, lp.k, lp.v = qkv, None, None, None
        if lp.gate_up is None and lp.gate is not None:
            gu = concat_linears([lp.gate, lp.up])
            if gu is not None:
                lp.gate_up, lp.gate, lp.up = gu, None, None
    return params


def apply_two_level(params: ModelParams) -> ModelParams:
    """Requantize every int4 linear into the two-level w4a8 form, in
    place (a no-op for params that already carry scales2)."""
    def rq(lin):
        return requantize_two_level(lin) \
            if isinstance(lin, QuantLinearParams) else lin

    for lp in params.layers:
        for obj in (lp, lp.moe) if lp.moe is not None else (lp,):
            for f in dataclasses.fields(obj):
                setattr(obj, f.name, rq(getattr(obj, f.name)))
    params.lm_head = rq(params.lm_head)
    return params


class EngineBuilder:
    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.model_cfg: Optional[ModelConfig] = None
        self.params: Optional[ModelParams] = None
        self.tokenizer: Optional[ByteTokenizer] = None

    def with_model(self, model_cfg: ModelConfig,
                   params: ModelParams) -> "EngineBuilder":
        self.model_cfg = model_cfg
        self.params = params
        return self

    def with_tokenizer(self, tok: ByteTokenizer) -> "EngineBuilder":
        self.tokenizer = tok
        return self

    def build(self) -> ContinuousBatchEngine:
        cfg = self.cfg
        cfg.validate()
        device = resolve_device(cfg.device)
        if self.model_cfg is None:
            raise ModelLoadError(
                "this slice of the port builds from explicit params "
                "(with_model); checkpoint loaders come later")
        if self.params.embed.device.type != device.type:
            raise ModelLoadError(f"params live on {self.params.embed.device}"
                                 f", the engine on {device}")
        if self.tokenizer is None:
            self.tokenizer = make_byte_tokenizer(
                vocab_extra=max(0, self.model_cfg.vocab_size - 258))
        set_w4a8(cfg.w4a8)
        set_w4a8_gd(cfg.w4a8_gd)
        if cfg.w4a8 and cfg.w4a8_two_level:
            self.params = apply_two_level(self.params)
        self.params = fuse_projections(self.params)
        kv_dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[
            cfg.kv_dtype]
        kv = PagedKvCache.create(
            self.model_cfg, cfg.num_slots * cfg.max_blocks_per_seq,
            cfg.kv_block_size, dtype=kv_dtype, device=device)
        runner = ModelRunner(self.model_cfg, cfg, self.params, kv, device)
        return ContinuousBatchEngine(cfg, runner, self.tokenizer)
