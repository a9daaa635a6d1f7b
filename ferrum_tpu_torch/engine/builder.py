"""EngineBuilder: weights → two-level requantize → fusion → KV → engine.

Port of `ferrum_tpu/engine/builder.py` for the served path: explicit
model config + params (`with_model`), the linear KV layout (every slot
reserves a full max_model_len region), build-time fusion at the sites
of `fuse_sites` (q|k|v and gate|up by default, the expert stacks'
gate|up with "moe"; none with `fuse_proj=False`), the
quantized-matmul mode (`EngineConfig.w4a8`, and `w4a8_gd`: the decode
kernel of two-level weights, mxu | all | down | off, routed as
ops/kernels/quant_matmul.py's table says) and, under
w4a8 with `w4a8_two_level`, the two-level requantization (dense linears
and MoE expert stacks). Without it the checkpoint's group scales are
served as they are: float-scale w4a8 at decode m, w4a16 elsewhere.
`squeeze_embeddings` then drops the table to int8 and an untied dense
lm_head to int4 (after the two-level pass, as in the JAX builder, so
that lm_head serves float-scale; a table already int8 is kept with its
lm_head). Expert stacks may be int4 or dense (bf16 / f32 `[E, in, out]`
tensors, ops/moe.py's dense route). The model comes from `with_model`,
else from `EngineConfig.model`: a local HF checkpoint directory
(config.json, safetensors shards, GPTQ or dense -- quantized on load
under `quantization="gptq_int4"` -- and its tokenizer.json;
models/loader.py) loaded onto the engine's device, or
`random:<preset>`, the JAX package's random dense weights
(`init_random_params`, in `EngineConfig.dtype`). A `.gguf` path is not
resolved here, as in the JAX builder (models/gguf.py loads one). The
KV layout, as the JAX builder picks it: "auto" is linear when every
slot's max_model_len region fits the autosized budget and
kv_num_blocks is 0, else paged; the linear pool
is num_slots regions, the paged one kv_num_blocks, or autosized from
the card's memory after the weights (`autosize_kv_blocks`). On the
CPU no device memory is there to read: autosizing takes a byte budget
(`with_device_memory`) or raises naming kv_num_blocks, and "auto"
without one takes linear. A profile path in the config sets the global
profile sink at build, as in the JAX builder.

Speculative decoding (engine/spec_decode.py): a draft model from
`with_draft_model`, else from `EngineConfig.spec_draft_model` -- a
checkpoint directory (the port's `load_checkpoint`) or random:<preset>
(`init_random_params(draft_cfg, cfg.seed)`, as the JAX package's
EngineBuilder) --, served as given (no requantization or fusion, as
there), its vocabulary the target's (else ModelLoadError).

LoRA-wrapped projections (models/lora.py `apply_lora`, applied before
the build) have their int4 base requantized like any other and their
fusion site kept split. The requantize, squeeze and fusion passes
return new params containers and leave the given params as they were,
so a base engine and an adapter engine can be built from one object.

The mode is a process-wide switch, as in the JAX package: `build()`
sets both switches, so building a second engine with another `w4a8` or
`w4a8_gd` changes the route of the first one too.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from ..config import EngineConfig
from ..device import resolve_device
from ..models.configs import ModelConfig, preset
from ..models.loader import load_checkpoint
from ..models.llama_family import (ModelParams, PagedKvCache,
                                   QuantEmbedding, init_random_params)
from ..models.quantize import _quant_dense, quantize_embedding
from ..ops.kernels.quant_matmul import set_w4a8, set_w4a8_gd
from ..ops.linear import LoraLinearParams, concat_linears
from ..ops.quant import QuantLinearParams, requantize_two_level
from ..tokenizer import Tokenizer, make_byte_tokenizer
from ..types import ModelLoadError
from .engine import ContinuousBatchEngine
from .runner import ModelRunner
from .spec_decode import SpecDecoder

KV_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32,
             "int8": torch.int8}


def autosize_kv_blocks(model_cfg: ModelConfig, engine_cfg: EngineConfig,
                       params_bytes: int, device_bytes: Optional[int] = None,
                       reserve_frac: float = 0.22,
                       device: Optional[torch.device] = None) -> int:
    """The paged pool's blocks: what fits in the device memory after the
    weights and a reserve for activations, at least one full sequence's
    and at most every slot's. `device_bytes` defaults to the card's
    total memory; on the CPU it must be given."""
    if device_bytes is None:
        if device is None or device.type != "cuda":
            raise ModelLoadError(
                "no device memory to autosize the KV pool from on the CPU: "
                "set kv_num_blocks (or give a byte budget)")
        device_bytes = torch.cuda.mem_get_info(device)[1]
    elem = torch.empty(0, dtype=KV_DTYPES[engine_cfg.kv_dtype]).element_size()
    block_bytes = (2 * model_cfg.num_layers * engine_cfg.kv_block_size
                   * model_cfg.kv_size * elem)
    if engine_cfg.kv_dtype == "int8":
        # f32 per-(token, kv head) scales beside the int8 values.
        block_bytes += (2 * model_cfg.num_layers * engine_cfg.kv_block_size
                        * model_cfg.num_kv_heads * 4)
    free = device_bytes * (1.0 - reserve_frac) - params_bytes
    blocks = int(free // block_bytes)
    min_blocks = engine_cfg.max_blocks_per_seq + 1
    max_blocks = engine_cfg.num_slots * engine_cfg.max_blocks_per_seq + 1
    if blocks < min_blocks:
        raise ModelLoadError(
            f"not enough device memory for KV: {blocks} blocks fit, need "
            f"{min_blocks}")
    return min(blocks, max_blocks)


def params_nbytes(params) -> int:
    """Bytes of every tensor in a params tree (dataclasses and lists)."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, (list, tuple)):
        return sum(params_nbytes(p) for p in params)
    if dataclasses.is_dataclass(params):
        return sum(params_nbytes(getattr(params, f.name))
                   for f in dataclasses.fields(params))
    return 0


def fuse_projections(params: ModelParams,
                     sites: str = "qkv,gate_up") -> ModelParams:
    """Fusion at the comma-listed `sites`: q|k|v ("qkv") and a dense
    MLP's gate|up ("gate_up") into one linear each (one kernel launch
    per site instead of 2-3), and an MoE layer's expert stacks' gate|up
    ("moe": `concat_linears` of int4 stacks, `torch.cat` of dense ones;
    off by default, as in the JAX package, whose grouped gate and up
    share one activation quantization instead). Unsupported combinations
    keep the split form: a LoRA-wrapped projection keeps its layer's
    site split, and the other sites of that layer still fuse. A fused
    layer is a new LayerParams: the caller's params object is left as it
    was (a base engine and an adapter engine may be built from one), so
    the split weights live on while the caller holds them."""
    want = set(sites.split(","))
    layers = []
    for lp in params.layers:
        fused = {}
        if "qkv" in want and lp.qkv is None and lp.q is not None:
            qkv = concat_linears([lp.q, lp.k, lp.v])
            if qkv is not None:
                fused.update(qkv=qkv, q=None, k=None, v=None)
        if "gate_up" in want and lp.gate_up is None \
                and lp.gate is not None and lp.moe is None:
            gu = concat_linears([lp.gate, lp.up])
            if gu is not None:
                fused.update(gate_up=gu, gate=None, up=None)
        m = lp.moe
        if "moe" in want and m is not None and m.gate_up is None:
            if isinstance(m.gate, QuantLinearParams):
                gu = concat_linears([m.gate, m.up])
            elif isinstance(m.gate, torch.Tensor):
                gu = torch.cat([m.gate, m.up], dim=-1)
            else:
                gu = None
            if gu is not None:
                fused["moe"] = dataclasses.replace(m, gate_up=gu, gate=None,
                                                   up=None)
        layers.append(dataclasses.replace(lp, **fused) if fused else lp)
    return dataclasses.replace(params, layers=layers)


def squeeze_embeddings(params: ModelParams) -> ModelParams:
    """The table to int8 and an untied dense lm_head to int4 g128 with
    bf16 group scales, whatever the model's dtype (the JAX builder's
    squeeze); a table already int8 keeps its lm_head. Returns new
    params, as the JAX builder's `dataclasses.replace`."""
    if isinstance(params.embed, QuantEmbedding):
        return params
    return dataclasses.replace(
        params, lm_head=_quant_dense(params.lm_head, 128, torch.bfloat16),
        embed=quantize_embedding(params.embed))


def _two_level(lin):
    """One linear in the two-level form; through a LoRA wrapper to its
    base, as the JAX builder's tree_map reaches it."""
    if isinstance(lin, QuantLinearParams):
        return requantize_two_level(lin)
    if isinstance(lin, LoraLinearParams):
        return dataclasses.replace(lin, base=_two_level(lin.base))
    return lin


def apply_two_level(params: ModelParams) -> ModelParams:
    """Every int4 linear (a LoRA wrapper's base too) in the two-level
    w4a8 form (unchanged where it already carries scales2), in new
    params containers as the JAX package's tree_map makes them."""
    def mapped(obj):
        return dataclasses.replace(obj, **{
            f.name: _two_level(getattr(obj, f.name))
            for f in dataclasses.fields(obj)})

    layers = []
    for lp in params.layers:
        lp = mapped(lp)
        if lp.moe is not None:
            lp.moe = mapped(lp.moe)
        layers.append(lp)
    return dataclasses.replace(params, layers=layers,
                               lm_head=_two_level(params.lm_head))


class EngineBuilder:
    def __init__(self, cfg: EngineConfig):
        self.cfg = cfg
        self.model_cfg: Optional[ModelConfig] = None
        self.params: Optional[ModelParams] = None
        self.tokenizer: Optional[Tokenizer] = None
        self.device_bytes: Optional[int] = None
        self._draft = None

    def with_model(self, model_cfg: ModelConfig,
                   params: ModelParams) -> "EngineBuilder":
        self.model_cfg = model_cfg
        self.params = params
        return self

    def with_draft_model(self, draft_cfg: ModelConfig,
                         draft_params: ModelParams) -> "EngineBuilder":
        """An explicit draft model for speculative decoding; sets
        spec_draft_model to "explicit" when the config names none."""
        self._draft = (draft_cfg, draft_params)
        if not self.cfg.spec_draft_model:
            self.cfg.spec_draft_model = "explicit"
        return self

    def with_tokenizer(self, tok: Tokenizer) -> "EngineBuilder":
        self.tokenizer = tok
        return self

    def with_device_memory(self, nbytes: int) -> "EngineBuilder":
        """The device memory the KV autosizing budgets, in place of the
        card's (the only budget it has on the CPU)."""
        self.device_bytes = nbytes
        return self

    def _resolve_model(self, device: torch.device) -> None:
        """`with_model` wins; else `cfg.model`: a local HF checkpoint
        directory (models/loader.py, onto `device`) or random:<preset>."""
        if self.model_cfg is not None:
            return
        src = self.cfg.model
        if src.startswith("random:"):
            try:
                model_cfg = preset(src.split(":", 1)[1])
            except ValueError as e:
                raise ModelLoadError(str(e)) from None
            dtype = torch.bfloat16 if self.cfg.dtype == "bf16" \
                else torch.float32
            self.params = init_random_params(model_cfg, self.cfg.seed,
                                             dtype=dtype, device=device)
            self.model_cfg = model_cfg
            return
        if os.path.isdir(src):
            self.model_cfg, self.params, tok = load_checkpoint(
                src, self.cfg, device)
            if self.tokenizer is None:
                self.tokenizer = tok
            return
        raise ModelLoadError(
            f"cannot resolve model source {src!r} (the port takes a local "
            f"checkpoint directory or random:<preset>)")

    def build(self) -> ContinuousBatchEngine:
        cfg = self.cfg
        cfg.validate()
        device = resolve_device(cfg.device)
        if cfg.profile_path or cfg.memory_profile_path:
            from ..utils.profile import configure_global_profile
            configure_global_profile(
                cfg.profile_path or cfg.memory_profile_path,
                entrypoint="serve", sample_rate=cfg.profile_sample_rate,
                detail=cfg.profile_detail,
                memory_path=cfg.memory_profile_path)
        self._resolve_model(device)
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
        if cfg.squeeze_embeddings:
            self.params = squeeze_embeddings(self.params)
        if cfg.fuse_proj:
            self.params = fuse_projections(self.params, cfg.fuse_sites)

        def autosize() -> int:
            return autosize_kv_blocks(self.model_cfg, cfg,
                                      params_nbytes(self.params),
                                      self.device_bytes, device=device)

        if cfg.kv_layout == "auto":
            need = cfg.num_slots * cfg.max_blocks_per_seq
            if cfg.kv_num_blocks:        # a pinned capacity is paged
                fits = False
            elif device.type != "cuda" and self.device_bytes is None:
                fits = True              # no device memory bounds it
            else:
                try:
                    fits = autosize() >= need
                except ModelLoadError:
                    fits = False
            cfg.kv_layout = "linear" if fits else "paged"
        if cfg.kv_layout == "linear":
            num_blocks = cfg.num_slots * cfg.max_blocks_per_seq
        else:
            num_blocks = cfg.kv_num_blocks or autosize()
        kv = PagedKvCache.create(self.model_cfg, num_blocks,
                                 cfg.kv_block_size,
                                 dtype=KV_DTYPES[cfg.kv_dtype], device=device)
        runner = ModelRunner(self.model_cfg, cfg, self.params, kv, device)
        spec = self._build_spec(runner, device) if cfg.spec_draft_model \
            else None
        return ContinuousBatchEngine(cfg, runner, self.tokenizer, spec=spec)

    def _build_spec(self, runner: ModelRunner,
                    device: torch.device) -> SpecDecoder:
        """The draft model (explicit, a checkpoint directory or
        random:<preset>) and its SpecDecoder on the target's block
        geometry."""
        cfg = self.cfg
        src = cfg.spec_draft_model
        if self._draft is not None:
            draft_cfg, draft_params = self._draft
        elif os.path.isdir(src):
            draft_cfg, draft_params, _tok = load_checkpoint(src, cfg, device)
        elif src.startswith("random:"):
            try:
                draft_cfg = preset(src.split(":", 1)[1])
            except ValueError as e:
                raise ModelLoadError(str(e)) from None
            dtype = torch.bfloat16 if cfg.dtype == "bf16" else torch.float32
            draft_params = init_random_params(draft_cfg, cfg.seed,
                                              dtype=dtype, device=device)
        else:
            raise ModelLoadError(
                f"cannot resolve draft model source {src!r}")
        if draft_cfg.vocab_size != self.model_cfg.vocab_size:
            raise ModelLoadError(
                "speculative draft must share the target vocab "
                f"({draft_cfg.vocab_size} != {self.model_cfg.vocab_size})")
        if draft_params.embed.device.type != device.type:
            raise ModelLoadError(f"draft params live on "
                                 f"{draft_params.embed.device}, the engine "
                                 f"on {device}")
        return SpecDecoder(runner, draft_cfg, draft_params,
                           k=cfg.spec_num_tokens)
