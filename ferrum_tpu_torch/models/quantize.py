"""Int4 weights: random ones made on the device, and RTN quantization.

Port of `ferrum_tpu/models/quantize.py`: `quantize_model_params` (the
JAX package's round-to-nearest group quantization of every transformer
linear and expert stack -- dense linears on their own device through
`make_quant_linear`, expert stacks through the numpy quantizer, the
same f32 arithmetic either way, so the packed bytes and scales equal
the JAX package's) and
`init_random_quant_params` (dense layers, and MoE layers' expert stacks
[E, ...] with a bf16 router), and the embedding squeeze
(`quantize_embedding`: an int8 table with f32 row scales, bit for bit
the JAX package's; `squeeze_embeddings=True` also quantizes an untied
lm_head to int4).
Throughput is weight-value independent, so the served-path benchmark
uses random packed bytes; the weights are generated directly on the
device from an explicit `torch.Generator(seed)`. Like the JAX
package, the two-level w4a8 fields are emitted directly: with uniform
group scales (0.01) the factorization is exact (scales2 == 15, chan ==
0.01 / 15), so the builder's requantize pass has nothing to do.

Uniform scales also mean these weights cannot catch a kernel that reads
the wrong group's scale: kernel checks use `requantize_two_level` of
random float weights instead (chip_smoke.py, tests/test_torch_quant.py).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..ops.linear import DenseLinearParams, concat_linears
from ..ops.quant import (QuantLinearParams, make_quant_linear,
                         quantize_weight_np)
from .configs import ModelConfig
from .llama_family import (LayerParams, ModelParams, MoeLayerParams,
                           QuantEmbedding)

# Vocabulary rows `quantize_embedding` widens to f32 at a time, and
# output columns `_quant_dense` quantizes at a time.
SQUEEZE_ROWS = 16384
QUANT_COLS = 16384


def quantize_embedding(embed) -> QuantEmbedding:
    """[vocab, h] → per-row symmetric int8 (the JAX `quantize_embedding`:
    f32 amax / 127 (at least 1e-8 / 127), round half to even, clip ±127),
    on the table's own device, SQUEEZE_ROWS rows at a time."""
    if isinstance(embed, QuantEmbedding):
        return embed
    v = embed.shape[0]
    q = torch.empty(embed.shape, dtype=torch.int8, device=embed.device)
    scale = torch.empty((v, 1), dtype=torch.float32, device=embed.device)
    for a in range(0, v, SQUEEZE_ROWS):
        w = embed[a:a + SQUEEZE_ROWS].to(torch.float32)
        sc = torch.clamp_min(w.abs().amax(dim=1, keepdim=True), 1e-8) \
            / 127.0
        q[a:a + SQUEEZE_ROWS] = torch.clamp(torch.round(w / sc), -127, 127)
        scale[a:a + SQUEEZE_ROWS] = sc
    return QuantEmbedding(q=q, scale=scale)


def init_random_quant_params(cfg: ModelConfig, seed: int = 0,
                             device: Optional[Union[str, torch.device]] = None,
                             group_size: int = 128,
                             dtype=torch.bfloat16,
                             squeeze_embeddings: bool = False
                             ) -> ModelParams:
    """Random int4 g128 model (two-level fields set), bf16 embeddings,
    norms and lm_head; on the card unless `device` says otherwise. As in
    the JAX package, every family gets ones norms and no sandwich norms
    (gemma3 included: ROADMAP Queue 3); a gemma3 model is built with
    `init_random_params` and `quantize_model_params` instead.
    squeeze_embeddings: the squeezed forms drawn directly, as the JAX
    package draws them (no bf16 table in between): an int8 table with
    row scales 0.02 / 127 and an untied lm_head in the two-level int4
    form of the other linears."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def qlin(in_f: int, out_f: int, *lead: int) -> QuantLinearParams:
        """One packed linear, or an expert stack with `lead` = (E,)."""
        g = in_f // group_size
        return QuantLinearParams(
            qweight=torch.randint(0, 256, (*lead, in_f // 2, out_f),
                                  generator=gen, device=dev,
                                  dtype=torch.uint8),
            scales=torch.full((*lead, g, out_f), 0.01, dtype=dtype,
                              device=dev),
            zeros=torch.full((*lead, g, out_f), 8, dtype=torch.int8,
                             device=dev),
            bias=None, in_features=in_f, out_features=out_f,
            group_size=group_size,
            scales2=torch.full((*lead, g, out_f), 15, dtype=torch.int8,
                               device=dev),
            chan_scale=torch.full((*lead, 1, out_f), 0.01 / 15.0,
                                  dtype=torch.float32, device=dev))

    def normal(*shape) -> torch.Tensor:
        return (0.02 * torch.randn(*shape, generator=gen, device=dev,
                                   dtype=torch.float32)).to(dtype)

    def ones(n: int) -> torch.Tensor:
        return torch.ones(n, dtype=dtype, device=dev)

    h, inter = cfg.hidden_size, cfg.intermediate_size
    layers = []
    for li in range(cfg.num_layers):
        moe = None
        gate = up = down = None
        if cfg.layer_is_moe(li):
            m = cfg.moe
            e, mi = m.num_experts, m.moe_intermediate_size
            moe = MoeLayerParams(
                router=DenseLinearParams(w=normal(h, e), bias=None),
                gate=qlin(h, mi, e), up=qlin(h, mi, e),
                down=qlin(mi, h, e))
        else:
            gate, up, down = qlin(h, inter), qlin(h, inter), qlin(inter, h)
        layers.append(LayerParams(
            input_norm=ones(h),
            q=qlin(h, cfg.q_size), k=qlin(h, cfg.kv_size),
            v=qlin(h, cfg.kv_size), o=qlin(cfg.q_size, h),
            q_norm=ones(cfg.head_dim) if cfg.qk_norm else None,
            k_norm=ones(cfg.head_dim) if cfg.qk_norm else None,
            pre_mlp_norm=ones(h), gate=gate, up=up, down=down, moe=moe))
    if squeeze_embeddings:
        embed = QuantEmbedding(
            q=torch.randint(-127, 128, (cfg.vocab_size, h), generator=gen,
                            device=dev, dtype=torch.int8),
            scale=torch.full((cfg.vocab_size, 1), 0.02 / 127.0,
                             dtype=torch.float32, device=dev))
        lm_head = None if cfg.tie_word_embeddings \
            else qlin(h, cfg.vocab_size)
    else:
        embed = normal(cfg.vocab_size, h)
        lm_head = None if cfg.tie_word_embeddings else DenseLinearParams(
            w=normal(h, cfg.vocab_size), bias=None)
    return ModelParams(embed=embed, layers=layers, final_norm=ones(h),
                       lm_head=lm_head)


def _quant_dense(lin, group_size: int, dtype):
    """A dense [in, out] linear → int4 on its own device (the JAX
    `_quant_dense`, through `make_quant_linear`: quantize_weight_np's f32
    arithmetic in torch, so a weight on the card never crosses to the
    host), QUANT_COLS output columns at a time (each column's groups
    are its own: a 151936-wide lm_head would take ~4 GiB of f32
    transients whole); already-quantized or oddly-shaped linears
    pass."""
    if lin is None or not isinstance(lin, DenseLinearParams):
        return lin
    if lin.w.shape[0] % group_size:
        return lin
    parts = [make_quant_linear(lin.w[:, a:a + QUANT_COLS], group_size,
                               symmetric=True, dtype=dtype)
             for a in range(0, lin.w.shape[1], QUANT_COLS)]
    p = parts[0] if len(parts) == 1 else concat_linears(parts)
    if lin.bias is not None:
        p.bias = lin.bias.to(dtype)
    return p


def _quant_expert_stack(w: torch.Tensor, group_size: int, dtype
                        ) -> QuantLinearParams:
    """A dense stack [E, in, out] → a QuantLinearParams with a leading E."""
    wn = w.to(torch.float32).cpu().numpy()
    e, in_f, out_f = wn.shape
    parts = [quantize_weight_np(wn[i], group_size) for i in range(e)]
    return QuantLinearParams(
        qweight=torch.from_numpy(np.stack([p[0] for p in parts])).to(w.device),
        scales=torch.from_numpy(np.stack([p[1] for p in parts])).to(
            w.device, dtype),
        zeros=torch.from_numpy(np.stack([p[2] for p in parts])).to(w.device),
        bias=None, in_features=in_f, out_features=out_f,
        group_size=group_size)


def quantize_model_params(params: ModelParams, group_size: int = 128,
                          dtype=torch.bfloat16,
                          quantize_experts: bool = True,
                          squeeze_embeddings: bool = False) -> ModelParams:
    """Every transformer linear (q / k / v / o, gate / up / down) and
    expert stack to int4 g`group_size` (symmetric RTN); embeddings, norms,
    the router and lm_head stay as they are (GPTQ checkpoints'
    convention). squeeze_embeddings: the table to int8
    (`quantize_embedding`) and an untied lm_head to int4 too."""
    layers = []
    for lp in params.layers:
        moe = lp.moe
        if moe is not None and quantize_experts \
                and not isinstance(moe.gate, QuantLinearParams):
            moe = MoeLayerParams(
                router=moe.router,
                gate=_quant_expert_stack(moe.gate, group_size, dtype),
                up=_quant_expert_stack(moe.up, group_size, dtype),
                down=_quant_expert_stack(moe.down, group_size, dtype))
        layers.append(LayerParams(
            input_norm=lp.input_norm,
            q=_quant_dense(lp.q, group_size, dtype),
            k=_quant_dense(lp.k, group_size, dtype),
            v=_quant_dense(lp.v, group_size, dtype),
            o=_quant_dense(lp.o, group_size, dtype),
            q_norm=lp.q_norm, k_norm=lp.k_norm,
            post_attn_norm=lp.post_attn_norm,
            pre_mlp_norm=lp.pre_mlp_norm,
            post_mlp_norm=lp.post_mlp_norm,
            gate=_quant_dense(lp.gate, group_size, dtype),
            up=_quant_dense(lp.up, group_size, dtype),
            down=_quant_dense(lp.down, group_size, dtype),
            moe=moe))
    embed, lm_head = params.embed, params.lm_head
    if squeeze_embeddings:
        embed = quantize_embedding(embed)
        lm_head = _quant_dense(lm_head, group_size, dtype)
    return ModelParams(embed=embed, layers=layers,
                       final_norm=params.final_norm, lm_head=lm_head)
