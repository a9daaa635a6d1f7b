"""Architecture-true random int4 weights, made on the device.

Port of `ferrum_tpu/models/quantize.py::init_random_quant_params` (dense
layers, and MoE layers' expert stacks [E, ...] with a bf16 router).
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

import torch

from ..device import resolve_device
from ..ops.linear import DenseLinearParams
from ..ops.quant import QuantLinearParams
from .configs import ModelConfig
from .llama_family import LayerParams, ModelParams, MoeLayerParams


def init_random_quant_params(cfg: ModelConfig, seed: int = 0,
                             device: Optional[Union[str, torch.device]] = None,
                             group_size: int = 128,
                             dtype=torch.bfloat16) -> ModelParams:
    """Random int4 g128 model (two-level fields set), bf16 embeddings,
    norms and lm_head; on the card unless `device` says otherwise."""
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
    embed = normal(cfg.vocab_size, h)
    lm_head = None if cfg.tie_word_embeddings else DenseLinearParams(
        w=normal(h, cfg.vocab_size), bias=None)
    return ModelParams(embed=embed, layers=layers, final_norm=ones(h),
                       lm_head=lm_head)
