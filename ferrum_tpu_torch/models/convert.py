"""Weight carry-over: a flat dict of numpy arrays → the port's ModelParams.

The dict holds the JAX package's `ModelParams` fields under their own
names, flattened with dots ("embed", "final_norm", "lm_head.w",
"layers.0.input_norm", "layers.0.qkv.qweight", "layers.0.moe.router.w",
"layers.0.moe.gate.qweight", ...). Linears are dense (`w`, optional
`bias`) or packed int4 (`qweight`, `scales`, `zeros` and optional
`bias`, `input_perm`, `scales2`, `chan_scale`); MoE expert stacks carry
a leading expert dim on each tensor, or are one dense [E, in, out] array
under their own name ("layers.0.moe.gate", or "...moe.gate_up" fused).
An int8 embedding table is "embed.q" with its f32 row scales
"embed.scale". A missing `lm_head` means tied embeddings. The caller
does the flattening, so the port never sees a
JAX object.
"""

from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from ..ops.linear import DenseLinearParams, LinearParams
from ..ops.quant import QuantLinearParams
from .llama_family import (LayerParams, ModelParams, MoeLayerParams,
                           QuantEmbedding)

_LINEARS = ("q", "k", "v", "o", "gate", "up", "down", "qkv", "gate_up")
_QUANT_OPTIONAL = ("bias", "input_perm", "scales2", "chan_scale")


def _linear(tree: Dict[str, np.ndarray], prefix: str, to) -> Optional[
        LinearParams]:
    if prefix in tree:                          # a dense expert stack
        return to(tree[prefix])
    if f"{prefix}.w" in tree:
        bias = tree.get(f"{prefix}.bias")
        return DenseLinearParams(w=to(tree[f"{prefix}.w"]),
                                 bias=None if bias is None else to(bias))
    if f"{prefix}.qweight" not in tree:
        return None
    qw = tree[f"{prefix}.qweight"]              # [(E,) in/2, out]
    scales = tree[f"{prefix}.scales"]
    in_f, out_f = qw.shape[-2] * 2, qw.shape[-1]
    opt = {name: tree.get(f"{prefix}.{name}") for name in _QUANT_OPTIONAL}
    return QuantLinearParams(
        qweight=to(qw), scales=to(scales), zeros=to(tree[f"{prefix}.zeros"]),
        bias=None if opt["bias"] is None else to(opt["bias"]),
        in_features=in_f, out_features=out_f,
        group_size=in_f // scales.shape[-2],
        input_perm=None if opt["input_perm"] is None
        else to(opt["input_perm"]).to(torch.int64),
        scales2=None if opt["scales2"] is None else to(opt["scales2"]),
        chan_scale=None if opt["chan_scale"] is None
        else to(opt["chan_scale"]).reshape(*qw.shape[:-2], 1, out_f))


def params_from_numpy(tree: Dict[str, np.ndarray],
                      device: Union[str, torch.device]) -> ModelParams:
    """Build ModelParams on `device`; every array keeps its dtype."""
    def to(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    n_layers = 1 + max(int(k.split(".")[1]) for k in tree
                       if k.startswith("layers."))
    layers = []
    for i in range(n_layers):
        p = f"layers.{i}"
        lin = {name: _linear(tree, f"{p}.{name}", to) for name in _LINEARS}
        norm = {name: (to(tree[f"{p}.{name}"]) if f"{p}.{name}" in tree
                       else None)
                for name in ("input_norm", "pre_mlp_norm", "q_norm",
                             "k_norm", "post_attn_norm", "post_mlp_norm")}
        moe = None
        if f"{p}.moe.router.w" in tree:
            moe = MoeLayerParams(**{
                name: _linear(tree, f"{p}.moe.{name}", to)
                for name in ("router", "gate", "up", "down", "gate_up")})
        layers.append(LayerParams(**norm, **lin, moe=moe))
    embed = QuantEmbedding(q=to(tree["embed.q"]),
                           scale=to(tree["embed.scale"])) \
        if "embed.q" in tree else to(tree["embed"])
    return ModelParams(embed=embed, layers=layers,
                       final_norm=to(tree["final_norm"]),
                       lm_head=_linear(tree, "lm_head", to))
