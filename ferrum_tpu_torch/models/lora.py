"""LoRA adapters: PEFT loading and application over dense or int4 bases.

Port of `ferrum_tpu/models/lora.py`. A PEFT adapter directory
(adapter_config.json and adapter_model*.safetensors, read with the
port's models/safetensors_io.py: the card's machine has no `safetensors`
package) gives (A [in, r], B [r, out]) pairs by (layer, projection) and
the scale lora_alpha / r. `apply_lora` wraps each targeted projection in
a `LoraLinearParams` -- y = base(x) + scale * (x @ A) @ B, the base on
its own route (an int4 base launches its kernel) -- in new layer
objects, leaving the given params as they were. Apply it before
`EngineBuilder(...).build()`: the builder keeps an adapted projection's
site split and requantizes its int4 base to the two-level form like any
other; `quantize_model_params` passes a wrapper through untouched.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, Tuple

import torch

from ..ops.linear import DenseLinearParams, LoraLinearParams
from ..types import ModelLoadError
from .llama_family import ModelParams
from .safetensors_io import SafetensorsFile

_TARGET_ATTRS = {
    "q_proj": "q", "k_proj": "k", "v_proj": "v", "o_proj": "o",
    "gate_proj": "gate", "up_proj": "up", "down_proj": "down",
}

Adapter = Dict[Tuple[int, str], Tuple[torch.Tensor, torch.Tensor]]


def load_lora_adapter(adapter_dir: str) -> Tuple[Adapter, float]:
    """({(layer_idx, attr): (A [in, r], B [r, out])} as CPU tensors,
    scale = lora_alpha / r)."""
    cfg_path = os.path.join(adapter_dir, "adapter_config.json")
    if not os.path.exists(cfg_path):
        raise ModelLoadError(f"no adapter_config.json under {adapter_dir}")
    with open(cfg_path) as f:
        acfg = json.load(f)
    r = int(acfg.get("r", 8))
    alpha = float(acfg.get("lora_alpha", r))
    scale = alpha / r

    files = glob.glob(os.path.join(adapter_dir, "adapter_model*.safetensors"))
    if not files:
        raise ModelLoadError(f"no adapter_model.safetensors in {adapter_dir}")
    raw: Dict[str, torch.Tensor] = {}
    for fpath in files:
        st = SafetensorsFile(fpath)
        for k in st.keys():
            raw[k] = st.get(k)

    pairs: Dict[Tuple[int, str], Dict[str, torch.Tensor]] = {}
    for name, t in raw.items():
        # ...model.layers.{i}.self_attn.q_proj.lora_A.weight
        parts = name.replace("base_model.model.", "").split(".")
        try:
            li = int(parts[parts.index("layers") + 1])
        except (ValueError, IndexError):
            continue
        proj = next((p for p in parts if p in _TARGET_ATTRS), None)
        if proj is None:
            continue
        kind = "A" if "lora_A" in name else ("B" if "lora_B" in name
                                             else None)
        if kind is None:
            continue
        pairs.setdefault((li, _TARGET_ATTRS[proj]), {})[kind] = t

    # PEFT stores lora_A [r, in] and lora_B [out, r]; x @ A takes
    # A [in, r] and B [r, out].
    out = {key: (ab["A"].t(), ab["B"].t()) for key, ab in pairs.items()
           if "A" in ab and "B" in ab}
    if not out:
        raise ModelLoadError(f"adapter {adapter_dir} has no usable pairs")
    return out, scale


def _device(lin) -> torch.device:
    if isinstance(lin, DenseLinearParams):
        return lin.w.device
    if isinstance(lin, LoraLinearParams):
        return _device(lin.base)
    return lin.qweight.device


def apply_lora(params: ModelParams, adapter: Adapter, scale: float,
               dtype=torch.bfloat16) -> ModelParams:
    """New params whose targeted projections are LoraLinearParams (A and
    B in `dtype` on the base weight's device); the layers an adapter
    does not touch, and `params` itself, stay as they are."""
    layers = []
    for li, lp in enumerate(params.layers):
        changes = {}
        for (ali, attr), (a, b) in adapter.items():
            if ali != li:
                continue
            base = getattr(lp, attr)
            if base is None:
                continue
            dev = _device(base)
            changes[attr] = LoraLinearParams(
                base=base,
                lora_a=a.to(device=dev, dtype=dtype).contiguous(),
                lora_b=b.to(device=dev, dtype=dtype).contiguous(),
                scale=scale)
        layers.append(dataclasses.replace(lp, **changes) if changes else lp)
    return ModelParams(embed=params.embed, layers=layers,
                       final_norm=params.final_norm, lm_head=params.lm_head)
