"""Shared helpers of the ferrum_tpu_torch parity tests (tests/test_torch_*).

Inputs are made with numpy from a seed and fed to both packages; the
JAX package runs on the CPU. Off the TPU the JAX package computes its
w4a8 two-level matmuls through the w4a16 reference, so `route_w4a8tl`
points its `quant_matmul` dispatch at `quant_matmul_w4a8tl_ref` -- the
function both TPU kernels compute -- for the duration of a test.
"""

from __future__ import annotations

import numpy as np
import torch

# xdist runs several workers: keep each test process's torch pool small.
torch.set_num_threads(2)


def route_w4a8tl(monkeypatch) -> None:
    """JAX side: params with scales2 take the two-level oracle (the w4a8
    dispatch the TPU runs), everything else the reference it ran before."""
    from ferrum_tpu.ops.pallas import quant_matmul as qm
    from ferrum_tpu.ops.quant import quant_matmul_w4a8tl_ref

    orig = qm.quant_matmul

    def routed(x, p):
        if p.scales2 is not None:
            return quant_matmul_w4a8tl_ref(x, p)
        return orig(x, p)

    monkeypatch.setattr(qm, "quant_matmul", routed)


def _np(a, dtype=None):
    arr = np.asarray(a)
    if dtype is not None:
        arr = arr.astype(dtype)
    elif arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _linear(out: dict, prefix: str, lin) -> None:
    if hasattr(lin, "w"):
        out[f"{prefix}.w"] = _np(lin.w)
        if lin.bias is not None:
            out[f"{prefix}.bias"] = _np(lin.bias)
        return
    out[f"{prefix}.qweight"] = _np(lin.qweight, np.uint8)
    out[f"{prefix}.scales"] = _np(lin.scales)
    out[f"{prefix}.zeros"] = _np(lin.zeros, np.int8)
    if lin.bias is not None:
        out[f"{prefix}.bias"] = _np(lin.bias)
    if lin.input_perm is not None:
        out[f"{prefix}.input_perm"] = _np(lin.input_perm, np.int64)
    if lin.scales2 is not None:
        out[f"{prefix}.scales2"] = _np(lin.scales2, np.int8)
        out[f"{prefix}.chan_scale"] = _np(lin.chan_scale)


def flatten_jax_params(params) -> dict:
    """JAX ModelParams → flat {dotted field name: numpy array} (the
    input format of ferrum_tpu_torch.models.convert.params_from_numpy)."""
    out = {"embed": _np(params.embed), "final_norm": _np(params.final_norm)}
    if params.lm_head is not None:
        _linear(out, "lm_head", params.lm_head)
    for i, lp in enumerate(params.layers):
        for name in ("input_norm", "pre_mlp_norm", "q_norm", "k_norm"):
            v = getattr(lp, name)
            if v is not None:
                out[f"layers.{i}.{name}"] = _np(v)
        for name in ("q", "k", "v", "o", "gate", "up", "down", "qkv",
                     "gate_up"):
            lin = getattr(lp, name)
            if lin is not None:
                _linear(out, f"layers.{i}.{name}", lin)
    return out


def jax_model(preset_name: str, quantized: bool, seed: int = 0):
    """(jax ModelConfig, f32 JAX params): random float weights, int4 g128
    two-level requantized when `quantized`, q|k|v and gate|up fused."""
    import jax
    import jax.numpy as jnp

    from ferrum_tpu.engine.builder import apply_two_level, fuse_projections
    from ferrum_tpu.models.configs import preset
    from ferrum_tpu.models.llama_family import init_random_params
    from ferrum_tpu.models.quantize import quantize_model_params

    cfg = preset(preset_name)
    params = init_random_params(cfg, seed=seed, dtype=jnp.float32)
    if quantized:
        params = jax.jit(apply_two_level)(
            quantize_model_params(params, 128, dtype=jnp.float32))
    return cfg, fuse_projections(params)


def torch_config(jax_cfg):
    """The port's ModelConfig with the same field values."""
    from ferrum_tpu_torch.models.configs import ModelConfig, RopeScaling
    import dataclasses

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: getattr(jax_cfg, k) for k in fields}
    if jax_cfg.rope_scaling is not None:
        kw["rope_scaling"] = RopeScaling(**dataclasses.asdict(
            jax_cfg.rope_scaling))
    return ModelConfig(**kw)
