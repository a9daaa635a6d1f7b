"""Shared helpers of the ferrum_tpu_torch parity tests (tests/test_torch_*).

Inputs are made with numpy from a seed and fed to both packages; the
JAX package runs on the CPU. Off the TPU the JAX package computes its
w4a8 two-level matmuls through the w4a16 reference, so `route_w4a8tl`
points its `quant_matmul` dispatch at `quant_matmul_w4a8tl_ref` -- the
function both TPU kernels compute -- for the duration of a test. Its MoE
dispatch likewise takes the all-experts route only on the TPU and with
w4a8 on; `route_moe_w4a8tl` turns both on and points the two MoE Pallas
entries at `jax_bmm_w4a8tl` / `jax_grouped_w4a8tl`, jnp forms that
tests/test_torch_moe.py holds bit for bit against interpret-mode runs of
the kernels. `route_float_scale` does the same for the float-scale
routes (w4a16 and float-scale w4a8, dense and grouped): the JAX
package's own dispatch runs as on the TPU, with its three Pallas entries
pointed at jnp forms that tests/test_torch_float_scale.py holds against
interpret-mode runs. Its two-level group-dot entry (`w4a8_gd` all /
down) likewise runs the JAX package's own entry, with the Pallas wrapper
pointed at `jax_qmm_w4a8tl_gd`, which tests/test_torch_group_dot.py
holds bit for bit against interpret-mode runs.
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


def _jax_stack_w8(p):
    """Two-level integer weights w8 = (q - z) * scales2 of an expert
    stack, int32 [E, K, N] (jnp)."""
    import jax
    import jax.numpy as jnp

    from ferrum_tpu.ops.quant import unpack_rows

    q = jax.vmap(lambda qw: unpack_rows(qw, p.group_size))(p.qweight)
    e, k, n = q.shape
    qg = q.reshape(e, k // p.group_size, p.group_size, n)
    w8 = ((qg - p.zeros[:, :, None, :].astype(jnp.int32))
          * p.scales2[:, :, None, :].astype(jnp.int32))
    return w8.reshape(e, k, n)


def jax_bmm_w4a8tl(xq3, xs3, p, out_dtype, **_):
    """jnp form of the JAX package's `quant_bmm_all_experts` (both its
    kernels): out[e] = ((f32(xq3[e|0] @ w8[e]) * xs3[e|0]) * chan[e])."""
    import jax.numpy as jnp

    w8 = _jax_stack_w8(p)
    e, k, n = w8.shape
    x = jnp.broadcast_to(xq3, (e,) + xq3.shape[1:]).astype(jnp.int32)
    acc = jnp.einsum("etk,ekn->etn", x, w8,
                     preferred_element_type=jnp.int32)
    chan = p.chan_scale.reshape(e, 1, n).astype(jnp.float32)
    return (acc.astype(jnp.float32) * xs3 * chan).astype(out_dtype)


def jax_grouped_w4a8tl(xq, xs, p, group_sizes, out_dtype, **_):
    """jnp form of the JAX package's `_quant_grouped_w4a8tl_2d`:
    y[r] = ((f32(xq[r] @ w8[e(r)]) * chan[e(r)]) * xs[r]), 0 past the
    last group."""
    import jax.numpy as jnp

    w8 = _jax_stack_w8(p)
    e, k, n = w8.shape
    offsets = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(group_sizes).astype(jnp.int32)])
    rows = jnp.arange(xq.shape[0])[:, None]
    chan = p.chan_scale.reshape(e, 1, n).astype(jnp.float32)
    acc = jnp.zeros((xq.shape[0], n), jnp.float32)
    for g in range(e):
        part = jnp.dot(xq.astype(jnp.int32), w8[g],
                       preferred_element_type=jnp.int32)
        mine = (rows >= offsets[g]) & (rows < offsets[g + 1])
        acc = jnp.where(mine, part.astype(jnp.float32) * chan[g], acc)
    return (acc * xs).astype(out_dtype)


def route_moe_w4a8tl(monkeypatch) -> None:
    """JAX side: the MoE dispatch the TPU runs (w4a8 on, all-experts at
    decode sizes, the two-level grouped kernel otherwise), through the
    jnp forms of its two MoE kernels; dense linears as `route_w4a8tl`."""
    from ferrum_tpu.ops.pallas import quant_matmul as qm

    route_w4a8tl(monkeypatch)
    monkeypatch.setattr(qm, "on_tpu", lambda: True)
    monkeypatch.setattr(qm, "_W4A8", True)
    monkeypatch.setattr(qm, "_W4A8_GD", "mxu")
    monkeypatch.setattr(qm, "quant_bmm_all_experts", jax_bmm_w4a8tl)
    monkeypatch.setattr(qm, "_quant_grouped_w4a8tl_2d", jax_grouped_w4a8tl)


def _jax_w4a16_weight(p):
    """bf16 weight of `_qmm_kernel` / `_qgmm_kernel`:
    bf16(bf16(q - z) * bf16(s)) per group, [..., K, N] (jnp)."""
    import jax
    import jax.numpy as jnp

    from ferrum_tpu.ops.quant import unpack_rows

    def one(qw, sc, z):
        q = unpack_rows(qw, p.group_size)
        k, n = q.shape
        qg = q.reshape(k // p.group_size, p.group_size, n)
        w = ((qg - z[:, None, :].astype(jnp.int32)).astype(jnp.bfloat16)
             * sc[:, None, :].astype(jnp.bfloat16))
        return w.reshape(k, n)
    if p.qweight.ndim == 3:
        return jax.vmap(one)(p.qweight, p.scales, p.zeros)
    return one(p.qweight, p.scales, p.zeros)


def _jax_tiles(p) -> None:
    assert p.group_size == 128 and p.in_features % 256 == 0 \
        and p.out_features % 128 == 0, "the jnp forms take tiled shapes"


def jax_qmm_w4a16(x, p, **_):
    """jnp form of `_quant_matmul_2d` (`_qmm_kernel`): x @ the bf16
    weight with f32 sums, cast to x.dtype."""
    import jax.numpy as jnp

    _jax_tiles(p)
    w = _jax_w4a16_weight(p).astype(jnp.float32)
    return jnp.dot(x.astype(jnp.float32), w,
                   preferred_element_type=jnp.float32).astype(x.dtype)


def jax_qmm_w4a8(xq, xs, p, out_dtype, **_):
    """jnp form of `_quant_matmul_w4a8_2d` (`_qmm_w4a8_kernel`), in the
    kernel's float order: per K step of bkb packed rows, each plane's
    groups summed from zero and added to the accumulator, low plane
    first; then times xs. Run op by op, every op rounds on its own;
    compiled, XLA CPU fuses each scale multiply into the add after it."""
    import jax.numpy as jnp

    from ferrum_tpu.ops.quant import unpack_rows

    _jax_tiles(p)
    k, n = p.in_features, p.out_features
    bkb = 512
    while (k // 2) % bkb:
        bkb //= 2
    gpt, half = bkb // 128, (k // 2) // 128
    q = unpack_rows(p.qweight, 128)
    x32 = xq.astype(jnp.int32)
    acc = jnp.zeros((xq.shape[0], n), jnp.float32)
    for step in range((k // 2) // bkb):
        for g0 in (step * gpt, half + step * gpt):
            part = jnp.zeros_like(acc)
            for g in range(g0, g0 + gpt):
                xg = x32[:, g * 128:(g + 1) * 128]
                p32 = jnp.dot(xg, q[g * 128:(g + 1) * 128],
                              preferred_element_type=jnp.int32)
                xsum = jnp.sum(xg, axis=1, keepdims=True).astype(jnp.float32)
                part += ((p32.astype(jnp.float32)
                          - p.zeros[g][None].astype(jnp.float32) * xsum)
                         * p.scales[g][None].astype(jnp.float32))
            acc += part
    return (acc * xs).astype(out_dtype)


def jax_qmm_w4a8tl_gd(xq, xs, p, out_dtype, **_):
    """jnp form of `_quant_matmul_w4a8tl_gd` (`_qmm_w4a8tl_gd_kernel`):
    per 128-group in global order, the int32 dot of xq_g with the raw
    nibbles times s2, minus sum(xq_g) * s2 * z, added to an int32
    accumulator; then f32(acc) * xs * chan. None where the Pallas wrapper
    returns None (a weight it cannot tile)."""
    import jax.numpy as jnp

    from ferrum_tpu.ops.quant import unpack_rows

    k, n = p.in_features, p.out_features
    if p.group_size != 128 or (k // 2) % 128 or n % 128:
        return None
    q = unpack_rows(p.qweight, 128)
    x32 = xq.astype(jnp.int32)
    acc = jnp.zeros((xq.shape[0], n), jnp.int32)
    for g in range(k // 128):
        xg = x32[:, g * 128:(g + 1) * 128]
        st = p.scales2[g][None].astype(jnp.int32)
        zt = p.zeros[g][None].astype(jnp.int32)
        dot = jnp.dot(xg, q[g * 128:(g + 1) * 128],
                      preferred_element_type=jnp.int32)
        acc = acc + dot * st - jnp.sum(xg, axis=1, keepdims=True) * (st * zt)
    chan = p.chan_scale.astype(jnp.float32).reshape(1, n)
    return (acc.astype(jnp.float32) * xs * chan).astype(out_dtype)


def jax_grouped_w4a16(x, p, group_sizes, **_):
    """jnp form of `_quant_grouped_2d` (`_qgmm_kernel`): each row @ its
    expert's bf16 weight, f32 sums, cast to x.dtype; 0 past the last
    group."""
    import jax.numpy as jnp

    w = _jax_w4a16_weight(p).astype(jnp.float32)
    offsets = jnp.concatenate([jnp.zeros(1, jnp.int32),
                               jnp.cumsum(group_sizes).astype(jnp.int32)])
    rows = jnp.arange(x.shape[0])[:, None]
    acc = jnp.zeros((x.shape[0], p.out_features), jnp.float32)
    for g in range(w.shape[0]):
        part = jnp.dot(x.astype(jnp.float32), w[g],
                       preferred_element_type=jnp.float32)
        mine = (rows >= offsets[g]) & (rows < offsets[g + 1])
        acc = jnp.where(mine, part, acc)
    return acc.astype(x.dtype)


def route_float_scale(monkeypatch, w4a8: bool, gd: str = "mxu") -> None:
    """Both packages in one quantized-matmul mode, the JAX side running
    its dispatch as on the TPU: its float-scale Pallas entries point at
    the jnp forms above, its two-level ones at those of
    `route_moe_w4a8tl` and, in the group-dot mode (gd=True), at its own
    entry with `jax_qmm_w4a8tl_gd` in place of the Pallas wrapper. The
    port's and the JAX package's mode switches are monkeypatched, so a
    test that builds an engine (which sets them) leaves them as they
    were."""
    from ferrum_tpu.ops.pallas import quant_matmul as qm
    from ferrum_tpu.ops.quant import quant_matmul_w4a8tl_ref
    from ferrum_tpu_torch.ops.kernels import quant_matmul as tqm

    for mod in (qm, tqm):
        monkeypatch.setattr(mod, "_W4A8", w4a8)
        monkeypatch.setattr(mod, "_W4A8_GD", gd)
    monkeypatch.setattr(qm, "on_tpu", lambda: True)
    monkeypatch.setattr(qm, "_quant_matmul_2d", jax_qmm_w4a16)
    monkeypatch.setattr(qm, "_quant_matmul_w4a8_2d", jax_qmm_w4a8)
    monkeypatch.setattr(qm, "_quant_grouped_2d", jax_grouped_w4a16)
    entry = qm.quant_matmul_w4a8tl
    monkeypatch.setattr(qm, "_quant_matmul_w4a8tl_gd", jax_qmm_w4a8tl_gd)
    monkeypatch.setattr(
        qm, "quant_matmul_w4a8tl", lambda x, p, gd=False: entry(x, p, gd=True)
        if gd is True else quant_matmul_w4a8tl_ref(x, p))
    monkeypatch.setattr(qm, "quant_bmm_all_experts", jax_bmm_w4a8tl)
    monkeypatch.setattr(qm, "_quant_grouped_w4a8tl_2d", jax_grouped_w4a8tl)


def run_pallas_interpret(fn, *args, **kw):
    """Run a JAX-package entry that reaches `pl.pallas_call` with every
    Pallas kernel in interpret mode, as tests/test_moe_grouped.py does."""
    import jax

    from ferrum_tpu.ops.pallas import quant_matmul as qm

    orig = qm.pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    qm.pl.pallas_call = patched
    try:
        with jax.disable_jit():
            return fn(*args, **kw)
    finally:
        qm.pl.pallas_call = orig


def _np(a, dtype=None):
    arr = np.asarray(a)
    if dtype is not None:
        arr = arr.astype(dtype)
    elif arr.dtype.kind == "f" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _linear(out: dict, prefix: str, lin) -> None:
    if not hasattr(lin, "w") and not hasattr(lin, "qweight"):
        out[prefix] = _np(lin)          # a dense expert stack [E, in, out]
        return
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
    input format of ferrum_tpu_torch.models.convert.params_from_numpy):
    an int8 table as embed.q / embed.scale, a dense expert stack under
    its own name (layers.i.moe.gate, ...; a fused one as .gate_up)."""
    out = {"final_norm": _np(params.final_norm)}
    if hasattr(params.embed, "q"):      # QuantEmbedding: int8 + f32 scales
        out["embed.q"] = _np(params.embed.q, np.int8)
        out["embed.scale"] = _np(params.embed.scale)
    else:
        out["embed"] = _np(params.embed)
    if params.lm_head is not None:
        _linear(out, "lm_head", params.lm_head)
    for i, lp in enumerate(params.layers):
        for name in ("input_norm", "pre_mlp_norm", "q_norm", "k_norm",
                     "post_attn_norm", "post_mlp_norm"):
            v = getattr(lp, name)
            if v is not None:
                out[f"layers.{i}.{name}"] = _np(v)
        for name in ("q", "k", "v", "o", "gate", "up", "down", "qkv",
                     "gate_up"):
            lin = getattr(lp, name)
            if lin is not None:
                _linear(out, f"layers.{i}.{name}", lin)
        if lp.moe is not None:
            for name in ("router", "gate", "up", "down", "gate_up"):
                lin = getattr(lp.moe, name)
                if lin is not None:
                    _linear(out, f"layers.{i}.moe.{name}", lin)
    return out


def flatten_torch_params(params) -> dict:
    """The port's ModelParams -> the same flat dict `flatten_jax_params`
    makes of the JAX package's (floats as f32, exact for bf16 / f16)."""
    def np_of(t):
        t = t.detach().cpu()
        return t.float().numpy() if t.is_floating_point() else t.numpy()

    class _View:
        def __init__(self, obj):
            self._obj = obj

        def __getattr__(self, name):
            v = getattr(self._obj, name)
            if isinstance(v, torch.Tensor):
                return np_of(v)
            if v is not None and hasattr(v, "__dataclass_fields__"):
                return _View(v)
            if isinstance(v, list):
                return [_View(x) for x in v]
            return v

    return flatten_jax_params(_View(params))


def jax_model(preset_name, quantized: bool, seed: int = 0,
              two_level: bool = True):
    """(jax ModelConfig, f32 JAX params) of a preset name or a JAX
    ModelConfig: random float weights, int4 g128 when `quantized`
    (two-level requantized unless `two_level` is False; MoE expert stacks
    too), q|k|v and gate|up fused."""
    import jax
    import jax.numpy as jnp

    from ferrum_tpu.engine.builder import apply_two_level, fuse_projections
    from ferrum_tpu.models.configs import preset
    from ferrum_tpu.models.llama_family import init_random_params
    from ferrum_tpu.models.quantize import quantize_model_params

    cfg = preset(preset_name) if isinstance(preset_name, str) \
        else preset_name
    params = init_random_params(cfg, seed=seed, dtype=jnp.float32)
    if quantized:
        params = quantize_model_params(params, 128, dtype=jnp.float32)
        if two_level:
            params = jax.jit(apply_two_level)(params)
    return cfg, fuse_projections(params)


def torch_config(jax_cfg):
    """The port's ModelConfig with the same field values."""
    from ferrum_tpu_torch.models.configs import (ModelConfig, MoeConfig,
                                                 RopeScaling)
    import dataclasses

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: getattr(jax_cfg, k) for k in fields}
    for name, cls in (("rope_scaling", RopeScaling), ("moe", MoeConfig)):
        if kw[name] is not None:
            kw[name] = cls(**dataclasses.asdict(kw[name]))
    return ModelConfig(**kw)
