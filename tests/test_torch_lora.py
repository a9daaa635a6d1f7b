"""LoRA adapters: ferrum_tpu_torch against ferrum_tpu.

  - `load_lora_adapter` on PEFT directories written with the port's
    `write_safetensors` (f32 and bf16, two shards, tensors it must skip):
    the same (layer, projection) pairs, A / B bit for bit and the same
    scale; the JAX refusals (no config, no weights, no usable pairs)
    with the same messages;
  - `apply_linear` on a LoRA-wrapped dense, float-scale int4 and
    two-level int4 base (both packages on the TPU's route table), f32
    within rtol 1e-4 / atol 1e-5 (tests/test_lora_replay.py's), bf16
    within one bf16 step of the output; `concat_linears` refuses a
    wrapper, `linear_out_features` looks through it;
  - `apply_lora` leaves the given params as they were, and
    `quantize_model_params` passes a wrapper through, as in JAX;
  - the builder: the route of each adapter layer's base (two-level or
    float-scale, as JAX's tree_map reaches into the wrapper), the
    adapter sites kept split and the others fused, the params object
    an engine was built from left unchanged;
  - engines on tiny-quant with an adapter: the port's greedy streams
    equal the JAX engine's; a B = 0 adapter gives exactly the base
    engine's tokens; a base engine built from the same params object
    before the adapter engine computes the same logits after it.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_engine as te
from torch_parity import (flatten_jax_params, route_float_scale,
                          route_w4a8tl, torch_config)

PREFIX = "base_model.model.model.layers"
SITES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
         "v": "self_attn.v_proj", "o": "self_attn.o_proj",
         "gate": "mlp.gate_proj", "up": "mlp.up_proj",
         "down": "mlp.down_proj"}


def _write_peft(d, shapes, r=4, alpha=8, dtype=torch.float32, seed=0,
                zero_b=False, shards=1, extra=True):
    """A PEFT adapter directory: adapter_config.json and the
    lora_A [r, in] / lora_B [out, r] tensors of `shapes` {(layer, attr):
    (in, out)} over `shards` files; `extra` adds tensors the loader
    skips (no layer index, an A without its B, a magnitude vector)."""
    from ferrum_tpu_torch.models.safetensors_io import write_safetensors

    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"r": r, "lora_alpha": alpha, "peft_type": "LORA",
                   "target_modules": sorted({SITES[a].split(".")[1]
                                             for _, a in shapes})}, f)
    rng = np.random.default_rng(seed)
    tensors = {}
    for (li, attr), (n_in, n_out) in sorted(shapes.items()):
        p = f"{PREFIX}.{li}.{SITES[attr]}"
        tensors[f"{p}.lora_A.weight"] = torch.from_numpy(
            rng.normal(0, 0.1, (r, n_in)).astype(np.float32)).to(dtype)
        b = rng.normal(0, 0.1, (n_out, r)).astype(np.float32)
        tensors[f"{p}.lora_B.weight"] = torch.from_numpy(
            np.zeros_like(b) if zero_b else b).to(dtype)
    if extra:
        tensors["base_model.model.lm_head.lora_A.weight"] = \
            torch.zeros(r, 8, dtype=dtype)
        tensors[f"{PREFIX}.9.self_attn.q_proj.lora_A.weight"] = \
            torch.zeros(r, 8, dtype=dtype)
        tensors[f"{PREFIX}.0.self_attn.q_proj.lora_magnitude_vector"] = \
            torch.zeros(8, dtype=dtype)
    names = list(tensors)
    for s in range(shards):
        part = {k: tensors[k] for k in names[s::shards]}
        suffix = "" if s == 0 else f"-{s + 1:05d}"
        write_safetensors(os.path.join(d, f"adapter_model{suffix}"
                                          f".safetensors"), part)
    return tensors


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.view(torch.int16) if a.dtype == torch.bfloat16
                else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


# ---------------------------------------------------------------------------
# Loading
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,shards", [(torch.float32, 1),
                                          (torch.bfloat16, 2)])
def test_load_matches_jax(tmp_path, dtype, shards):
    from ferrum_tpu.models.lora import load_lora_adapter as jload
    from ferrum_tpu_torch.models.lora import load_lora_adapter

    shapes = {(0, "q"): (64, 64), (0, "down"): (128, 64),
              (1, "gate"): (64, 128), (1, "v"): (64, 32)}
    _write_peft(tmp_path, shapes, r=4, alpha=16, dtype=dtype, shards=shards)
    got, scale = load_lora_adapter(str(tmp_path))
    want, jscale = jload(str(tmp_path))
    assert scale == jscale == 4.0
    assert sorted(got) == sorted(want) == sorted(shapes)
    for key, (a, b) in got.items():
        ja, jb = want[key]
        assert a.shape == ja.shape == (shapes[key][0], 4)
        assert b.shape == jb.shape == (4, shapes[key][1])
        assert a.dtype == dtype and b.dtype == dtype
        assert np.array_equal(_bits(a), _bits(ja))
        assert np.array_equal(_bits(b), _bits(jb))


def _refusal_dirs(d):
    """(name, directory) of each JAX refusal."""
    from ferrum_tpu_torch.models.safetensors_io import write_safetensors
    no_cfg = d / "no_config"
    no_cfg.mkdir()
    no_weights = d / "no_weights"
    no_weights.mkdir()
    (no_weights / "adapter_config.json").write_text('{"r": 4}')
    no_pairs = d / "no_pairs"
    no_pairs.mkdir()
    (no_pairs / "adapter_config.json").write_text('{"r": 4}')
    write_safetensors(str(no_pairs / "adapter_model.safetensors"), {
        f"{PREFIX}.0.self_attn.q_proj.lora_A.weight": torch.zeros(4, 8),
        "base_model.model.lm_head.lora_B.weight": torch.zeros(8, 4)})
    return {"no config": no_cfg, "no weights": no_weights,
            "no usable pairs": no_pairs}


@pytest.mark.parametrize("case", ["no config", "no weights",
                                  "no usable pairs"])
def test_load_refusals_match_jax(tmp_path, case):
    from ferrum_tpu.models.lora import load_lora_adapter as jload
    from ferrum_tpu.types import ModelLoadError as JError
    from ferrum_tpu_torch.models.lora import load_lora_adapter
    from ferrum_tpu_torch.types import ModelLoadError

    d = str(_refusal_dirs(tmp_path)[case])
    with pytest.raises(ModelLoadError) as got:
        load_lora_adapter(d)
    with pytest.raises(JError) as want:
        jload(d)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# apply_linear
# ---------------------------------------------------------------------------

K, N, R = 512, 256, 8


def _to_torch(a, dtype=None) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    t = torch.from_numpy(np.array(arr))
    return t if dtype is None else t.to(dtype)


def _base_pair(kind, dtype, seed=0):
    """(JAX base, port base) of one [K, N] linear: dense, float-scale int4
    or two-level int4 (g128), weights / scales in `dtype`."""
    from ferrum_tpu.ops import linear as jl
    from ferrum_tpu.ops.quant import make_quant_linear, requantize_two_level
    from ferrum_tpu_torch.ops.linear import DenseLinearParams
    from ferrum_tpu_torch.ops.quant import QuantLinearParams

    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    w = np.random.default_rng(seed).normal(0, 0.05, (K, N)).astype(
        np.float32)
    if kind == "dense":
        jp = jl.DenseLinearParams(w=jnp.asarray(w, jdt), bias=None)
        return jp, DenseLinearParams(w=_to_torch(jp.w), bias=None)
    jp = make_quant_linear(w, 128, dtype=jdt)
    if kind == "two-level":
        jp = requantize_two_level(jp)
    opt = {}
    if jp.scales2 is not None:
        opt = dict(scales2=_to_torch(jp.scales2),
                   chan_scale=_to_torch(jp.chan_scale))
    return jp, QuantLinearParams(
        qweight=_to_torch(jp.qweight), scales=_to_torch(jp.scales),
        zeros=_to_torch(jp.zeros), bias=None, in_features=K,
        out_features=N, group_size=128, **opt)


@pytest.mark.parametrize("m", [3, 96])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["dense", "float-scale", "two-level"])
def test_apply_linear_matches_jax(monkeypatch, kind, dtype, m):
    """y = base(x) + scale * (x @ A) @ B against the JAX package, both on
    the TPU's route table (w4a8 on: the int4 bases take their w4a8 route
    at m <= 64 and beyond; the JAX side's Pallas entries on their jnp
    forms)."""
    from ferrum_tpu.ops import linear as jl
    from ferrum_tpu_torch.ops.linear import LoraLinearParams, apply_linear
    from test_torch_float_scale import assert_one_bf16_step

    route_float_scale(monkeypatch, w4a8=True)
    jbase, base = _base_pair(kind, dtype)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(0, 1, (m, K)), jdt)
    a = jnp.asarray(rng.normal(0, 0.1, (K, R)), jdt)
    b = jnp.asarray(rng.normal(0, 0.1, (R, N)), jdt)
    want = jl.apply_linear(jl.LoraLinearParams(base=jbase, lora_a=a,
                                               lora_b=b, scale=2.0), x)
    got = apply_linear(LoraLinearParams(base=base, lora_a=_to_torch(a),
                                        lora_b=_to_torch(b), scale=2.0),
                       _to_torch(x))
    assert got.dtype == (torch.float32 if dtype == "f32"
                         else torch.bfloat16)
    assert got.shape == want.shape
    want_np = np.asarray(want.astype(jnp.float32))
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), want_np, rtol=1e-4,
                                   atol=1e-5)
    else:
        assert_one_bf16_step(got, want_np)


def test_concat_and_out_features_look_at_the_wrapper():
    from ferrum_tpu_torch.ops.linear import (LoraLinearParams,
                                             concat_linears,
                                             linear_out_features)

    _, dense = _base_pair("dense", "f32")
    _, quant = _base_pair("two-level", "f32")
    for base in (dense, quant):
        lora = LoraLinearParams(base=base, lora_a=torch.zeros(K, R),
                                lora_b=torch.zeros(R, N), scale=1.0)
        assert concat_linears([base, lora, base]) is None
        assert linear_out_features(lora) == linear_out_features(base) == N
    assert concat_linears([quant, quant]).out_features == 2 * N


# ---------------------------------------------------------------------------
# apply_lora, quantize_model_params, the builder
# ---------------------------------------------------------------------------

# Adapter sites on tiny-quant: layer 0's q and down (its q|k|v stays
# split, gate|up fuses), layer 1's gate (q|k|v fuses, gate|up split).
ADAPTED = {(0, "q"): (512, 512), (0, "down"): (1024, 512),
           (1, "gate"): (512, 1024)}


def _jax_tiny(two_level: bool, seed: int = 3):
    """tiny-quant's JAX config and f32 int4 params, unfused (float-scale,
    or two-level requantized)."""
    from ferrum_tpu.engine.builder import apply_two_level
    from ferrum_tpu.models.configs import preset
    from ferrum_tpu.models.llama_family import init_random_params
    from ferrum_tpu.models.quantize import quantize_model_params

    cfg = preset("tiny-quant")
    params = quantize_model_params(
        init_random_params(cfg, seed=seed, dtype=jnp.float32), 128,
        dtype=jnp.float32)
    if two_level:
        params = jax.jit(apply_two_level)(params)
    return cfg, params


def _adapters(d, shapes=ADAPTED, zero_b=False, seed=0):
    """(JAX adapter, port adapter, scale) of one PEFT directory."""
    from ferrum_tpu.models.lora import load_lora_adapter as jload
    from ferrum_tpu_torch.models.lora import load_lora_adapter

    _write_peft(d, shapes, r=8, alpha=16, zero_b=zero_b, seed=seed,
                extra=False)
    jad, jscale = jload(str(d))
    ad, scale = load_lora_adapter(str(d))
    assert scale == jscale
    return jad, ad, scale


def _ids(params):
    """The identity of every layer object and of each of its fields."""
    return [(id(lp), {k: id(v) for k, v in vars(lp).items()})
            for lp in params.layers]


def _kinds(params):
    """Per layer and projection field: the linear's form after a build
    -- None, dense, int4 (two-level or float-scale), or lora over one."""
    def kind(lin):
        if lin is None:
            return None
        name = type(lin).__name__
        if name == "LoraLinearParams":
            return ("lora", kind(lin.base))
        if name == "QuantLinearParams":
            return ("int4", lin.scales2 is not None)
        return (name,)
    return [{f: kind(getattr(lp, f)) for f in
             ("q", "k", "v", "o", "gate", "up", "down", "qkv", "gate_up")}
            for lp in params.layers]


def test_apply_lora_and_quantize_pass_through_as_jax(tmp_path):
    """apply_lora wraps exactly the adapter's sites in new layer objects
    (the given params keep theirs); quantize_model_params after it
    leaves the wrapped projections dense and quantizes the rest, in
    both packages."""
    from ferrum_tpu.models.llama_family import init_random_params
    from ferrum_tpu.models.lora import apply_lora as japply
    from ferrum_tpu.models.quantize import quantize_model_params as jquant
    from ferrum_tpu.models.configs import preset
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.models.lora import apply_lora
    from ferrum_tpu_torch.models.quantize import quantize_model_params

    jad, ad, scale = _adapters(tmp_path)
    jparams = init_random_params(preset("tiny-quant"), seed=0,
                                 dtype=jnp.float32)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    before = _ids(params)
    lora = apply_lora(params, ad, scale, dtype=torch.float32)
    assert _ids(params) == before
    assert lora.layers[0] is not params.layers[0]
    assert lora.layers[0].k is params.layers[0].k
    jlora = japply(jparams, jad, scale, dtype=jnp.float32)
    assert _kinds(lora) == _kinds(jlora)
    q = lora.layers[0].q
    assert q.lora_a.dtype == torch.float32 and q.lora_a.is_contiguous()
    assert np.array_equal(q.lora_a.numpy(), np.asarray(jlora.layers[0].q
                                                      .lora_a))
    got = quantize_model_params(lora, 128, dtype=torch.float32)
    want = jquant(jlora, 128, dtype=jnp.float32)
    assert _kinds(got) == _kinds(want)
    assert got.layers[0].q is lora.layers[0].q
    assert _kinds(got)[0]["q"] == ("lora", ("DenseLinearParams",))


def _build(params, cfg, **kw):
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    return EngineBuilder(EngineConfig(device="cpu", **{
        **te._engine_kw(), **te.LINEAR, **kw})).with_model(cfg, params) \
        .build()


@pytest.mark.parametrize("mode", [{}, {"w4a8_two_level": False},
                                  {"fuse_proj": False}])
def test_builder_routes_adapter_layers_as_jax(monkeypatch, tmp_path, mode):
    """Built from float-scale int4 params with an adapter: each layer's
    linears take the JAX builder's forms -- an adapter's base two-level
    under w4a8_two_level (the JAX tree_map reaches into the wrapper),
    the adapter sites split and the other sites fused -- and the params
    object given to the builder keeps its layers."""
    from ferrum_tpu.config import EngineConfig as JConfig
    from ferrum_tpu.engine.builder import EngineBuilder as JBuilder
    from ferrum_tpu.models.lora import apply_lora as japply
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.models.lora import apply_lora

    route_float_scale(monkeypatch, w4a8=True)
    jad, ad, scale = _adapters(tmp_path)
    jcfg, jparams = _jax_tiny(two_level=False)
    jeng = JBuilder(JConfig(model="parity", dtype="f32", kv_layout="linear",
                            enable_prefix_cache=False, **te._engine_kw(),
                            **mode)) \
        .with_model(jcfg, japply(jparams, jad, scale, dtype=jnp.float32)) \
        .build()
    jeng.stop()
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    lora = apply_lora(params, ad, scale, dtype=torch.float32)
    given = _ids(lora)
    eng = _build(lora, torch_config(jcfg), **mode)
    eng.stop()
    assert _kinds(eng.runner.params) == _kinds(jeng.runner.params)
    assert _ids(lora) == given
    kinds = _kinds(eng.runner.params)
    two_level = mode.get("w4a8_two_level", True)
    assert kinds[0]["q"] == ("lora", ("int4", two_level))
    assert kinds[0]["qkv"] is None and kinds[1]["gate_up"] is None
    fused = mode.get("fuse_proj", True)
    assert (kinds[0]["gate_up"] is not None) == fused
    assert (kinds[1]["qkv"] is not None) == fused


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

def _streams(cfg, params, loop):
    """The port engine's generated tokens (every one streamed, each the
    built model's clear argmax) and the engine."""
    got, streamed, engine = te._torch_streams(cfg, params, loop)
    assert streamed == got
    built = engine.runner.params
    for prompt, out in zip(te._prompts(te.LOOPS[loop][1]), got):
        argmax, margins = te._margins(cfg, built, prompt, out)
        assert argmax == out
        assert min(margins) > te.MARGIN, (
            f"near-tie (margin {min(margins):.2e} of the logit scale)")
    return got, engine


def _mode_restored(monkeypatch):
    from ferrum_tpu_torch.ops.kernels import quant_matmul as tqm
    for name in ("_W4A8", "_W4A8_GD"):
        monkeypatch.setattr(tqm, name, getattr(tqm, name))


@pytest.mark.parametrize("loop", ["unpipelined-c3", "pipelined-c4"])
@pytest.mark.parametrize("adapter_dtype", ["f32", "bf16"])
def test_lora_engine_streams_match_jax(monkeypatch, tmp_path, loop,
                                       adapter_dtype):
    """tiny-quant (float-scale int4, two-level requantized by both
    builders) with the adapter at ADAPTED: the port's greedy streams
    equal the JAX engine's."""
    from ferrum_tpu.models.lora import apply_lora as japply
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.models.lora import apply_lora

    route_w4a8tl(monkeypatch)
    _mode_restored(monkeypatch)
    jad, ad, scale = _adapters(tmp_path)
    jcfg, jparams = _jax_tiny(two_level=False)
    jdt, dt = ((jnp.float32, torch.float32) if adapter_dtype == "f32"
               else (jnp.bfloat16, torch.bfloat16))
    cfg = torch_config(jcfg)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    got, _ = _streams(cfg, apply_lora(params, ad, scale, dtype=dt), loop)
    base, _ = _streams(cfg, params, loop)
    assert got != base                   # the adapter moves the streams
    assert got == te._jax_streams(jcfg, japply(jparams, jad, scale,
                                               dtype=jdt), loop)


def _prompt_logits(cfg, params, prompt):
    """Every position's logits of one prompt through the batched prefill
    (a fresh f32 cache)."""
    from ferrum_tpu_torch.models import llama_family as lf
    t = -(-len(prompt) // 16) * 16
    kv = lf.PagedKvCache.create(cfg, 16, 16, dtype=torch.float32,
                                device="cpu")
    tokens = torch.zeros(1, t, dtype=torch.int64)
    tokens[0, :len(prompt)] = torch.tensor(prompt)
    pos = torch.arange(t)[None]
    flat = torch.where(pos < len(prompt), pos, torch.full_like(pos, 1 << 30))
    h, _ = lf.prefill_forward_batched(
        params, cfg, kv, tokens, pos, torch.arange(16)[None],
        torch.tensor([len(prompt)]), flat, ctx_pad=t)
    return lf.logits_from_hidden(params, cfg, h[0])


def test_zero_adapter_gives_the_base_tokens(monkeypatch, tmp_path):
    """An adapter with B = 0 on all seven projections of both layers:
    exactly the base engine's tokens."""
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.models.lora import apply_lora

    _mode_restored(monkeypatch)
    shapes = {(li, a): (1024 if a == "down" else 512,
                        {"q": 512, "k": 256, "v": 256, "o": 512,
                         "gate": 1024, "up": 1024, "down": 512}[a])
              for li in (0, 1) for a in SITES}
    _, ad, scale = _adapters(tmp_path, shapes, zero_b=True)
    jcfg, jparams = _jax_tiny(two_level=False)
    cfg = torch_config(jcfg)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    base = te._torch_streams(cfg, params, "unpipelined-c3")[0]
    zero = te._torch_streams(cfg, apply_lora(params, ad, scale),
                             "unpipelined-c3")[0]
    assert zero == base


def test_base_engine_keeps_its_logits_after_an_adapter_build(monkeypatch,
                                                              tmp_path):
    """A base engine built first, then an adapter from the same params
    object and its engine: the base params keep their split linears
    (the adapter wraps all of ADAPTED, as on unbuilt params: its
    streams equal the JAX adapter engine's), and the base engine's
    built params compute the same logits before and after."""
    from ferrum_tpu.models.lora import apply_lora as japply
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.models.lora import apply_lora

    route_w4a8tl(monkeypatch)
    _mode_restored(monkeypatch)
    jad, ad, scale = _adapters(tmp_path)
    jcfg, jparams = _jax_tiny(two_level=False)
    cfg = torch_config(jcfg)
    params = params_from_numpy(flatten_jax_params(jparams), "cpu")
    given = _ids(params)
    base_eng = _build(params, cfg)
    base_eng.stop()
    prompt = te.PROMPTS[1]
    before = _prompt_logits(cfg, base_eng.runner.params, prompt)
    assert _ids(params) == given
    lora = apply_lora(params, ad, scale, dtype=torch.float32)
    assert _kinds(lora)[0]["q"] == ("lora", ("int4", False))
    got, _ = _streams(cfg, lora, "unpipelined-c3")
    assert _ids(params) == given
    assert torch.equal(_prompt_logits(cfg, base_eng.runner.params, prompt),
                       before)
    assert got == te._jax_streams(jcfg, japply(jparams, jad, scale,
                                               dtype=jnp.float32),
                                  "unpipelined-c3")
