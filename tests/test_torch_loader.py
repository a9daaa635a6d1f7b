"""Checkpoint loading: ferrum_tpu_torch's loaders vs ferrum_tpu's, on the CPU.

Local checkpoint directories are written here (safetensors shards from
numpy, seeded; nothing is downloaded) and read by both packages:

- `config_from_hf_dict` field by field for llama (with llama3 rope
  scaling), qwen2, qwen3, qwen3_moe, gemma3 (plain, wrapped as
  Gemma3ForConditionalGeneration, with softcaps and linear rope scaling)
  and mistral with a sliding window; what the port's trunk does not run,
  and what the JAX mapping reads and drops, raises ModelLoadError;
- `repack_from_gptq` bit for bit (groups 32 / 64 / 128, with and without
  act-order, zero nibbles random, all 0 and all 15);
- the port's safetensors reader against `safetensors` (numpy for F32,
  F16, I64, I32, I16, I8, U8 and BOOL; torch for BF16) across two shards,
  and its writer read back by `safetensors`;
- `load_checkpoint` leaf by leaf against the JAX one: integers exact,
  floats exact after the same casts (GPTQ llama with act-order, a tied
  qwen3 with q/k norms, qwen3_moe expert stacks, a dense f32 directory
  quantized on load, a dense f16 qwen2 with q/k/v bias, gemma3 dense and
  GPTQ with its sandwich norms, mistral with a window);
- a BF16 directory, leaf by leaf against the JAX loader;
- engines built from a directory serve the JAX engine's greedy tokens;
- HF parity: tiny Llama, Qwen3, Mistral with a window and Gemma 3 from
  `transformers`, saved with `save_pretrained`, read by the port's
  reader, give HF's logits within tests/test_hf_parity.py's tolerances
  (2e-4; gemma3 6e-4).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from torch_parity import (flatten_jax_params, flatten_torch_params,
                          route_moe_w4a8tl, route_w4a8tl, torch_config)

# Engine-test model: the smallest widths the int4 g128 layout takes
# (in/2 a group multiple), a vocabulary that holds the engine tests'
# prompt ids (up to 1000).
H, HEADS, KV_HEADS, HEAD_DIM, INTER, VOCAB = 256, 4, 2, 64, 512, 1024
MOE_E, MOE_K, MOE_INTER = 8, 2, 256


def _llama_cfg(**kw):
    d = dict(architectures=["LlamaForCausalLM"], vocab_size=VOCAB,
             hidden_size=H, num_hidden_layers=2, num_attention_heads=HEADS,
             num_key_value_heads=KV_HEADS, intermediate_size=INTER,
             rms_norm_eps=1e-5, rope_theta=500000.0,
             max_position_embeddings=2048, tie_word_embeddings=False,
             bos_token_id=1, eos_token_id=2,
             rope_scaling=dict(rope_type="llama3", factor=8.0,
                               low_freq_factor=1.0, high_freq_factor=4.0,
                               original_max_position_embeddings=64))
    d.update(kw)
    return d


def _qwen3_cfg(**kw):
    d = dict(architectures=["Qwen3ForCausalLM"], vocab_size=VOCAB,
             hidden_size=H, num_hidden_layers=2, num_attention_heads=HEADS,
             num_key_value_heads=KV_HEADS, head_dim=HEAD_DIM,
             intermediate_size=INTER, rms_norm_eps=1e-6, rope_theta=1e6,
             max_position_embeddings=4096, tie_word_embeddings=True,
             bos_token_id=None, eos_token_id=[7, 9])
    d.update(kw)
    return d


def _gemma_cfg(**kw):
    d = dict(architectures=["Gemma3ForCausalLM"], vocab_size=VOCAB,
             hidden_size=H, num_hidden_layers=3, num_attention_heads=HEADS,
             num_key_value_heads=KV_HEADS, head_dim=HEAD_DIM,
             intermediate_size=INTER, rms_norm_eps=1e-6, rope_theta=1e6,
             rope_local_base_freq=1e4, sliding_window=16,
             sliding_window_pattern=3, query_pre_attn_scalar=48,
             max_position_embeddings=4096, tie_word_embeddings=True,
             bos_token_id=2, eos_token_id=[1, 106])
    d.update(kw)
    return d


def _moe_cfg(**kw):
    d = _qwen3_cfg(architectures=["Qwen3MoeForCausalLM"],
                   tie_word_embeddings=False, num_experts=MOE_E,
                   num_experts_per_tok=MOE_K,
                   moe_intermediate_size=MOE_INTER, norm_topk_prob=True,
                   decoder_sparse_step=1, mlp_only_layers=[])
    d.update(kw)
    return d


CONFIGS = {
    "llama": dict(_llama_cfg(), rope_scaling=None),
    "llama3_rope": _llama_cfg(),
    "qwen2": dict(architectures=["Qwen2ForCausalLM"], vocab_size=VOCAB,
                  hidden_size=H, num_hidden_layers=2,
                  num_attention_heads=HEADS, num_key_value_heads=KV_HEADS,
                  intermediate_size=INTER, rms_norm_eps=1e-6,
                  rope_theta=10000.0, max_position_embeddings=512,
                  sliding_window=4096, use_sliding_window=False,
                  tie_word_embeddings=False, eos_token_id=3),
    "qwen3": dict(_qwen3_cfg(), layer_types=["full_attention"] * 2),
    "qwen3_moe": _moe_cfg(),
    "gemma3": _gemma_cfg(),
    "gemma3_wrapped": dict(architectures=["Gemma3ForConditionalGeneration"],
                           text_config={
                               k: v for k, v in _gemma_cfg().items()
                               if k != "architectures"},
                           eos_token_id=[1, 106]),
    "gemma3_softcaps": _gemma_cfg(
        final_logit_softcapping=30.0, attn_logit_softcapping=50.0,
        rope_scaling=dict(rope_type="linear", factor=8.0),
        layer_types=["sliding_attention", "full_attention",
                     "sliding_attention"]),
    "mistral_window": dict(_llama_cfg(), architectures=["MistralForCausalLM"],
                           rope_scaling=None, sliding_window=8),
    "mistral_window_layer_types": dict(
        _llama_cfg(), architectures=["MistralForCausalLM"],
        rope_scaling=None, sliding_window=8,
        layer_types=["sliding_attention", "full_attention"]),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_config_from_hf_dict_matches_jax(name):
    from ferrum_tpu.models.configs import config_from_hf_dict as jax_map
    from ferrum_tpu_torch.models.configs import ModelConfig, config_from_hf_dict

    got, want = config_from_hf_dict(CONFIGS[name]), jax_map(CONFIGS[name])
    for f in dataclasses.fields(ModelConfig):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(w):
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g == w, (name, f.name, g, w)


# What the port's trunk does not run ("item N"), and what the JAX mapping
# reads and then computes as another model ("Queue 3"): a window or a
# softcap on a family whose mapping drops it, yarn computed unscaled.
UNPORTED = {
    "use_sliding_window": (dict(_qwen3_cfg(), use_sliding_window=True,
                                sliding_window=64), "Queue 3"),
    "softcap": (dict(_llama_cfg(), final_logit_softcapping=30.0),
                "Queue 3"),
    "attn_softcap_mistral": (dict(_llama_cfg(), architectures=[
        "MistralForCausalLM"], attn_logit_softcapping=50.0), "Queue 3"),
    "sliding_layer_types": (dict(_qwen3_cfg(), layer_types=[
        "sliding_attention", "full_attention"]), "Queue 3"),
    "mistral_layer_types_no_window": (dict(_llama_cfg(), architectures=[
        "MistralForCausalLM"], layer_types=["sliding_attention",
                                            "full_attention"]), "Queue 3"),
    "chunked_layer_types": (dict(_gemma_cfg(), layer_types=[
        "chunked_attention", "full_attention", "full_attention"]),
        "Queue 3"),
    "qwen3_next": (dict(_moe_cfg(), architectures=[
        "Qwen3NextForCausalLM"]), "item 11"),
    "linear_layer_types": (dict(_qwen3_cfg(), layer_types=[
        "linear_attention", "full_attention"]), "item 11"),
    "shared_expert": (dict(_moe_cfg(), shared_expert_intermediate_size=64),
                      "item 11"),
    "yarn": (dict(_llama_cfg(), rope_scaling=dict(rope_type="yarn",
                                                  factor=4.0)), "Queue 3"),
    "gemma3_yarn": (dict(_gemma_cfg(), rope_scaling=dict(
        rope_type="yarn", factor=8.0)), "Queue 3"),
    "unknown_arch": (dict(_llama_cfg(), architectures=["GPT2LMHeadModel"]),
                     "unsupported architectures"),
}


# The cases the port refused before it ran windows and softcaps, now
# mapped as the JAX package maps them.
PORTED = {
    "gemma3": dict(_qwen3_cfg(), architectures=["Gemma3ForCausalLM"]),
    "mistral_window": dict(_llama_cfg(), architectures=[
        "MistralForCausalLM"], sliding_window=8),
    "softcap": _gemma_cfg(final_logit_softcapping=30.0),
}


@pytest.mark.parametrize("name", list(PORTED))
def test_config_now_ported_matches_jax(name):
    from ferrum_tpu.models.configs import config_from_hf_dict as jax_map
    from ferrum_tpu_torch.models.configs import config_from_hf_dict

    got, want = config_from_hf_dict(PORTED[name]), jax_map(PORTED[name])
    assert got == torch_config(want)
    assert got.sliding_window is not None
    for li in range(got.num_layers):
        assert got.layer_sliding_window(li) == want.layer_sliding_window(li)


@pytest.mark.parametrize("name", list(UNPORTED))
def test_config_unported_raises(name):
    from ferrum_tpu_torch.models.configs import config_from_hf_dict
    from ferrum_tpu_torch.types import ModelLoadError

    d, match = UNPORTED[name]
    with pytest.raises(ModelLoadError, match=match):
        config_from_hf_dict(d)


# ---------------------------------------------------------------------------
# GPTQ tensors and the repack
# ---------------------------------------------------------------------------

def gptq_np(rng, in_f, out_f, group=128, act_order=False, zeros="random"):
    """AutoGPTQ-form tensors of one linear: qweight int32 [in/8, out],
    qzeros int32 [in/g, out/8] (stored zero nibbles), scales f16
    [in/g, out], g_idx int32 [in] (a permuted group map with act-order)."""
    qweight = rng.integers(0, 2 ** 32, (in_f // 8, out_f),
                           dtype=np.uint64).astype(np.uint32).view(np.int32)
    nz = {"random": rng.integers(0, 16, (in_f // group, out_f)),
          "0": np.zeros((in_f // group, out_f), np.int64),
          "15": np.full((in_f // group, out_f), 15)}[zeros]
    nz = nz.reshape(in_f // group, out_f // 8, 8).astype(np.uint32)
    qzeros = (nz << (np.arange(8, dtype=np.uint32) * 4)).sum(
        -1, dtype=np.uint32).view(np.int32)
    scales = rng.uniform(0.002, 0.02, (in_f // group, out_f)
                         ).astype(np.float16)
    g_idx = np.arange(in_f) // group
    if act_order:
        g_idx = rng.permutation(g_idx)
    return qweight, qzeros, scales, g_idx.astype(np.int32)


@pytest.mark.parametrize("zeros", ["random", "0", "15"])
@pytest.mark.parametrize("act_order", [False, True])
@pytest.mark.parametrize("group", [32, 64, 128])
def test_repack_from_gptq_matches_jax(group, act_order, zeros):
    from ferrum_tpu.ops.quant import repack_from_gptq as jax_repack
    from ferrum_tpu_torch.ops.quant import repack_from_gptq

    rng = np.random.default_rng(group + 7 * act_order)
    qw, qz, sc, gi = gptq_np(rng, 512, 96, group, act_order, zeros)
    want = jax_repack(qw, qz, sc, gi)
    got = repack_from_gptq(*map(torch.from_numpy, (qw, qz, sc, gi)))
    for g, w, dt in zip(got[:3], want[:3], (torch.uint8, torch.float32,
                                            torch.int8)):
        assert g.dtype == dt and np.array_equal(g.numpy(), w)
    assert got[3] == want[3] == group
    if act_order:
        assert np.array_equal(got[4].numpy(), want[4])
    else:
        assert got[4] is None and want[4] is None
    # Without g_idx at all: no act-order either.
    assert repack_from_gptq(*map(torch.from_numpy, (qw, qz, sc)))[4] is None


# ---------------------------------------------------------------------------
# The safetensors reader and writer
# ---------------------------------------------------------------------------

def test_reader_matches_safetensors(tmp_path):
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    from ferrum_tpu_torch.models.loader import TensorSource

    rng = np.random.default_rng(0)
    shard1 = {"f32": rng.normal(size=(3, 5)).astype(np.float32),
              "f16": rng.normal(size=(7,)).astype(np.float16),
              "i64": rng.integers(-2 ** 40, 2 ** 40, (2, 3)),
              "i32": rng.integers(-2 ** 31, 2 ** 31, (4, 4)).astype(np.int32),
              "both": np.zeros((2,), np.float32)}
    shard2 = {"i16": rng.integers(-3000, 3000, (5,)).astype(np.int16),
              "i8": rng.integers(-128, 128, (6, 2)).astype(np.int8),
              "u8": rng.integers(0, 256, (3, 3)).astype(np.uint8),
              "bool": rng.integers(0, 2, (4,)).astype(bool),
              "scalar": np.array(2.5, np.float32),
              "empty": np.zeros((0, 4), np.float32),
              "both": np.ones((2,), np.float32)}
    save_file(shard1, str(tmp_path / "model-00001-of-00003.safetensors"),
              metadata={"format": "np"})
    save_file(shard2, str(tmp_path / "model-00002-of-00003.safetensors"))
    bf = {"bf16": torch.randn(4, 3, generator=torch.Generator().manual_seed(
        0)).to(torch.bfloat16)}
    save_torch(bf, str(tmp_path / "model-00003-of-00003.safetensors"))

    src = TensorSource.from_dir(str(tmp_path))
    assert set(src.keys()) == set(shard1) | set(shard2) | set(bf)
    for name, want in {**shard1, **shard2}.items():
        got = src.get(name)
        assert tuple(got.shape) == want.shape, name
        assert np.array_equal(got.numpy(), want), name
        assert got.numpy().dtype == want.dtype, name
    got = src.get("bf16")
    assert got.dtype == torch.bfloat16 and torch.equal(got, bf["bf16"])
    # A name in two shards: the later shard's tensor, as the JAX loader.
    assert np.array_equal(src.get("both").numpy(), shard2["both"])


def test_reader_raises_on_an_unread_dtype(tmp_path):
    from safetensors.numpy import save_file

    from ferrum_tpu_torch.models.loader import TensorSource
    from ferrum_tpu_torch.types import ModelLoadError

    save_file({"x": np.zeros(3, np.float64)}, str(tmp_path / "a.safetensors"))
    with pytest.raises(ModelLoadError, match="F64"):
        TensorSource.from_dir(str(tmp_path))
    with pytest.raises(ModelLoadError, match="no .safetensors"):
        TensorSource.from_dir(str(tmp_path / "missing"))


def test_reader_keeps_host_memory_at_a_tensor(tmp_path):
    """Reading a 256 MiB shard tensor by tensor (16 MiB each) raises the
    process's RSS by a few tensors, not by the file: the reader unmaps
    what it has copied. (Kept mapped, the pages read would raise it by
    the file's 256 MiB.) VmRSS sampled every millisecond."""
    import threading

    from ferrum_tpu_torch.models.safetensors_io import (SafetensorsFile,
                                                        write_safetensors)

    def rss_mib():
        with open("/proc/self/status") as f:
            return next(int(line.split()[1]) for line in f
                        if line.startswith("VmRSS:")) / 1024

    path = str(tmp_path / "big.safetensors")
    write_safetensors(path, {f"t{i}": torch.full((4 << 20,), float(i))
                             for i in range(16)})
    f = SafetensorsFile(path)
    stop, peak = threading.Event(), [0.0]

    def sample():
        while not stop.wait(0.001):
            peak[0] = max(peak[0], rss_mib())

    before = rss_mib()
    th = threading.Thread(target=sample)
    th.start()
    try:
        for i in range(16):
            t = f.get(f"t{i}")
            assert t[0].item() == i and t[-1].item() == i
            del t
    finally:
        stop.set()
        th.join(timeout=30)
    assert not th.is_alive()
    assert max(peak[0], rss_mib()) - before < 96, (before, peak[0])


def test_writer_is_read_by_safetensors(tmp_path):
    from safetensors.torch import load_file

    from ferrum_tpu_torch.models.safetensors_io import write_safetensors

    g = torch.Generator().manual_seed(1)
    tensors = {"bf16": torch.randn(3, 8, generator=g).to(torch.bfloat16),
               "f16": torch.randn(5, generator=g).half(),
               "f32": torch.randn(2, 2, 2, generator=g),
               "i32": torch.randint(-9, 9, (4,), generator=g,
                                    dtype=torch.int32),
               "i64": torch.arange(3), "u8": torch.arange(7,
                                                          dtype=torch.uint8),
               "bool": torch.tensor([True, False, True])}
    path = str(tmp_path / "w.safetensors")
    write_safetensors(path, tensors, metadata={"format": "pt"})
    back = load_file(path)
    assert set(back) == set(tensors)
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t), k


# ---------------------------------------------------------------------------
# Checkpoint directories
# ---------------------------------------------------------------------------

def _dense_np(rng, out_f, in_f, dtype=np.float32, scale=0.05):
    return (scale * rng.normal(size=(out_f, in_f))).astype(dtype)


def _linear_np(out, rng, prefix, in_f, out_f, gptq, act_order, fdt,
               bias=False):
    if gptq:
        qw, qz, sc, gi = gptq_np(rng, in_f, out_f, act_order=act_order)
        out.update({f"{prefix}.qweight": qw, f"{prefix}.qzeros": qz,
                    f"{prefix}.scales": sc, f"{prefix}.g_idx": gi})
    else:
        out[f"{prefix}.weight"] = _dense_np(rng, out_f, in_f, fdt)
    if bias:
        out[f"{prefix}.bias"] = (0.1 * rng.normal(size=out_f)).astype(fdt)


def checkpoint_tensors(cfg: dict, seed=0, gptq=False, act_order_layers=(),
                       fdt=np.float32):
    """HF-named tensors of a config dict: random norms and weights, GPTQ
    int4 g128 linears where `gptq` (act-order in `act_order_layers`)."""
    rng = np.random.default_rng(seed)
    h, v = cfg["hidden_size"], cfg["vocab_size"]
    hd = cfg.get("head_dim") or h // cfg["num_attention_heads"]
    qs, kvs = cfg["num_attention_heads"] * hd, \
        cfg["num_key_value_heads"] * hd
    qwen = cfg["architectures"][0].startswith(("Qwen3", "Gemma3"))
    gemma = cfg["architectures"][0].startswith("Gemma3")
    bias = cfg["architectures"][0].startswith("Qwen2")
    t = {"model.embed_tokens.weight": _dense_np(rng, v, h, fdt, 0.5),
         "model.norm.weight": (1 + 0.1 * rng.normal(size=h)).astype(fdt)}
    if not cfg["tie_word_embeddings"]:
        t["lm_head.weight"] = _dense_np(rng, v, h, fdt)
    for i in range(cfg["num_hidden_layers"]):
        p = f"model.layers.{i}"
        act = i in act_order_layers
        for name in ("input_layernorm", "post_attention_layernorm") + (
                ("pre_feedforward_layernorm", "post_feedforward_layernorm")
                if gemma else ()):
            t[f"{p}.{name}.weight"] = (1 + 0.1 * rng.normal(size=h)
                                       ).astype(fdt)
        for name, i_f, o_f in (("q", h, qs), ("k", h, kvs), ("v", h, kvs),
                               ("o", qs, h)):
            _linear_np(t, rng, f"{p}.self_attn.{name}_proj", i_f, o_f, gptq,
                       act, fdt, bias=bias and name != "o")
        if qwen:
            for name in ("q_norm", "k_norm"):
                t[f"{p}.self_attn.{name}.weight"] = (
                    1 + 0.1 * rng.normal(size=hd)).astype(fdt)
        if "num_experts" in cfg:
            e, mi = cfg["num_experts"], cfg["moe_intermediate_size"]
            t[f"{p}.mlp.gate.weight"] = _dense_np(rng, e, h, fdt, 0.5)
            for x in range(e):
                ep = f"{p}.mlp.experts.{x}"
                for name, i_f, o_f in (("gate", h, mi), ("up", h, mi),
                                       ("down", mi, h)):
                    _linear_np(t, rng, f"{ep}.{name}_proj", i_f, o_f, gptq,
                               False, fdt)
        else:
            inter = cfg["intermediate_size"]
            for name, i_f, o_f in (("gate", h, inter), ("up", h, inter),
                                   ("down", inter, h)):
                _linear_np(t, rng, f"{p}.mlp.{name}_proj", i_f, o_f, gptq,
                           act, fdt)
    return t


def write_checkpoint(d, cfg: dict, tensors: dict, gptq=False, bf16=False):
    """config.json (+ quantize_config.json) and two safetensors shards."""
    from safetensors.numpy import save_file
    from safetensors.torch import save_file as save_torch

    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump(cfg, f)
    if gptq:
        with open(os.path.join(d, "quantize_config.json"), "w") as f:
            json.dump({"bits": 4, "group_size": 128, "desc_act": True}, f)
    names = sorted(tensors)
    for k, part in enumerate((names[::2], names[1::2])):
        path = os.path.join(d, f"model-0000{k + 1}-of-00002.safetensors")
        if bf16:
            save_torch({n: torch.from_numpy(tensors[n]).to(torch.bfloat16)
                        if tensors[n].dtype.kind == "f"
                        else torch.from_numpy(tensors[n]) for n in part}, path)
        else:
            save_file({n: tensors[n] for n in part}, path)
    return str(d)


DIRS = {
    # name: (config, gptq, act-order layers, float dtype, quantization)
    "llama_gptq_act_order": (_llama_cfg(), True, (1,), np.float16, "none"),
    "qwen3_gptq_tied": (_qwen3_cfg(), True, (), np.float16, "none"),
    "qwen3_moe_gptq": (_moe_cfg(), True, (), np.float16, "none"),
    "llama_dense_quantize_on_load": (_llama_cfg(), False, (), np.float32,
                                     "gptq_int4"),
    "qwen2_dense_f16_bias": (CONFIGS["qwen2"], False, (), np.float16, "none"),
    "qwen3_moe_dense_quantize_on_load": (_moe_cfg(), False, (), np.float32,
                                         "gptq_int4"),
    "gemma3_dense": (_gemma_cfg(), False, (), np.float32, "none"),
    "gemma3_gptq": (CONFIGS["gemma3_softcaps"], True, (2,), np.float16,
                    "none"),
    "mistral_window_dense_f16": (CONFIGS["mistral_window"], False, (),
                                 np.float16, "none"),
}


def make_dir(tmp_path, name, seed=None):
    cfg, gptq, act, fdt, _ = DIRS[name]
    seed = len(name) if seed is None else seed
    return write_checkpoint(tmp_path / name, cfg, checkpoint_tensors(
        cfg, seed=seed, gptq=gptq, act_order_layers=act, fdt=fdt), gptq)


def _flat_port(params):
    return flatten_torch_params(params)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("name", list(DIRS))
def test_load_checkpoint_matches_jax(tmp_path, name, dtype):
    from ferrum_tpu.config import EngineConfig as JaxEngineConfig
    from ferrum_tpu.models.loader import load_checkpoint as jax_load
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.models.loader import load_checkpoint

    d = make_dir(tmp_path, name)
    quant = DIRS[name][4]
    jcfg, jparams, _ = jax_load(d, JaxEngineConfig(
        model=d, dtype=dtype, quantization=quant))
    cfg, params, tok = load_checkpoint(d, EngineConfig(
        model=d, dtype=dtype, quantization=quant), "cpu")
    assert tok is None
    want, got = flatten_jax_params(jparams), _flat_port(params)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == \
            want[k].shape, k
        assert np.array_equal(got[k], want[k]), k
    # The float leaves keep the engine's dtype on both sides.
    wdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    assert params.embed.dtype == wdt
    for f in dataclasses.fields(cfg):
        g, w = getattr(cfg, f.name), getattr(jcfg, f.name)
        if dataclasses.is_dataclass(w):
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g == w, f.name
    if name == "llama_gptq_act_order":
        assert params.layers[1].q.input_perm is not None
        assert params.layers[0].q.input_perm is None


def test_bf16_directory_matches_jax(tmp_path):
    """BF16 shards, the form Llama-3.1 and Qwen3 checkpoints ship in: the
    port reads them with its own reader, leaf for leaf what the JAX
    loader reads (safetensors' numpy framework knows bfloat16 once
    ml_dtypes is imported, which importing jax does)."""
    from ferrum_tpu.config import EngineConfig as JaxEngineConfig
    from ferrum_tpu.models.loader import load_checkpoint as jax_load
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.models.loader import load_checkpoint

    cfg = _qwen3_cfg()
    tensors = checkpoint_tensors(cfg, seed=5)
    d = write_checkpoint(tmp_path / "bf16", cfg, tensors, bf16=True)
    _, jparams, _ = jax_load(d, JaxEngineConfig(model=d))
    _, params, _ = load_checkpoint(d, EngineConfig(model=d), "cpu")
    want, got = flatten_jax_params(jparams), _flat_port(params)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    emb = torch.from_numpy(tensors["model.embed_tokens.weight"])
    assert params.embed.dtype == torch.bfloat16
    assert torch.equal(params.embed, emb.to(torch.bfloat16))
    w = torch.from_numpy(tensors["model.layers.1.self_attn.o_proj.weight"])
    assert torch.equal(params.layers[1].o.w, w.to(torch.bfloat16).t())


def test_load_checkpoint_eos_from_tokenizer(tmp_path):
    """A tokenizer.json beside the weights: its generation_config eos list
    becomes the config's eos ids, as the JAX loader sets them."""
    from ferrum_tpu.config import EngineConfig as JaxEngineConfig
    from ferrum_tpu.models.loader import load_checkpoint as jax_load
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.models.loader import load_checkpoint
    from test_torch_tokenizer import write_tokenizer_dir

    d = make_dir(tmp_path, "qwen3_gptq_tied")
    write_tokenizer_dir(d, "qwen2", eos=[5, 6])
    jcfg, _, jtok = jax_load(d, JaxEngineConfig(model=d))
    cfg, _, tok = load_checkpoint(d, EngineConfig(model=d), "cpu")
    assert cfg.eos_token_ids == jcfg.eos_token_ids == tuple(
        jtok.eos_token_ids)
    assert tok.encode("hello world") == jtok.encode("hello world")


def test_loader_refuses_other_quantization(tmp_path):
    from ferrum_tpu_torch.models.loader import detect_quantization
    from ferrum_tpu_torch.types import ModelLoadError

    for q, match in (({"quant_method": "awq", "bits": 4}, "awq"),
                     ({"quant_method": "gptq", "bits": 8}, "4-bit"),
                     ({"quant_method": "gptq", "bits": 4,
                       "checkpoint_format": "gptq_v2"}, "gptq_v2")):
        d = tmp_path / q.get("checkpoint_format", q["quant_method"]) / \
            str(q["bits"])
        os.makedirs(d)
        with open(d / "config.json", "w") as f:
            json.dump(dict(_llama_cfg(), quantization_config=q), f)
        with pytest.raises(ModelLoadError, match=match):
            detect_quantization(str(d))


# ---------------------------------------------------------------------------
# Engines built from a directory
# ---------------------------------------------------------------------------

# name: (directory, quantization, weight seed). A seed whose greedy
# tokens each lead the runner-up by MARGIN (test_torch_engine.py): a
# near-tie would make the comparison a coin flip.
ENGINE_DIRS = {
    "llama_gptq_act_order": ("llama_gptq_act_order", "none", 1),
    "llama_dense_quantize_on_load": ("llama_dense_quantize_on_load",
                                     "gptq_int4", 1),
    "dense_none": ("llama_dense_quantize_on_load", "none", 5),
    "qwen3_moe_gptq": ("qwen3_moe_gptq", "none", 1),
}


@pytest.mark.parametrize("name", list(ENGINE_DIRS))
def test_engine_from_directory_matches_jax_engine(tmp_path, monkeypatch,
                                                  name):
    """EngineBuilder(EngineConfig(model=<dir>, device="cpu")) and the JAX
    builder on the same directory: equal greedy tokens (the unpipelined
    loop, f32, the linear layout), each a clear argmax of the port's
    model. "dense_none" serves the dense f32 weights unquantized."""
    from ferrum_tpu.config import EngineConfig as JaxEngineConfig
    from ferrum_tpu.engine.builder import EngineBuilder as JaxBuilder
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.types import SamplingParams as JSamp
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    from test_torch_engine import (LINEAR, MARGIN, MAX_TOKENS, PROMPTS,
                                   UNPIPELINED, _engine_kw, _margins, _serve)

    route_w4a8tl(monkeypatch)
    route_moe_w4a8tl(monkeypatch)
    dir_name, quant, seed = ENGINE_DIRS[name]
    d = make_dir(tmp_path, dir_name, seed)
    kw = dict(_engine_kw(), **UNPIPELINED, dtype="f32", quantization=quant)
    engine = EngineBuilder(EngineConfig(model=d, device="cpu", **LINEAR,
                                        **kw)).build()
    cfg, params = engine.runner.model_cfg, engine.runner.params
    got = _serve(engine, InferenceRequest, SamplingParams, PROMPTS, 3)[0]
    jengine = JaxBuilder(JaxEngineConfig(
        model=d, kv_layout="linear", enable_prefix_cache=False,
        adaptive_windows=False, **kw)).build()
    want = _serve(jengine, JReq, JSamp, PROMPTS, 3)[0]
    for prompt, out in zip(PROMPTS, got):
        assert len(out) == MAX_TOKENS
        argmax, margins = _margins(cfg, params, prompt, out)
        assert argmax == out
        assert min(margins) > MARGIN, f"near-tie {min(margins):.2e}"
    assert got == want


def test_builder_needs_cuda_unless_cpu_is_asked_for(tmp_path):
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.types import ModelLoadError

    d = make_dir(tmp_path, "qwen3_gptq_tied")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            EngineBuilder(EngineConfig(model=d)).build()
    with pytest.raises(ModelLoadError, match="cannot resolve"):
        EngineBuilder(EngineConfig(model=str(tmp_path / "x.gguf"),
                                   device="cpu")).build()


@pytest.mark.parametrize("entry", ["load_checkpoint", "params_from_hf"])
def test_loaders_default_to_the_card(tmp_path, entry):
    """Without a device the loaders take the engine config's, and that
    None the CUDA card: with no card they raise, as the builder does;
    the host is used only when the caller asks for it."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.models.configs import config_from_hf_json
    from ferrum_tpu_torch.models.loader import (TensorSource, load_checkpoint,
                                                params_from_hf)

    d = make_dir(tmp_path, "qwen3_gptq_tied")

    def load(**kw):
        if entry == "load_checkpoint":
            return load_checkpoint(d, EngineConfig(model=d, **kw))[1]
        return params_from_hf(config_from_hf_json(f"{d}/config.json"),
                              TensorSource.from_dir(d),
                              device=kw.get("device"))

    if torch.cuda.is_available():
        assert load().embed.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            load()
    assert load(device="cpu").embed.device.type == "cpu"


def test_dense_expert_stack_reaches_the_builder(tmp_path):
    """A dense MoE directory without quantize-on-load loads as bf16 expert
    stacks [E, in, out], which the builder serves through ops/moe.py's
    dense route (tests/test_torch_settings.py holds it against the JAX
    package)."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    d = make_dir(tmp_path, "qwen3_moe_dense_quantize_on_load")
    engine = EngineBuilder(EngineConfig(
        model=d, device="cpu", kv_layout="linear", max_num_seqs=2,
        max_model_len=256)).build()
    try:
        moe = engine.runner.params.layers[0].moe
        assert moe.down.dtype == torch.bfloat16 and moe.down.dim() == 3
        out = engine.infer(InferenceRequest(
            prompt_token_ids=[5, 9, 17, 3], sampling=SamplingParams(
                max_tokens=4, ignore_eos=True, temperature=0.0)))
        assert out.completion_tokens == 4
    finally:
        engine.stop()


def test_act_order_experts_raise(tmp_path):
    from ferrum_tpu_torch.models.loader import TensorSource, _expert_stack
    from ferrum_tpu_torch.types import ModelLoadError

    rng = np.random.default_rng(0)
    t = {}
    for e in range(2):
        qw, qz, sc, gi = gptq_np(rng, 256, 64, act_order=True)
        p = f"model.layers.0.mlp.experts.{e}.up_proj"
        t.update({f"{p}.qweight": qw, f"{p}.qzeros": qz, f"{p}.scales": sc,
                  f"{p}.g_idx": gi})
    with pytest.raises(ModelLoadError, match="act-order"):
        _expert_stack(TensorSource(t), "model.layers.0", "up_proj", 2,
                      torch.float32, "cpu", False)


# ---------------------------------------------------------------------------
# HF parity through the port's reader
# ---------------------------------------------------------------------------

def _port_logits(cfg, params, tokens):
    from ferrum_tpu_torch.models import llama_family as lf

    t = -(-len(tokens) // 16) * 16
    kv = lf.PagedKvCache.create(cfg, 8, 16, dtype=torch.float32,
                                device="cpu")
    tok = torch.zeros(1, t, dtype=torch.int64)
    tok[0, :len(tokens)] = torch.tensor(tokens)
    pos = torch.arange(t)[None]
    flat = torch.where(pos < len(tokens), pos, torch.full_like(pos, 1 << 30))
    h, _ = lf.prefill_forward_batched(
        params, cfg, kv, tok, pos, torch.arange(8)[None],
        torch.tensor([len(tokens)]), flat, ctx_pad=t)
    return lf.logits_from_hidden(params, cfg, h[0, :len(tokens)]).numpy()


def _hf_model(family):
    """A tiny `transformers` model of the family, seeded (the configs of
    tests/test_hf_parity.py for mistral with a window and gemma3)."""
    import transformers as tf

    torch.manual_seed(11)
    if family == "llama":
        return tf.LlamaForCausalLM(tf.LlamaConfig(
            vocab_size=128, hidden_size=64, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=128, rms_norm_eps=1e-5, rope_theta=10000.0,
            rope_scaling=dict(rope_type="llama3", factor=8.0,
                              low_freq_factor=1.0, high_freq_factor=4.0,
                              original_max_position_embeddings=64),
            max_position_embeddings=512, tie_word_embeddings=False))
    if family == "qwen3":
        return tf.Qwen3ForCausalLM(tf.Qwen3Config(
            vocab_size=128, hidden_size=64, num_hidden_layers=3,
            num_attention_heads=4, num_key_value_heads=2, head_dim=16,
            intermediate_size=128, rms_norm_eps=1e-6, rope_theta=10000.0,
            max_position_embeddings=512, tie_word_embeddings=True))
    if family == "mistral_window":
        return tf.MistralForCausalLM(tf.MistralConfig(
            vocab_size=128, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2,
            intermediate_size=128, rms_norm_eps=1e-5, rope_theta=10000.0,
            sliding_window=8, max_position_embeddings=512,
            tie_word_embeddings=False))
    return tf.Gemma3ForCausalLM(tf.Gemma3TextConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=4,
        num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        intermediate_size=128, rms_norm_eps=1e-6, rope_theta=10000.0,
        rope_local_base_freq=10000.0, sliding_window=8,
        query_pre_attn_scalar=16.0,
        layer_types=["sliding_attention", "sliding_attention",
                     "sliding_attention", "full_attention"],
        max_position_embeddings=512, tie_word_embeddings=True))


# tests/test_hf_parity.py's tolerances: 2e-4, gemma3 6e-4 (f32).
HF_FAMILIES = {"llama": 2e-4, "qwen3": 2e-4, "mistral_window": 2e-4,
               "gemma3": 6e-4}


@pytest.mark.parametrize("family", list(HF_FAMILIES))
def test_hf_parity_through_the_port_reader(tmp_path, family):
    """A tiny `transformers` model saved with save_pretrained, read by the
    port's config mapping and reader: the port's prefill logits (24
    tokens, past the windows of 8) equal HF's within the family's
    tolerance, argmax for argmax."""
    pytest.importorskip("transformers")
    from ferrum_tpu_torch.models.configs import config_from_hf_json
    from ferrum_tpu_torch.models.loader import TensorSource, params_from_hf

    m = _hf_model(family).eval()
    m.save_pretrained(str(tmp_path), safe_serialization=True)
    cfg = config_from_hf_json(str(tmp_path / "config.json"))
    params = params_from_hf(cfg, TensorSource.from_dir(str(tmp_path)),
                            dtype=torch.float32, device="cpu")
    tokens = np.random.default_rng(3).integers(0, 128, 24).tolist()
    with torch.no_grad():
        want = m(torch.tensor([tokens])).logits[0].float().numpy()
    got = _port_logits(cfg, params, tokens)
    tol = HF_FAMILIES[family]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    assert (got.argmax(-1) == want.argmax(-1)).all()
