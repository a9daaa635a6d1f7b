"""GGUF: ferrum_tpu_torch/models/gguf.py vs ferrum_tpu/models/gguf.py.

The port keeps its own numpy copy of the JAX package's GGUF module. On
files written here (tests/test_gguf.py's tiny qwen3 checkpoint, F32 and
Q4_K): the writers' bytes, the reader's metadata and tensor table,
dequantization of Q8_0 / Q4_K / Q6_K / F16 / BF16 blocks (random blocks
with finite f16 scales), `hf_name`, `config_from_gguf` and
`load_gguf_checkpoint` (leaf by leaf, integers exact, floats exact after
the same casts) all equal the JAX package's.
"""

import dataclasses

import numpy as np
import pytest

from test_gguf import _tiny_gguf
from torch_parity import flatten_jax_params, flatten_torch_params


def _modules():
    from ferrum_tpu.models import gguf as jax_gguf
    from ferrum_tpu_torch.models import gguf

    return gguf, jax_gguf


@pytest.mark.parametrize("quant", ["F32", "Q4_K"])
def test_writer_and_reader_match_jax(tmp_path, quant):
    gguf, jax_gguf = _modules()
    ty = getattr(gguf, f"GGML_{quant}")
    _tiny_gguf(str(tmp_path / "jax.gguf"), quant=ty)
    rng = np.random.default_rng(4)
    tensors = {"a.weight": (rng.normal(size=(8, 256)).astype(np.float32), ty),
               "b.weight": (rng.normal(size=(16,)).astype(np.float32),
                            gguf.GGML_F16)}
    meta = {"general.architecture": "llama", "n": 3, "f": 0.5,
            "flag": True, "ids": [1, 2, 3], "s": "hello"}
    gguf.write_gguf(str(tmp_path / "p.gguf"), meta, tensors)
    jax_gguf.write_gguf(str(tmp_path / "j.gguf"), meta, tensors)
    assert (tmp_path / "p.gguf").read_bytes() == \
        (tmp_path / "j.gguf").read_bytes()
    for name in ("jax.gguf", "p.gguf"):
        g = gguf.read_gguf(str(tmp_path / name))
        jg = jax_gguf.read_gguf(str(tmp_path / name))
        assert g.metadata == jg.metadata and g.data_offset == jg.data_offset
        assert {k: dataclasses.astuple(v) for k, v in g.tensors.items()} \
            == {k: dataclasses.astuple(v) for k, v in jg.tensors.items()}
        for k in g.tensors:
            got, want = g.load_tensor(k), jg.load_tensor(k)
            assert got.dtype == want.dtype and np.array_equal(got, want), k


def _random_blocks(rng, ty, n_blocks):
    """Random blocks of a ggml type with finite f16 scales."""
    gguf, _ = _modules()
    nbytes = gguf._DTYPE_BLOCK[ty][1]
    raw = rng.integers(0, 256, (n_blocks, nbytes), dtype=np.uint8)
    d = rng.uniform(-0.05, 0.05, (n_blocks, 2)).astype(np.float16)
    if ty == gguf.GGML_Q8_0:
        raw[:, 0:2] = d[:, :1].view(np.uint8)
    elif ty == gguf.GGML_Q4_K:
        raw[:, 0:4] = d.view(np.uint8)
    elif ty == gguf.GGML_Q6_K:
        raw[:, 208:210] = d[:, :1].view(np.uint8)
    return raw.tobytes()


@pytest.mark.parametrize("kind", ["Q8_0", "Q4_K", "Q6_K", "F16", "BF16"])
def test_dequantize_matches_jax(kind):
    gguf, jax_gguf = _modules()
    rng = np.random.default_rng(len(kind))
    ty = getattr(gguf, f"GGML_{kind}")
    block = gguf._DTYPE_BLOCK[ty][0]
    n = 4 * 256
    if kind in ("F16", "BF16"):
        raw = rng.integers(0, 2 ** 16, n, dtype=np.uint16)
        if kind == "F16":
            raw = rng.normal(size=n).astype(np.float16).view(np.uint16)
        raw = raw.tobytes()
    else:
        raw = _random_blocks(rng, ty, n // block)
    shape = (4, 256)
    got = gguf.dequantize_tensor(raw, gguf.GgufTensorInfo("t", shape, ty, 0))
    want = jax_gguf.dequantize_tensor(
        raw, jax_gguf.GgufTensorInfo("t", shape, ty, 0))
    assert got.shape == shape and got.dtype == want.dtype
    assert np.array_equal(got, want, equal_nan=True)


def test_quantize_q4k_matches_jax():
    gguf, jax_gguf = _modules()
    w = np.random.default_rng(9).normal(0, 0.1, 2048).astype(np.float32)
    assert gguf.quantize_q4k_np(w) == jax_gguf.quantize_q4k_np(w)


@pytest.mark.parametrize("name", [
    "token_embd.weight", "output_norm.weight", "output.weight",
    "blk.3.attn_q.weight", "blk.0.ffn_down.weight", "blk.12.attn_k.bias",
    "blk.1.ffn_gate_inp.weight", "rope_freqs.weight", "blk.2.unknown"])
def test_hf_name_matches_jax(name):
    gguf, jax_gguf = _modules()
    assert gguf.hf_name(name) == jax_gguf.hf_name(name)


@pytest.mark.parametrize("extra", [None, {
    "qwen3.rope.scaling.type": "llama3", "qwen3.rope.scaling.factor": 8.0,
    "qwen3.rope.scaling.original_context_length": 128}])
def test_config_from_gguf_matches_jax(tmp_path, extra):
    gguf, jax_gguf = _modules()
    from ferrum_tpu_torch.models.configs import ModelConfig

    path = str(tmp_path / "t.gguf")
    _tiny_gguf(path, extra_meta=extra)
    got = gguf.config_from_gguf(gguf.read_gguf(path))
    want = jax_gguf.config_from_gguf(jax_gguf.read_gguf(path))
    for f in dataclasses.fields(ModelConfig):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if dataclasses.is_dataclass(w):
            g, w = dataclasses.asdict(g), dataclasses.asdict(w)
        assert g == w, f.name


def test_config_from_gguf_refuses_gemma3(tmp_path):
    gguf, _ = _modules()
    from ferrum_tpu_torch.types import ModelLoadError

    path = str(tmp_path / "g.gguf")
    gguf.write_gguf(path, {"general.architecture": "gemma3"},
                    {"x.weight": (np.zeros(4, np.float32), gguf.GGML_F32)})
    with pytest.raises(ModelLoadError, match="Queue 3"):
        gguf.config_from_gguf(gguf.read_gguf(path))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("quant", ["F32", "Q4_K"])
def test_load_gguf_checkpoint_matches_jax(tmp_path, quant, dtype):
    gguf, jax_gguf = _modules()
    from ferrum_tpu.config import EngineConfig as JaxEngineConfig
    from ferrum_tpu_torch.config import EngineConfig

    path = str(tmp_path / "t.gguf")
    _tiny_gguf(path, quant=getattr(gguf, f"GGML_{quant}"))
    _, jparams = jax_gguf.load_gguf_checkpoint(path,
                                               JaxEngineConfig(dtype=dtype))
    _, params = gguf.load_gguf_checkpoint(path, EngineConfig(dtype=dtype),
                                          "cpu")
    want, got = flatten_jax_params(jparams), flatten_torch_params(params)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    # Q4_K files quantize on load (the down projections: in = 128).
    assert any(k.endswith("qweight") for k in got) == (quant == "Q4_K")


def test_load_gguf_checkpoint_defaults_to_the_card(tmp_path):
    """Without a device it takes the engine config's, and that None the
    CUDA card: with no card it raises; the host only when asked for."""
    import torch

    gguf, _ = _modules()
    from ferrum_tpu_torch.config import EngineConfig

    path = str(tmp_path / "t.gguf")
    _tiny_gguf(path, quant=gguf.GGML_F32)
    if torch.cuda.is_available():
        _, params = gguf.load_gguf_checkpoint(path, EngineConfig())
        assert params.embed.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            gguf.load_gguf_checkpoint(path, EngineConfig())
    _, params = gguf.load_gguf_checkpoint(path, EngineConfig(device="cpu"))
    assert params.embed.device.type == "cpu"
