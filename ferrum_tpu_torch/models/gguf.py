"""GGUF container parsing, K-quant dequantization and loader mapping.

Port of `ferrum_tpu/models/gguf.py` (the port keeps its own numpy copy:
it imports nothing of the JAX package): parses the GGUF header,
metadata and tensor table, dequantizes Q4_K / Q6_K / Q8_0 / F16 / BF16 /
F32 blocks in vectorized numpy, maps ggml tensor names to HF names, and
loads into ModelParams on a device -- requantizing the matmul weights
into the packed int4 layout, so one kernel family serves GPTQ and GGUF.

Q4_K numerics follow ggml's dequantize_row_q4_K (super-blocks of 256 =
8 sub-blocks of 32, 6-bit scales and mins, w = d*sc*q - dmin*m); Q6_K
follows dequantize_row_q6_K. A matching encoder (quantize_q4k_np) is
provided for tests and export. A gemma3 GGUF raises in
`config_from_gguf`: the JAX mapping drops its window, sandwich norms,
embedding scale and local rope (ROADMAP Queue 3).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Any, BinaryIO, Dict, Optional, Tuple

import numpy as np

from ..types import ModelLoadError
from .configs import ModelConfig, RopeScaling

GGUF_MAGIC = 0x46554747  # "GGUF" little-endian

# ggml value types
_T_U8, _T_I8, _T_U16, _T_I16, _T_U32, _T_I32 = 0, 1, 2, 3, 4, 5
_T_F32, _T_BOOL, _T_STR, _T_ARR, _T_U64, _T_I64, _T_F64 = 6, 7, 8, 9, 10, 11, 12

# ggml tensor dtypes
GGML_F32, GGML_F16 = 0, 1
GGML_Q8_0 = 8
GGML_Q4_K = 12
GGML_Q6_K = 14
GGML_BF16 = 30

QK_K = 256

_DTYPE_BLOCK = {
    GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2),
    GGML_Q8_0: (32, 34), GGML_Q4_K: (QK_K, 144), GGML_Q6_K: (QK_K, 210),
}


@dataclass
class GgufTensorInfo:
    name: str
    shape: Tuple[int, ...]     # numpy shape [out, ..., in] (ggml-reversed)
    ggml_type: int
    offset: int                # relative to data section


@dataclass
class GgufFile:
    metadata: Dict[str, Any]
    tensors: Dict[str, GgufTensorInfo]
    data_offset: int
    path: str

    def tensor_nbytes(self, info: GgufTensorInfo) -> int:
        n = int(np.prod(info.shape))
        block, bsize = _DTYPE_BLOCK[info.ggml_type]
        assert n % block == 0
        return n // block * bsize

    def load_tensor(self, name: str) -> np.ndarray:
        """Dequantize a tensor to f32 numpy in its numpy shape."""
        info = self.tensors[name]
        with open(self.path, "rb") as f:
            f.seek(self.data_offset + info.offset)
            raw = f.read(self.tensor_nbytes(info))
        return dequantize_tensor(raw, info)


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------

def _read_str(f: BinaryIO) -> str:
    (n,) = struct.unpack("<Q", f.read(8))
    return f.read(n).decode("utf-8")


def _read_value(f: BinaryIO, ty: int):
    if ty == _T_U8:
        return struct.unpack("<B", f.read(1))[0]
    if ty == _T_I8:
        return struct.unpack("<b", f.read(1))[0]
    if ty == _T_U16:
        return struct.unpack("<H", f.read(2))[0]
    if ty == _T_I16:
        return struct.unpack("<h", f.read(2))[0]
    if ty == _T_U32:
        return struct.unpack("<I", f.read(4))[0]
    if ty == _T_I32:
        return struct.unpack("<i", f.read(4))[0]
    if ty == _T_F32:
        return struct.unpack("<f", f.read(4))[0]
    if ty == _T_BOOL:
        return bool(f.read(1)[0])
    if ty == _T_STR:
        return _read_str(f)
    if ty == _T_U64:
        return struct.unpack("<Q", f.read(8))[0]
    if ty == _T_I64:
        return struct.unpack("<q", f.read(8))[0]
    if ty == _T_F64:
        return struct.unpack("<d", f.read(8))[0]
    if ty == _T_ARR:
        (ety, n) = struct.unpack("<IQ", f.read(12))
        return [_read_value(f, ety) for _ in range(n)]
    raise ModelLoadError(f"unknown GGUF value type {ty}")


def read_gguf(path: str) -> GgufFile:
    with open(path, "rb") as f:
        magic, version = struct.unpack("<II", f.read(8))
        if magic != GGUF_MAGIC:
            raise ModelLoadError(f"{path}: not a GGUF file")
        if version < 2:
            raise ModelLoadError(f"GGUF version {version} unsupported")
        n_tensors, n_kv = struct.unpack("<QQ", f.read(16))
        meta: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = _read_str(f)
            (ty,) = struct.unpack("<I", f.read(4))
            meta[key] = _read_value(f, ty)
        tensors: Dict[str, GgufTensorInfo] = {}
        for _ in range(n_tensors):
            name = _read_str(f)
            (ndim,) = struct.unpack("<I", f.read(4))
            dims = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
            ty, offset = struct.unpack("<IQ", f.read(12))
            if ty not in _DTYPE_BLOCK:
                raise ModelLoadError(
                    f"tensor {name}: unsupported ggml type {ty}")
            # ggml dims are fastest-first; numpy shape is the reverse.
            tensors[name] = GgufTensorInfo(
                name=name, shape=tuple(reversed(dims)), ggml_type=ty,
                offset=offset)
        align = int(meta.get("general.alignment", 32))
        pos = f.tell()
        data_offset = (pos + align - 1) // align * align
    return GgufFile(metadata=meta, tensors=tensors,
                    data_offset=data_offset, path=path)


# ---------------------------------------------------------------------------
# Dequantizers (vectorized ggml ports)
# ---------------------------------------------------------------------------

def _dequant_q8_0(raw: bytes, n: int) -> np.ndarray:
    blocks = np.frombuffer(raw, dtype=np.uint8).reshape(n // 32, 34)
    d = blocks[:, :2].copy().view(np.float16).astype(np.float32)  # [B,1]
    q = blocks[:, 2:].view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)


def _q4k_scale_min(sc_bytes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """sc_bytes uint8 [B, 12] → (scales [B, 8], mins [B, 8]) 6-bit."""
    q = sc_bytes.astype(np.uint16)
    sc = np.empty((q.shape[0], 8), np.float32)
    mn = np.empty((q.shape[0], 8), np.float32)
    for j in range(8):
        if j < 4:
            sc[:, j] = (q[:, j] & 63).astype(np.float32)
            mn[:, j] = (q[:, j + 4] & 63).astype(np.float32)
        else:
            sc[:, j] = ((q[:, j + 4] & 0xF) | ((q[:, j - 4] >> 6) << 4)
                        ).astype(np.float32)
            mn[:, j] = ((q[:, j + 4] >> 4) | ((q[:, j] >> 6) << 4)
                        ).astype(np.float32)
    return sc, mn


def _dequant_q4_k(raw: bytes, n: int) -> np.ndarray:
    nb = n // QK_K
    blocks = np.frombuffer(raw, dtype=np.uint8).reshape(nb, 144)
    d = blocks[:, 0:2].copy().view(np.float16).astype(np.float32)[:, 0]
    dmin = blocks[:, 2:4].copy().view(np.float16).astype(np.float32)[:, 0]
    sc, mn = _q4k_scale_min(blocks[:, 4:16])          # [nb, 8]
    qs = blocks[:, 16:144]                            # [nb, 128]
    out = np.empty((nb, 256), np.float32)
    # layout: 4 chunks of 64; chunk c uses qs[:, c*32:(c+1)*32]:
    # low nibbles → sub-block 2c, high nibbles → sub-block 2c+1.
    for c in range(4):
        qb = qs[:, c * 32:(c + 1) * 32]
        lo = (qb & 0xF).astype(np.float32)
        hi = (qb >> 4).astype(np.float32)
        s1 = (d * sc[:, 2 * c])[:, None]
        m1 = (dmin * mn[:, 2 * c])[:, None]
        s2 = (d * sc[:, 2 * c + 1])[:, None]
        m2 = (dmin * mn[:, 2 * c + 1])[:, None]
        out[:, c * 64:c * 64 + 32] = s1 * lo - m1
        out[:, c * 64 + 32:c * 64 + 64] = s2 * hi - m2
    return out.reshape(-1)


def _dequant_q6_k(raw: bytes, n: int) -> np.ndarray:
    nb = n // QK_K
    blocks = np.frombuffer(raw, dtype=np.uint8).reshape(nb, 210)
    ql = blocks[:, 0:128]
    qh = blocks[:, 128:192]
    scales = blocks[:, 192:208].view(np.int8).astype(np.float32)  # [nb,16]
    d = blocks[:, 208:210].copy().view(np.float16).astype(np.float32)[:, 0]
    out = np.empty((nb, 256), np.float32)
    for half in range(2):            # n = 0, 128
        qlh = ql[:, half * 64:half * 64 + 64]
        qhh = qh[:, half * 32:half * 32 + 32]
        sch = scales[:, half * 8:half * 8 + 8]
        l = np.arange(32)
        q1 = ((qlh[:, :32] & 0xF) | ((qhh & 3) << 4)).astype(np.int8) - 32
        q2 = ((qlh[:, 32:] & 0xF) | (((qhh >> 2) & 3) << 4)).astype(np.int8) - 32
        q3 = ((qlh[:, :32] >> 4) | (((qhh >> 4) & 3) << 4)).astype(np.int8) - 32
        q4 = ((qlh[:, 32:] >> 4) | (((qhh >> 6) & 3) << 4)).astype(np.int8) - 32
        base = half * 128
        is_ = l // 16                    # 0 or 1 within each 32
        out[:, base:base + 32] = d[:, None] * sch[:, is_] * q1
        out[:, base + 32:base + 64] = d[:, None] * sch[:, is_ + 2] * q2
        out[:, base + 64:base + 96] = d[:, None] * sch[:, is_ + 4] * q3
        out[:, base + 96:base + 128] = d[:, None] * sch[:, is_ + 6] * q4
    return out.reshape(-1)


def dequantize_tensor(raw: bytes, info: GgufTensorInfo) -> np.ndarray:
    n = int(np.prod(info.shape))
    t = info.ggml_type
    if t == GGML_F32:
        out = np.frombuffer(raw, np.float32).copy()
    elif t == GGML_F16:
        out = np.frombuffer(raw, np.float16).astype(np.float32)
    elif t == GGML_BF16:
        u = np.frombuffer(raw, np.uint16).astype(np.uint32) << 16
        out = u.view(np.float32).copy()
    elif t == GGML_Q8_0:
        out = _dequant_q8_0(raw, n)
    elif t == GGML_Q4_K:
        out = _dequant_q4_k(raw, n)
    elif t == GGML_Q6_K:
        out = _dequant_q6_k(raw, n)
    else:
        raise ModelLoadError(f"unsupported ggml type {t}")
    return out.reshape(info.shape)


# ---------------------------------------------------------------------------
# Q4_K encoder (tests / export)
# ---------------------------------------------------------------------------

def quantize_q4k_np(w: np.ndarray) -> bytes:
    """Encode a flat f32 array (len % 256 == 0) as Q4_K blocks."""
    flat = w.reshape(-1)
    nb = len(flat) // QK_K
    out = bytearray()
    for b in range(nb):
        block = flat[b * QK_K:(b + 1) * QK_K].reshape(8, 32)
        smax = block.max(axis=1)
        smin = np.minimum(block.min(axis=1), 0.0)
        # sub-block scale/min before 6-bit quantization
        sc_f = (smax - smin) / 15.0
        sc_f = np.maximum(sc_f, 1e-10)
        mn_f = -smin
        d = float(sc_f.max() / 63.0) or 1e-10
        dmin = float(mn_f.max() / 63.0) or 1e-10
        ls = np.clip(np.round(sc_f / d), 0, 63).astype(np.uint8)
        lm = np.clip(np.round(mn_f / dmin), 0, 63).astype(np.uint8)
        # pack 6-bit scales (inverse of _q4k_scale_min)
        scb = np.zeros(12, np.uint8)
        for j in range(4):
            scb[j] = ls[j]
            scb[j + 4] = lm[j]
        for j in range(4, 8):
            scb[j + 4] = (ls[j] & 0xF) | ((lm[j] & 0xF) << 4)
            scb[j - 4] |= (ls[j] >> 4) << 6
            scb[j] |= (lm[j] >> 4) << 6
        # quantize values
        q = np.zeros((8, 32), np.uint8)
        for j in range(8):
            s = d * ls[j] or 1e-10
            m = dmin * lm[j]
            q[j] = np.clip(np.round((block[j] + m) / s), 0, 15)
        qs = np.zeros(128, np.uint8)
        for c in range(4):
            qs[c * 32:(c + 1) * 32] = q[2 * c] | (q[2 * c + 1] << 4)
        out += np.float16(d).tobytes() + np.float16(dmin).tobytes()
        out += scb.tobytes() + qs.tobytes()
    return bytes(out)


# ---------------------------------------------------------------------------
# Writer (tests / export)
# ---------------------------------------------------------------------------

def write_gguf(path: str, metadata: Dict[str, Any],
               tensors: Dict[str, Tuple[np.ndarray, int]]) -> None:
    """Write a GGUF file. tensors: name → (f32 array, ggml_type)."""
    align = 32

    def enc_str(s: str) -> bytes:
        b = s.encode()
        return struct.pack("<Q", len(b)) + b

    def enc_value(v) -> bytes:
        if isinstance(v, bool):
            return struct.pack("<I", _T_BOOL) + struct.pack("<B", v)
        if isinstance(v, int):
            return struct.pack("<I", _T_U32) + struct.pack("<I", v)
        if isinstance(v, float):
            return struct.pack("<I", _T_F32) + struct.pack("<f", v)
        if isinstance(v, str):
            return struct.pack("<I", _T_STR) + enc_str(v)
        if isinstance(v, list):
            assert all(isinstance(x, int) for x in v)
            body = b"".join(struct.pack("<I", x) for x in v)
            return struct.pack("<I", _T_ARR) + struct.pack(
                "<IQ", _T_U32, len(v)) + body
        raise ValueError(type(v))

    payloads = {}
    for name, (arr, ty) in tensors.items():
        if ty == GGML_F32:
            payloads[name] = arr.astype(np.float32).tobytes()
        elif ty == GGML_F16:
            payloads[name] = arr.astype(np.float16).tobytes()
        elif ty == GGML_Q4_K:
            payloads[name] = quantize_q4k_np(arr)
        else:
            raise ValueError(f"writer does not support type {ty}")

    with open(path, "wb") as f:
        f.write(struct.pack("<II", GGUF_MAGIC, 3))
        f.write(struct.pack("<QQ", len(tensors), len(metadata)))
        for k, v in metadata.items():
            f.write(enc_str(k))
            f.write(enc_value(v))
        offset = 0
        for name, (arr, ty) in tensors.items():
            f.write(enc_str(name))
            dims = tuple(reversed(arr.shape))
            f.write(struct.pack("<I", len(dims)))
            f.write(struct.pack(f"<{len(dims)}Q", *dims))
            f.write(struct.pack("<IQ", ty, offset))
            offset += (len(payloads[name]) + align - 1) // align * align
        pos = f.tell()
        f.write(b"\x00" * ((pos + align - 1) // align * align - pos))
        for name in tensors:
            pl = payloads[name]
            f.write(pl)
            f.write(b"\x00" * ((len(pl) + align - 1) // align * align
                               - len(pl)))


# ---------------------------------------------------------------------------
# Name mapping + model loading (ref: gguf/names.rs, gguf_engine_loader.rs)
# ---------------------------------------------------------------------------

_NAME_MAP = [
    ("token_embd.weight", "model.embed_tokens.weight"),
    ("output_norm.weight", "model.norm.weight"),
    ("output.weight", "lm_head.weight"),
]
_BLK_MAP = {
    "attn_q.weight": "self_attn.q_proj.weight",
    "attn_k.weight": "self_attn.k_proj.weight",
    "attn_v.weight": "self_attn.v_proj.weight",
    "attn_output.weight": "self_attn.o_proj.weight",
    "attn_q.bias": "self_attn.q_proj.bias",
    "attn_k.bias": "self_attn.k_proj.bias",
    "attn_v.bias": "self_attn.v_proj.bias",
    "attn_q_norm.weight": "self_attn.q_norm.weight",
    "attn_k_norm.weight": "self_attn.k_norm.weight",
    "attn_norm.weight": "input_layernorm.weight",
    "ffn_norm.weight": "post_attention_layernorm.weight",
    "ffn_gate.weight": "mlp.gate_proj.weight",
    "ffn_up.weight": "mlp.up_proj.weight",
    "ffn_down.weight": "mlp.down_proj.weight",
    "ffn_gate_inp.weight": "mlp.gate.weight",
}


def hf_name(gguf_name: str) -> Optional[str]:
    for src, dst in _NAME_MAP:
        if gguf_name == src:
            return dst
    if gguf_name.startswith("blk."):
        _, idx, rest = gguf_name.split(".", 2)
        mapped = _BLK_MAP.get(rest)
        if mapped:
            return f"model.layers.{idx}.{mapped}"
    return None


_GGUF_ARCH_FAMILY = {"llama": "llama", "qwen2": "qwen2", "qwen3": "qwen3",
                     "gemma3": "gemma3", "qwen3moe": "qwen3_moe",
                     "mistral": "mistral"}


def config_from_gguf(g: GgufFile):
    meta = g.metadata
    arch = meta.get("general.architecture")
    family = _GGUF_ARCH_FAMILY.get(arch)
    if family is None:
        raise ModelLoadError(f"unsupported GGUF architecture {arch!r}")
    if family == "gemma3":
        # The JAX config_from_gguf maps gemma3 without its sliding window,
        # sandwich norms, embedding scale or local rope: another model.
        raise ModelLoadError("GGUF architecture 'gemma3': the JAX package's "
                             "mapping computes another model from it "
                             "(ROADMAP Queue 3), so the port refuses it",
                             param="general.architecture")

    def mk(key, default=None):
        return meta.get(f"{arch}.{key}", default)

    heads = int(mk("attention.head_count"))
    hidden = int(mk("embedding_length"))
    cfg = ModelConfig(
        family=family,
        vocab_size=int(meta.get(f"{arch}.vocab_size",
                                len(meta.get("tokenizer.ggml.tokens", []))
                                or 32000)),
        hidden_size=hidden,
        num_layers=int(mk("block_count")),
        num_heads=heads,
        num_kv_heads=int(mk("attention.head_count_kv", heads)),
        head_dim=int(mk("attention.key_length", hidden // heads)),
        intermediate_size=int(mk("feed_forward_length")),
        rms_norm_eps=float(mk("attention.layer_norm_rms_epsilon", 1e-5)),
        rope_theta=float(mk("rope.freq_base", 10000.0)),
        max_position_embeddings=int(mk("context_length", 8192)),
    )
    # RoPE scaling metadata ({arch}.rope.scaling.*): mirror the HF path
    # (config_from_hf_json → RopeScaling.from_hf) so Llama-3.1-style
    # GGUFs don't silently load with unscaled RoPE (ADVICE r1 low).
    stype = mk("rope.scaling.type")
    factor = mk("rope.scaling.factor")
    if stype not in (None, "none") and (stype or factor):
        cfg.rope_scaling = RopeScaling(
            rope_type=str(stype or "linear"),
            factor=float(factor if factor is not None else 1.0),
            low_freq_factor=float(
                mk("rope.scaling.low_freq_factor", 1.0)),
            high_freq_factor=float(
                mk("rope.scaling.high_freq_factor", 4.0)),
            original_max_position_embeddings=int(
                mk("rope.scaling.original_context_length",
                   mk("context_length", 8192))),
        )
    if family in ("qwen3", "qwen3_moe"):
        cfg.qk_norm = True
    # tied embeddings: no output.weight tensor present
    cfg.tie_word_embeddings = "output.weight" not in g.tensors
    return cfg


def load_gguf_checkpoint(path: str, engine_cfg, device=None):
    """GGUF -> (ModelConfig, ModelParams on `device`; None takes
    `engine_cfg.device`, and that None the CUDA card, raising without
    one). Matmul weights requantize into the packed int4 layout (one
    kernel family for all formats); norms and embeddings stay in the
    engine's dtype."""
    import torch

    from ..device import resolve_device
    from .loader import TensorSource, params_from_hf

    device = resolve_device(engine_cfg.device if device is None else device)

    g = read_gguf(path)
    cfg = config_from_gguf(g)

    tensors: Dict[str, np.ndarray] = {}
    for gname, info in g.tensors.items():
        name = hf_name(gname)
        if name is None:
            continue
        tensors[name] = g.load_tensor(gname)
    dtype = torch.bfloat16 if engine_cfg.dtype == "bf16" else torch.float32
    quantize = any(i.ggml_type in (GGML_Q4_K, GGML_Q6_K, GGML_Q8_0)
                   for i in g.tensors.values())
    params = params_from_hf(cfg, TensorSource(tensors), dtype=dtype,
                            quantize_rtn=quantize, device=device)
    return cfg, params
