"""KV block compression and the prefix cache's host offload tier.

Port of `ferrum_tpu/kv/compression.py`. The strategies compress whole KV
blocks on the host: `none`, symmetric `int8` and `int4` (two codes a
byte along the last axis) with one f32 scale per row of the last axis,
and `fp8` (e4m3 through the JAX package's 256-entry table and its
nearest-entry rule, a tie taking the lower magnitude -- not
`torch.float8_e4m3fn` casts, which round ties and saturate otherwise).

Blocks are CPU tensors (the card's machine has no ml_dtypes, and a bf16
tensor has no numpy form); the arithmetic is f32 in the JAX package's
order (`x / scale`, round half to even), so payloads, scales and
decompressed values equal the JAX package's bit for bit.

`HostOffloadTier` is the opt-in second tier of the paged PrefixCache
(`prefix_offload_mb`; kv/prefix_cache.py, engine/engine.py): an evicted
block group (k, v[, k_scale, v_scale]) as `ModelRunner.read_kv_block`
returns it is kept compressed in host RAM, LRU within a byte budget, and
restored on a later hash-chain hit. Its rules are the JAX tier's as they
are (ROADMAP Queue 3): an f32 array with fewer than 4 dims is kept raw
(the int8 cache's scale planes, but also an f32 cache's K and V, which
therefore never compress), every other array goes through the strategy
(an int8 cache's K and V too: int8 of int8, truncated back to int8 on
restore, so up to one step off), and the scale is per row of the last
axis, which in the engine's [L, page, kv_size] layout is a whole
layer-token row, not one head.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np
import torch


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


@dataclass
class CompressedBlock:
    """One compressed array: its payload, the f32 scales (None when
    stored raw) and what it was."""

    data: torch.Tensor                  # packed payload
    scale: Optional[torch.Tensor]       # f32, one per row of the last axis
    original_dtype: torch.dtype
    original_shape: tuple
    algorithm: str
    params: Dict[str, int] = field(default_factory=dict)

    @property
    def nbytes(self) -> int:
        n = nbytes(self.data)
        if self.scale is not None:
            n += nbytes(self.scale)
        return n


class CompressionStrategy:
    """compress / decompress + ratio + name."""

    name = "none"

    def compress(self, block: torch.Tensor) -> CompressedBlock:
        raise NotImplementedError

    def decompress(self, c: CompressedBlock) -> torch.Tensor:
        raise NotImplementedError

    def compression_ratio(self) -> float:
        return 1.0


class NoCompression(CompressionStrategy):
    name = "none"

    def compress(self, block: torch.Tensor) -> CompressedBlock:
        return CompressedBlock(
            data=block.contiguous(), scale=None, original_dtype=block.dtype,
            original_shape=tuple(block.shape), algorithm=self.name)

    def decompress(self, c: CompressedBlock) -> torch.Tensor:
        return c.data


def _rowhead_scale(block: torch.Tensor, qmax: float) -> torch.Tensor:
    """f32 amax over the last axis, at least 1e-8, over qmax."""
    amax = block.to(torch.float32).abs().amax(dim=-1)
    return torch.clamp_min(amax, 1e-8) / qmax


def _scaled(block: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return block.to(torch.float32) / scale[..., None]


class Int8Compression(CompressionStrategy):
    """Symmetric int8, one scale per row of the last axis."""

    name = "int8"

    def compress(self, block: torch.Tensor) -> CompressedBlock:
        scale = _rowhead_scale(block, 127.0)
        q = torch.clamp(torch.round(_scaled(block, scale)), -127, 127)
        return CompressedBlock(
            data=q.to(torch.int8), scale=scale,
            original_dtype=block.dtype, original_shape=tuple(block.shape),
            algorithm=self.name, params={"quantization_bits": 8})

    def decompress(self, c: CompressedBlock) -> torch.Tensor:
        out = c.data.to(torch.float32) * c.scale[..., None]
        return out.to(c.original_dtype)

    def compression_ratio(self) -> float:
        return 2.0


class Int4Compression(CompressionStrategy):
    """Symmetric int4 (codes 1..15 around 8), two a byte along the last
    axis: even positions in the low nibble."""

    name = "int4"

    def compress(self, block: torch.Tensor) -> CompressedBlock:
        if block.shape[-1] % 2:
            raise ValueError("int4 compression needs an even last axis")
        scale = _rowhead_scale(block, 7.0)
        q = (torch.clamp(torch.round(_scaled(block, scale)), -7, 7)
             + 8).to(torch.uint8)
        return CompressedBlock(
            data=q[..., 0::2] | (q[..., 1::2] << 4), scale=scale,
            original_dtype=block.dtype, original_shape=tuple(block.shape),
            algorithm=self.name, params={"quantization_bits": 4})

    def decompress(self, c: CompressedBlock) -> torch.Tensor:
        lo = (c.data & 0xF).to(torch.int32) - 8
        hi = (c.data >> 4).to(torch.int32) - 8
        q = torch.stack([lo, hi], dim=-1).reshape(c.original_shape)
        return (q.to(torch.float32) * c.scale[..., None]).to(
            c.original_dtype)

    def compression_ratio(self) -> float:
        return 4.0


def _e4m3_table() -> np.ndarray:
    """The 256 e4m3 values (1 sign, 4 exponent bits biased by 7, 3
    mantissa bits; exponent 15 with mantissa 7 is nan), f32."""
    codes = np.arange(256, dtype=np.uint8)
    sign = np.where(codes & 0x80, -1.0, 1.0)
    exp = ((codes >> 3) & 0xF).astype(np.int32)
    man = (codes & 0x7).astype(np.float32)
    val = np.where(exp == 0, man * 2.0 ** -9,
                   (1.0 + man / 8.0) * 2.0 ** (exp - 7.0))
    val = sign * val
    val[(exp == 15) & (codes & 0x7 == 7)] = np.nan
    return val.astype(np.float32)


class Fp8Compression(CompressionStrategy):
    """e4m3 codes through the table: the nearest positive entry to each
    scaled magnitude (ties to the lower one), the sign in bit 7; one
    scale per row of the last axis maps its amax to 448."""

    name = "fp8"

    def __init__(self):
        table = _e4m3_table()
        pos = table[:128].copy()
        pos[np.isnan(pos)] = np.inf
        order = np.argsort(pos)          # the magnitudes are distinct
        self._table = torch.from_numpy(table)
        self._pos = torch.from_numpy(pos)
        self._sorted = torch.from_numpy(np.ascontiguousarray(pos[order]))
        self._order = torch.from_numpy(order)

    def compress(self, block: torch.Tensor) -> CompressedBlock:
        scale = _rowhead_scale(block, 448.0)
        x = _scaled(block, scale)
        mag = x.abs()
        idx = torch.searchsorted(self._sorted, mag).clamp(0, 126)
        cand = self._order[idx]
        cand_lo = self._order[torch.clamp_min(idx - 1, 0)]
        take_lo = ((self._pos[cand_lo] - mag).abs()
                   <= (self._pos[cand] - mag).abs())
        code = torch.where(take_lo, cand_lo, cand).to(torch.uint8)
        code = torch.where(x < 0, code | 0x80, code)
        return CompressedBlock(
            data=code, scale=scale, original_dtype=block.dtype,
            original_shape=tuple(block.shape), algorithm=self.name,
            params={"quantization_bits": 8})

    def decompress(self, c: CompressedBlock) -> torch.Tensor:
        out = self._table[c.data.to(torch.int64)] * c.scale[..., None]
        return out.to(c.original_dtype)

    def compression_ratio(self) -> float:
        return 2.0


STRATEGIES = {
    "none": NoCompression,
    "int8": Int8Compression,
    "int4": Int4Compression,
    "fp8": Fp8Compression,
}


def make_strategy(name: str) -> CompressionStrategy:
    if name not in STRATEGIES:
        raise ValueError(f"unknown compression strategy {name!r} "
                         f"(have {sorted(STRATEGIES)})")
    return STRATEGIES[name]()


# ---------------------------------------------------------------------------
# Host offload tier: compressed prefix blocks in host RAM
# ---------------------------------------------------------------------------

@dataclass
class OffloadStats:
    saves: int = 0
    restores: int = 0
    drops: int = 0                   # capacity evictions
    bytes_held: int = 0


class HostOffloadTier:
    """Second tier of the paged prefix cache in host memory, keyed by the
    device cache's hash chain: `put` keeps an evicted block group
    compressed (LRU within `capacity_bytes`), `get` gives it back
    decompressed. The JAX tier's rules, listed in the module docstring."""

    def __init__(self, capacity_bytes: int,
                 strategy: Optional[CompressionStrategy] = None):
        self.capacity_bytes = int(capacity_bytes)
        self.strategy = strategy or Int8Compression()
        self._blocks: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()
        self.stats = OffloadStats()

    def __contains__(self, h: int) -> bool:
        return h in self._blocks

    def __len__(self) -> int:
        return len(self._blocks)

    def put(self, h: int, arrays: tuple) -> None:
        """Store one evicted block group (k, v[, k_scale, v_scale]) under
        its chain hash; a hash already held is only touched."""
        if h in self._blocks:
            self._blocks.move_to_end(h)
            return
        comp = []
        for a in arrays:
            if a is None:
                comp.append(None)
            elif a.dtype == torch.float32 and a.dim() < 4:
                comp.append(CompressedBlock(
                    data=a.contiguous(), scale=None, original_dtype=a.dtype,
                    original_shape=tuple(a.shape), algorithm="none"))
            else:
                comp.append(self.strategy.compress(a))
        size = sum(c.nbytes for c in comp if c is not None)
        while (self._blocks
               and self.stats.bytes_held + size > self.capacity_bytes):
            _, (_old, old_size) = self._blocks.popitem(last=False)
            self.stats.bytes_held -= old_size
            self.stats.drops += 1
        if size > self.capacity_bytes:
            return                   # one block group over the budget
        self._blocks[h] = (tuple(comp), size)
        self.stats.bytes_held += size
        self.stats.saves += 1

    def get(self, h: int) -> Optional[tuple]:
        """A block group decompressed (CPU tensors), or None."""
        entry = self._blocks.get(h)
        if entry is None:
            return None
        self._blocks.move_to_end(h)
        out = []
        for c in entry[0]:
            if c is None:
                out.append(None)
            elif c.algorithm == "none":
                out.append(c.data)
            else:
                out.append(self.strategy.decompress(c))
        self.stats.restores += 1
        return tuple(out)
