"""Engine configuration: the `EngineConfig` fields the served path reads.

Port of `ferrum_tpu/config.py` (no env/TOML registry yet: the port is
configured by its callers). Field names and defaults follow the JAX
package. The fields this slice fixes -- the linear KV layout, fused
projections, chunked prefill -- are not options here; they come back as
fields when a later slice adds the alternative.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .types import InvalidRequestError


@dataclass
class EngineConfig:
    # --- batching / scheduling ---
    max_num_seqs: int = 32              # decode slots
    max_num_batched_tokens: int = 2048  # per-iteration token budget
    max_model_len: int = 4096
    prefill_chunk_size: int = 512
    # --- KV cache ---
    kv_block_size: int = 32
    kv_dtype: str = "bf16"              # bf16 | f32
    # --- decoding ---
    decode_multi_step: int = 8          # steps per window, one host sync
    # Keep decode windows outstanding: window W+1 is dispatched (chained
    # on the device from W's last tokens) before W's tokens are fetched,
    # so host bookkeeping overlaps the card's work.
    pipeline_decode: bool = True
    # How many windows may be outstanding at once; the engine drops to 1
    # at <= 4 decoding sequences (each extra window delays delivery).
    pipeline_depth: int = 2
    # One slot's prefill chunk rides each decode window's trunk (the
    # decode steps already stream the weights).
    mixed_prefill: bool = True
    # Hold decode for an iteration while a multi-sequence admission wave
    # prefills at low occupancy, so the next windows run fuller.
    refill_first: bool = True
    # Decode lane buckets: "" = pow2 ladder 1, 2, 4, .. up to the slot
    # count (the half-frame bucket dropped); "max" = the full frame
    # only; or a list like "1,8" (the slot count always ends it).
    decode_bucket_spec: str = ""
    # Window length per bucket, e.g. "1:32,8:16"; other buckets run
    # decode_multi_step.
    decode_t_spec: str = ""
    seed: int = 0
    device: Optional[str] = None        # None = the CUDA card
    # --- numerics / quant ---
    # w4a8: int4 weights x dynamic-int8 activations on the int8 tensor
    # cores; off = w4a16 (bf16 dequant, no activation quantization).
    w4a8: bool = True
    # Two-level requantization (QServe-style): group scales become small
    # integers so the int8 path applies at every batch size. Slightly
    # perturbs group scales (requantized weights). No effect without w4a8.
    w4a8_two_level: bool = True
    # Decode-m (<= 64) kernel for two-level params: mxu = the two-level
    # decode GEMM; all = its group-dot form (scales2 and the zero
    # correction on the output side; the same results); down = the
    # group-dot form only where in_features > out_features, the
    # float-scale w4a8 GEMM on the effective scales elsewhere; off = that
    # float-scale GEMM everywhere. Bools map to off / all.
    w4a8_gd: str = "mxu"

    def validate(self) -> None:
        if self.max_num_seqs < 1:
            raise InvalidRequestError("max_num_seqs must be >= 1",
                                      param="max_num_seqs")
        if self.kv_block_size < 1 or self.kv_block_size & (
                self.kv_block_size - 1):
            raise InvalidRequestError(
                "kv_block_size must be a positive power of two",
                param="kv_block_size")
        if self.max_model_len % self.kv_block_size:
            raise InvalidRequestError(
                "max_model_len must be a multiple of kv_block_size",
                param="max_model_len")
        if self.prefill_chunk_size < self.kv_block_size:
            raise InvalidRequestError(
                "prefill_chunk_size must be >= kv_block_size",
                param="prefill_chunk_size")
        if self.max_num_batched_tokens < self.prefill_chunk_size:
            raise InvalidRequestError(
                "max_num_batched_tokens must be >= prefill_chunk_size",
                param="max_num_batched_tokens")
        if self.kv_dtype not in ("bf16", "f32"):
            raise InvalidRequestError(
                "kv_dtype must be bf16 or f32 (int8 KV comes with a later "
                "slice of the port)", param="kv_dtype")
        if not isinstance(self.w4a8_gd, bool) \
                and self.w4a8_gd not in ("off", "all", "down", "mxu"):
            raise InvalidRequestError(
                f"unknown w4a8_gd mode {self.w4a8_gd!r}: off | all | down "
                f"| mxu", param="w4a8_gd")
        if self.decode_multi_step < 1:
            raise InvalidRequestError("decode_multi_step must be >= 1",
                                      param="decode_multi_step")
        if not 1 <= self.pipeline_depth <= 4:
            raise InvalidRequestError("pipeline_depth must be in [1, 4]",
                                      param="pipeline_depth")
        try:
            self.decode_buckets
            self.t_for_bucket(1)
        except ValueError:
            raise InvalidRequestError(
                "decode_bucket_spec is a list of ints and decode_t_spec "
                "of bucket:steps pairs", param="decode_t_spec") from None

    @property
    def num_slots(self) -> int:
        return self.max_num_seqs

    @property
    def decode_buckets(self) -> Tuple[int, ...]:
        """Padded decode lane counts, ascending, ending at num_slots. A
        window packs its sequences into the smallest bucket that fits.
        The auto ladder drops the half-frame bucket, as the JAX package
        does (there its lane gather cost more than the full frame's
        slice)."""
        top = self.num_slots
        if not self.decode_bucket_spec:
            sizes, b = [], 1
            while b < top:
                sizes.append(b)
                b *= 2
            sizes.append(top)
            if top >= 8 and top // 2 in sizes:
                sizes.remove(top // 2)
            return tuple(sizes)
        if self.decode_bucket_spec == "max":
            return (top,)
        sizes = sorted({int(s) for s in self.decode_bucket_spec.split(",")
                        if s.strip()})
        sizes = [s for s in sizes if 0 < s <= top]
        if not sizes or sizes[-1] != top:
            sizes.append(top)
        return tuple(sizes)

    def t_for_bucket(self, bucket: int) -> int:
        """Window length of a lane bucket: its decode_t_spec entry, else
        decode_multi_step."""
        base = max(1, self.decode_multi_step)
        for part in self.decode_t_spec.split(","):
            if not part.strip():
                continue
            b, t = part.split(":")
            if int(b) == bucket:
                return max(1, int(t))
        return base

    @property
    def max_blocks_per_seq(self) -> int:
        return self.max_model_len // self.kv_block_size
