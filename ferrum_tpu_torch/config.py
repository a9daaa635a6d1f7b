"""Engine configuration: the `EngineConfig` fields the served path reads.

Port of `ferrum_tpu/config.py` (no env/TOML registry yet: the port is
configured by its callers). Field names and defaults follow the JAX
package. The fields this slice fixes -- the linear KV layout, fused
projections, chunked prefill -- are not options here; they come back as
fields when a later slice adds the alternative.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

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

    @property
    def num_slots(self) -> int:
        return self.max_num_seqs

    @property
    def max_blocks_per_seq(self) -> int:
        return self.max_model_len // self.kv_block_size
