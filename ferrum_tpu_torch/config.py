"""Engine configuration, with CLI > env > file > base precedence.

Port of `ferrum_tpu/config.py`. Field names and defaults follow the JAX
package. The fields the port does not have yet -- GDN's prefill tile,
parallelism, GGUF quantization -- and the two the JAX engine reads
nowhere (`tokenizer`, `greedy_argmax_device`) are not options here:
`NOT_PORTED` holds the value the port fixes for each (the JAX field and
env names). `resolve` raises
InvalidRequestError, naming the field and "not yet ported", when a
source sets one of them to anything else; the JAX package's resolve
drops unknown keys, the port never drops a request silently.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Tuple

from .types import InvalidRequestError

# ---------------------------------------------------------------------------
# Env registry: name -> (field, python type, description). The port's
# own fields; NOT_PORTED_ENV names the JAX package's others.
# ---------------------------------------------------------------------------

ENV_REGISTRY: Dict[str, Tuple[str, type, str]] = {
    "FERRUM_MAX_NUM_SEQS": ("max_num_seqs", int, "decode slot count"),
    "FERRUM_MAX_NUM_BATCHED_TOKENS": (
        "max_num_batched_tokens", int, "per-iteration token budget"),
    "FERRUM_KV_BLOCK_SIZE": ("kv_block_size", int, "tokens per KV block"),
    "FERRUM_MAX_MODEL_LEN": ("max_model_len", int, "max sequence length"),
    "FERRUM_PREFILL_CHUNK": ("prefill_chunk_size", int,
                             "max prefill chunk tokens"),
    "FERRUM_KV_DTYPE": ("kv_dtype", str, "bf16|f32|int8"),
    "FERRUM_KV_LAYOUT": ("kv_layout", str, "paged|linear|auto"),
    "FERRUM_KV_MAX_BLOCKS": ("kv_num_blocks", int,
                             "KV pool blocks (0 = autosize)"),
    "FERRUM_ENABLE_PREFIX_CACHE": ("enable_prefix_cache", bool,
                                   "block-hash prefix reuse"),
    "FERRUM_PREFIX_CACHE_POLICY": ("prefix_cache_policy", str,
                                   "eviction policy: lru|fifo|clock"),
    "FERRUM_PREFIX_OFFLOAD_MB": ("prefix_offload_mb", int,
                                 "host-RAM budget (MiB) for the compressed "
                                 "prefix offload tier (0 = off; paged layout)"),
    "FERRUM_PREFIX_OFFLOAD_ALGO": ("prefix_offload_algo", str,
                                   "offload compression: none|int8|int4|fp8"),
    "FERRUM_PREFIX_CACHE_BLOCKS": ("prefix_cache_blocks", int,
                                   "linear prefix-store blocks (-1 auto, "
                                   "0 off)"),
    "FERRUM_DTYPE": ("dtype", str, "activation/weight dtype: bf16|f32"),
    "FERRUM_QUANT": ("quantization", str, "none|gptq_int4"),
    "FERRUM_W4A8": ("w4a8", bool,
                    "int8-activation path for int4 matmuls"),
    "FERRUM_W4A8_GD": ("w4a8_gd", str,
                       "two-level decode kernel mode: off|all|down|mxu"),
    "FERRUM_W4A8_TL": ("w4a8_two_level", bool, "two-level requantize"),
    "FERRUM_SEED": ("seed", int, "base PRNG seed"),
    "FERRUM_PROFILE_JSONL": ("profile_path", str, "profile event JSONL path"),
    "FERRUM_PROFILE_DETAIL": ("profile_detail", str,
                              "profile detail level: off|basic|debug|full"),
    "FERRUM_PROFILE_SAMPLE_RATE": ("profile_sample_rate", float,
                                   "timed-span sampling rate (full forces "
                                   "1.0)"),
    "FERRUM_MEMORY_PROFILE_JSONL": ("memory_profile_path", str,
                                    "separate sink for memory snapshots"),
    "FERRUM_SESSION_CACHE_ENTRIES": ("session_cache_entries", int,
                                     "server X-Ferrum-Session entries"),
    "FERRUM_SESSION_CACHE_TOKENS": ("session_cache_tokens", int,
                                    "server X-Ferrum-Session token budget"),
    "FERRUM_DECODE_BUCKETS": ("decode_bucket_spec", str,
                              "decode lane buckets: '' = pow2 ladder, "
                              "'max' = full frame, or e.g. '1,8,32'"),
    "FERRUM_DECODE_T_SPEC": ("decode_t_spec", str,
                             "per-bucket window length, e.g. 1:32,8:16"),
    "FERRUM_DECODE_MULTI_STEP": ("decode_multi_step", int,
                                 "decode steps per window"),
    "FERRUM_REFILL_FIRST": ("refill_first", bool,
                            "hold decode while admission waves prefill"),
    "FERRUM_PIPELINE_DEPTH": ("pipeline_depth", int,
                              "decode windows outstanding at once"),
    "FERRUM_PIPELINE_DECODE": ("pipeline_decode", bool,
                               "dispatch window W+1 before reading W"),
    "FERRUM_MIXED_PREFILL": ("mixed_prefill", bool,
                             "one prefill chunk rides each decode window"),
    "FERRUM_SPEC_DRAFT": ("spec_draft_model", str,
                          "draft model for speculative decoding"),
    "FERRUM_SPEC_K": ("spec_num_tokens", int, "speculative draft length"),
    "FERRUM_ENABLE_CHUNKED_PREFILL": ("enable_chunked_prefill", bool, ""),
    "FERRUM_SCHEDULER": ("scheduler", str, "continuous|fifo|priority"),
    "FERRUM_SCHEDULER_TRACE_JSONL": ("scheduler_trace_path", str,
                                     "per-iteration scheduler trace JSONL "
                                     "path"),
    "FERRUM_SLOT_SLACK": ("slot_slack", int,
                          "extra device lanes beyond max_num_seqs so "
                          "admissions never wait on deferred releases"),
    "FERRUM_ADAPTIVE_WINDOWS": ("adaptive_windows", bool,
                                "adaptive decode-window lengths (double at "
                                "low occupancy, halve in pileups)"),
    "FERRUM_SQUEEZE_EMBED": ("squeeze_embeddings", bool,
                             "int8 embeddings + int4 untied lm_head "
                             "(single-chip 30B fit posture)"),
    "FERRUM_FUSE_PROJ": ("fuse_proj", bool,
                         "build-time q|k|v and gate|up fusion "
                         "(single-chip; auto-off under a mesh)"),
    "FERRUM_FUSE_SITES": ("fuse_sites", str,
                          "comma list of build-time fusion sites: "
                          "qkv,gate_up,moe (moe off by default — "
                          "see engine/builder.fuse_projections)"),
}

# The JAX package's fields the port does not have, each at the value
# the port fixes (a tuple: every value it accepts; quantization's
# gguf_q4k is the JAX value the port does not take yet).
NOT_PORTED: Dict[str, Any] = {
    "tokenizer": None,
    "quantization": ("none", "gptq_int4"),
    "gdn_chunk_block": 64,
    "tensor_parallel": 1,
    "data_parallel": 1,
    "expert_parallel": 1,
    "greedy_argmax_device": True,
}

NOT_PORTED_ENV: Dict[str, Tuple[str, type]] = {
    "FERRUM_TP": ("tensor_parallel", int),
    "FERRUM_DP": ("data_parallel", int),
    "FERRUM_EP": ("expert_parallel", int),
    "FERRUM_GREEDY_ARGMAX": ("greedy_argmax_device", bool),
    "FERRUM_GDN_CHUNKED": ("gdn_chunk_block", int),
}


def _parse_env_value(raw: str, ty: type) -> Any:
    if ty is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    if ty is int:
        return int(raw.strip())
    if ty is float:
        return float(raw.strip())
    return raw


def snapshot_from_process_env(environ: Optional[Mapping[str, str]] = None
                              ) -> Dict[str, Any]:
    """field -> value of the FERRUM_* variables in `environ` (default:
    the process's), the port's registry and the names of the fields it
    does not have alike."""
    env = os.environ if environ is None else environ
    out: Dict[str, Any] = {}
    for name, raw in env.items():
        entry = ENV_REGISTRY.get(name) or NOT_PORTED_ENV.get(name)
        if entry is None:
            continue
        try:
            out[entry[0]] = _parse_env_value(raw, entry[1])
        except ValueError as e:
            raise InvalidRequestError(f"bad env value {name}={raw!r}: {e}",
                                      param=name)
    return out


def load_toml_runtime(path: str) -> Dict[str, Any]:
    """The [runtime] table of a ferrum.toml: the port's fields and those
    of NOT_PORTED (checked by `resolve`); other keys are ignored, as in
    the JAX package."""
    import tomllib

    with open(path, "rb") as f:
        data = tomllib.load(f)
    valid = {f.name for f in dataclasses.fields(EngineConfig)} \
        | set(NOT_PORTED)
    return {k: v for k, v in data.get("runtime", {}).items() if k in valid}


def check_not_ported(values: Mapping[str, Any]) -> None:
    """Raise on a field the port does not have, set to another value
    than the one the port fixes."""
    for name, value in values.items():
        if name not in NOT_PORTED:
            continue
        fixed = NOT_PORTED[name]
        ok = fixed if isinstance(fixed, tuple) else (fixed,)
        if value not in ok:
            raise InvalidRequestError(
                f"{name}={value!r} is not yet ported (the port runs "
                f"{name}={ok[0]!r})", param=name)


def adaptive_window_steps(t_steps: int, n_active: int) -> int:
    """Low-occupancy window doubling (the JAX runner's
    `adaptive_window_steps`): at <= 4 active lanes a window twice as
    long, at most 16 steps."""
    if n_active <= 4:
        return min(2 * t_steps, 16)
    return t_steps


# ---------------------------------------------------------------------------
# EngineConfig
# ---------------------------------------------------------------------------

@dataclass
class EngineConfig:
    model: str = ""                     # checkpoint dir or random:<preset>
    # --- batching / scheduling ---
    max_num_seqs: int = 32              # decode slots
    max_num_batched_tokens: int = 2048  # per-iteration token budget
    max_model_len: int = 4096
    prefill_chunk_size: int = 512
    # Off: a prompt that fits the token budget is prefilled whole (the
    # chunk cap is max_num_batched_tokens).
    enable_chunked_prefill: bool = True
    # continuous: admission in arrival order; fifo: a prompt that fits
    # one batch is prefilled whole (admission waits for the budget);
    # priority: request.priority (higher first), then arrival.
    scheduler: str = "continuous"
    # --- KV cache ---
    kv_num_blocks: int = 0              # paged pool; 0 = autosize
    kv_block_size: int = 32
    kv_dtype: str = "bf16"              # bf16 | f32 | int8
    # "paged": block tables over one pool, shared prefix blocks,
    #          preemption (recompute) under block pressure.
    # "linear": every slot owns a contiguous max_model_len region;
    #          attention slices it, prefix reuse copies through a store
    #          (kv/linear_prefix.py), no KV pressure.
    # "auto":  linear when every slot's region fits the device memory
    #          and kv_num_blocks is 0, else paged (engine/builder.py).
    kv_layout: str = "paged"
    enable_prefix_cache: bool = True
    prefix_cache_policy: str = "lru"    # lru | fifo | clock
    # Linear layout: blocks of the prefix store; -1 = an eighth of the
    # slot pool (at least one sequence's), capped by free device
    # memory; 0 = no copy-based reuse.
    prefix_cache_blocks: int = -1
    # Paged layout with the prefix cache: the host-RAM budget (MiB) of
    # the compressed offload tier -- evicted prefix blocks kept on the
    # host and restored on a later chain hit (kv/compression.py
    # HostOffloadTier); 0 = off. Each spill waits for its read.
    prefix_offload_mb: int = 0
    prefix_offload_algo: str = "int8"   # none | int8 | int4 | fp8
    # --- decoding ---
    decode_multi_step: int = 8          # steps per window, one host sync
    # Adaptive window lengths (no decode_t_spec, pipelined): twice as
    # long (at most 16) at <= 4 decoding sequences with nothing
    # waiting and no prefill chunk, half as long (at least 4) while an
    # admission pile-up prefills.
    adaptive_windows: bool = True
    # Extra lanes beyond max_num_seqs: a paged sequence's release waits
    # for the window in flight, and a slack lane admits its replacement
    # meanwhile. Each costs one more lane in every per-slot array (and a
    # slot region on the linear layout).
    slot_slack: int = 0
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
    # Speculative decoding: the draft model (a checkpoint directory or
    # random:<preset>; None = off) and its proposals a round (K).
    spec_draft_model: Optional[str] = None
    spec_num_tokens: int = 4
    seed: int = 0
    device: Optional[str] = None        # None = the CUDA card
    # --- numerics / quant ---
    dtype: str = "bf16"                 # weights and activations: bf16 | f32
    # none | gptq_int4 (gguf_q4k not yet ported); gptq_int4 on a dense
    # checkpoint directory quantizes it on load (int4 g128), as in the
    # JAX package.
    quantization: str = "none"
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
    # An int8 embedding table (f32 row scales) and an int4 untied
    # lm_head, made at build after the two-level pass (so the lm_head
    # serves float-scale): the JAX package's single-chip 30B fit.
    squeeze_embeddings: bool = False
    # Build-time fusion (engine/builder.fuse_projections) at the sites
    # of fuse_sites: qkv, gate_up, and moe (the expert stacks' gate|up;
    # off by default, as in the JAX package).
    fuse_proj: bool = True
    fuse_sites: str = "qkv,gate_up"

    # --- observability (utils/profile.py's locked schema) ---
    # One JSON line an iteration: the scheduler's batch (scheduler/
    # continuous.py `_trace`).
    scheduler_trace_path: Optional[str] = None
    profile_path: Optional[str] = None
    profile_detail: str = "basic"       # off|basic|debug|full
    profile_sample_rate: float = 0.01
    memory_profile_path: Optional[str] = None
    # --- server: the X-Ferrum-Session cache (server/app.py) ---
    session_cache_entries: int = 64
    session_cache_tokens: int = 8192

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
        if self.scheduler not in ("continuous", "fifo", "priority"):
            raise InvalidRequestError("unknown scheduler", param="scheduler")
        if self.kv_dtype not in ("bf16", "f32", "int8"):
            raise InvalidRequestError("unknown kv_dtype", param="kv_dtype")
        if self.kv_layout not in ("paged", "linear", "auto"):
            raise InvalidRequestError("unknown kv_layout", param="kv_layout")
        if self.prefix_cache_policy not in ("lru", "fifo", "clock"):
            raise InvalidRequestError("unknown prefix_cache_policy",
                                      param="prefix_cache_policy")
        if self.prefix_offload_algo not in ("none", "int8", "int4", "fp8"):
            raise InvalidRequestError(
                "prefix_offload_algo must be none, int8, int4 or fp8",
                param="prefix_offload_algo")
        if self.quantization not in ("none", "gptq_int4", "gguf_q4k"):
            raise InvalidRequestError("unknown quantization",
                                      param="quantization")
        check_not_ported({"quantization": self.quantization})
        if self.dtype not in ("bf16", "f32"):
            raise InvalidRequestError("dtype must be bf16 or f32",
                                      param="dtype")
        if self.profile_detail not in ("off", "basic", "debug", "full"):
            raise InvalidRequestError("unknown profile_detail",
                                      param="profile_detail")
        if not isinstance(self.w4a8_gd, bool) \
                and self.w4a8_gd not in ("off", "all", "down", "mxu"):
            raise InvalidRequestError(
                f"unknown w4a8_gd mode {self.w4a8_gd!r}: off | all | down "
                f"| mxu", param="w4a8_gd")
        if self.decode_multi_step < 1:
            raise InvalidRequestError("decode_multi_step must be >= 1",
                                      param="decode_multi_step")
        if self.spec_num_tokens < 1:
            raise InvalidRequestError("spec_num_tokens must be >= 1",
                                      param="spec_num_tokens")
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
        """Device lanes: max_num_seqs plus the slack lanes."""
        return self.max_num_seqs + max(0, self.slot_slack)

    @property
    def decode_buckets(self) -> Tuple[int, ...]:
        """Padded decode lane counts, ascending, ending at num_slots (with
        slack lanes more than max_num_seqs sequences may decode while a
        release is deferred). A window packs its sequences into the
        smallest bucket that fits.
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
    def chunk_cap(self) -> int:
        """The scheduler's chunk cap: prefill_chunk_size, or the token
        budget without chunked prefill."""
        return self.prefill_chunk_size if self.enable_chunked_prefill \
            else self.max_num_batched_tokens

    @property
    def max_chunk_tokens(self) -> int:
        """The longest chunk the scheduler emits: chunk_cap, or the token
        budget under fifo, whose prompts that fit it are prefilled
        whole. (The JAX runner pads every chunk to at most
        prefill_chunk_size, and its fifo admission keeps chunk_cap, so
        the JAX package fails on a longer unchunked prompt and never
        admits one under fifo: ROADMAP Queue 3.)"""
        return self.max_num_batched_tokens if self.scheduler == "fifo" \
            else self.chunk_cap

    def window_lengths(self, bucket: Optional[int] = None
                       ) -> Tuple[int, ...]:
        """The window lengths the engine dispatches at lane bucket
        `bucket` (None: at any) outside minimum progress: the bucket's
        length, and under adaptive windows (no decode_t_spec) the halved
        one and, pipelined, the doubled one at the buckets that hold at
        most 4 lanes (engine.run_iteration)."""
        buckets = self.decode_buckets if bucket is None else (bucket,)
        out = {self.t_for_bucket(b) for b in buckets}
        if self.adaptive_windows and not self.decode_t_spec:
            base = max(1, self.decode_multi_step)
            out.add(max(4, base // 2))
            small = min((b for b in self.decode_buckets if b >= 4),
                        default=self.decode_buckets[-1])
            if self.pipeline_decode and min(buckets) <= small:
                out.add(adaptive_window_steps(base, 1))
        return tuple(sorted(out))

    @property
    def max_blocks_per_seq(self) -> int:
        return self.max_model_len // self.kv_block_size

    @property
    def resolved_prefix_cache_blocks(self) -> int:
        """Blocks of the linear layout's prefix store: -1 → an eighth of
        the slot pool, at least one sequence's; explicit values pass."""
        if self.prefix_cache_blocks >= 0:
            return self.prefix_cache_blocks
        return max(self.max_blocks_per_seq,
                   self.num_slots * self.max_blocks_per_seq // 8)

    @classmethod
    def resolve(cls, cli_overrides: Optional[Dict[str, Any]] = None,
                environ: Optional[Mapping[str, str]] = None,
                toml_path: Optional[str] = None,
                **base: Any) -> "EngineConfig":
        """Merge sources with precedence CLI > env > file > base (``**base``
        is the lowest layer). CLI values of None are unset. A field the
        port does not have raises unless it holds the value the port
        fixes (`check_not_ported`); any other unknown key raises."""
        merged: Dict[str, Any] = dict(base)
        if toml_path and os.path.exists(toml_path):
            merged.update(load_toml_runtime(toml_path))
        merged.update(snapshot_from_process_env(environ))
        if cli_overrides:
            merged.update({k: v for k, v in cli_overrides.items()
                           if v is not None})
        check_not_ported(merged)
        valid = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(k for k in merged
                         if k not in valid and k not in NOT_PORTED)
        if unknown:
            raise InvalidRequestError(f"unknown config field {unknown[0]!r}",
                                      param=unknown[0])
        cfg = cls(**{k: v for k, v in merged.items() if k in valid})
        cfg.validate()
        return cfg
