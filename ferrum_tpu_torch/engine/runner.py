"""ModelRunner: device state, batched prefill and fused decode windows.

Port of `ferrum_tpu/engine/runner.py` for both KV layouts: "linear"
(slot regions sliced, the attention `attn_impl="linear"`) and "paged"
(block tables, pages gathered, `attn_impl="ref"`), bf16 / f32 / int8
caches, and the linear layout's prefix store. The JAX runner compiles
one XLA program per (phase, bucket); PyTorch runs eagerly, so each call
here issues the kernels directly:

  run_prefill_batch    B sequences' chunks through one trunk pass (every
                       projection at m = B*T: the prefill GEMM kernel),
                       first tokens sampled on the device; returns
                       without waiting for them (BatchPrefillResult).
                       `score=True` (prompt scoring, one chunk) also
                       returns each position's logprob of the next
                       prompt token, its argmax and the argmax's
                       logprob, reduced on the device.
  start_decode_window  T decode steps over the sequences packed into
                       the lanes of the smallest bucket that fits
                       (EngineConfig.decode_buckets), optionally with
                       one slot's prefill chunk riding the steps; each
                       step's sampled token feeds the next on the
                       device, the cache stays read-only and the
                       window's K/V land with one append at its end
                       (linear); on the paged layout each step appends
                       its own K/V (the JAX runner's paged window, which
                       takes no riding chunk). Returns without waiting
                       (DecodeWindow).
  sync_window          waits for one window's tokens alone.
  run_decode           one decode step, waited for, with its logits (the
                       host-masked guided path samples on the host).
  warm_prefill_siblings  no-op dispatches of the program keys a cell may
                       meet that the warm-up did not (see below).
  copy_prefix_blocks   whole blocks between the pool and the prefix
                       store: the source pages gathered (index_select),
                       every array written in one `kv_append_pages`
                       launch; add_prompt_counts seeds the repetition
                       counts of a reused prefix.
  read_kv_block /      one paged pool block to the host and back (the
  write_kv_block       prefix cache's offload tier): the read waits for
                       its copies, the one host sync outside
                       `sync_window` / `HostCopy`; the write goes up
                       from pinned memory in stream order.

Windows chain on the device through the slot-indexed `last_toks`: a
window reads the input token of every lane its predecessor covered
from there, so window W+1 is dispatched before W's tokens are read.
Nothing else here synchronizes the stream: host rows go up from pinned
memory without blocking, and results come back into pinned memory with
an event recorded after the copy, which `HostCopy.numpy()` waits on
alone (a stream sync would also wait for every window dispatched
since).

Per-slot state has one row past the slots, the sink at index
`num_slots`: pad lanes carry that slot id, so their gathers read the
sink and their scatters write it, with no mask and no host sync.

Guided decoding on the device (sampling/token_fsm.py): every FSM the
engine registers is stacked under row 0, the FREE state (every token
allowed, a self-loop), and uploaded padded to a power-of-two row bucket
at the next guided dispatch. Each slot holds its state in `gstates`. A
window or batched prefill with a guided sequence applies the queued
slot resets from its host rows (`set_guided_state`: FREE for an
unguided admission, the FSM's start or the processor's state for a
guided one), masks every step's logits by each lane's row before
sampling (unguided lanes sit at FREE) and folds each sampled token's
codepoints through the table; the states go back to the slots with the
window's other lane state, so they carry from window to window on the
device.

Sampling noise: one `torch.Generator` for the engine, drawn whole for
every row of a step; a slot admitted with `SamplingParams.seed` takes
its row from `seeded_gumbel` instead (keyed by the seed and the
position of the token drawn), so a seeded request gives the same
tokens alone, in a batch and in another slot. A draw with no seeded
row computes no hash.

Counters (the JAX runner's): `decode_steps`, `prefill_steps` (chunks
dispatched, a window's riding chunk too), host seconds in the window
dispatches (`decode_device_time`), blocked in `sync_window`
(`decode_sync_time`) and in the prefill dispatches
(`prefill_device_time`), and the compile audit: `compilations` and
`compile_log`, one (site, key) entry per program key first dispatched.
The port compiles no program: a key is the shape of the work a site
issues -- `window` (lane bucket, context bucket, T, chunk rows, greedy,
guided, the FSM tables' row bucket), `prefill` (batch pad, chunk pad,
context pad, greedy, logits returned, guided, row bucket) and `decode1`
(run_decode's step), the JAX runner's sites, each logged with the
runner's layout and KV dtype;
`prefix_copy` (rows padded), `counts` (tokens padded) and
`kv_block_io` (whether the cache is int8) as the JAX runner keys them
-- plus `kernel_build`, one per CUDA library first used in the process
(ops/kernels/build.py `LOADED`). A key first met inside a measured
bench cell is a warm-up hole (bench/bench_engine.py counts them per
cell). The CUDA graphs of a later slice are captured at the
same keys.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import EngineConfig
from ..models.configs import ModelConfig
from ..models.llama_family import (
    OOB_SENTINEL, ModelParams, PagedKvCache, append_window_kv,
    decode_forward, logits_from_hidden, make_inv_freq, make_local_inv_freq,
    prefill_forward_batched)
from ..ops.kernels import build as kernel_build
from ..ops.kernels.kv_append import append_pages_pairs
from ..sampling.device import (SlotSamplingParams, guided_advance,
                               guided_mask_rows, lane_noise, sample_step,
                               update_counts)
from ..scheduler.continuous import PrefillChunk
from ..scheduler.sequence import Sequence
from ..utils import profile as _prof


def _round_up_pow2(x: int, lo: int, hi: int) -> int:
    x = max(x, lo)
    return min(1 << (x - 1).bit_length(), hi)


class HostCopy:
    """A device tensor's copy into host memory, started at once. On a
    card it goes into pinned memory without blocking, and `numpy()`
    waits on the event recorded after that copy, not on the stream."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.is_cuda:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            t = host
        self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
            self._event = None
        return self._host.numpy()


@dataclass
class BatchPrefillResult:
    """One batched prefill's sampled tokens (meaningful for final
    chunks), still on their way to the host."""

    tokens: HostCopy                  # int64 [B]
    rows: Dict[str, int]              # request id -> row
    # return_logits: f32 [B, V], each row's last-position logits (the
    # host-masked guided path samples its first token from them).
    logits: Optional[HostCopy] = None
    # score=True: f32 [2, B, t_pad] (target logprob, argmax logprob) and
    # int64 [B, t_pad] argmax ids, per chunk position.
    score_lp: Optional[HostCopy] = None
    score_argmax: Optional[HostCopy] = None


@dataclass
class DecodeWindow:
    """A dispatched decode window whose tokens have not been read."""

    seqs: List[Sequence]              # the lanes' sequences
    covered: frozenset                # request ids riding this window
    toks: HostCopy                    # int64 [T, s_pad]
    end_pos: Dict[int, int]           # slot -> position after the window
    num_steps: int
    lanes: Dict[str, int]             # request id -> lane
    s_pad: int                        # the lane bucket
    p_rows: int = 0                   # rows a step of the riding chunk
    # Mixed prefill: the chunk that rode the window; when it was the
    # prompt's last, its first token.
    pf_seq: Optional[Sequence] = None
    pf_is_last: bool = False
    pf_tok: Optional[HostCopy] = None
    # Paged layout: sequences that finished while this window could
    # still write their blocks; released when it is read.
    deferred: List[Sequence] = field(default_factory=list)
    # run_decode: the step's logits, f32 [s_pad, V].
    logits: Optional[HostCopy] = None


class ModelRunner:
    def __init__(self, model_cfg: ModelConfig, engine_cfg: EngineConfig,
                 params: ModelParams, kv: PagedKvCache,
                 device: torch.device):
        self.model_cfg = model_cfg
        self.cfg = engine_cfg
        self.params = params
        self.kv = kv
        self.device = device
        if engine_cfg.kv_layout not in ("linear", "paged"):
            raise ValueError("the runner takes a resolved kv_layout, "
                             f"not {engine_cfg.kv_layout!r}")
        # Linear: slot regions sliced; paged: pages gathered through
        # block tables (the JAX runner's attn_impl).
        self.attn_impl = "linear" if engine_cfg.kv_layout == "linear" \
            else "ref"
        # Linear-layout prefix store (ensure_prefix_store).
        self.prefix_store: Optional[PagedKvCache] = None
        s = engine_cfg.num_slots
        v = model_cfg.vocab_size
        self.num_slots = s
        self.page = kv.page
        self.max_pages = engine_cfg.max_blocks_per_seq
        # Row s is the pad lanes' sink.
        self.counts = torch.zeros((s + 1, v), dtype=torch.int32,
                                  device=device)
        self.samp = {
            "temps": torch.zeros(s + 1, dtype=torch.float32, device=device),
            "top_ks": torch.zeros(s + 1, dtype=torch.int64, device=device),
            "top_ps": torch.ones(s + 1, dtype=torch.float32, device=device),
            "pens": torch.ones(s + 1, dtype=torch.float32, device=device),
            "seeds": torch.zeros(s + 1, dtype=torch.int64, device=device),
            "seeded": torch.zeros(s + 1, dtype=torch.bool, device=device),
        }
        # Slot-indexed final tokens of the latest window: the chain carry.
        self.last_toks = torch.zeros(s + 1, dtype=torch.int64, device=device)
        self._temps = np.zeros(s, np.float32)      # host mirror (greedy)
        self._seeded = np.zeros(s, bool)           # host mirror (noise)
        self.generator = torch.Generator(device=device)
        self.generator.manual_seed(engine_cfg.seed)
        self.inv_freq = make_inv_freq(model_cfg, device)
        # gemma3's sliding-window layers' table (None elsewhere).
        self.inv_freq_local = make_local_inv_freq(model_cfg, device)
        self.eos_mask = torch.zeros(v, dtype=torch.bool, device=device)
        self.eos_mask[list(model_cfg.eos_token_ids)] = True
        # Counters read by callers: windows by lane bucket, windows that
        # carried a prefill block, decode steps.
        self.windows_by_bucket: Dict[int, int] = {}
        self.mixed_windows = 0
        self.decode_steps = 0
        self.prefill_steps = 0
        self.decode_device_time = 0.0
        self.decode_sync_time = 0.0
        self.prefill_device_time = 0.0
        # Compile audit: program keys first dispatched, by site.
        self.compilations = 0
        self.compile_log: list = []
        self._prefill_keys: set = set()
        self._window_keys: set = set()
        self._copy_keys: set = set()
        self._count_keys: set = set()
        self._score_keys: set = set()
        self._block_io_keys: set = set()
        self._chunk_lens: set = set()        # prompt chunk lengths seen
        self._builds_seen = len(kernel_build.LOADED)
        # "error" makes every dispatch fail on a host sync of the stream
        # (torch.cuda.set_sync_debug_mode), to prove the pipeline free
        # of them.
        self.sync_debug: Optional[str] = None
        self._decode1_keys: set = set()
        # Guided decoding on the device (sampling/token_fsm.py): the
        # stacked tables of every registered FSM, row 0 the FREE state
        # (every token allowed, a self-loop) where unguided slots sit.
        # The words are the JAX package's uint32 bits held as int32.
        # FSMs are registered on the host by `submit` on the caller's
        # thread (under the lock) and uploaded by the loop at its next
        # guided dispatch. Per-slot states live on the device (the sink
        # at s) and advance inside the windows; a slot's reset rides the
        # next guided dispatch's host rows (`set_guided_state`).
        self.gstates = torch.zeros(s + 1, dtype=torch.int32, device=device)
        self._gtrans_np = np.zeros((1, 258), np.int32)
        self._gmask_np = np.full((1, (v + 31) // 32), -1, np.int32)
        self._gtokcp_np: Optional[np.ndarray] = None
        self._gdev: Optional[tuple] = None     # (trans, mask, token_cps)
        self._grows_bucket = 0
        self._fsm_offsets: Dict[int, int] = {}            # id(fsm) -> row
        self._pending_ginit: Dict[int, int] = {}          # slot -> state
        self._guided_lock = threading.Lock()

    def _upload_rows(self, parts: List[np.ndarray]) -> List[torch.Tensor]:
        """int64 host rows to the device in ONE upload; each part's flat
        view there."""
        dev = self._upload(np.concatenate([p.reshape(-1) for p in parts]))
        out, off = [], 0
        for p in parts:
            out.append(dev[off:off + p.size])
            off += p.size
        return out

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host rows to the device without blocking the host: a pinned
        copy (the caching host allocator reuses its block only after
        this copy's event), then an asynchronous transfer."""
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _note_compile(self, site: str, key) -> None:
        """One program key first dispatched: count it, audit it, and emit
        `engine.compile`."""
        self.compilations += 1
        self.compile_log.append((site, key))
        _prof.emit_instant("engine.compile",
                           {"site": site, "key": repr(key)},
                           status="diagnostic_only")

    def _note_key(self, keys: set, site: str, key) -> None:
        if key not in keys:
            keys.add(key)
            self._note_compile(site, key + (self.cfg.kv_layout,
                                            self.cfg.kv_dtype))

    def _note_kernel_builds(self) -> None:
        """A `kernel_build` entry for each CUDA library first used in the
        process since the last dispatch."""
        loaded = kernel_build.LOADED
        while self._builds_seen < len(loaded):
            self._note_compile("kernel_build", loaded[self._builds_seen])
            self._builds_seen += 1

    @contextlib.contextmanager
    def sync_guard(self):
        """Around each dispatch: torch.cuda.set_sync_debug_mode at
        `sync_debug` (when set), restored after."""
        if self.sync_debug is None:
            yield
            return
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(self.sync_debug)
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    # ------------------------------------------------------------------
    def admit_slot(self, seq: Sequence) -> None:
        sp = seq.request.sampling
        slot = seq.slot
        self._temps[slot] = sp.temperature
        self.counts[slot].zero_()
        self.samp["temps"][slot] = sp.temperature
        self.samp["top_ks"][slot] = sp.top_k
        self.samp["top_ps"][slot] = sp.top_p
        self.samp["pens"][slot] = sp.repetition_penalty
        self._seeded[slot] = sp.seed is not None
        self.samp["seeded"][slot] = sp.seed is not None
        if sp.seed is not None:
            seed = sp.seed & 0xFFFFFFFFFFFFFFFF      # int64 two's complement
            self.samp["seeds"][slot] = seed - (1 << 64) if seed >> 63 \
                else seed

    # ------------------------------------------------------------------
    # Guided decoding (device FSM)
    # ------------------------------------------------------------------
    def register_guided_fsm(self, fsm, vocab_table) -> int:
        """Stack a TokenFsm's tables under the registered ones; returns
        its first global row. Host only (any thread): the loop uploads
        the tables at its next guided dispatch, padded to a power-of-two
        row bucket (`grows` in the dispatch keys)."""
        with self._guided_lock:
            off = self._fsm_offsets.get(id(fsm))
            if off is not None:
                return off
            off = self._gtrans_np.shape[0]
            self._gtrans_np = np.concatenate(
                [self._gtrans_np, fsm.trans + off])   # local -> global rows
            self._gmask_np = np.concatenate(
                [self._gmask_np, fsm.mask_words.view(np.int32)])
            self._fsm_offsets[id(fsm)] = off
            if self._gtokcp_np is None:
                self._gtokcp_np = vocab_table.token_cps
            self._gdev = None
            return off

    def set_guided_state(self, slot: int, state: int) -> None:
        """Queue a slot's FSM state (0: FREE); the next guided dispatch
        applies it through its host rows."""
        self._pending_ginit[slot] = state

    def guided_table_bytes(self) -> int:
        """Device bytes of the uploaded guided tables (0 before any)."""
        return sum(t.numel() * t.element_size() for t in self._gdev) \
            if self._gdev is not None else 0

    def _guided_tables(self):
        """(trans, mask words, token codepoints, row bucket) on the
        device, uploaded when an FSM was registered since the last
        guided dispatch. Pad rows go to FREE and allow every token."""
        with self._guided_lock:
            rows = self._gtrans_np.shape[0]
            bucket = max(2, 1 << (rows - 1).bit_length())
            if self._gdev is None or bucket != self._grows_bucket:
                pad = bucket - rows
                trans = np.concatenate(
                    [self._gtrans_np, np.zeros((pad, 258), np.int32)])
                mask = np.concatenate(
                    [self._gmask_np,
                     np.full((pad, self._gmask_np.shape[1]), -1, np.int32)])
                self._gdev = tuple(self._upload(a) for a in (
                    trans, mask, self._gtokcp_np))
                self._grows_bucket = bucket
            return self._gdev + (bucket,)

    def _ginit_row(self, drain: bool) -> np.ndarray:
        """Per-slot init states for this dispatch, -1 where the device
        state stays (the sink too). Drains every queued reset (a slot
        outside the batch is no lane: harmless); a warm-up drains none."""
        row = np.full(self.num_slots + 1, -1, np.int64)
        if drain:
            for slot, st in self._pending_ginit.items():
                row[slot] = st
            self._pending_ginit.clear()
        return row

    def _drain_ginit(self, gi: torch.Tensor) -> None:
        """Apply a dispatch's uploaded init row to the slot states."""
        self.gstates.copy_(torch.where(gi >= 0, gi.to(torch.int32),
                                       self.gstates))

    # ------------------------------------------------------------------
    # Prefix store (the linear layout's prefix cache; kv/linear_prefix.py)
    # ------------------------------------------------------------------
    def prefix_store_block_bytes(self) -> int:
        """Device bytes of one prefix-store block: every layer's K and V
        page (and their scale pages, int8)."""
        kv = self.kv
        n_layers = kv.k.shape[0]
        f = kv.kv_heads * kv.head_dim
        per = n_layers * self.page * f * kv.k.element_size() * 2
        if kv.quantized:
            per += n_layers * self.page * kv.kv_heads * 4 * 2
        return per

    def prefix_store_budget_blocks(self,
                                   headroom_bytes: int = 4 << 30) -> int:
        """Store blocks that fit in the card's free memory after a
        headroom for transients (a batched prefill's logits pass 1 GB at
        the 8B vocabulary). On the CPU no device memory bounds it."""
        if self.device.type != "cuda":
            return 1 << 30
        free, _total = torch.cuda.mem_get_info(self.device)
        return max(0, int(free - headroom_bytes)
                   // self.prefix_store_block_bytes())

    def ensure_prefix_store(self, num_blocks: int) -> None:
        """The device-side prefix store: a block extent with the pool's
        (layer, page, head) geometry and dtype."""
        if self.prefix_store is not None:
            return
        kv = self.kv
        self.prefix_store = PagedKvCache.create(
            self.model_cfg, num_blocks, self.page, dtype=kv.k.dtype,
            device=self.device)

    def copy_prefix_blocks(self, src_blocks: List[int],
                           dst_blocks: List[int], to_store: bool) -> None:
        """Whole blocks, every layer, between the pool and the prefix
        store (to_store: a save at finish; else a restore at admission).
        The block count pads to a power of two (the JAX program's row
        key): pad sources read block 0, pad destinations are >= B and
        dropped. The source pages are gathered with index_select and
        every array (K, V and an int8 cache's scales) lands in one
        `kv_append_pages` launch, issued in stream order with the
        windows and prefills that touch the same blocks."""
        page = self.page
        r_pad = _round_up_pow2(len(src_blocks) * page, page, 1 << 22)
        self._note_key(self._copy_keys, "prefix_copy", (r_pad,))
        n_pad = r_pad // page
        src_ids = np.zeros(n_pad, np.int64)
        dst_ids = np.full(n_pad, OOB_SENTINEL, np.int64)
        src_ids[:len(src_blocks)] = src_blocks
        dst_ids[:len(dst_blocks)] = dst_blocks
        src, dst = (self.kv, self.prefix_store) if to_store \
            else (self.prefix_store, self.kv)
        n_layers = src.k.shape[0]
        layer = np.arange(n_layers)[:, None]
        src_all = (layer * src.num_blocks + src_ids[None]).reshape(-1)
        dst_all = np.where(dst_ids[None] >= OOB_SENTINEL, OOB_SENTINEL,
                           layer * dst.num_blocks + dst_ids[None])
        dev = self._upload(np.concatenate([src_all, dst_all.reshape(-1)]))
        src_dev = dev[:src_all.size]
        dst_dev = dev[src_all.size:].to(torch.int32)
        with self.sync_guard():
            append_pages_pairs(
                [(d, s.index_select(0, src_dev))
                 for s, d in zip(src.flat_arrays(), dst.flat_arrays())],
                dst_dev)
        self._note_kernel_builds()

    def add_prompt_counts(self, slot: int, tokens: List[int]) -> None:
        """Repetition counts of prompt tokens a prefill did not process
        (a reused prefix): the prefill counts only its own tokens."""
        n = len(tokens)
        if n == 0:
            return
        n_pad = _round_up_pow2(n, 8, 1 << 20)
        self._note_key(self._count_keys, "counts", (n_pad,))
        arr = np.full(n_pad, self.model_cfg.vocab_size, np.int64)
        arr[:n] = tokens
        toks = self._upload(arr)
        with self.sync_guard():
            update_counts(self.counts, torch.full_like(toks, slot), toks)

    # ------------------------------------------------------------------
    # KV block host I/O (the paged prefix cache's offload tier;
    # kv/compression.py)
    # ------------------------------------------------------------------
    def _block_arrays(self) -> List[torch.Tensor]:
        kv = self.kv
        return [kv.k, kv.v] + ([kv.k_scale, kv.v_scale]
                               if kv.quantized else [])

    def read_kv_block(self, block_id: int) -> tuple:
        """One pool block to the host: (k, v[, k_scale, v_scale]) CPU
        tensors, k / v [L, page, kv_size], the scales [L, page,
        kv_heads]. A DECLARED HOST SYNC on the eviction path, as the JAX
        runner's blocking readback: each array is copied into a pinned
        buffer of its own (the tier may keep it as it is), and the host
        waits on one event after the copies, so the block holds every
        write enqueued before. The no-sync check's runs use no tier."""
        self._note_key(self._block_io_keys, "kv_block_io",
                       (self.kv.quantized,))
        srcs = [a[:, block_id] for a in self._block_arrays()]
        if self.device.type != "cuda":
            return tuple(s.clone() for s in srcs)
        out = []
        for s in srcs:
            host = torch.empty(s.shape, dtype=s.dtype, pin_memory=True)
            host.copy_(s, non_blocking=True)
            out.append(host)
        done = torch.cuda.Event()
        done.record()
        done.synchronize()
        return tuple(out)

    def write_kv_block(self, block_id: int, arrays: tuple) -> None:
        """A host block group (read_kv_block's form) into pool block
        `block_id` (the restore path), in stream order: every array goes
        up from pinned memory without blocking -- the caching host
        allocator reuses a pinned buffer only after its copy's event, so
        the next restore cannot overwrite one in flight -- and lands
        before any prefill enqueued after it reads the block."""
        self._note_key(self._block_io_keys, "kv_block_io",
                       (self.kv.quantized,))
        with self.sync_guard():
            for dst, a in zip(self._block_arrays(), arrays):
                src = a.to(dst.dtype)
                if dst.is_cuda:
                    src = src.pin_memory().to(dst.device, non_blocking=True)
                dst[:, block_id].copy_(src)

    def ctx_bucket(self, max_len: int) -> int:
        return _round_up_pow2(max_len, max(2 * self.page, 16),
                              self.cfg.max_model_len)

    def lane_bucket(self, n: int) -> int:
        """Smallest decode lane bucket >= n."""
        for b in self.cfg.decode_buckets:
            if b >= n:
                return b
        return self.cfg.decode_buckets[-1]

    def chunk_bucket(self, t: int) -> int:
        # A page multiple (whole-page appends), up to the largest chunk
        # (an unchunked prompt's whole length; the JAX runner caps it at
        # prefill_chunk_size, too few for one: ROADMAP Queue 3).
        lo = max(8, self.page, min(64, self.cfg.prefill_chunk_size))
        cap = -(-self.cfg.max_chunk_tokens // self.page) * self.page
        return _round_up_pow2(t, lo, max(cap, lo))

    def _sampling(self, slots: torch.Tensor,
                  min_active: torch.Tensor) -> SlotSamplingParams:
        return SlotSamplingParams(
            self.samp["temps"][slots], self.samp["top_ks"][slots],
            self.samp["top_ps"][slots], self.samp["pens"][slots],
            min_active)

    def _noise(self, slots: torch.Tensor, positions: torch.Tensor,
               seqs, greedy: bool) -> Optional[torch.Tensor]:
        """A draw's noise when one of `seqs` has its own seed (else None:
        sample_step draws from the generator itself, the same draw)."""
        if greedy or not any(self._seeded[q.slot] for q in seqs):
            return None
        return lane_noise(slots, positions, self.samp["seeds"],
                          self.samp["seeded"], self.model_cfg.vocab_size,
                          self.generator)

    def _flat_rows(self, seq: Sequence, start: int, n: int) -> np.ndarray:
        """Flat cache slots of positions start .. start+n-1 of a sequence,
        OOB_SENTINEL past its reserved blocks."""
        blocks = np.asarray(seq.blocks.blocks, np.int64)
        p = start + np.arange(n)
        blk = blocks[np.minimum(p // self.page, len(blocks) - 1)]
        return np.where(p < len(blocks) * self.page,
                        blk * self.page + p % self.page, OOB_SENTINEL)

    # ------------------------------------------------------------------
    def run_prefill_batch(self, chunks: List[PrefillChunk],
                          score: bool = False,
                          return_logits: bool = False) -> BatchPrefillResult:
        """One trunk pass over every chunk (one per sequence); the token
        sampled at each chunk's last position is on its way to the host
        when this returns. `score`: the chunks' score rows too (the
        engine dispatches a scored chunk alone: its [t_pad, V] logits are
        the transient). `return_logits`: each row's last-position logits
        too. A row of a device-FSM guided sequence samples under its
        slot's mask, and a final chunk advances the slot's state."""
        t0 = time.perf_counter()
        with self.sync_guard():
            res = self._prefill(chunks, score=score,
                                return_logits=return_logits)
        self.prefill_device_time += time.perf_counter() - t0
        self.prefill_steps += len(chunks)
        self._note_kernel_builds()
        return res

    def _prefill(self, chunks: List[PrefillChunk],
                 warm: Optional[tuple] = None,
                 score: bool = False,
                 return_logits: bool = False) -> BatchPrefillResult:
        """warm: the key (b, t_pad, ctx_pad, greedy, return_logits,
        guided, grows) of a no-op prefill with no chunks (every row a
        pad row)."""
        if warm is None:
            b = len(chunks)
            t_pad = self.chunk_bucket(max(len(c.tokens) for c in chunks))
            ctx_pad = max(self.ctx_bucket(c.start + len(c.tokens))
                          for c in chunks)
            greedy = bool(all(self._temps[c.seq.slot] == 0
                              for c in chunks))
            guided = any(c.seq.guided_fsm_offset is not None
                         for c in chunks)
        else:
            b, t_pad, ctx_pad, greedy, return_logits, guided, _ = warm
        grows = 0
        if guided:
            gtrans, gmask, gcps, grows = self._guided_tables()
        if score:
            self._note_key(self._score_keys, "prefill_score",
                           (b, t_pad, ctx_pad, greedy))
        else:
            self._note_key(self._prefill_keys, "prefill",
                           (b, t_pad, ctx_pad, greedy, return_logits, guided,
                            grows))
        # int rows: tokens, positions (pads past the context), flat slots
        # (pads dropped), count tokens (pads = vocab, dropped); per-row
        # scalars: slot, last index, total length, min_tokens active,
        # final-chunk slot (else the sink). The rows of a warm-up take
        # the sink slot and write nothing.
        v = self.model_cfg.vocab_size
        # Scoring adds a fifth row: each position's target, the next token
        # of the prefill target (pads and the prompt's last = vocab).
        packed = np.zeros((5 if score else 4, b, t_pad), np.int64)
        packed[1] = self.cfg.max_model_len + ctx_pad
        packed[2] = OOB_SENTINEL
        packed[3] = v
        if score:
            packed[4] = v
        scal = np.zeros((5, b), np.int64)
        scal[0] = scal[4] = self.num_slots
        rows: Dict[str, int] = {}
        for i, c in enumerate(chunks):
            seq = c.seq
            n = len(c.tokens)
            self._chunk_lens.add(n)
            total = c.start + n
            packed[0, i, :n] = c.tokens
            packed[1, i, :n] = np.arange(c.start, total)
            packed[2, i, :n] = self._flat_rows(seq, c.start, n)
            packed[3, i, :n] = c.tokens
            if score:
                nxt = seq.prefill_target[c.start + 1:total + 1]
                packed[4, i, :len(nxt)] = nxt
            scal[:, i] = (seq.slot, n - 1, total,
                          int(seq.num_output_tokens
                              < seq.request.sampling.min_tokens),
                          seq.slot if c.is_last else self.num_slots)
            rows[seq.request.request_id] = i
        parts = [packed, scal]
        if self.attn_impl == "ref":
            parts.append(self._host_tables([c.seq for c in chunks], b))
        if guided:
            parts.append(self._ginit_row(drain=warm is None))
        views = self._upload_rows(parts)
        pk = views[0].view(packed.shape[0], b, t_pad)
        sc = views[1].view(5, b)
        slots = sc[0]
        tables = self._tables(slots) if self.attn_impl == "linear" \
            else views[2].view(b, self.max_pages)
        h, _ = prefill_forward_batched(
            self.params, self.model_cfg, self.kv, pk[0], pk[1],
            tables, sc[2], pk[2], ctx_pad=ctx_pad,
            inv_freq=self.inv_freq, inv_freq_local=self.inv_freq_local,
            attn_impl=self.attn_impl)
        update_counts(self.counts, slots[:, None].expand(b, t_pad), pk[3])
        score_lp = score_am = None
        if score:
            # Per position: lp(target | prefix), the argmax and its lp,
            # from the f32 logits' max and logsumexp on the device.
            lg = logits_from_hidden(self.params, self.model_cfg,
                                    h.reshape(b * t_pad, -1)).float()
            mx = lg.max(dim=-1).values
            lse = mx + torch.log(torch.exp(lg - mx[:, None]).sum(-1))
            tgt = pk[4].reshape(-1).clamp(0, v - 1)
            t_lp = lg.gather(1, tgt[:, None])[:, 0] - lse
            score_lp = HostCopy(torch.stack([t_lp, mx - lse]).view(
                2, b, t_pad))
            score_am = HostCopy(lg.argmax(dim=-1).view(b, t_pad))
        hs = h[torch.arange(b, device=self.device), sc[1]]      # [B, H]
        logits = logits_from_hidden(self.params, self.model_cfg, hs)
        mask = None
        if guided:
            self._drain_ginit(views[-1])
            st = self.gstates[slots]
            mask = guided_mask_rows(gmask, st, v)
        toks = sample_step(logits, self._sampling(slots, sc[3] == 1),
                           self.counts[slots], self.eos_mask,
                           greedy_only=greedy, generator=self.generator,
                           noise=self._noise(slots, sc[2],
                                             [c.seq for c in chunks],
                                             greedy),
                           allowed_mask=mask)
        if guided:
            # Only a final chunk's token is kept: its row advances.
            st2 = guided_advance(gtrans, gcps, st, toks)
            self.gstates.index_copy_(0, slots,
                                     torch.where(sc[4] == slots, st2, st))
        # Final chunks count their token (other rows add to the sink
        # row).
        update_counts(self.counts, sc[4], toks)
        return BatchPrefillResult(
            tokens=HostCopy(toks), rows=rows, score_lp=score_lp,
            score_argmax=score_am,
            logits=HostCopy(logits.float()) if return_logits else None)

    def _host_tables(self, seqs: List[Sequence], n: int) -> np.ndarray:
        """Paged block tables [n, max_pages], flat: row i the blocks of
        seqs[i]; rows past the sequences (pads) zero."""
        tab = np.zeros((n, self.max_pages), np.int64)
        for i, seq in enumerate(seqs):
            ids = seq.blocks.blocks
            tab[i, :len(ids)] = ids
        return tab.reshape(-1)

    def _tables(self, slots: torch.Tensor) -> torch.Tensor:
        """Identity block tables of the linear layout for these slots."""
        return (slots.to(torch.int64)[:, None] * self.max_pages
                + torch.arange(self.max_pages, device=self.device)[None])

    # ------------------------------------------------------------------
    def start_decode_window(self, seqs: List[Sequence], num_steps: int,
                            prev: Optional[DecodeWindow] = None,
                            pf_chunk: Optional[PrefillChunk] = None
                            ) -> DecodeWindow:
        """Dispatch one decode window of `num_steps` steps for `seqs`
        without waiting for it.

        The sequences take lanes 0..n-1 of the smallest bucket s_pad that
        fits (lane == slot when s_pad is the slot count: the regions are
        then views of the cache, not gathers). A sequence that `prev`
        (the newest window still in flight) covered takes its input
        token from `last_toks` on the device and its position from
        prev.end_pos; the others take host rows.

        pf_chunk: one slot's prefill chunk riding the window, split into
        T blocks of P rows (mixed prefill). When it ends the prompt, its
        first token is sampled after the steps, written to `last_toks`
        (the next window chains from it) and returned as `pf_tok`."""
        t0 = time.perf_counter()
        with self.sync_guard():
            window = self._window(seqs, num_steps, prev, pf_chunk)
        dt = time.perf_counter() - t0
        self.decode_device_time += dt
        _prof.emit("window.dispatch", dt, {
            "steps": num_steps, "lanes": len(seqs), "bucket": window.s_pad,
            "p_rows": window.p_rows})
        self.windows_by_bucket[window.s_pad] = self.windows_by_bucket.get(
            window.s_pad, 0) + 1
        self.decode_steps += num_steps
        if pf_chunk is not None:
            self.mixed_windows += 1
            self.prefill_steps += 1
        self._note_kernel_builds()
        return window

    def _window(self, seqs, num_steps, prev, pf_chunk,
                warm: Optional[tuple] = None,
                single: bool = False) -> DecodeWindow:
        """warm: (s_pad, ctx_pad, p_rows, greedy, guided) of a no-op
        window with no sequences (every lane a pad lane; a chunk
        block of p_rows pad rows on the sink slot when p_rows > 0).
        single: run_decode's step (one step, its logits kept, the
        argmax taken: the host samples)."""
        s = self.num_slots
        t = num_steps
        s_pad = warm[0] if warm is not None \
            else self.lane_bucket(max(1, len(seqs)))
        ident = s_pad == s
        paged = self.attn_impl == "ref"
        if paged and (pf_chunk is not None
                      or (warm is not None and warm[2])):
            raise ValueError("a prefill chunk rides only the linear "
                             "layout's windows")
        # Lane rows: tokens, positions, cache lens, slots (the sink for
        # pads), min_tokens active, token from the carry; then the flat
        # slots of every step [T, s_pad].
        lrows = np.zeros((6, s_pad), np.int64)
        lrows[3] = s
        flat = np.full((t, s_pad), OOB_SENTINEL, np.int64)
        max_len = 2
        end_pos: Dict[int, int] = {}
        lanes: Dict[str, int] = {}
        for i, seq in enumerate(seqs):
            lane = seq.slot if ident else i
            sl = seq.slot
            rid = seq.request.request_id
            lanes[rid] = lane
            if prev is not None and rid in prev.covered \
                    and sl in prev.end_pos:
                pos = prev.end_pos[sl]
                lrows[5, lane] = 1
            else:
                pos = seq.next_position()
                lrows[0, lane] = seq.all_tokens[-1]
            lrows[1, lane] = pos
            lrows[2, lane] = pos + 1
            lrows[3, lane] = sl
            # Suppress EOS through the whole window while under
            # min_tokens (may overshoot by <= T-1, never under).
            lrows[4, lane] = int(seq.num_output_tokens
                                 < seq.request.sampling.min_tokens)
            flat[:, lane] = self._flat_rows(seq, pos, t)
            end_pos[sl] = pos + t
            max_len = max(max_len, pos + 1)
        covered = {seq.request.request_id for seq in seqs}

        parts = [lrows, flat]
        if paged:
            tab = self._host_tables([], s_pad).reshape(s_pad, -1)
            for seq in seqs:
                lane = lanes[seq.request.request_id]
                ids = seq.blocks.blocks
                tab[lane, :len(ids)] = ids
            parts.append(tab)
        p_rows = 0
        if pf_chunk is not None or (warm is not None and warm[2]):
            if pf_chunk is not None:
                seq_p = pf_chunk.seq
                n, start, psl = len(pf_chunk.tokens), pf_chunk.start, \
                    seq_p.slot
                self._chunk_lens.add(n)
                p_rows = _round_up_pow2(-(-n // t), 8, 512)
            else:                   # a no-op block: pad rows, sink slot
                n, start, psl, p_rows = 0, 0, s, warm[2]
            # Rows: tokens, count tokens (pads = vocab), positions (pads
            # past every context), flat slots (pads dropped).
            pf = np.zeros((4, t * p_rows), np.int64)
            pf[1] = self.model_cfg.vocab_size
            pf[2] = self.cfg.max_model_len + (1 << 16)
            pf[3] = OOB_SENTINEL
            if pf_chunk is not None:
                pf[0, :n] = pf_chunk.tokens
                pf[1, :n] = pf_chunk.tokens
                pf[2, :n] = np.arange(start, start + n)
                pf[3, :n] = self._flat_rows(seq_p, start, n)
                max_len = max(max_len, start + n)
                if pf_chunk.is_last:
                    covered.add(seq_p.request.request_id)
                    end_pos[psl] = start + n
            parts.append(pf)
        pf_part = len(parts) - 1
        if warm is not None:
            ctx_pad, greedy, guided = warm[1], warm[3], warm[4]
        else:
            ctx_pad = self.ctx_bucket(max_len + t)
            greedy = single or bool(
                all(self._temps[q.slot] == 0 for q in seqs)
                and (pf_chunk is None
                     or self._temps[pf_chunk.seq.slot] == 0))
            guided = any(q.guided_fsm_offset is not None for q in seqs)
        grows = 0
        if guided:
            # The init row rides this dispatch's one upload.
            gtrans, gmask, gcps, grows = self._guided_tables()
            parts.append(self._ginit_row(drain=warm is None))
        views = self._upload_rows(parts)
        if single:
            self._note_key(self._decode1_keys, "decode1", (s_pad, ctx_pad))
        else:
            self._note_key(self._window_keys, "window",
                           (s_pad, ctx_pad, t, p_rows, greedy, guided,
                            grows))

        lr = views[0].view(6, s_pad)
        flat_dev = views[1].view(t, s_pad)
        tables = views[2].view(s_pad, self.max_pages) if paged else None
        lane_slots = lr[3]
        tokens = torch.where(lr[5] == 1, self.last_toks[lane_slots], lr[0])
        positions, cache_len = lr[1], lr[2]
        lane_ids = torch.where(lane_slots < s,
                               torch.arange(s_pad, device=self.device),
                               torch.full_like(lane_slots, s_pad))
        # Lane state: the slots' own rows at the full frame (pad lanes'
        # counts updates drop), gathered copies otherwise.
        counts_l = self.counts[:s] if ident else self.counts[lane_slots]
        samp = self._sampling(lane_slots, lr[4] == 1)
        v = self.model_cfg.vocab_size
        lane = {"logits": None}
        if guided:
            # Pending resets first, then the lanes' states (pad lanes:
            # the sink, which stays FREE).
            self._drain_ginit(views[-1])
            lane["gst"] = self.gstates[lane_slots]

        def draw(logits, step):
            """One step's tokens: under the lanes' guided masks, each
            lane's state advanced by its token; the counts updated."""
            if single:
                lane["logits"] = logits
            mask = guided_mask_rows(gmask, lane["gst"], v) if guided \
                else None
            toks = sample_step(logits, samp, counts_l, self.eos_mask,
                               greedy_only=greedy, generator=self.generator,
                               noise=self._noise(lane_slots,
                                                 positions + step + 1,
                                                 seqs, greedy),
                               allowed_mask=mask)
            if guided:
                lane["gst"] = guided_advance(gtrans, gcps, lane["gst"], toks)
            update_counts(counts_l, lane_ids, toks)
            return toks

        def finish(all_toks, **extra) -> DecodeWindow:
            """Lane state back to the slots (pad lanes: the sink row)."""
            if not ident:
                self.counts.index_copy_(0, lane_slots, counts_l)
            self.last_toks.index_copy_(0, lane_slots, all_toks[t - 1])
            if guided:
                self.gstates.index_copy_(0, lane_slots, lane["gst"])
            return DecodeWindow(
                seqs=list(seqs), covered=frozenset(covered),
                toks=HostCopy(all_toks), end_pos=end_pos, num_steps=t,
                lanes=lanes, s_pad=s_pad,
                logits=HostCopy(lane["logits"].float()) if single else None,
                **extra)

        kv = self.kv
        if paged:
            return finish(self._paged_steps(tokens, positions, cache_len,
                                            tables, flat_dev, ctx_pad, draw))
        n_layers = kv.k.shape[0]
        lc = lane_slots.clamp_max(s - 1)
        # Under an int8 cache the window's K/V collect in bf16, as in
        # the JAX runner.
        acc_dtype = torch.bfloat16 if kv.quantized else kv.k.dtype

        def region(cache, li):
            frame = cache[li].view(s, -1, cache.shape[-1])
            return frame[:, :ctx_pad] if ident else frame[lc, :ctx_pad]

        win = {"k": torch.zeros((n_layers, t, s_pad, kv.kv_heads,
                                 kv.head_dim), dtype=acc_dtype,
                                device=self.device),
               "cache_len": cache_len,
               "k_lins": [region(kv.k, li) for li in range(n_layers)],
               "v_lins": [region(kv.v, li) for li in range(n_layers)]}
        if kv.quantized:
            win["ks_lins"] = [region(kv.k_scale, li)
                              for li in range(n_layers)]
            win["vs_lins"] = [region(kv.v_scale, li)
                              for li in range(n_layers)]
        win["v"] = torch.zeros_like(win["k"])
        steps_valid = torch.arange(t, device=self.device)
        pf_toks = pf_pos = None
        if p_rows:
            pfd = views[pf_part].view(4, t, p_rows)
            pf_toks, pf_pos = pfd[0], pfd[2]
            # A no-op block's sink slot reads the last slot's region.
            pc = min(psl, s - 1)

            def slot_ctx(cache, li):
                return cache[li].view(s, -1, cache.shape[-1])[pc, :ctx_pad]

            win["pk"] = torch.zeros((n_layers, t, p_rows, kv.kv_heads,
                                     kv.head_dim), dtype=acc_dtype,
                                    device=self.device)
            win["pv"] = torch.zeros_like(win["pk"])
            win["pf"] = {
                "chunk_start": start, "valid_len": n,
                "k_ctx": [slot_ctx(kv.k, li) for li in range(n_layers)],
                "v_ctx": [slot_ctx(kv.v, li) for li in range(n_layers)]}
            if kv.quantized:
                win["pf"]["ks_ctx"] = [slot_ctx(kv.k_scale, li)
                                       for li in range(n_layers)]
                win["pf"]["vs_ctx"] = [slot_ctx(kv.v_scale, li)
                                       for li in range(n_layers)]
            last_t, last_j = (n - 1) // p_rows, (n - 1) % p_rows
        h_last = None
        steps = []
        for step in range(t):
            win["step"] = step
            win["valid"] = (steps_valid < step)[None, :].expand(s_pad, t)
            fwd_tok, fwd_pos = tokens, positions + step
            if p_rows:
                win["pf"]["positions"] = pf_pos[step]
                fwd_tok = torch.cat([tokens, pf_toks[step]])
                fwd_pos = torch.cat([fwd_pos, pf_pos[step]])
            h, win = decode_forward(
                self.params, self.model_cfg, kv, fwd_tok, fwd_pos, None,
                cache_len + step, None, ctx_pad=ctx_pad,
                inv_freq=self.inv_freq, inv_freq_local=self.inv_freq_local,
                win=win)
            if p_rows:
                if step == last_t:
                    h_last = h[s_pad + last_j:s_pad + last_j + 1]
                h = h[:s_pad]
            tokens = draw(logits_from_hidden(self.params, self.model_cfg, h),
                          step)
            steps.append(tokens)
        all_toks = torch.stack(steps)                          # [T, s_pad]

        # ONE append for the whole window (the chunk's rows too).
        win_k, win_v, flat_all = win["k"], win["v"], flat_dev
        if p_rows:
            win_k = torch.cat([win_k, win["pk"]], dim=2)
            win_v = torch.cat([win_v, win["pv"]], dim=2)
            flat_all = torch.cat([flat_dev, pfd[3]], dim=1)
        append_window_kv(kv, win_k, win_v, flat_all)
        window = finish(all_toks, p_rows=p_rows)

        pf_tok = None
        if p_rows:
            # The chunk's prompt tokens count; when it ends the prompt,
            # its first token is sampled as the standalone prefill does,
            # after the lanes' scatters (the slot is never a lane).
            update_counts(self.counts,
                          torch.full_like(pfd[1], psl).reshape(-1),
                          pfd[1].reshape(-1))
            if pf_chunk is not None and pf_chunk.is_last:
                slot_t = lane_slots.new_full((1,), psl)
                min_act = torch.full(
                    (1,), seq_p.num_output_tokens
                    < seq_p.request.sampling.min_tokens,
                    dtype=torch.bool, device=self.device)
                logits_p = logits_from_hidden(self.params, self.model_cfg,
                                              h_last)
                tok_p = sample_step(logits_p,
                                    self._sampling(slot_t, min_act),
                                    self.counts[psl:psl + 1], self.eos_mask,
                                    greedy_only=greedy,
                                    generator=self.generator,
                                    noise=self._noise(
                                        slot_t, slot_t.new_full(
                                            (1,), start + n),
                                        [seq_p], greedy))
                update_counts(self.counts, slot_t, tok_p)
                self.last_toks[psl:psl + 1] = tok_p
                pf_tok = HostCopy(tok_p)
        window.pf_seq = pf_chunk.seq if pf_chunk is not None else None
        window.pf_is_last = bool(pf_chunk is not None and pf_chunk.is_last)
        window.pf_tok = pf_tok
        return window

    def _paged_steps(self, tokens, positions, cache_len, tables, flat,
                     ctx_pad, draw) -> torch.Tensor:
        """The paged layout's window: T per-step decode forwards over the
        lanes' block tables, each appending its own K/V (the JAX runner's
        scan over `decode_forward(attn_impl="ref")`); tokens [T, s_pad]
        from `draw(logits, step)`."""
        steps = []
        for step in range(flat.shape[0]):
            h, _ = decode_forward(
                self.params, self.model_cfg, self.kv, tokens,
                positions + step, tables, cache_len + step, flat[step],
                ctx_pad=ctx_pad, inv_freq=self.inv_freq,
                inv_freq_local=self.inv_freq_local, attn_impl="ref")
            tokens = draw(logits_from_hidden(self.params, self.model_cfg, h),
                          step)
            steps.append(tokens)
        return torch.stack(steps)

    def sync_window(self, window: DecodeWindow) -> Dict[str, List[int]]:
        """A window's tokens per request id; waits for that window alone.
        A completed mixed-prefill chunk's sequence gets a list whose
        last entry is its first token."""
        t0 = time.perf_counter()
        host = window.toks.numpy()                            # [T, s_pad]
        pf_tok = None
        if window.pf_tok is not None:
            pf_tok = int(window.pf_tok.numpy()[0])
        dt = time.perf_counter() - t0
        self.decode_sync_time += dt
        _prof.emit("window.fetch", dt, {
            "steps": window.num_steps, "lanes": len(window.seqs)})
        out = {seq.request.request_id:
               host[:, window.lanes[seq.request.request_id]].tolist()
               for seq in window.seqs}
        if pf_tok is not None:
            out[window.pf_seq.request.request_id] = \
                [0] * (window.num_steps - 1) + [pf_tok]
        return out

    def run_decode_multi(self, seqs: List[Sequence], num_steps: int
                         ) -> Dict[str, List[int]]:
        """One window, waited for (the unpipelined loop)."""
        return self.sync_window(self.start_decode_window(seqs, num_steps))

    def run_decode(self, seqs: List[Sequence], return_logits: bool = False):
        """One decode step for `seqs` (each from its last token), waited
        for: {request id: token} (+ {request id: f32 [V] logits} with
        return_logits). The host-masked guided path samples from the
        logits itself, so the step takes the argmax and draws no noise;
        its K/V append and counts go as in a window."""
        t0 = time.perf_counter()
        with self.sync_guard():
            window = self._window(seqs, 1, None, None, single=True)
        self.decode_device_time += time.perf_counter() - t0
        self.decode_steps += 1
        self._note_kernel_builds()
        toks = window.toks.numpy()[0]
        out = {rid: int(toks[lane]) for rid, lane in window.lanes.items()}
        if not return_logits:
            return out
        lg = window.logits.numpy()
        return out, {rid: lg[lane] for rid, lane in window.lanes.items()}

    # ------------------------------------------------------------------
    # Warm-up: no-op dispatches of the keys a cell may meet
    # ------------------------------------------------------------------
    def warm_prefill_siblings(self) -> int:
        """Dispatch every batch-size sibling of the prefill keys already
        seen as a no-op (every row a pad row on the sink slot:
        nothing is written), then the smaller lane buckets and the mixed
        variants of the windows seen (`warm_decode_buckets`,
        `warm_mixed_windows`), so a measured cell meets no key for the
        first time however its admission waves fall. Returns the number
        of keys added."""
        done = 0
        budget = self.cfg.max_num_batched_tokens
        for (_, t_pad, ctx_pad, greedy, rl, guided, _g) in sorted(
                self._prefill_keys):
            # A (b, t_pad) group's chunks each hold > t_pad / 2 tokens,
            # and the scheduler admits within the token budget: no larger
            # batch is ever dispatched.
            # (The JAX runner pads the batch to a power of two and warms
            # those; the port runs the exact batch, so it warms each.)
            max_b = min(max(1, budget // max(1, t_pad // 2 + 1)),
                        max(self.num_slots, 1))
            for b in range(1, max_b + 1):
                key = (b, t_pad, ctx_pad, greedy, rl, guided,
                       self._grows_now(guided))
                if key not in self._prefill_keys:
                    self._prefill([], warm=key).tokens.numpy()
                    done += 1
        done += self.warm_decode_buckets() + self.warm_mixed_windows()
        self._note_kernel_builds()
        return done

    def _grows_now(self, guided: bool) -> int:
        """A warm-up's row bucket: the tables' current one (a guided
        dispatch never meets an older one again), 0 unguided."""
        return self._grows_bucket if guided else 0

    def _warm_window(self, s_pad: int, ctx_pad: int, t: int, p_rows: int,
                     greedy: bool, guided: bool, _grows: int) -> None:
        """A no-op window at this key; a guided one runs on the current
        tables and applies no queued reset."""
        self._window([], t, None, None, warm=(
            s_pad, ctx_pad, p_rows, greedy, guided)).toks.numpy()

    def warm_decode_buckets(self) -> int:
        """For every window key seen, the same window at every lane
        bucket and every length the engine dispatches there (under
        adaptive windows the doubled and halved ones too, as the JAX
        runner's warm-up adds them), so a cell's shrinking tail, or a
        wave the warm-up never held together, meets no new key. (The
        JAX runner warms the smaller buckets only: a warm-up wave whose
        requests end inside one window never reaches its own bucket.)
        A length outside that set (minimum progress's one step) is
        warmed as it is at every bucket."""
        done = 0
        normal = self.cfg.window_lengths()
        for (s_pad, ctx_pad, t, p_rows, greedy, guided, _g) in sorted(
                self._window_keys):
            gd = (guided, self._grows_now(guided))
            for b in self.cfg.decode_buckets:
                for t_b in (self.cfg.window_lengths(b) if t in normal
                            else (t,)):
                    # Another T needs its own chunk geometry: the plain
                    # window here, warm_mixed_windows adds its mixed
                    # variants.
                    for ctx in self._ctx_at_t(ctx_pad, t, t_b):
                        key = (b, ctx, t_b, p_rows if t_b == t else 0,
                               greedy, *gd)
                        if key not in self._window_keys:
                            self._warm_window(*key)
                            done += 1
        return done

    def _ctx_at_t(self, ctx_pad: int, t: int, t_b: int) -> List[int]:
        """The context buckets a window of t_b steps can take where one
        of t steps took ctx_pad: ctx_pad == ctx_bucket(m + t) bounds the
        window's length m (>= 2), and m + t_b falls in the buckets that
        range shifted by t_b - t covers."""
        lo_len = ctx_pad // 2 + 1 if ctx_pad > self.ctx_bucket(1) \
            else 2 + t
        out = [self.ctx_bucket(max(1, lo_len + t_b - t))]
        hi = self.ctx_bucket(max(1, ctx_pad + t_b - t))
        while out[-1] < hi:
            out.append(self.ctx_bucket(out[-1] + 1))
        return out

    def warm_mixed_windows(self) -> int:
        """The mixed variants of every plain window key seen: the chunk
        rows a step of a 256-token chunk, of a full chunk and of every
        chunk length dispatched so far (the JAX runner takes the first
        two only: a cell of shorter prompts then meets its chunks' rows
        first inside the cell)."""
        if not self.cfg.mixed_prefill or self.attn_impl != "linear":
            return 0
        done = 0
        chunk_cap = max(16, self.cfg.max_chunk_tokens)
        lengths = self._chunk_lens | {256, chunk_cap}
        for (s_pad, ctx_pad, t, p0, greedy, guided, _g) in sorted(
                self._window_keys):
            gd = (guided, self._grows_now(guided))
            if p0:
                continue
            p_want = {_round_up_pow2(-(-n // t), 8, 512)
                      for n in lengths if n <= 128 * t}
            for p_rows in sorted(p_want):
                key = (s_pad, ctx_pad, t, p_rows, greedy, *gd)
                if key not in self._window_keys:
                    self._warm_window(*key)
                    done += 1
        return done
