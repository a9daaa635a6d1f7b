#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (ferrum_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, in order, each printing JSON lines:
  env        nvidia-smi name/power limit, torch / CUDA / nvcc versions
  build      nvcc build of every kernel source (seconds)
  kernels    each Hopper kernel against its plain PyTorch version at the
             shapes of the served paths (llama-3.1-8b projections,
             qwen3-30b-a3b projections and expert stacks; the unwired
             w4a8tl_prefill_mcache at the llama prefill shapes, beside
             w4a8tl_prefill on the same weights and activations): exact
             equality for the integer-dot kernels, one bf16 step for the
             two w4a16 ones; kernel / plain / library times (CUDA events)
             and the card's bound for the same work, each decode-size
             w4a16 case with its launch plan; then exact cases of their
             own: one-hot x for the w4a16 kernels at prefill and decode
             sizes (m = 1 .. 64, K = 14336, forced K splits starting
             mid-group; 8 and 256 grouped rows over 3 and 128 experts),
             bf16 and f32 scales, for the two
             two-level prefill kernels ragged m, the qwen3 sites, the
             int32 range at K = 14336 and one-hot xq, for the two two-level
             decode kernels one-hot xq at m = 1 .. 64, the int32 range,
             K = 256, one, three (a split starting mid-group) and the
             most K splits, N = 192 (64-column tiles) and the wrap case
             at one and the most splits, the split-K counters zero after
             each, for the float-scale decode kernel (its timed cases
             with their plans) one-hot xq at m = 1 .. 64, the integer
             range at K = 14336, gpt 1 and 2, forced K splits (more than
             the TPU steps too) and N = 192, bf16 and f32 scales, the
             counters zero after each, for the all-experts bmm one-hot
             xq on shared and on
             each expert's own rows (3 and 128 experts; t = 1 .. 64),
             the int32 range, K = 256 and N = 192, each with its launch
             plan, for the
             grouped two-level kernel at 128-row tiles one-hot xq, one
             expert, four experts, ragged rows and K = 256, and at decode
             sizes (the expert-grid loop, each with its plan) one-hot xq
             at 8 / 120 / 256 rows, experts over BM rows, one expert
             holding all rows and K = 256; kv_append_rows one array and
             K with V in one launch (bf16, f32, int8), the pair timed
             beside an empty kernel's launch, and K with V at a decode
             window's size (lane A at bucket 32 with a 256-token chunk
             riding it: 16384 rows x 2 KiB each), the summary's row,
             and the same window as lane F appends it (int8 K and V with
             their f32 scale planes in one launch); a paged decode step
             as lane G appends it (32 layers x 32 lanes at scattered
             blocks of its pool, pad lanes dropped), bf16 K and V and
             the int8 four arrays;
             kv_append_pages one array (bf16 / f32 / int8) and its pairs
             form at a batched prefill's size (2048 rows x 2 KiB, 32
             layers, scattered and dropped ids) with one to four arrays
             (bf16 K; K and V; int8 K and V; int8 K and V with their f32
             scale planes), each beside one launch an array -- K and V
             in one launch the summary's row; for lane I
             (gemma-3-12b), rows 1 and 2 exact at its four projections
             (K = 3840, 4096, 15360) at m = 32 and 2048 beside
             torch._int_mm, each decode case with its plan, and a line a
             size summing the layer; rows 3 and 4 at its 4 KiB rows
             (F = 2048: a paged decode step and a batched prefill's
             pages, bf16 and int8 with its scale planes)
  sampling   sample_step's candidate pick (topk_ids: lower ids first among
             ties, as jax.lax.top_k) at 32 slots x 128256 against a full
             stable sort, timed beside both and torch.topk
  attention  the bf16 decode and prefill attention at the served shapes
             against the same function on the CPU, which takes every
             product and sum in f32 (the JAX package's precision)
  attention_window  the same at lane I's shapes (16 / 8 heads of 256)
             with its sliding window of 1024, without and with a softcap
             of 50, a bf16 cache and an int8 one; the window changes
             every case's output
  checkpoint (lane H) two local HF checkpoint directories written from a
             seed into a temporary directory (removed after) with the
             port's safetensors writer: H1 llama-3.1-8b at full width,
             4 layers, GPTQ int4 g128 (layers 1 and 3 act-order), f16
             scales, bf16 embed / norms / lm_head, two shards, llama3
             rope scaling, a generation_config eos list and a
             tokenizer.json in Llama-3's form (byte alphabet, 300 merges
             trained here, its split regex, <|begin_of_text|> /
             <|eot_id|>, TemplateProcessing); H2 qwen3-30b-a3b at full
             width, 2 layers, 128 GPTQ experts, a Qwen2-form tokenizer.
             For each: the card load equals the CPU load moved to the
             card, leaf for leaf and bit for bit (load seconds, host
             peak RSS, the card's peak memory); an engine built from the
             directory with the default EngineConfig serves 32 text
             prompts and one alone twice (every token in range, the
             solo tokens repeat and equal the batch's),
             every kernel of the lane's path launched in the 32 and no
             other; the logits check on the loaded weights (lane A's
             tolerance); the tokenizer round-trips the prompts and
             generation_config.json's eos ids reach the model config.
             H1 also serves guided requests through engine.infer on its
             tokenizer.json, under the no-sync check: a strict json
             schema and a regex over the corpus words (multi-character
             tokens), each in its language and the device-FSM path's
             tokens equal to the host-masked path's ("H1 ... guided")
Then, for each of five lanes at full width and depth (lane B at 2 of
its 48 layers, C at 4 of 32, D at 4 of 48, for the run's time: see
LANES) -- A
llama-3.1-8b
and B qwen3-30b-a3b with two-level w4a8 weights (serve, logits;
serve_moe, logits_moe), C llama-3.1-8b float-scale w4a8
(EngineConfig(w4a8_two_level=False); serve_fs, logits_fs, profile_fs),
D qwen3-30b-a3b w4a16 (EngineConfig(w4a8=False); serve_moe_w4a16,
logits_moe_w4a16, profile_moe_w4a16), C and D on the same random weights
with the two-level fields dropped, the form an int4 checkpoint loads as,
and E llama-3.1-8b two-level in the group-dot decode mode
(EngineConfig(w4a8_gd="all"); serve_gd, logits_gd) on A's weights
(B's and E's profile phases are left out to keep the run inside its
time):
  serve      EngineBuilder(model, random int4 weights, seed 0) with
             bench.py's engine settings (lane buckets 1, 8, 32; T = 32 at
             bucket 1, 8 elsewhere; the pipelined loop, mixed prefill and
             refill-first, the defaults), 32 concurrent greedy 256/128
             requests; launch counts of every kernel over that run, each
             of the lane's kernels required, every other kernel required
             to stay at 0; windows by bucket, mixed windows, the most
             windows in flight, kv_append_rows launches a window; the
             prompt of request 0 alone before the run and (but on E)
             again after it gives the same tokens; E's solo request
             must give A's tokens (its decode kernel computes A's
             function bit for bit). Lane A's run dispatches
             under torch.cuda.set_sync_debug_mode("error"): a host sync
             of the stream inside a window or prefill dispatch fails it
  serve_c1, serve_c4 (B: serve_moe)  the same with 1 and 4 requests:
             1- and 8-lane windows (the MoE sort route: moe_grouped's
             <= 256-row loop must launch, moe_bmm need not); lane A's
             bench cells serve 1 and 4 requests instead
  window_check (A)  a T = 8 window through decode_forward's window form
             and one append against 8 per-step calls from the same state
             (8 lanes, 256-token prompts): hidden states within one bf16
             step on 95% of the token rows and 5e-2 of the scale, the
             cache's other rows unchanged, layer 0's window rows equal
  logits     one prefill + 4 decode steps at full width, kernels vs plain
             versions, both on the card; the MoE runs decode two steps
             at 32 lanes (B: all-experts route; D: 256 grouped rows) and
             two at 1 lane (sort + grouped route: 8 rows, so B must
             launch moe_grouped's decode-sized loop); the plain run decodes
             the kernel run's tokens. A, B, E: every logit within 1e-3
             of the logit scale (the kernels are exact). C, D: 99% of the
             token rows within 2e-2 of it at the lane's depth (one-bf16-
             step GEMM differences can move a whole row on random
             weights), also measured at 1, 2, 4 (and C: 8) layers
  profile    (A, C, D) torch.profiler over 32 concurrent 256/16
             requests on the same engine: device time by kernel, device
             busy share
  bench      (A) bench/bench_engine.py's run_bench on the same engine:
             cells c = 1 / 4 / 32 with 1 / 4 / 32 requests of 256/128,
             two repeats each (a warm-up before each cell's first);
             every cell and repeat completes its requests without error,
             meets no program key for the first time (the runner's
             compile audit), runs decode steps, and its decode dispatch,
             decode sync and prefill times are >= 0 and sum to no more
             than its wall time; each cell carries its stats over the
             repeats; kernels 1-4 launch during the cells, no other
  profile_sink (A) utils/profile.py's sink at detail debug, sample rate
             1.0, with a memory sink, over one extra cell (32 x 256/32):
             every line schema 2 with a known kind and status, one
             window.dispatch per window dispatched, one engine.compile
             per key the audit counted, an engine.memory line with the
             card's bytes in use; tools/analyze_profile.py reads the file
  server     (A) the port's OpenAI-compatible server (server/app.py) in
             this process on the same engine, on a free localhost port,
             spoken to with http.client only: 8 concurrent greedy chat
             completions (4 streaming, 4 not; usage equal to the chunks,
             each stream well-formed, the streaming and non-streaming
             texts of each prompt compared and counted); each of 2
             prompts alone non-streaming, streaming and through
             engine.infer on the rendered ids (the three texts and the
             usage counts equal); /v1/completions with a stop string
             from the greedy text (finish "stop", the text cut before
             it); an echo + logprobs request of 256 prompt tokens (its
             logprobs equal engine.infer's, and those a teacher-forced
             forward of the plain versions on the card within lane A's
             tolerance, argmax equal where the plain top two are
             further apart than the largest difference); a seeded
             sampled request twice (the same text); bench-serve at c = 1
             and 4 (no failed request); engine.abort on a long request
             (its last chunk says abort, running_requests back to 0).
             Kernels 1-3 must launch and none off lane A's path; the
             counts go into the summary as "A server". HTTP times beside
             engine.infer's, with the card's name and power limit
  guided     (A) guided decoding on the same engine, every dispatch
             under the no-sync check: over HTTP guided_regex,
             guided_choice, guided_json, a strict json_schema,
             json_object and tool_choice="required", each streaming and
             not (the text in its DFA's language or a live prefix at
             length; a strict schema validated or the server's 400; the
             SSE outcome equal to the non-streaming one; completions
             texts equal to engine.infer's); 8 requests, 4 guided, in
             bucket-8 windows, each text equal to the request's alone;
             the device-FSM path's tokens equal to the host-masked
             path's over three patterns, a refused FSM served on the
             host path; a seeded sampled guided request twice (the same
             text); guided_mask_rows / guided_advance on the card equal
             to the CPU on the registered tables; kernels 1-3 launch and
             none off A's path ("A guided"). Printed beside them: the
             FSM build seconds at vocab 128256, the table bytes, TPOT
             p50 guided vs plain at c = 1 and the kernels a guided step
             and window add (torch.profiler) with their device time
  cli        `python -m ferrum_tpu_torch bench random:qwen3-0.6b`
             (dense bf16, the JAX CLI's random: weights, 4 x 256/32)
             twice, each in its own process: "plain" through decode
             windows, "spec" with `--spec-draft random:qwen3-0.6b
             --spec-k 4` (speculative rounds). Both start when lane A's
             phases end and draw their weights on the host while lanes
             B-E run; their benches run one after the other once the
             lanes are done: exit code 0, 4 requests completed without
             error, jax never imported; plain ran decode windows and no
             round, spec ran rounds (spec.stats in its line); the weight
             draws' and the process's seconds
Lanes F and G (with G's offload form), on lane A's weights once its
phases are done:
  serve_int8_prefix (F)  kv_dtype int8, the linear layout with the prefix
             store: two waves of 16 requests, each a shared 192-token
             prefix and 64 own tokens, 64 generated; wave 2's hits and
             reused tokens counted and its prefill tokens down by them,
             one kv_append_rows launch a window carrying four arrays;
             a new request's first-step logits with the prefix restored
             from the store against the same request prefilled whole
             in the same chunks and against the plain path (lane A's
             tolerance); the share of wave 2's greedy tokens equal to
             the same engine's with no store
  serve_paged (G)  the paged layout with the prefix cache on a pool of
             150 blocks: the same waves, every request complete, >= 1
             preemption (recompute), shared prefix blocks, every
             dispatch under the no-sync check; the share of wave 1's
             greedy tokens equal to a pool where nothing is preempted
             (the offload form's wave 1)
  serve_paged_offload (G offload)  the paged layout with the prefix
             cache and a 64 MiB host offload tier (bf16 KV, the int8
             strategy), the pool autosized: wave 1, the release waited
             for, every cached block evicted (each spills), wave 2:
             >= 6 saves and restores (the shared prefix's 192 / 32
             blocks), every wave-2 request reusing the prefix, rows 1-4
             launched and no other kernel, the `kv_block_io` key in the
             compile audit, a block group kept with the `none` strategy
             back bit for bit on the card; printed: the share of wave
             2's greedy tokens equal to lane G's, the ms a block group
             to spill (read + compress) and to restore (decompress +
             upload) beside the device ms of prefilling the prefix (its
             kernels' time, torch.profiler). Not under the no-sync
             check (a spill's read is a declared sync)

Lane I, after the cli phase, on the card alone: gemma-3-12b (the text
config of google/gemma-3-12b-it through the port's config mapping) at
full width, 8 of its 48 layers (layer 5 global, seven local with
a window of 1024), random bf16 weights drawn on the card (seed 0) ->
quantize_model_params -> the default EngineConfig at max_model_len 2048
(two-level w4a8, the paged layout with the prefix cache):
  logits_gemma3  one 1536-token prompt through a batched prefill and 16
             decode steps, kernels vs plain versions: every logit within
             1e-3 of the logit scale; the plain prefill with the window
             widened past the prompt equals it below position 1024 and
             differs at every position from 1024 on
  serve_gemma3, profile_gemma3  32 x 256/128 (every request 128 tokens,
             rows 1-4 launched and no other kernel; TTFT, TPOT), then
             the profile phase (busy share)
  long_gemma3  4 requests of 1536/64, alone and batched, on the paged
             layout and on the linear one: the greedy tokens equal
             across the four runs

Lane J, after lane I: speculative decoding. Target qwen3-8b at full
width, 4 of its 36 layers; draft qwen3-0.6b at full width, 4 of its 28
(both cut for the run's time); two-level w4a8 random weights drawn on
the card (seed 0); the default EngineConfig with spec_num_tokens = 4
(rounds: K + 1 draft steps at m = 32, one verify pass at m = 160 with
its K/V rows in one kv_append_rows launch):
  verify_logits_spec  one round's verify pass (8 sequences, positions
             250..254, off the page grid) through the kernels and the
             plain versions from the same cache: every logit within 1e-3
             of the logit scale, the appended rows equal
  serve_spec  the plain engine at 32 and 8 x 256/64, the spec engine at
             32 x 256/64 under the no-sync check (and a seeded sampled
             request twice: the same tokens), a spec engine with draft =
             target at 8 x 256/64: every request 64 tokens, rows 1-4
             launched and no other kernel; tok/s, TTFT p50, TPOT p50 and
             the acceptance rate of each run
  lane_j     each spec stream against the argmax of a teacher-forced
             plain forward: a token may differ only where the plain top
             two logits are within 1e-3 of the logit scale (counted);
             the plain engine's streams likewise, for information
The kernel phase holds rows 1-4 at lane J's shapes: w4a8tl_decode at the
draft's projections at m = 32, w4a8tl_prefill at the target's at m =
160, kv_append_rows at the verify's 12 layers x 32 lanes x 5 rows and a
draft step's 4 x 32, off the page grid, and kv_append_pages at the
target's prompt prefill (12 layers x 64 pages), each exact.

Lane K, after lane J: the engine's remaining settings. qwen3-30b-a3b at
full width, 2 of its 48 layers (lane B's depth), random two-level int4
weights drawn on the card (seed 0), EngineConfig()'s defaults (adaptive
windows, the paged layout with the prefix cache, KV autosized) with
squeeze_embeddings, fuse_sites="qkv,gate_up,moe", slot_slack=2 and the
priority scheduler writing its trace to a temporary file:
  logits_k   a 256-token prefill (its last row's logits) and decode
             steps at 32 and 1 lanes through the kernels, the plain
             versions and a fuse_proj=False build of the same weights:
             all three equal bit for bit (int8 table, float-scale int4
             lm_head, fused expert gate|up)
  serve_k    run_cell at 32 concurrent 256/64 (64 requests) and at 4:
             no program key met inside a cell; windows by length, with
             16-step ones at <= 4 lanes and 4-step ones while requests
             wait; lane K's kernels launch (w4a8_decode for the
             lm_head) and no other
  slack_k    4 of 32 decoding requests aborted with the loop held and 4
             new ones submitted: >= 1 admission while a release waits
  priority_k 16 requests of priority 0 then 4 of priority 1: the trace,
             read back, admits the 4 first
  lane_k     the card's memory with and without the squeeze (weights,
             table and lm_head bytes, after the build, peak)
The kernel phase holds lane K's cases: row 6 (the squeezed float-scale
lm_head) and row 1 (a two-level one) at K = 2048, N = 151936, m = 1 and
32, rows 11 and 10 on the fused gate|up stack (N = 1536; bmm t = 32,
grouped 256 and 16384 rows), each exact; and dense_moe: one
qwen3-30b-a3b layer with bf16 expert stacks through ops/moe.py's dense
route at 32 and 256 tokens, within two bf16 steps of the same function
on the CPU. The cli phase's plain run serves with FERRUM_SQUEEZE_EMBED=1
(its tied table int8, in its line) and both runs with
FERRUM_ADAPTIVE_WINDOWS=0; lanes A-G state adaptive_windows=False, as
bench.py does.

Lane L, after lane K: LoRA adapters. llama-3.1-8b at full width, 4 of
its 32 layers, random two-level int4 (seed 0) drawn on the card; a PEFT
adapter (r = 16, lora_alpha = 32, all seven projections of every layer,
bf16 A / B from seed 1) written with the port's safetensors writer into
a temporary directory, loaded with `load_lora_adapter` and applied
before the build (`apply_lora`), `EngineConfig()`'s defaults; a B = 0
adapter beside it:
  serve_lora the base engine, the adapter engine and the B = 0 one at
             32 x 256/64: every request 64 tokens, rows 1-4 launched and
             no other kernel, the adapter engines' projections split
             (LoRA over a two-level base, nothing fused); tok/s, TTFT
             p50, TPOT p50 of each
  logits_lora  a 256-token prefill and decode steps at 32 and 1 lanes
             on the adapter engine's params, kernels vs plain versions:
             every logit within 1e-3 of the logit scale
  lane_l     (each engine serves a warm-up wave of 4 x 256/4 first)
             the B = 0 engine's tokens equal the base engine's bit for
             bit, the adapter moves some, and the base params keep their
             split linears through both builds
The kernel phase holds rows 1 and 2 at the split projections (q, o
4096 x 4096; k, v 4096 x 1024; gate, up 4096 x 14336; down 14336 x
4096) at m = 32 and 2048, exact, with a line a size summing a layer's
seven (`lora_rows`).

Then the kernel summary line, the nvidia-smi line, and as the last line
{"ok": true, "device": {...}}. Any failure raises and exits nonzero
with no result line; so does a machine without CUDA. Every phase line
carries `t_s`, the seconds since the script started.
"""

from __future__ import annotations

import gc
import itertools
import json
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
INT8_OPS_PER_S = 1979e12         # H100 SXM dense int8 tensor-core peak
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor-core peak
PAGE = 32
OOB_SENTINEL = 1 << 30
PREFILL_ROWS = 2048              # one batched prefill's rows (llama)
# llama-3.1-8b projection shapes (K, N) with fused q|k|v and gate|up.
GEMM_SHAPES = {"qkv": (4096, 6144), "o": (4096, 4096),
               "gate_up": (4096, 28672), "down": (14336, 4096)}
DECODE_M = (1, 32, 64)
PREFILL_M = (256, 2048, 8192)
SERVE_DECODE_M = 32              # decode lanes of the serve phase
SERVE_PREFILL_M = 2048           # one batched prefill of the serve phase
# qwen3-30b-a3b expert stacks: E experts, (K, N) per projection; gate and
# up read one shared row block, down each expert's own rows.
MOE_E, MOE_TOPK = 128, 8
MOE_SHAPES = {"gate": (2048, 768), "up": (2048, 768), "down": (768, 2048)}
BMM_T = (16, 32, 64)
# t = 1, 15 and 32 decode (the expert-grid loop at <= 256 rows), 256- and
# 2048-token prefill.
GROUPED_A = (8, 120, 256, 2048, 16384)
SERVE_BMM_T = 32                 # decode lanes of the MoE serve phase
SERVE_GROUPED_A = 16384          # one batched MoE prefill: 2048 tokens x 8
KV_PATH = ("kv_append_rows", "kv_append_pages")
LLAMA_PATH = ("w4a8tl_decode", "w4a8tl_prefill") + KV_PATH
MOE_PATH = LLAMA_PATH + ("moe_bmm", "moe_grouped")
# qwen3-30b-a3b dense projections (K, N): fused q|k|v and o.
QWEN_SHAPES = {"qkv": (2048, 5120), "o": (4096, 2048)}
QWEN_M = (1, 32, 64, 2048)
GROUPED_W4A16_A = (8, 256, 2048, 16384)   # decode t=1, t=32; prefills
SERVE_GROUPED_W4A16_A = 16384
# The lanes. `path`: kernels that must launch (every other kernel must
# not). `lanes`: the logits phase's decode lanes.
# `tol`, `min_rows`: the logits check at full depth -- the share of token
# rows whose every logit is within `tol` of the logit scale; `depths`:
# the depths it is also measured at (None = the model's depth).
# `profile`: whether the lane's profile phase runs (B's and E's are left
# out to keep the run inside its time). `small`: the lane also serves 1
# and 4 requests. `bench`: the lane's engine runs the bench,
# profile_sink and cli phases. `sync_check`: its 32-request serve dispatches under
# the no-sync check. `window_check`: the window form is checked against
# the per-step form at its width. `solo_as`: the lane whose
# solo request's tokens this lane's must equal. `layers`: a depth cut
# (the model's first layers): lane D, the slowest lane on a busy host
# (its sort-route decode makes ~1.06M launches per profile window at 48
# layers: 560 of 1043 s of one run on an H100 with a slow host), ran 12
# of its 48 layers so the run stayed well inside its 1200 s. Since
# lanes F and G joined the run (993.7 s with B at 48; 979.2 s with B at
# 24; 1077.6 s on a slow host with B at 12 and C at 16), lane B runs 6
# of its 48 layers; C keeps all 32 (its float-scale logits check holds
# kernels 5 and 6 at full depth) and E all 32 (its solo request must
# give A's tokens). Lane H's checkpoints joined the run next (1047.1 s
# before them, on a slow host): lane D runs 6 of its 48 layers, its
# logits measured at 1, 2 and 4 layers and its depth. The guided phase
# came next (974.7 s on an H100; 1184.8 s on an H100 with a host ~22%
# slower in every phase; 1160.5 s on such a host with C at 16 and B, D
# at 4 layers): lane C went to 8 of its 32 layers, B and D to 4 of
# their 48 (at 2 layers D's logits check fails: 97.5% of the rows
# within tolerance against 99%), and the bench phase to two repeats a
# cell. Lane I
# (gemma-3-12b) came next: 1078.1 s on an H100 whose host ran lane A's
# serve ~17% slower than usual, so C runs 4 of its 32 layers (its logits
# measured at 1 and 2 layers and its depth: 99.6% of the rows within
# tolerance at 4 layers in that run) and B 2 of its 48 (its logits
# check is exact at any depth). Before lanes G's offload form and L
# joined (930.7 s): lane A no longer serves 1 and 4 requests apart from
# its bench cells, which serve the same 256/128 requests at c = 1 and 4
# twice each on the same engine (27 s), and lane E's solo request runs
# once, before its serve, where its tokens must equal A's (12 s); lane
# A keeps the repeat.
LANES = (
    dict(name="A llama-3.1-8b w4a8 two-level", model="llama-3.1-8b",
         mode={}, float_scale=False, path=LLAMA_PATH,
         lanes=(1, 1, 1, 1), tol=1e-3, min_rows=1.0, depths=(None,),
         tag="", profile=True, small=False, sync_check=True,
         window_check=True, bench=True, fg=True),
    # 32 lanes: the all-experts route; 1 lane: sort + grouped.
    dict(name="B qwen3-30b-a3b w4a8 two-level", model="qwen3-30b-a3b",
         layers=2, mode={}, float_scale=False, path=MOE_PATH,
         lanes=(32, 32, 1, 1), tol=1e-3, min_rows=1.0, depths=(None,),
         tag="_moe", profile=False, small=True),
    dict(name="C llama-3.1-8b float-scale w4a8", model="llama-3.1-8b",
         layers=4, mode={"w4a8": True, "w4a8_two_level": False},
         float_scale=True,
         path=("w4a8_decode", "w4a16_gemm") + KV_PATH,
         lanes=(1, 1, 1, 1),
         tol=2e-2, min_rows=0.99, depths=(1, 2, None), tag="_fs",
         profile=True),
    # 32 lanes: 256 grouped rows a step; 1 lane: 8.
    dict(name="D qwen3-30b-a3b w4a16", model="qwen3-30b-a3b", layers=4,
         mode={"w4a8": False}, float_scale=True,
         path=("w4a16_gemm", "moe_grouped_w4a16") + KV_PATH,
         lanes=(32, 32, 1, 1),
         tol=2e-2, min_rows=0.99, depths=(1, 2, 4, None),
         tag="_moe_w4a16",
         profile=True),
    dict(name="E llama-3.1-8b w4a8 two-level group-dot",
         model="llama-3.1-8b", mode={"w4a8_gd": "all"}, float_scale=False,
         path=("w4a8tl_gd_decode", "w4a8tl_prefill") + KV_PATH,
         lanes=(1, 1, 1, 1), tol=1e-3, min_rows=1.0, depths=(None,),
         tag="_gd", profile=False, repeat=False,
         solo_as="A llama-3.1-8b w4a8 two-level"),
)
T0 = time.perf_counter()


def emit(obj) -> None:
    print(json.dumps({**obj, "t_s": round(time.perf_counter() - T0, 1)}),
          flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


class Timer:
    """Median CUDA-event time of a callable, in device time only: the L2
    cache (50 MB) is flushed before every timed run, as a layer's weights
    are cold when the served path reaches them, and the card then spins
    (~0.5 ms) so the host has enqueued the whole call before the start
    event fires -- else the Python wrapper's host time lands inside the
    events."""

    SPIN_CYCLES = 1_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device="cuda")

    def __call__(self, fn, reps=20, warmup=3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(reps):
            self.flush_buf.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(nbytes: float, ops: float, ops_per_s: float = INT8_OPS_PER_S):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bf16_step_check(got, want):
    """(within, share differing, max abs error): every output within one
    bf16 step of the plain version, |got - want| <= 2^-7 |want| + 2^-12
    max|want| (the f32 sums run in another order than the plain
    version's float64 ones, then round to bf16)."""
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    tol = 2.0 ** -7 * w.abs() + 2.0 ** -12 * w.abs().max()
    return (bool((diff <= tol).all()), (diff > 0).float().mean().item(),
            diff.max().item())


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def make_gemm_weight(torch, k, n, gen, two_level=True):
    """Random float weight with asymmetric per-group offsets, quantized
    asymmetric (bf16 scales) and, with `two_level`, requantized two-level:
    non-uniform scales, zeros (and scales2, chan) -- the uniform bench
    init cannot catch an indexing bug."""
    from ferrum_tpu_torch.ops.quant import (make_quant_linear,
                                            requantize_two_level)
    w = torch.randn(k, n, generator=gen, device="cuda") * 0.02
    shift = (torch.rand(k // 128, 1, n, generator=gen, device="cuda")
             - 0.5) * 0.06
    w = (w.reshape(k // 128, 128, n) + shift).reshape(k, n)
    p = make_quant_linear(w, 128, symmetric=False)
    del w
    return requantize_two_level(p) if two_level else p


def int_mm_weight(torch, p):
    """The two-level int8 weight w8, column-major (torch._int_mm's
    layout): the library call's operand."""
    from ferrum_tpu_torch.ops.quant import two_level_w8
    return two_level_w8(p).to(torch.int8).t().contiguous().t()


def two_level_case(rows, timer, row, fn, plain, p, w8_cm, xq, xs):
    """One case of a two-level GEMM kernel: equal to its plain version,
    again after the timed launches (which also shows that the split-K
    scratch of the decode kernels came back zeroed every time); bound for
    its bytes and int8 ops; `torch._int_mm` on the int8 w8 as the
    library call (it takes m > 16 only)."""
    import torch
    m, k = xq.shape
    n = p.out_features
    nbytes = (p.qweight.nbytes + p.scales2.nbytes + p.zeros.nbytes
              + p.chan_scale.nbytes + xq.nbytes + xs.nbytes + 2 * m * n)
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, 2.0 * m * k * n)
    check_case(rows, row, timer, lambda: fn(xq, xs, p, torch.bfloat16),
               lambda: plain(xq, xs, p, torch.bfloat16),
               (lambda: torch._int_mm(xq, w8_cm)) if m > 16 else None,
               exact=True)


def gemm_rows(torch, timer):
    """The four two-level dense kernels at the llama-3.1-8b projections,
    each pair of one function on the same weight and activations:
    w4a8tl_decode and w4a8tl_gd_decode at decode m, w4a8tl_prefill and
    w4a8tl_prefill_mcache at prefill m."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    pairs = ((DECODE_M, (("w4a8tl_decode", qmm.w4a8tl_decode,
                          qmm.w4a8tl_plain),
                         ("w4a8tl_gd_decode", qmm.w4a8tl_gd_decode,
                          qmm.w4a8tl_gd_plain))),
             (PREFILL_M, (("w4a8tl_prefill", qmm.w4a8tl_prefill,
                           qmm.w4a8tl_plain),
                          ("w4a8tl_prefill_mcache", qmm.w4a8tl_prefill_mcache,
                           qmm.w4a8tl_plain))))
    rows = []
    for site, (k, n) in GEMM_SHAPES.items():
        p = make_gemm_weight(torch, k, n, gen)
        assert p.scales2.unique().numel() > 1 and p.zeros.unique().numel() > 1
        w8_cm = int_mm_weight(torch, p)
        for ms_list, kernels in pairs:
            for m in ms_list:
                x = torch.randn(m, k, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                xq, xs = qmm.quantize_activation_rows(x)
                for kernel, fn, plain in kernels:
                    two_level_case(rows, timer,
                                   {"kernel": kernel, "site": site, "m": m,
                                    "k": k, "n": n},
                                   fn, plain, p, w8_cm, xq, xs)
        del p, w8_cm
        torch.cuda.empty_cache()
    return rows


def group_dot_rows(torch, timer):
    """w4a8tl_gd_decode at the qwen3-30b-a3b dense projections (qkv, o) at
    decode m, and the wrap case: llama's down shape (K = 14336, N = 4096)
    at m = 32 with xq = 127, q = 15, z = 15, scales2 = 127. Every w8 is 0,
    so the result is exactly 0, while sum_g s2 * dot alone would reach
    ~3.5e9 > 2^31 before the zero correction cancels it."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    from ferrum_tpu_torch.ops.quant import QuantLinearParams
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    rows = []

    def full(shape, v, dt):
        return torch.full(shape, v, dtype=dt, device="cuda")

    k, n = GEMM_SHAPES["down"]
    g = k // 128
    wrap = QuantLinearParams(
        qweight=full((k // 2, n), 0xFF, torch.uint8),
        scales=full((g, n), 1.0, torch.bfloat16),
        zeros=full((g, n), 15, torch.int8), bias=None, in_features=k,
        out_features=n, group_size=128, scales2=full((g, n), 127, torch.int8),
        chan_scale=torch.rand(1, n, generator=gen, device="cuda") * 1e-3
        + 1e-3)
    cases = [("qwen3-30b-a3b", site, (k, n), DECODE_M)
             for site, (k, n) in QWEN_SHAPES.items()]
    cases.append(("wrap case", "down", (k, n), (32,)))
    for model, site, (k, n), ms_list in cases:
        p = wrap if model == "wrap case" else make_gemm_weight(torch, k, n,
                                                               gen)
        w8_cm = int_mm_weight(torch, p)
        for m in ms_list:
            if model == "wrap case":
                xq = full((m, k), 127, torch.int8)
                xs = torch.rand(m, 1, generator=gen, device="cuda") + 0.5
                if qmm.w4a8tl_gd_plain(xq, xs, p, torch.bfloat16).any():
                    raise AssertionError("the wrap case's exact result is 0")
            else:
                x = torch.randn(m, k, generator=gen, device="cuda",
                                dtype=torch.bfloat16)
                xq, xs = qmm.quantize_activation_rows(x)
            two_level_case(rows, timer,
                           {"kernel": "w4a8tl_gd_decode", "model": model,
                            "site": site, "m": m, "k": k, "n": n},
                           qmm.w4a8tl_gd_decode, qmm.w4a8tl_gd_plain, p,
                           w8_cm, xq, xs)
        del p, w8_cm
    del wrap
    torch.cuda.empty_cache()
    return rows


def float_scale_rows(torch, timer):
    """The dense float-scale kernels at the served shapes: w4a8_decode
    (llama projections, decode m) equal to its plain version; w4a16_gemm
    (llama projections at prefill m, qwen3 qkv / o at decode and prefill
    m) within one bf16 step of its plain version."""
    from ferrum_tpu_torch.ops.kernels.quant_matmul import (
        quantize_activation_rows, w4a8_decode, w4a8_decode_plan, w4a8_plain,
        w4a16_decode_plan, w4a16_gemm, w4a16_plain)
    from ferrum_tpu_torch.ops.quant import w4a16_weight
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    rows = []
    cases = [("llama-3.1-8b", site, k, n, "w4a8_decode", DECODE_M)
             for site, (k, n) in GEMM_SHAPES.items()]
    cases += [("llama-3.1-8b", site, k, n, "w4a16_gemm", PREFILL_M)
              for site, (k, n) in GEMM_SHAPES.items()]
    cases += [("qwen3-30b-a3b", site, k, n, "w4a16_gemm", QWEN_M)
              for site, (k, n) in QWEN_SHAPES.items()]
    for model, site, k, n, kernel, ms_list in cases:
        p = make_gemm_weight(torch, k, n, gen, two_level=False)
        assert p.scales.unique().numel() > 1 and p.zeros.unique().numel() > 1
        w_bf16 = w4a16_weight(p)
        for m in ms_list:
            x = torch.randn(m, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            row = {"kernel": kernel, "model": model, "site": site, "m": m,
                   "k": k, "n": n}
            wbytes = p.qweight.nbytes + p.scales.nbytes + p.zeros.nbytes
            if kernel == "w4a8_decode":
                xq, xs = quantize_activation_rows(x)
                fn = lambda: w4a8_decode(  # noqa: E731
                    xq, xs, p, torch.bfloat16)
                plain = lambda: w4a8_plain(  # noqa: E731
                    xq, xs, p, torch.bfloat16)
                library = None   # no one PyTorch call computes it
                row["plan"] = w4a8_decode_plan(m, n, k)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    wbytes + xq.nbytes + xs.nbytes + 2 * m * n,
                    2.0 * m * k * n)
            else:
                fn = lambda: w4a16_gemm(x, p)  # noqa: E731
                plain = lambda: w4a16_plain(x, p)  # noqa: E731
                library = lambda: torch.matmul(x, w_bf16)  # noqa: E731
                if m <= 64:
                    row["plan"] = w4a16_decode_plan(m, n, k)
                row["bound_ms"], row["bound_by"] = bound_ms(
                    wbytes + x.nbytes + 2 * m * n, 2.0 * m * k * n,
                    BF16_FLOPS_PER_S)
            check_case(rows, row, timer, fn, plain, library,
                       exact=kernel == "w4a8_decode")
            if kernel == "w4a8_decode" and not scratch_zero(torch):
                raise AssertionError(f"w4a8_decode {site} m={m}: split-K "
                                     f"counters not zero after the case")
        del p, w_bf16
        torch.cuda.empty_cache()
    return rows


def scratch_zero(torch) -> bool:
    """Whether the current stream's split-K counters are all zero."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()
    _, scratch = qmm._SCRATCH.get((stream.device_index, stream.cuda_stream),
                                  (0, torch.zeros(1)))
    return not bool(scratch.any().item())


def check_case(rows, row, timer, fn, plain, library, exact, launch=None):
    """Kernel vs plain version (exact, or within one bf16 step and then
    the same bits again: deterministic), timed, and checked once more
    after the timed launches; raises on a miss. `launch`, where given, is
    the kernel's launch alone on inputs `fn` prepares itself (a grouped
    kernel on a tile map built before): it must give `fn`'s bits, and
    `kernel_ms` times it while `call_ms` times the whole call `fn`."""
    import torch
    got = fn()
    want = plain()
    torch.cuda.synchronize()
    if exact:
        ok = bool(torch.equal(got, want))
        row["equal"] = ok
        row["max_abs_err"] = (got.float() - want.float()).abs().max().item()
    else:
        ok, row["share_differing"], row["max_abs_err"] = bf16_step_check(
            got, want)
        row["tolerance"] = "2^-7 |want| + 2^-12 max|want|"
    row["kernel_ms"] = timer(launch or fn)
    if launch is not None:
        row["call_ms"] = timer(fn)
        ok &= bool(torch.equal(launch(), got))
    again = fn()
    ok &= bool(torch.equal(again, want)) if exact \
        else bf16_step_check(again, want)[0] and bool(torch.equal(again, got))
    row["ok"] = ok
    row["plain_ms"] = timer(plain, reps=3, warmup=1)
    row["library_ms"] = None if library is None else timer(library)
    rows.append(row)
    emit({"phase": "kernel_case", **row})
    if not ok:
        raise AssertionError(f"{row['kernel']} {row.get('site')}: kernel "
                             f"differs from plain by {row['max_abs_err']}")


def make_moe_stack(torch, k, n, gen, two_level=True):
    """An expert stack [MOE_E, ...] of non-uniform weights (each expert as
    make_gemm_weight makes one)."""
    import dataclasses
    parts = [make_gemm_weight(torch, k, n, gen, two_level)
             for _ in range(MOE_E)]
    fields = ("qweight", "scales", "zeros") + (
        ("scales2", "chan_scale") if two_level else ())
    stacked = {f: torch.stack([getattr(p, f) for p in parts])
               for f in fields}
    return dataclasses.replace(parts[0], **stacked)


def routed_sizes(torch, gen, a):
    """Expert group sizes of `a` rows (a / 8 tokens at top-8) routed by a
    random router over MOE_E experts."""
    from ferrum_tpu_torch.ops.moe import route_topk
    logits = torch.randn(a // MOE_TOPK, MOE_E, generator=gen, device="cuda"
                         ).to(torch.bfloat16)
    _, ids = route_topk(logits, MOE_TOPK, True)
    return torch.bincount(ids.reshape(-1), minlength=MOE_E)


def stack_bytes(p, experts):
    """Bytes of `experts` experts' packed weight, scales2, zeros and chan."""
    per = (p.qweight[0].nbytes + p.scales2[0].nbytes + p.zeros[0].nbytes
           + p.chan_scale[0].nbytes)
    return experts * per


def bmm_case(torch, rows, timer, p, w_bf16, site, t, bx, gen, **extra):
    """moe_bmm at t rows (on one shared row block, bx = 1, or each
    expert's own, bx = MOE_E) equal to its plain version, beside
    torch.bmm on the bf16 stack."""
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (
        bmm_plain, moe_bmm_plan, quant_bmm_all_experts)
    from ferrum_tpu_torch.ops.kernels.quant_matmul import (
        quantize_activation_rows)
    k, n = p.in_features, p.out_features
    x = torch.randn(bx, t, k, generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    xq, xs = quantize_activation_rows(x.reshape(bx * t, k))
    xq3, xs3 = xq.reshape(bx, t, k), xs.reshape(bx, t, 1)
    row = {"kernel": "moe_bmm", "site": site, "t": t, "k": k, "n": n,
           "experts": MOE_E, "shared_rows": bx == 1,
           "plan": moe_bmm_plan(t, n, k, MOE_E), **extra}
    row["bound_ms"], row["bound_by"] = bound_ms(
        stack_bytes(p, MOE_E) + xq3.nbytes + xs3.nbytes
        + 2 * MOE_E * t * n, 2.0 * MOE_E * t * k * n)
    xb = x.expand(MOE_E, t, k)
    check_case(rows, row, timer,
               lambda: quant_bmm_all_experts(xq3, xs3, p, torch.bfloat16),
               lambda: bmm_plain(xq3, xs3, p, torch.bfloat16),
               lambda: torch.bmm(xb, w_bf16), exact=True)


def grouped_case(torch, rows, timer, p, w_bf16, site, a, gen, **extra):
    """moe_grouped over `a` expert-sorted rows routed by a random router,
    equal to its plain version, its launch on a prebuilt tile map timed
    apart, beside torch._grouped_mm on the bf16 stack."""
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (
        grouped_bm, grouped_map, grouped_plain, grouped_plan,
        grouped_w4a8tl, grouped_w4a8tl_on_map)
    from ferrum_tpu_torch.ops.kernels.quant_matmul import (
        quantize_activation_rows)
    grouped_mm = getattr(torch, "_grouped_mm", None)
    k, n = p.in_features, p.out_features
    sizes = routed_sizes(torch, gen, a)
    gs = sizes.to(torch.int32)
    x = torch.randn(a, k, generator=gen, device="cuda", dtype=torch.bfloat16)
    xq, xs = quantize_activation_rows(x)
    active = int((sizes > 0).sum().item())
    row = {"kernel": "moe_grouped", "site": site, "rows": a, "k": k, "n": n,
           "experts": MOE_E, "active_experts": active,
           "empty_experts": MOE_E - active,
           "library": "torch._grouped_mm (bf16)"
           if grouped_mm is not None else None, **extra}
    if grouped_bm(a) == 16:
        row["plan"] = grouped_plan(a, n, k, MOE_E)
    row["bound_ms"], row["bound_by"] = bound_ms(
        stack_bytes(p, active) + xq.nbytes + xs.nbytes + 2 * a * n,
        2.0 * a * k * n)
    offs = torch.cumsum(sizes, 0).to(torch.int32)
    tmap = grouped_map(gs, a)
    check_case(rows, row, timer,
               lambda: grouped_w4a8tl(xq, xs, p, gs, torch.bfloat16),
               lambda: grouped_plain(xq, xs, p, gs, torch.bfloat16),
               None if grouped_mm is None
               else lambda: grouped_mm(x, w_bf16, offs=offs),
               exact=True,
               launch=lambda: grouped_w4a8tl_on_map(
                   xq, xs, p, tmap, torch.bfloat16))


def moe_cases(torch, timer):
    """The two MoE kernels at the qwen3-30b-a3b expert shapes against
    their plain versions (exact equality), with their times."""
    from ferrum_tpu_torch.ops.quant import dequantize
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    rows = []

    for site, (k, n) in MOE_SHAPES.items():
        p = make_moe_stack(torch, k, n, gen)
        assert p.scales2.unique().numel() > 1 and p.zeros.unique().numel() > 1
        w_bf16 = dequantize(p, torch.bfloat16)            # [E, K, N]
        bx = 1 if site != "down" else MOE_E
        for t in BMM_T:
            bmm_case(torch, rows, timer, p, w_bf16, site, t, bx, gen)
        for a in GROUPED_A:
            grouped_case(torch, rows, timer, p, w_bf16, site, a, gen)
        del p, w_bf16
        torch.cuda.empty_cache()
        grouped_w4a16_cases(torch, timer, site, k, n, gen, rows)
    return rows


def grouped_w4a16_cases(torch, timer, site, k, n, gen, rows):
    """The w4a16 grouped kernel on a float-scale stack, within one bf16
    step of its plain version, at the rows of lane D's decode step (256)
    and prefills, and the single-slot decode (8)."""
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (
        grouped_bm, grouped_map, grouped_w4a16, grouped_w4a16_on_map,
        grouped_w4a16_plain, grouped_w4a16_plan)
    from ferrum_tpu_torch.ops.quant import w4a16_weight
    grouped_mm = getattr(torch, "_grouped_mm", None)
    p = make_moe_stack(torch, k, n, gen, two_level=False)
    assert p.scales.unique().numel() > 1 and p.zeros.unique().numel() > 1
    w_bf16 = w4a16_weight(p)                              # [E, K, N]
    for a in GROUPED_W4A16_A:
        sizes = routed_sizes(torch, gen, a)
        gs = sizes.to(torch.int32)
        x = torch.randn(a, k, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        active = int((sizes > 0).sum().item())
        row = {"kernel": "moe_grouped_w4a16", "site": site, "rows": a,
               "k": k, "n": n, "experts": MOE_E, "active_experts": active,
               "library": "torch._grouped_mm (bf16)"
               if grouped_mm is not None else None}
        if grouped_bm(a) == 16:
            row["plan"] = grouped_w4a16_plan(a, n, k, MOE_E)
        per = p.qweight[0].nbytes + p.scales[0].nbytes + p.zeros[0].nbytes
        row["bound_ms"], row["bound_by"] = bound_ms(
            active * per + x.nbytes + 2 * a * n, 2.0 * a * k * n,
            BF16_FLOPS_PER_S)
        offs = torch.cumsum(sizes, 0).to(torch.int32)
        tmap = grouped_map(gs, a)
        check_case(rows, row, timer,
                   lambda: grouped_w4a16(x, p, gs),
                   lambda: grouped_w4a16_plain(x, p, gs),
                   None if grouped_mm is None
                   else lambda: grouped_mm(x, w_bf16, offs=offs),
                   exact=False,
                   launch=lambda: grouped_w4a16_on_map(x, p, tmap))
    del p, w_bf16
    torch.cuda.empty_cache()


# The exact dequant cases: (m, K, N) dense and (rows, K, N) grouped, each
# with bf16 and with f32 scales. m = 256 takes 128-column tiles, m = 2048
# at N = 6144 256-column ones; grouped N = 768 256-column, N = 640 128.
ONEHOT_DENSE = ((256, 4096, 768), (256, 4096, 6144), (2048, 4096, 6144))
ONEHOT_GROUPED = ((2048, 2048, 768), (2048, 2048, 640))
# ... and at decode sizes, on the streamed decode loop in bf16
# (csrc/w4a16_stream.cuh). Dense (m, K, N, splits; 0: the launcher's
# count): every BM (m = 1 / 32 / 64) at the qwen3-30b-a3b qkv and o
# sites, K = 14336 (llama down), and forced splits of 3 steps and of 1
# (every other split starting mid-group). Grouped (rows, experts, K, N,
# group sizes; None: routed): 8 and 256 rows over the 128 experts at the
# qwen3 gate / up and down sites, and over 3 experts with an empty group
# and groups spanning 16-row tiles.
ONEHOT_DECODE_DENSE = tuple((m, k, n, 0) for m in (1, 32, 64)
                            for k, n in QWEN_SHAPES.values()) + (
    (32, 14336, 4096, 0), (32, 2048, 5120, 6), (1, 4096, 2048, 32))
ONEHOT_DECODE_GROUPED = ((8, MOE_E, 2048, 768, None),
                         (256, MOE_E, 2048, 768, None),
                         (256, MOE_E, 768, 2048, None),
                         (8, 3, 768, 2048, (1, 0, 7)),
                         (256, 3, 2048, 768, (10, 200, 46)),
                         (256, 3, 768, 2048, (0, 17, 239)))


def onehot_weight(torch, k, n, gen, experts, f32_scales):
    """A float-scale weight ([experts, ...] when experts > 0) built so a
    one-hot x reads its dequant exactly: across each group's columns
    every (q, z) pair in 0..15 x 0..15 (q = (n + k + e) % 16, z = (n / 16
    + g + e) % 16), the last group of each nibble half with zeros across
    all of int8, and scales 2^t (1 + u), t sweeping -133 .. 119 over
    the columns (below 2^-126 the bf16 scale is subnormal), u random (f32
    scales then round to bf16 in the kernel)."""
    from ferrum_tpu_torch.ops.quant import QuantLinearParams
    dev = "cuda"
    g = k // 128
    e = max(experts, 1)
    ei = torch.arange(e, device=dev)[:, None, None]
    kk = torch.arange(k, device=dev)[None, :, None]
    nn = torch.arange(n, device=dev)[None, None, :]
    gg = torch.arange(g, device=dev)[None, :, None]
    q = (nn + kk + ei) % 16                                      # [E, K, N]
    z = (nn // 16 + gg + ei) % 16                                # [E, G, N]
    wide = (nn * 37 + ei * 11) % 256 - 128
    z[:, [g // 2 - 1, g - 1], :] = wide.expand(e, 2, n)
    t = (nn * 11 + gg * 5 + ei) % 253 - 133
    u = torch.rand((e, g, n), generator=gen, device=dev)
    s = (1 + u) * torch.pow(2.0, t.to(torch.float32))
    qw = (q[:, :k // 2] | (q[:, k // 2:] << 4)).to(torch.uint8)
    fields = dict(qweight=qw, scales=s if f32_scales else s.to(torch.bfloat16),
                  zeros=z.to(torch.int8))
    if not experts:
        fields = {f: v[0].contiguous() for f, v in fields.items()}
    return QuantLinearParams(**fields, bias=None, in_features=k,
                             out_features=n, group_size=128)


def onehot_x(torch, m, k, gen):
    """bf16 [m, K], row i one-hot at k_i: the first and the last k of
    every group (both nibble halves' groups), then random k; with fewer
    rows than that, m of those first and last k at random."""
    need = torch.stack([torch.arange(0, k, 128, device="cuda"),
                        torch.arange(127, k, 128, device="cuda")], 1)
    if m < need.numel():
        ks = need.reshape(-1)[torch.randperm(
            need.numel(), generator=gen, device="cuda")[:m]]
    else:
        ks = torch.cat([need.reshape(-1), torch.randint(
            0, k, (m - need.numel(),), generator=gen, device="cuda")])
    x = torch.zeros(m, k, dtype=torch.bfloat16, device="cuda")
    x[torch.arange(m, device="cuda"), ks] = 1.0
    return x


def onehot_cases(torch):
    """Both w4a16 kernels on one-hot x, at prefill sizes (ONEHOT_DENSE,
    ONEHOT_GROUPED) and decode sizes (onehot_decode_cases): y is rows of
    the dequantized weight, so the kernel must equal its plain version
    bit for bit -- the check a dequant, layout, swizzle, fragment, split
    or proxy-fence fault cannot pass."""
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (grouped_w4a16,
                                                       grouped_w4a16_plain)
    from ferrum_tpu_torch.ops.kernels.quant_matmul import (w4a16_gemm,
                                                           w4a16_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    rows = []
    cases = [("w4a16_gemm", shape) for shape in ONEHOT_DENSE] \
        + [("moe_grouped_w4a16", shape) for shape in ONEHOT_GROUPED]
    for kernel, (m, k, n) in cases:
        x = onehot_x(torch, m, k, gen)
        for f32 in (False, True):
            row = {"kernel": kernel, "case": "one-hot dequant", "m": m,
                   "k": k, "n": n, "scales": "f32" if f32 else "bf16"}
            if kernel == "w4a16_gemm":
                p = onehot_weight(torch, k, n, gen, 0, f32)
                got, want = w4a16_gemm(x, p), w4a16_plain(x, p)
            else:
                sizes = routed_sizes(torch, gen, m)
                offs = torch.cumsum(sizes, 0)
                row["boundary_inside_64_rows"] = bool(
                    (offs[:-1] % 64 != 0).any().item())
                gs = sizes.to(torch.int32)
                p = onehot_weight(torch, k, n, gen, MOE_E, f32)
                got, want = grouped_w4a16(x, p, gs), \
                    grouped_w4a16_plain(x, p, gs)
            onehot_row(torch, rows, row, got, want)
            del p, got, want
        torch.cuda.empty_cache()
    return rows + onehot_decode_cases(torch, gen)


def onehot_row(torch, rows, row, got, want):
    """Finish and emit one one-hot case's row: equal bit for bit, else
    raise."""
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    row["equal"] = bool(torch.equal(got, want))
    row["outputs_differing"] = int((diff > 0).sum().item())
    row["subnormal_weights"] = int(
        ((want != 0) & (want.float().abs() < 2.0 ** -126)).sum().item())
    rows.append(row)
    emit({"phase": "kernel_case", **row})
    if not row["equal"] or not row.get("boundary_inside_64_rows", True) \
            or not row.get("group_spans_16_row_tiles", True) \
            or not row.get("scratch_zero", True):
        raise AssertionError(f"{row['kernel']} one-hot: {row}")


def onehot_decode_cases(torch, gen):
    """Both w4a16 kernels' decode sizes on one-hot x (ONEHOT_DECODE_*),
    bf16 and f32 scales: equal to the plain version bit for bit, each row
    with its launch plan; the dense kernel's split-K counters zero after
    each case; some group of each grouped case spans two 16-row tiles
    (at 256 rows)."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (grouped_w4a16,
                                                       grouped_w4a16_plain,
                                                       grouped_w4a16_plan)
    rows = []
    for m, k, n, splits in ONEHOT_DECODE_DENSE:
        x = onehot_x(torch, m, k, gen)
        for f32 in (False, True):
            p = onehot_weight(torch, k, n, gen, 0, f32)
            got = qmm.w4a16_gemm(x, p, splits=splits)
            row = {"kernel": "w4a16_gemm", "case": "one-hot decode", "m": m,
                   "k": k, "n": n, "scales": "f32" if f32 else "bf16",
                   "plan": qmm.w4a16_decode_plan(m, n, k, splits),
                   "scratch_zero": scratch_zero(torch)}
            onehot_row(torch, rows, row, got, qmm.w4a16_plain(x, p))
            del p, got
        torch.cuda.empty_cache()
    for a, e, k, n, sizes in ONEHOT_DECODE_GROUPED:
        x = onehot_x(torch, a, k, gen)
        if sizes is None:
            gs = routed_sizes(torch, gen, a).to(torch.int32)
        else:
            gs = torch.tensor(sizes, dtype=torch.int32, device="cuda")
        offs = torch.cumsum(gs, 0).tolist()
        spans = any(lo // 16 != (hi - 1) // 16
                    for lo, hi in zip([0] + offs[:-1], offs) if hi > lo)
        for f32 in (False, True):
            p = onehot_weight(torch, k, n, gen, e, f32)
            row = {"kernel": "moe_grouped_w4a16", "case": "one-hot decode",
                   "rows": a, "experts": e, "k": k, "n": n,
                   "scales": "f32" if f32 else "bf16",
                   "plan": grouped_w4a16_plan(a, n, k, e)}
            if a > 16:
                row["group_spans_16_row_tiles"] = spans
            onehot_row(torch, rows, row, grouped_w4a16(x, p, gs),
                       grouped_w4a16_plain(x, p, gs))
            del p
        torch.cuda.empty_cache()
    return rows


# The exact cases of the two two-level prefill kernels beyond the timed
# llama shapes, (m, K, N): ragged m (the engine's batched prefill gives
# m = b * t_pad), the qwen3-30b-a3b dense sites (N = 5120 and 2048), the
# int32 range at K = 14336 (every |xq| and |w8| 127), and one-hot xq.
# m <= 256 and N = 2048 take 128-column tiles in w4a8tl_prefill, m = 2048
# at N = 4096 / 5120 / 6144 256-column ones.
PREFILL_RAGGED = tuple((m, 4096, 4096) for m in (65, 100, 257, 2047))
PREFILL_QWEN = tuple((m, k, n) for k, n in QWEN_SHAPES.values()
                     for m in (256, 2048))
PREFILL_EXTREME = ((256, 14336, 512), (2048, 14336, 4096))
PREFILL_ONEHOT = ((256, 4096, 768), (2048, 4096, 6144))


def two_level_weight(torch, k, n, gen, kind, experts=0):
    """A two-level weight ([experts, ...] when experts > 0) built for an
    exact case. "extreme": q in {6, 8}, z = 7, scales2 = 127, so every w8
    is +-127 (random signs). "onehot": across each group's columns every
    (q, z) in 0..15 x 0..15 (q = (n + k + e) % 16, z = (n / 16 + g + e) %
    16), scales2 from 1 up to the cap 127 // max(z, 15 - z) that keeps
    |w8| <= 127. "random": q and z uniform over 0..15, scales2 uniform
    over 1 .. the cap. "wrap": q = z = 15, scales2 = 127, so every w8 is
    0, while sum_g s2 * (xq . q) alone passes 2^31 at K = 14336 with xq =
    127."""
    from ferrum_tpu_torch.ops.quant import QuantLinearParams
    dev = "cuda"
    g = k // 128
    e = max(experts, 1)
    ei = torch.arange(e, device=dev)[:, None, None]
    kk = torch.arange(k, device=dev)[None, :, None]
    nn = torch.arange(n, device=dev)[None, None, :]
    gg = torch.arange(g, device=dev)[None, :, None]
    if kind == "extreme":
        q = torch.where(torch.rand(e, k, n, generator=gen, device=dev) < 0.5,
                        6, 8)
        z = torch.full((e, g, n), 7, device=dev)
        s2 = torch.full((e, g, n), 127, device=dev)
    elif kind == "wrap":
        q = torch.full((e, k, n), 15, device=dev)
        z = torch.full((e, g, n), 15, device=dev)
        s2 = torch.full((e, g, n), 127, device=dev)
    elif kind == "onehot":
        q = (nn + kk + ei) % 16
        z = (nn // 16 + gg + ei) % 16
        s2 = 1 + (nn * 7 + gg * 3 + ei) % (127 // torch.maximum(z, 15 - z))
    else:
        q = torch.randint(0, 16, (e, k, n), generator=gen, device=dev)
        z = torch.randint(0, 16, (e, g, n), generator=gen, device=dev)
        s2 = 1 + (torch.rand(e, g, n, generator=gen, device=dev)
                  * (127 // torch.maximum(z, 15 - z))).long()
    fields = dict(
        qweight=(q[:, :k // 2] | (q[:, k // 2:] << 4)).to(torch.uint8),
        scales=torch.ones(e, g, n, dtype=torch.bfloat16, device=dev),
        zeros=z.to(torch.int8), scales2=s2.to(torch.int8),
        chan_scale=torch.rand(e, 1, n, generator=gen, device=dev) * 1e-3
        + 1e-3)
    if not experts:
        fields = {f: v[0] for f, v in fields.items()}
    return QuantLinearParams(**fields, bias=None, in_features=k,
                             out_features=n, group_size=128)


def prefill_exact_cases(torch):
    """w4a8tl_prefill and w4a8tl_prefill_mcache equal to w4a8tl_plain bit
    for bit on the PREFILL_* cases: ragged m and the qwen3 sites on random
    non-uniform weights; the extreme case, where each row m meets the
    largest sum 127 * 127 * K at column m % N; one-hot xq, where every
    output is one w8 row times xs and chan, in bf16 and in f32 -- the
    check a dequant, transpose, swizzle or proxy-fence fault cannot
    pass."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    from ferrum_tpu_torch.ops.quant import two_level_w8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    cases = [("ragged m", s) for s in PREFILL_RAGGED] \
        + [("qwen3-30b-a3b", s) for s in PREFILL_QWEN] \
        + [("extreme", s) for s in PREFILL_EXTREME] \
        + [("one-hot", s) for s in PREFILL_ONEHOT]
    rows = []
    for case, (m, k, n) in cases:
        xs = torch.rand(m, 1, generator=gen, device="cuda") + 0.5
        if case == "extreme":
            p = two_level_weight(torch, k, n, gen, "extreme")
            sign = torch.where(two_level_w8(p) > 0, 1, -1)       # [K, N]
            flip = torch.where(torch.rand(m, 1, generator=gen,
                                          device="cuda") < 0.5, 1, -1)
            cols = torch.arange(m, device="cuda") % n
            xq = (127 * sign[:, cols].t() * flip).to(torch.int8)
            xq = xq.contiguous()
            top = (xq.double() @ two_level_w8(p).double()).abs().max()
            if top.item() != 127 * 127 * k:
                raise AssertionError(f"extreme case peaks at {top.item()}")
        elif case == "one-hot":
            p = two_level_weight(torch, k, n, gen, "onehot")
            xq = onehot_x(torch, m, k, gen).to(torch.int8)
        else:
            p = make_gemm_weight(torch, k, n, gen)
            x = torch.randn(m, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            xq, xs = qmm.quantize_activation_rows(x)
        outs = (torch.bfloat16, torch.float32) if case == "one-hot" \
            else (torch.bfloat16,)
        for out_dtype in outs:
            want = qmm.w4a8tl_plain(xq, xs, p, out_dtype)
            for kernel in ("w4a8tl_prefill", "w4a8tl_prefill_mcache"):
                got = getattr(qmm, kernel)(xq, xs, p, out_dtype)
                torch.cuda.synchronize()
                row = {"kernel": kernel, "case": case, "m": m, "k": k,
                       "n": n, "out": str(out_dtype).split(".")[-1],
                       "equal": bool(torch.equal(got, want)),
                       "outputs_differing": int((got != want).sum().item())}
                rows.append(row)
                emit({"phase": "kernel_case", **row})
                if not row["equal"]:
                    raise AssertionError(f"{kernel} {case} {m}x{k}x{n}: "
                                         f"{row}")
        del p, xq, xs, want, got
    torch.cuda.empty_cache()
    return rows


# The exact cases of the two-level decode kernels beyond the timed sites,
# (case, m, K, N, K splits; 0: the launcher's rule): one-hot xq at every
# BM (16 / 32 / 64) and its edges, the int32 range at K = 14336, K = 256
# (two K steps of 64 packed rows, fewer than the ring's 3 loads ahead),
# one split and one per K step, 3 splits of 32 steps (steps 0, 11, 22:
# one split starts mid-group), N = 192 (64-column tiles), and the wrap
# case at K = 14336 (exact result 0) at one split and one per K step.
DECODE_EXACT = tuple(("one-hot", m, 4096, 6144, 0)
                     for m in (1, 5, 16, 17, 32, 33, 64)) + (
    ("extreme", 64, 14336, 4096, 0), ("random", 32, 256, 768, 0),
    ("random", 32, 4096, 4096, 1), ("random", 32, 4096, 4096, 32),
    ("random", 32, 4096, 4096, 3), ("random", 17, 4096, 192, 0),
    ("wrap", 32, 14336, 4096, 1), ("wrap", 32, 14336, 4096, 112))


def decode_exact_cases(torch, timer):
    """Both two-level decode kernels, w4a8tl_decode (the w8 form) and
    w4a8tl_gd_decode (the group-dot form), each equal to its own plain
    version (w4a8tl_plain, w4a8tl_gd_plain) bit for bit on the
    DECODE_EXACT cases, in bf16 and f32 out, before and after its timed
    launches, with the stream's split-K counters all zero after each --
    the check a chunk placement, dequant or unpack, fragment, rescale,
    ring, split or epilogue fault cannot pass."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    from ferrum_tpu_torch.ops.quant import two_level_w8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    kernels = (("w4a8tl_decode", qmm.w4a8tl_decode, qmm.w4a8tl_plain,
                qmm.w4a8tl_decode_plan),
               ("w4a8tl_gd_decode", qmm.w4a8tl_gd_decode,
                qmm.w4a8tl_gd_plain, qmm.w4a8tl_gd_decode_plan))
    rows = []
    for case, m, k, n, splits in DECODE_EXACT:
        xs = torch.rand(m, 1, generator=gen, device="cuda") + 0.5
        if case == "wrap":
            p = two_level_weight(torch, k, n, gen, "wrap")
            xq = torch.full((m, k), 127, dtype=torch.int8, device="cuda")
            if qmm.w4a8tl_gd_plain(xq, xs, p, torch.float32).any():
                raise AssertionError("the wrap case's exact result is 0")
        elif case == "extreme":
            p = two_level_weight(torch, k, n, gen, "extreme")
            sign = torch.where(two_level_w8(p) > 0, 1, -1)       # [K, N]
            cols = torch.arange(m, device="cuda") % n
            xq = (127 * sign[:, cols].t()).to(torch.int8).contiguous()
            top = (xq.double() @ two_level_w8(p).double()).abs().max()
            if top.item() != 127 * 127 * k:
                raise AssertionError(f"extreme case peaks at {top.item()}")
        elif case == "one-hot":
            p = two_level_weight(torch, k, n, gen, "onehot")
            xq = onehot_x(torch, m, k, gen).to(torch.int8)
        else:
            p = two_level_weight(torch, k, n, gen, "random")
            xq = torch.randint(-127, 128, (m, k), generator=gen,
                               device="cuda").to(torch.int8)
        for (kernel, fn, plain, plan), out_dtype in itertools.product(
                kernels, (torch.bfloat16, torch.float32)):
            def launch():
                return fn(xq, xs, p, out_dtype, splits=splits)
            want = plain(xq, xs, p, out_dtype)
            got = launch()
            ms_ = timer(launch)
            again = launch()
            row = {"kernel": kernel, "case": case, "m": m, "k": k, "n": n,
                   "out": str(out_dtype).split(".")[-1],
                   "plan": plan(m, n, k, splits), "kernel_ms": ms_,
                   "equal": bool(torch.equal(got, want))
                   and bool(torch.equal(again, want)),
                   "outputs_differing": int((got != want).sum().item()),
                   "scratch_zero": scratch_zero(torch)}
            rows.append(row)
            emit({"phase": "kernel_case", **row})
            if not row["equal"] or not row["scratch_zero"]:
                raise AssertionError(f"{kernel} {case} {m}x{k}x{n}: {row}")
        del p, xq, xs, want, got, again
    torch.cuda.empty_cache()
    return rows


# The exact cases of the float-scale decode kernel beyond the timed llama
# sites, (case, m, K, N, K splits -- 0: the launcher's rule --, f32
# scales): one-hot xq at every row tile's edge (each output one scaled
# group term; bf16-subnormal scales, zeros across int8), the integer
# range at K = 14336 (|xq| = 127, |q - z| = 15), gpt 1 (K = 256: one TPU
# step; 768: three) and 2 (K = 1536), forced splits (4 of 14 TPU steps:
# 4, 4, 4, 2; one a TPU step; 8 of 3), N = 192 (three 64-column tiles).
FS_EXACT = tuple(("one-hot", m, 4096, 768, 0, m % 2 == 1)
                 for m in (1, 17, 33, 64)) + (
    ("extreme", 64, 14336, 256, 0, False), ("extreme", 17, 14336, 256, 3, True),
    ("random", 32, 256, 768, 0, True), ("random", 32, 768, 768, 0, False),
    ("random", 33, 1536, 768, 0, True), ("random", 32, 14336, 4096, 4, False),
    ("random", 1, 14336, 4096, 14, True), ("random", 64, 768, 768, 8, False),
    ("random", 17, 4096, 192, 0, True), ("random", 64, 4096, 192, 2, False))


def float_scale_weight(torch, k, n, gen, kind, f32_scales):
    """A float-scale weight for an exact case. Scales of random sign and
    mantissa, 2^-12 .. 2^1. "extreme": z in {0, 15}, q = 15 - z, so every
    |q - z| is 15; "random": q and z uniform over 0..15."""
    from ferrum_tpu_torch.ops.quant import QuantLinearParams
    dev = "cuda"
    g = k // 128
    if kind == "extreme":
        z = torch.where(torch.rand(g, n, generator=gen, device=dev) < 0.5,
                        0, 15)
        q = 15 - z.repeat_interleave(128, 0)
    else:
        q = torch.randint(0, 16, (k, n), generator=gen, device=dev)
        z = torch.randint(0, 16, (g, n), generator=gen, device=dev)
    sign = torch.where(torch.rand(g, n, generator=gen, device=dev) < 0.5,
                       -1.0, 1.0)
    s = sign * (1 + torch.rand(g, n, generator=gen, device=dev)) * torch.pow(
        2.0, torch.randint(-12, 2, (g, n), generator=gen, device=dev).float())
    return QuantLinearParams(
        qweight=(q[:k // 2] | (q[k // 2:] << 4)).to(torch.uint8),
        scales=s if f32_scales else s.to(torch.bfloat16),
        zeros=z.to(torch.int8), bias=None, in_features=k, out_features=n,
        group_size=128)


def float_scale_exact_cases(torch, timer):
    """w4a8_decode equal to w4a8_plain bit for bit on the FS_EXACT cases,
    in bf16 and f32 out, before and after its timed launches, with the
    stream's split-K counters all zero after each, each row with its
    plan -- the check a ring, unpack, row-sum, scale-slot, fold-order,
    row-tile, split-plane or epilogue fault cannot pass."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    rows = []
    for case, m, k, n, splits, f32 in FS_EXACT:
        xs = torch.rand(m, 1, generator=gen, device="cuda") + 0.5
        if case == "one-hot":
            p = onehot_weight(torch, k, n, gen, 0, f32)
            xq = onehot_x(torch, m, k, gen).to(torch.int8)
        elif case == "extreme":
            p = float_scale_weight(torch, k, n, gen, "extreme", f32)
            sign = torch.where(torch.rand(m, k // 128, generator=gen,
                                          device="cuda") < 0.5, -127, 127)
            xq = sign.repeat_interleave(128, 1).to(torch.int8).contiguous()
        else:
            p = float_scale_weight(torch, k, n, gen, "random", f32)
            xq = torch.randint(-127, 128, (m, k), generator=gen,
                               device="cuda").to(torch.int8)
        for out_dtype in (torch.bfloat16, torch.float32):
            def launch():
                return qmm.w4a8_decode(xq, xs, p, out_dtype, splits=splits)
            want = qmm.w4a8_plain(xq, xs, p, out_dtype)
            got = launch()
            zero_before = scratch_zero(torch)
            ms_ = timer(launch)
            again = launch()
            row = {"kernel": "w4a8_decode", "case": case, "m": m, "k": k,
                   "n": n, "scales": "f32" if f32 else "bf16",
                   "out": str(out_dtype).split(".")[-1],
                   "plan": qmm.w4a8_decode_plan(m, n, k, splits),
                   "kernel_ms": ms_,
                   "equal": bool(torch.equal(got, want))
                   and bool(torch.equal(again, want)),
                   "outputs_differing": int((got != want).sum().item()),
                   "scratch_zero": zero_before and scratch_zero(torch)}
            rows.append(row)
            emit({"phase": "kernel_case", **row})
            if not row["equal"] or not row["scratch_zero"]:
                raise AssertionError(f"w4a8_decode {case} {m}x{k}x{n}: {row}")
        del p, xq, xs, want, got, again
    torch.cuda.empty_cache()
    return rows


# The exact cases of the all-experts bmm beyond the timed ones, (case,
# experts, t, K, N, shared rows): one-hot xq at the qwen3 gate / up site
# on shared rows and at the down site on each expert's own rows (128
# experts), at every BM (t = 1, 17, 33, 64) on 3 experts; the int32 range
# at K = 14336 on each expert's own rows; K = 256 (2 K steps, fewer than
# the ring's 3 prologue loads); N = 192 (64-column tiles) on 3 and 128
# experts.
BMM_EXACT = (("one-hot", 128, 32, 2048, 768, True),
             ("one-hot", 128, 32, 768, 2048, False),
             ("one-hot", 3, 1, 2048, 768, True),
             ("one-hot", 3, 17, 2048, 768, False),
             ("one-hot", 3, 33, 768, 2048, True),
             ("one-hot", 3, 64, 768, 2048, False),
             ("extreme", 3, 64, 14336, 256, False),
             ("random", 3, 17, 256, 768, True),
             ("random", 3, 33, 256, 768, False),
             ("random", 3, 16, 2048, 192, True),
             ("random", 128, 64, 2048, 192, False))


def bmm_exact_cases(torch, timer):
    """moe_bmm equal to bmm_plain bit for bit on the BMM_EXACT cases, in
    bf16 and f32 out, before and after its timed launches, each row with
    the launch's plan (moe_bmm_plan). One-hot xq makes every output one
    w8 row of its expert times xs and chan, on stacks whose experts
    differ (q, z and scales2 depend on the expert); on per-expert rows
    each expert's row i is hot at its own k (k_i + 129 e mod K), so a
    fault in an expert's weight, scale, chan, row or output offset
    cannot pass. The extreme case: each expert's row m meets the largest
    sum 127 * 127 * K at column m % N."""
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (bmm_plain,
                                                       moe_bmm_plan,
                                                       quant_bmm_all_experts)
    from ferrum_tpu_torch.ops.quant import two_level_w8
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    rows = []
    for case, e, t, k, n, shared in BMM_EXACT:
        bx = 1 if shared else e
        p = two_level_weight(torch, k, n, gen,
                             "onehot" if case == "one-hot" else case,
                             experts=e)
        xs3 = torch.rand(bx, t, 1, generator=gen, device="cuda") + 0.5
        if case == "one-hot":
            hot = onehot_x(torch, t, k, gen).argmax(-1)           # [t]
            shift = 129 * torch.arange(bx, device="cuda")[:, None]
            xq3 = torch.zeros(bx, t, k, dtype=torch.int8, device="cuda")
            xq3.scatter_(2, ((hot[None] + shift) % k)[..., None], 1)
        elif case == "extreme":
            w8 = two_level_w8(p)                                  # [E, K, N]
            cols = torch.arange(t, device="cuda") % n
            xq3 = (127 * torch.where(w8[:, :, cols] > 0, 1, -1)
                   .transpose(1, 2)).to(torch.int8).contiguous()
            top = (xq3.double() @ w8.double()).abs().amax((1, 2))
            if (top != 127 * 127 * k).any():
                raise AssertionError(f"extreme case peaks at {top}")
            del w8
        else:
            xq3 = torch.randint(-127, 128, (bx, t, k), generator=gen,
                                device="cuda").to(torch.int8)
        for out_dtype in (torch.bfloat16, torch.float32):
            def launch():
                return quant_bmm_all_experts(xq3, xs3, p, out_dtype)
            want = bmm_plain(xq3, xs3, p, out_dtype)
            got = launch()
            ms_ = timer(launch, reps=5, warmup=1)
            again = launch()
            torch.cuda.synchronize()
            row = {"kernel": "moe_bmm", "case": case, "experts": e, "t": t,
                   "k": k, "n": n, "shared_rows": shared,
                   "out": str(out_dtype).split(".")[-1],
                   "plan": moe_bmm_plan(t, n, k, e), "kernel_ms": ms_,
                   "equal": bool(torch.equal(got, want))
                   and bool(torch.equal(again, want)),
                   "outputs_differing": int((got != want).sum().item())}
            rows.append(row)
            emit({"phase": "kernel_case", **row})
            if not row["equal"]:
                raise AssertionError(f"moe_bmm {case} E={e} t={t} "
                                     f"{k}x{n}: {row}")
            del want, got, again
        del p, xq3, xs3
    torch.cuda.empty_cache()
    return rows


# The exact cases of the grouped two-level kernel beyond the timed routed
# ones, (case, rows, K, N) over MOE_E experts. At 128-row tiles: one-hot
# xq at the qwen3 gate / up and down sites, every row to one expert, four
# experts active, ragged row counts (no multiple of top-k), K = 256 (2 K
# steps, fewer than the ring's 3 prologue loads). At decode sizes (<= 256
# rows, the expert-grid loop): one-hot xq at 8 / 120 / 256 rows, experts
# over BM rows (chunks), every row to one expert, K = 256.
GROUPED_EXACT = (("one-hot", 2048, 2048, 768), ("one-hot", 2048, 768, 2048),
                 ("one expert", 2048, 2048, 768),
                 ("four experts", 2048, 768, 2048),
                 ("ragged", 257, 2048, 768), ("ragged", 1000, 768, 2048),
                 ("K = 256", 2048, 256, 768),
                 ("one-hot", 8, 2048, 768), ("one-hot", 8, 768, 2048),
                 ("one-hot", 120, 2048, 768), ("one-hot", 120, 768, 2048),
                 ("one-hot", 256, 2048, 768), ("one-hot", 256, 768, 2048),
                 ("experts over BM rows", 256, 768, 2048),
                 ("one expert", 120, 2048, 768),
                 ("K = 256", 120, 256, 768))


def grouped_exact_cases(torch, timer):
    """moe_grouped equal to grouped_plain bit for bit on the GROUPED_EXACT
    cases, in bf16 and f32 out, before and after its timed launches:
    one-hot xq, where every output is one w8 row of the row's expert
    times chan and xs (at 128-row tiles some expert boundary must lie
    inside a 64-row slice, so a warpgroup's rows span two experts);
    random stacks and activations otherwise -- the check a window, chunk,
    expert offset, epilogue order, dequant or short-K ring fault cannot
    pass. Decode-sized rows carry their launch's plan."""
    from ferrum_tpu_torch.ops.kernels.moe_gemm import (grouped_bm,
                                                       grouped_map,
                                                       grouped_plain,
                                                       grouped_plan,
                                                       grouped_w4a8tl,
                                                       grouped_w4a8tl_on_map)
    from ferrum_tpu_torch.ops.kernels.quant_matmul import (
        quantize_activation_rows)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    rows = []
    for case, a, k, n in GROUPED_EXACT:
        if case in ("one-hot", "K = 256"):
            sizes = routed_sizes(torch, gen, a)
        elif case == "ragged":
            sizes = torch.bincount(torch.randint(
                0, MOE_E, (a,), generator=gen, device="cuda"),
                minlength=MOE_E)
        else:
            sizes = torch.zeros(MOE_E, dtype=torch.int64, device="cuda")
            if case == "one expert":
                sizes[77] = a
            elif case == "four experts":
                sizes[torch.tensor([3, 40, 41, 127], device="cuda")] = \
                    torch.tensor([1000, 600, 300, 148], device="cuda")
            else:                           # experts over BM rows
                sizes[torch.tensor([3, 77, 127], device="cuda")] = \
                    torch.tensor([40, 100, 116], device="cuda")
        gs = sizes.to(torch.int32)
        offs = torch.cumsum(sizes, 0)
        p = two_level_weight(torch, k, n, gen,
                             "onehot" if case == "one-hot" else "random",
                             experts=MOE_E)
        if case == "one-hot":
            xq = onehot_x(torch, a, k, gen).to(torch.int8)
            xs = torch.rand(a, 1, generator=gen, device="cuda") + 0.5
        else:
            xq, xs = quantize_activation_rows(torch.randn(
                a, k, generator=gen, device="cuda", dtype=torch.bfloat16))
        tmap = grouped_map(gs, a)
        tiles = grouped_bm(a)
        for out_dtype in (torch.bfloat16, torch.float32):
            want = grouped_plain(xq, xs, p, gs, out_dtype)
            got = grouped_w4a8tl(xq, xs, p, gs, out_dtype)
            ms = timer(lambda: grouped_w4a8tl_on_map(xq, xs, p, tmap,
                                                     out_dtype), reps=5,
                       warmup=1)
            again = grouped_w4a8tl_on_map(xq, xs, p, tmap, out_dtype)
            torch.cuda.synchronize()
            row = {"kernel": "moe_grouped", "case": case, "rows": a, "k": k,
                   "n": n, "out": str(out_dtype).split(".")[-1],
                   "active_experts": int((sizes > 0).sum().item()),
                   "most_rows_an_expert": int(sizes.max().item()),
                   "kernel_ms": ms,
                   "equal": bool(torch.equal(got, want))
                   and bool(torch.equal(again, want)),
                   "outputs_differing": int((got != want).sum().item())}
            if tiles == 128:
                row["boundary_inside_64_rows"] = bool(
                    (offs[:-1] % 64 != 0).any().item())
            else:
                row["plan"] = grouped_plan(a, n, k, MOE_E)
            rows.append(row)
            emit({"phase": "kernel_case", **row})
            # The case must reach what it is for: a warpgroup's rows over
            # two experts (one-hot at 128-row tiles), an expert in several
            # chunks (decode sizes, one expert or experts over BM rows).
            reached = row["boundary_inside_64_rows"] if tiles == 128 \
                else row["most_rows_an_expert"] > row["plan"]["bm"]
            if not row["equal"] or not reached and (
                    case == "one-hot" if tiles == 128
                    else case in ("one expert", "experts over BM rows")):
                raise AssertionError(f"moe_grouped {case} {a}x{k}x{n}: "
                                     f"{row}")
            del want, got, again
        del p, xq, xs
    torch.cuda.empty_cache()
    return rows


def kv_ids(torch, layers, slots, blocks_per_slot, pos, inactive):
    """Decode append ids for `layers` x `slots` rows at per-slot positions
    `pos` (the model's layer-merged block ids); `inactive` slots carry the
    OOB sentinel."""
    nb = slots * blocks_per_slot
    blk = (torch.arange(slots, device="cuda") * blocks_per_slot
           + pos // PAGE)
    blk = (torch.arange(layers, device="cuda")[:, None] * nb + blk[None, :])
    blk[:, inactive] = OOB_SENTINEL
    off = (pos % PAGE)[None, :].expand(layers, slots)
    return (blk.reshape(-1).to(torch.int32).contiguous(),
            off.reshape(-1).to(torch.int32).contiguous())


def kv_rows_cases(torch, timer):
    """kv_append_rows at the llama-3.1-8b decode step's shape (32 layers x
    32 slots, two inactive slots and one id exactly B dropped), one array
    (append_rows) and K with V in one launch (append_rows_pairs, as
    decode_forward calls it), each equal to its plain version bit for bit
    in bf16, f32 and int8. The bf16 cases are timed beside index_copy_
    (one per array), and the pair beside an empty kernel's launch
    (`floor_ms`, torch.cuda._sleep(0)) with the same Timer."""
    from ferrum_tpu_torch.ops.kernels.kv_append import (
        append_rows_pairs, append_rows_pairs_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(2)
    layers, slots, bps = 32, 32, 1024 // PAGE
    b = layers * slots * bps
    pos = torch.randint(0, 1024, (slots,), generator=gen, device="cuda")
    blk, off = kv_ids(torch, layers, slots, bps, pos, inactive=[3, 17])
    blk[5] = b                                   # exactly B: dropped
    valid = (blk < b)
    n_valid = int(valid.sum().item())
    rows = []
    for dt, f in ((torch.bfloat16, 1024), (torch.float32, 8),
                  (torch.int8, 1024)):
        for arrays in (1, 2):
            pairs = []
            for _ in range(arrays):
                if dt == torch.int8:
                    cache = torch.randint(-127, 128, (b, PAGE, f),
                                          generator=gen, device="cuda",
                                          dtype=torch.int8)
                    new = torch.randint(-127, 128, (blk.numel(), f),
                                        generator=gen, device="cuda",
                                        dtype=torch.int8)
                else:
                    cache = torch.randn(b, PAGE, f, generator=gen,
                                        device="cuda").to(dt)
                    new = torch.randn(blk.numel(), f, generator=gen,
                                      device="cuda").to(dt)
                pairs.append((cache, new))
            ref = append_rows_pairs_plain([(c.clone(), r) for c, r in pairs],
                                          blk, off)
            append_rows_pairs(pairs, blk, off)
            torch.cuda.synchronize()
            err = max((c.float() - w.float()).abs().max().item()
                      for (c, _), w in zip(pairs, ref))
            row = {"kernel": "kv_append_rows",
                   "dtype": str(dt).split(".")[-1], "arrays": arrays,
                   "rows": blk.numel(), "f": f,
                   "equal": all(bool(torch.equal(c, w))
                                for (c, _), w in zip(pairs, ref)),
                   "max_abs_err": err}
            del ref
            row["bound_ms"], row["bound_by"] = bound_ms(
                arrays * 2 * n_valid * f * pairs[0][0].element_size()
                + 2 * blk.nbytes, 0)
            if dt == torch.bfloat16:
                row["kernel_ms"] = timer(
                    lambda: append_rows_pairs(pairs, blk, off))
                row["plain_ms"] = timer(
                    lambda: append_rows_pairs_plain(pairs, blk, off), reps=10)
                idx = (blk.long() * PAGE + off.long())[valid]
                copies = [(c.view(-1, f), r[valid]) for c, r in pairs]
                row["library_ms"] = timer(lambda: [
                    flat.index_copy_(0, idx, src) for flat, src in copies])
                if arrays == 2:
                    row["floor_ms"] = timer(lambda: torch.cuda._sleep(0))
            rows.append(row)
            emit({"phase": "kernel_case", **row})
            if not row["equal"]:
                raise AssertionError(f"kv_append_rows {dt} x {arrays}: "
                                     f"differs by {err}")
            del pairs
    return rows


# A decode window's append on lane A at bucket 32 with a mixed-prefill
# block: T = 8 steps of 32 lanes and P = 32 chunk rows (a 256-token
# chunk), 32 layers: 32 x 8 x 64 = 16384 rows of K and of V, F = 1024.
WIN_T, WIN_LANES, WIN_P = 8, 32, 32


def kv_array(torch, gen, dt, shape):
    """Seeded cache or source contents: int8 over [-127, 127], else
    normal draws in `dt`."""
    if dt == torch.int8:
        return torch.randint(-127, 128, shape, generator=gen,
                             device="cuda", dtype=torch.int8)
    return torch.randn(*shape, generator=gen, device="cuda").to(dt)


# The rows forms the served paths append: bf16 K and V; int8 K and V with
# their f32 scale planes (Hkv = 8 scales a row: 32 bytes beside 1024).
ROWS_BF16 = ("bf16 K, V", [("bfloat16", 1024)] * 2)
ROWS_INT8 = ("int8 K, V, K scales, V scales",
             [("int8", 1024)] * 2 + [("float32", 8)] * 2)


def kv_rows_form_cases(torch, timer, gen, blk, off, b, forms, extra):
    """Each form's (cache, rows) arrays in one append_rows_pairs launch at
    the ids blk / off (blocks >= b dropped), bit for bit against
    append_rows_pairs_plain on copies of the same caches; timed beside the
    plain version and one index_copy_ an array, the bound from the bytes
    moved. `extra`: fields every row carries."""
    from ferrum_tpu_torch.ops.kernels.kv_append import (
        append_rows_pairs, append_rows_pairs_plain)
    n = blk.numel()
    valid = blk < b
    n_valid = int(valid.sum().item())
    idx = (blk.long() * PAGE + off.long())[valid]
    rows = []
    for label, kinds in forms:
        pairs = [(kv_array(torch, gen, getattr(torch, dt), (b, PAGE, w)),
                  kv_array(torch, gen, getattr(torch, dt), (n, w)))
                 for dt, w in kinds]
        ref = append_rows_pairs_plain([(c.clone(), r) for c, r in pairs],
                                      blk, off)
        append_rows_pairs(pairs, blk, off)
        torch.cuda.synchronize()
        row = {"kernel": "kv_append_rows", "dtype": label,
               "arrays": len(pairs), "rows": n, "f": kinds[0][1], **extra,
               "equal": all(bool(torch.equal(c, w))
                            for (c, _), w in zip(pairs, ref)),
               "max_abs_err": max((c.float() - w.float()).abs().max().item()
                                  for (c, _), w in zip(pairs, ref))}
        del ref
        row["bound_ms"], row["bound_by"] = bound_ms(
            sum(2 * n_valid * r[0].nbytes for _, r in pairs)
            + blk.nbytes + off.nbytes, 0)
        row["kernel_ms"] = timer(lambda: append_rows_pairs(pairs, blk, off))
        row["plain_ms"] = timer(
            lambda: append_rows_pairs_plain(pairs, blk, off), reps=10)
        copies = [(c.view(-1, c.shape[-1]), r[valid]) for c, r in pairs]
        row["library_ms"] = timer(lambda: [
            flat_c.index_copy_(0, idx, src) for flat_c, src in copies])
        rows.append(row)
        emit({"phase": "kernel_case", **row})
        if not row["equal"]:
            raise AssertionError(f"kv_append_rows {label} ({extra['at']}): "
                                 f"differs by {row['max_abs_err']}")
        del pairs, copies
        torch.cuda.empty_cache()
    return rows


def kv_window_case(torch, timer):
    """kv_append_rows at the window size append_window_kv gives it: one
    window in one launch, ids laid out as the model lays them
    (layer-major, then step, then lane, then chunk row): 31 decoding
    lanes at seeded positions, slot 5's lane a pad (dropped) while its
    256-token chunk rides the window's rows. Two forms: bf16 K and V
    (lanes A-E; the summary's row) and int8 K and V with their f32 scale
    planes (lane F's window: four arrays of two widths in one launch).
    Each bit for bit against its plain version (kv_rows_form_cases)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    layers, bps = 32, 1024 // PAGE
    nb = WIN_LANES * bps
    b = layers * nb
    pos = torch.randint(256, 1024 - WIN_T, (WIN_LANES,), generator=gen,
                        device="cuda")
    steps = torch.arange(WIN_T, device="cuda")[:, None]
    lane_flat = torch.arange(WIN_LANES, device="cuda") * 1024 + pos + steps
    lane_flat[:, 5] = OOB_SENTINEL                     # the pad lane
    chunk = 5 * 1024 + torch.arange(WIN_T * WIN_P, device="cuda")
    flat = torch.cat([lane_flat, chunk.view(WIN_T, WIN_P)], 1).reshape(-1)
    ok = flat < OOB_SENTINEL
    blk = torch.where(ok[None], torch.arange(layers, device="cuda")[:, None]
                      * nb + (flat // PAGE)[None],
                      torch.full((layers, 1), OOB_SENTINEL, device="cuda"))
    blk = blk.reshape(-1).to(torch.int32).contiguous()
    off = (flat % PAGE).repeat(layers).to(torch.int32).contiguous()
    return kv_rows_form_cases(
        torch, timer, gen, blk, off, b, (ROWS_BF16, ROWS_INT8),
        {"window": True, "at": f"one window: {layers} layers x T={WIN_T} "
                               f"x ({WIN_LANES} lanes + {WIN_P} chunk "
                               f"rows)"})


def kv_paged_step_case(torch, timer):
    """kv_append_rows as a paged decode step appends (lane G: each step
    of a window appends its own rows): 32 layers x 32 lanes (bucket 32),
    16 decoding lanes at seeded positions up to FG_SHARED + FG_OWN +
    FG_OUT, each in its own block of a G_BLOCKS pool at scattered ids
    (the paged layout's block tables), the 16 pad lanes dropped, plus
    one id of exactly B. Lane G's bf16 K and V, and the same step on an
    int8 pool (K, V and their scale planes), bit for bit against the
    plain version (kv_rows_form_cases)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    layers, lanes, live = 32, 32, FG_REQUESTS
    b = layers * G_BLOCKS
    pos = torch.randint(0, FG_SHARED + FG_OWN + FG_OUT, (lanes,),
                        generator=gen, device="cuda")
    lane_blk = torch.randperm(G_BLOCKS, generator=gen,
                              device="cuda")[:lanes]
    blk = torch.arange(layers, device="cuda")[:, None] * G_BLOCKS \
        + lane_blk[None]
    blk[:, live:] = OOB_SENTINEL                       # pad lanes
    blk = blk.reshape(-1).to(torch.int32).contiguous()
    blk[7] = b                                         # exactly B: dropped
    off = (pos % PAGE).repeat(layers).to(torch.int32).contiguous()
    return kv_rows_form_cases(
        torch, timer, gen, blk, off, b, (ROWS_BF16, ROWS_INT8),
        {"form": "paged step", "at": f"a paged decode step: {layers} "
                                     f"layers x {lanes} lanes ({live} "
                                     f"live) over {G_BLOCKS} blocks"})


def kv_pages_cases(torch, timer):
    from ferrum_tpu_torch.ops.kernels.kv_append import (append_pages,
                                                        append_pages_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    layers, slots, bps = 32, 32, 1024 // PAGE
    nb = slots * bps
    b = layers * nb
    seqs, t = 32, 256                     # one 256-token prefill of 32 seqs
    n_pg = t // PAGE
    blk_seq = (torch.arange(seqs, device="cuda")[:, None] * bps
               + torch.arange(n_pg, device="cuda")[None, :])   # [seqs, n_pg]
    blk_seq[7, 4:] = OOB_SENTINEL         # a short chunk: pad pages dropped
    blk_seq[21, :] = OOB_SENTINEL         # a pad row
    blk = (torch.arange(layers, device="cuda")[:, None] * nb
           + blk_seq.reshape(1, -1))
    blk = torch.where(blk_seq.reshape(1, -1) >= OOB_SENTINEL,
                      torch.full_like(blk, OOB_SENTINEL), blk)
    blk = blk.reshape(-1).to(torch.int32).contiguous()
    blk[1] = b                            # exactly B: dropped
    rows = []
    cases = ((torch.bfloat16, 1024, blk), (torch.float32, 8, blk),
             (torch.int8, 1024, blk))
    for dt, f, ids in cases:
        p = ids.numel()
        if dt == torch.int8:
            cache = torch.randint(-127, 128, (b, PAGE, f), generator=gen,
                                  device="cuda", dtype=torch.int8)
            pages = torch.randint(-127, 128, (p, PAGE, f), generator=gen,
                                  device="cuda", dtype=torch.int8)
        else:
            cache = torch.randn(b, PAGE, f, generator=gen, device="cuda"
                                ).to(dt)
            pages = torch.randn(p, PAGE, f, generator=gen,
                                device="cuda").to(dt)
        ref = append_pages_plain(cache.clone(), pages, ids)
        append_pages(cache, pages, ids)
        torch.cuda.synchronize()
        err = (cache.float() - ref.float()).abs().max().item()
        row = {"kernel": "kv_append_pages", "dtype": str(dt).split(".")[-1],
               "pages": p, "f": f, "equal": bool(torch.equal(cache, ref)),
               "max_abs_err": err}
        del ref
        valid = ids < b
        n_valid = int(valid.sum().item())
        row["bound_ms"], row["bound_by"] = bound_ms(
            2 * n_valid * PAGE * f * cache.element_size() + ids.nbytes, 0)
        if dt == torch.bfloat16:
            row["kernel_ms"] = timer(lambda: append_pages(cache, pages, ids))
            row["plain_ms"] = timer(
                lambda: append_pages_plain(cache, pages, ids), reps=10)
            idx = ids.long()[valid]
            src = pages[valid]
            row["library_ms"] = timer(lambda: cache.index_copy_(0, idx, src))
        rows.append(row)
        emit({"phase": "kernel_case", **row})
        if not row["equal"]:
            raise AssertionError(f"kv_append_pages {dt}: differs by {err}")
        del cache, pages
        torch.cuda.empty_cache()
    return rows


def kv_pages_pairs_cases(torch, timer):
    """kv_append_pages' pairs form at a llama-3.1-8b batched prefill's
    size (2048 rows: 64 pages a layer, 32 layers), ids scattered over
    the pool as the paged layout's blocks, a short chunk's pad pages
    (OOB_SENTINEL) and an id of exactly B dropped: one to four arrays
    in one launch -- bf16 K; bf16 K and V; int8 K and V; int8 K and V
    with their f32 scale planes -- bit for bit against the plain
    version, timed beside one single-array launch per array (the
    two-launch and four-launch forms it replaces), with the bound from
    the bytes moved."""
    from ferrum_tpu_torch.ops.kernels.kv_append import (
        append_pages, append_pages_pairs, append_pages_pairs_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(8)
    layers, nb_layer, f, hkv = 32, 1024, 1024, 8
    b = layers * nb_layer
    n_pg = PREFILL_ROWS // PAGE
    perm = torch.randperm(nb_layer, generator=gen, device="cuda")[:n_pg]
    blk_seq = perm.clone()
    blk_seq[40:] = torch.where(torch.arange(n_pg - 40, device="cuda") < 4,
                               perm[40:], OOB_SENTINEL)
    blk = torch.where(blk_seq[None] >= OOB_SENTINEL,
                      torch.full((layers, 1), OOB_SENTINEL, device="cuda"),
                      torch.arange(layers, device="cuda")[:, None]
                      * nb_layer + blk_seq[None])
    ids = blk.reshape(-1).to(torch.int32).contiguous()
    ids[3] = b                            # exactly B: dropped
    p = ids.numel()
    valid = ids < b
    n_valid = int(valid.sum().item())

    rows = []
    forms = (("bf16 K", [(torch.bfloat16, f)]),
             ("bf16 K, V", [(torch.bfloat16, f)] * 2),
             ("int8 K, V", [(torch.int8, f)] * 2),
             ("int8 K, V, K scales, V scales",
              [(torch.int8, f)] * 2 + [(torch.float32, hkv)] * 2))
    for label, kinds in forms:
        pairs = [(kv_array(torch, gen, dt, (b, PAGE, w)),
                  kv_array(torch, gen, dt, (p, PAGE, w)))
                 for dt, w in kinds]
        ref = append_pages_pairs_plain([(c.clone(), q) for c, q in pairs],
                                       ids)
        append_pages_pairs(pairs, ids)
        torch.cuda.synchronize()
        row = {"kernel": "kv_append_pages", "form": "pairs",
               "arrays": len(pairs), "dtype": label, "pages": p,
               "f": f, "rows": PREFILL_ROWS,
               "equal": all(bool(torch.equal(c, w))
                            for (c, _), w in zip(pairs, ref)),
               "max_abs_err": max((c.float() - w.float()).abs().max().item()
                                  for (c, _), w in zip(pairs, ref))}
        del ref
        row["bound_ms"], row["bound_by"] = bound_ms(
            sum(2 * n_valid * q[0].nbytes for _, q in pairs) + ids.nbytes,
            0)
        row["kernel_ms"] = timer(lambda: append_pages_pairs(pairs, ids))
        row["single_launches_ms"] = timer(
            lambda: [append_pages(c, q, ids) for c, q in pairs])
        row["plain_ms"] = timer(
            lambda: append_pages_pairs_plain(pairs, ids), reps=10)
        idx = ids.long()[valid]
        srcs = [(c, q[valid]) for c, q in pairs]
        row["library_ms"] = timer(
            lambda: [c.index_copy_(0, idx, q) for c, q in srcs])
        rows.append(row)
        emit({"phase": "kernel_case", **row})
        if not row["equal"]:
            raise AssertionError(f"kv_append_pages pairs {label}: differs "
                                 f"by {row['max_abs_err']}")
        del pairs, srcs
        torch.cuda.empty_cache()
    return rows


def _summed(sel, at):
    """One summary entry: the cases' times and bounds summed (None where
    a case lacks the number)."""
    def tot(key):
        vals = [c.get(key) for c in sel]
        return None if any(v is None for v in vals) else sum(vals)
    tb = sum(c["bound_ms"] for c in sel if c["bound_by"] == "bytes")
    to = sum(c["bound_ms"] for c in sel if c["bound_by"] != "bytes")
    return {"ms": tot("kernel_ms"), "plain_ms": tot("plain_ms"),
            "library_ms": tot("library_ms"), "bound_ms": tot("bound_ms"),
            "bound_by": "bytes" if tb >= to else "operations",
            "at": f"{at}, sum over {[c['site'] for c in sel]}"}


def summarize(cases):
    """One entry per kernel: the GEMMs summed over a layer's projections
    at the serve phases' shapes, the appends at their bf16 case."""
    out = {}
    for name, key, at in (("w4a8tl_decode", "m", SERVE_DECODE_M),
                          ("w4a8tl_prefill", "m", SERVE_PREFILL_M),
                          ("w4a8tl_gd_decode", "m", SERVE_DECODE_M),
                          ("w4a8tl_prefill_mcache", "m", SERVE_PREFILL_M),
                          ("moe_bmm", "t", SERVE_BMM_T),
                          ("moe_grouped", "rows", SERVE_GROUPED_A),
                          ("w4a8_decode", "m", SERVE_DECODE_M),
                          ("w4a16_gemm", "m", SERVE_PREFILL_M),
                          ("moe_grouped_w4a16", "rows",
                           SERVE_GROUPED_W4A16_A)):
        # The dense GEMMs: a llama-3.1-8b layer's four projections.
        out[name] = _summed([c for c in cases if c["kernel"] == name
                             and c[key] == at
                             and c.get("model", "llama-3.1-8b")
                             == "llama-3.1-8b"], f"{key}={at}")
    # The appends: a decode window's K and V in one launch, a batched
    # prefill's K and V pages in one launch (the served paths' sizes).
    for name in ("kv_append_rows", "kv_append_pages"):
        c = next(c for c in cases
                 if c["kernel"] == name and c.get("arrays") == 2
                 and "bf" in c["dtype"]
                 and c.get("model", "llama-3.1-8b") == "llama-3.1-8b"
                 and (c.get("window") or c.get("form") == "pairs"))
        out[name] = {k: c.get(k) for k in ("plain_ms", "library_ms",
                                           "bound_ms", "bound_by")}
        out[name]["ms"] = c.get("kernel_ms")
        out[name]["at"] = (f"{c.get('rows', c.get('pages'))} "
                           f"{'rows' if 'rows' in c else 'pages'}, F={c['f']}"
                           + (", K and V" if "arrays" in c else ""))
    for name in out:
        errs = [c["max_abs_err"] for c in cases if c["kernel"] == name]
        out[name]["max_abs_err"] = max(errs) if errs else None
    return out


# ---------------------------------------------------------------------------
# attention precision
# ---------------------------------------------------------------------------

# Largest share of bf16 outputs that may differ from the f32-product
# computation, each by at most one bf16 step at the output's scale
# (2^-7 of max |out|): the card's exp and f32 sums, taken in another
# order, can move a bf16 rounding of a probability or an output. Scores
# rounded to bf16 before the softmax change 30-80% of the outputs
# (measured on the CPU, tests/test_torch_ops.py).
ATTN_DIFF_SHARE = 0.02


def attention_phase(torch, device):
    """The served path's bf16 attention at the llama-3.1-8b decode and
    prefill shapes (Hq=32, Hkv=8, D=128) on `device`, against the same
    function on CPU copies of the inputs: the CPU route widens bf16 to
    f32 before every product, so it keeps the scores and the PV sums in
    f32 as the JAX package does. q is scaled so the scores spread ~6 and
    reach ~25, where bf16's spacing is 0.125."""
    from ferrum_tpu_torch.ops.attention import (flat_decode_attention,
                                                flat_prefill_attention)
    hq, hkv, d = 32, 8, 128
    f, scale = hkv * d, d ** -0.5
    gen = torch.Generator(device="cpu")
    gen.manual_seed(4)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(torch.bfloat16)

    s, c = SERVE_REQUESTS, 512                   # decode: 32 slots, bucket
    dec = [rnd(s, hq, d, std=6.0), rnd(s, c, f), rnd(s, c, f),
           torch.randint(1, c + 1, (s,), generator=gen),
           rnd(s, hkv, d), rnd(s, hkv, d)]
    b, t = 4, PROMPT_LEN                          # prefill: 4 chunks
    pos = torch.arange(t)[None] + torch.tensor([0, 256, 100, 0])[:, None]
    pos[3, 200:] = 1 << 20                        # pad rows past the end
    total = torch.tensor([256, 512, 356, 200])
    pre = [rnd(b, t, hq, d, std=6.0), rnd(b, 256, f), rnd(b, 256, f), pos,
           total, rnd(b, t, hkv, d), rnd(b, t, hkv, d)]
    out = {"phase": "attention", "card": smi_line(),
           "tolerance": f"<= {ATTN_DIFF_SHARE} of outputs differ, each by "
                        f"<= 2^-7 of max |out|"}
    for name, fn, args in (("decode", flat_decode_attention, dec),
                           ("prefill", flat_prefill_attention, pre)):
        want = fn(*args, hkv=hkv, scale=scale).float()
        got = fn(*[a.to(device) for a in args], hkv=hkv,
                 scale=scale).float().cpu()
        if name == "prefill":
            real = pos < total[:, None]
            got, want = got[real], want[real]
        diff = (got - want).abs()
        share = (diff > 0).float().mean().item()
        worst = diff.max().item() / want.abs().max().item()
        out[name] = {"share_differing": share,
                     "max_abs_diff_over_max_out": worst,
                     "max_abs_diff": diff.max().item()}
        if share > ATTN_DIFF_SHARE or worst > 2 ** -7:
            emit(out)
            raise AssertionError(f"{name} attention on {device} is not "
                                 f"the f32-product computation: {out[name]}")
    emit(out)


def sampling_phase(torch, timer):
    """sample_step's candidate pick at the serve shape (32 slots x the
    llama-3.1-8b vocabulary, 128256, k_cap 256) on logits rounded to 1/8,
    so ties straddle the cut: topk_ids (jax.lax.top_k's order, lower id
    first among ties) must give the ids of a full stable descending
    sort; CUDA-event times of both beside torch.topk (no tie order)."""
    from ferrum_tpu_torch.sampling.device import TOPK_CAP, topk_ids
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    x = torch.randn(SERVE_REQUESTS, 128256, generator=gen, device="cuda")
    x = torch.round(x * 8) / 8 + 0.0          # no -0.0: sort ranks it 0.0
    k = TOPK_CAP
    want = torch.sort(x, dim=-1, descending=True,
                      stable=True).indices[:, :k]
    got = topk_ids(x, k)
    cut = torch.sort(x, dim=-1, descending=True).values[:, k - 1:k]
    out = {"phase": "sampling", "slots": x.shape[0], "vocab": x.shape[1],
           "k_cap": k, "equal_to_stable_sort": bool(torch.equal(got, want)),
           "ties_at_cut": int((x == cut).sum().item()),
           "topk_ids_ms": timer(lambda: topk_ids(x, k)),
           "stable_sort_ms": timer(lambda: torch.sort(
               x, dim=-1, descending=True, stable=True)),
           "torch_topk_ms": timer(lambda: torch.topk(x, k, dim=-1)),
           "card": smi_line()}
    emit(out)
    if not out["equal_to_stable_sort"]:
        raise AssertionError("topk_ids is not the stable descending order")


# ---------------------------------------------------------------------------
# serve + logits
# ---------------------------------------------------------------------------

SERVE_REQUESTS, PROMPT_LEN, OUTPUT_LEN = 32, 256, 128


def drop_two_level(params) -> None:
    """Drop every int4 linear's two-level fields in place: the float-scale
    form an int4 checkpoint loads as (scales, zeros only)."""
    import dataclasses

    from ferrum_tpu_torch.ops.quant import QuantLinearParams
    for lp in params.layers:
        for obj in (lp, lp.moe) if lp.moe is not None else (lp,):
            for f in dataclasses.fields(obj):
                lin = getattr(obj, f.name)
                if isinstance(lin, QuantLinearParams):
                    lin.scales2, lin.chan_scale = None, None


def build_engine(model, mode, float_scale, layers=None):
    import dataclasses

    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.quantize import init_random_quant_params

    mc = preset(model)
    if layers is not None:
        mc = dataclasses.replace(mc, num_layers=layers)
    params = init_random_quant_params(mc, seed=0)
    if float_scale:
        drop_two_level(params)
    # bench.py's engine settings: lane buckets 1, 8 and the top, T = 32
    # at bucket 1 and 8 elsewhere, no adaptive window lengths; the
    # pipelined loop with mixed prefill-in-window and refill-first are
    # the defaults. The linear layout with no prefix store, as bench.py
    # sets them.
    cfg = EngineConfig(
        max_num_seqs=SERVE_REQUESTS, max_model_len=1024,
        prefill_chunk_size=PROMPT_LEN, max_num_batched_tokens=2048,
        kv_block_size=PAGE, kv_dtype="bf16", decode_multi_step=8, seed=0,
        decode_bucket_spec="1,8", decode_t_spec="1:32",
        adaptive_windows=False, kv_layout="linear", prefix_cache_blocks=0,
        **mode)
    return mc, EngineBuilder(cfg).with_model(mc, params).build()


def request(tokens, max_tokens=OUTPUT_LEN):
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    return InferenceRequest(
        prompt_token_ids=[int(t) for t in tokens],
        sampling=SamplingParams(max_tokens=max_tokens, ignore_eos=True))


# The counts' key of moe_grouped's launches at <= 256 rows (the
# expert-grid loop), a part of its launches.
GROUPED_DECODE = "moe_grouped at <= 256 rows"


def counts(K):
    """Every kernel's launches since the last reset, and GROUPED_DECODE."""
    return {**K.launch_counts(),
            GROUPED_DECODE: K.MOE_GROUPED.decode_launches}


def off_path(lane):
    """The kernels a lane's runs must not launch: all but its path's."""
    from ferrum_tpu_torch.ops import kernels as K
    return [k.name for k in K.KERNELS if k.name not in lane["path"]]


def serve_run(torch, engine, mc, lane, prompts, path, sync_check=False):
    """len(prompts) concurrent greedy 256/128 requests (all at once)
    through the engine, the launch counts
    set to 0 just before and read just after. Every kernel of `path`
    must launch and no kernel off the lane's path. sync_check: the
    engine's dispatches run under torch.cuda.set_sync_debug_mode
    ("error"), so any host sync of the stream inside one fails the run.
    Returns (launches, responses, the emitted line)."""
    from concurrent.futures import ThreadPoolExecutor

    from ferrum_tpu_torch.ops import kernels as K

    runner = engine.runner
    conc = len(prompts)
    buckets0 = dict(runner.windows_by_bucket)
    mixed0 = runner.mixed_windows
    engine.max_inflight = 0
    runner.sync_debug = "error" if sync_check else None
    K.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(conc) as ex:
            resps = list(ex.map(engine.infer, [request(p) for p in prompts]))
        torch.cuda.synchronize()
    finally:
        runner.sync_debug = None
    wall = time.perf_counter() - t0
    launches = counts(K)
    peak = torch.cuda.max_memory_allocated()
    for r in resps:
        if len(r.token_ids) != OUTPUT_LEN or r.completion_tokens != OUTPUT_LEN:
            raise AssertionError(f"{r.request_id}: {len(r.token_ids)} tokens")
        if not all(0 <= t < mc.vocab_size for t in r.token_ids):
            raise AssertionError(f"{r.request_id}: token out of vocab")
    name = lane["name"]
    idle = [k for k in path if launches[k] == 0]
    if idle:
        raise AssertionError(f"{name} c={conc}: kernels the served path "
                             f"never launched: {idle}")
    stray = [k for k in off_path(lane) if launches[k] != 0]
    if stray:
        raise AssertionError(f"{name} c={conc}: kernels of another route "
                             f"launched: {stray}")
    windows = {b: n - buckets0.get(b, 0)
               for b, n in sorted(runner.windows_by_bucket.items())
               if n - buckets0.get(b, 0)}
    n_windows = sum(windows.values())
    ttft = [r.ttft for r in resps]
    tpot = [(r.e2e_latency - r.ttft) / (OUTPUT_LEN - 1) for r in resps]
    line = {"phase": f"serve{lane['tag']}" + ("" if conc == SERVE_REQUESTS
                                              else f"_c{conc}"),
            "lane": name, "mode": lane["mode"], "model": lane["model"],
            "layers": mc.num_layers, "requests": conc,
            "prompt_len": PROMPT_LEN, "output_len": OUTPUT_LEN,
            "wall_s": wall, "output_tok_s": conc * OUTPUT_LEN / wall,
            "ttft_p50_ms": statistics.median(ttft) * 1e3,
            "ttft_max_ms": max(ttft) * 1e3,
            "tpot_p50_ms": statistics.median(tpot) * 1e3,
            "windows_by_bucket": windows, "mixed_windows":
            runner.mixed_windows - mixed0,
            "max_windows_in_flight": engine.max_inflight,
            "kv_append_rows_per_window":
            launches["kv_append_rows"] / max(n_windows, 1),
            "no_sync_checked": sync_check,
            "max_memory_allocated_gib": peak / 2**30,
            "launches": launches, "card": smi_line()}
    return launches, resps, line


def sync_canary(torch, runner):
    """The no-sync check can fail: under the runner's guard at "error", a
    host sync (`.item()`) raises in this torch build."""
    runner.sync_debug = "error"
    try:
        with runner.sync_guard():
            torch.ones(1, device="cuda").item()
    except RuntimeError:
        return
    finally:
        runner.sync_debug = None
    raise AssertionError("set_sync_debug_mode('error') let a sync through")


def serve_phase(torch, lane, want_solo=None):
    """The lane's serve runs on its model and mode: 32 concurrent greedy
    256/128 requests (every kernel of its path must launch and no
    other), then for lanes with `small` 1 and 4 concurrent ones (their
    path without moe_bmm: 1- and 8-lane windows take the MoE sort
    route, so moe_grouped must launch its <= 256-row loop). The prompt
    of request 0 alone, before and (unless the lane sets `repeat`
    False) after the 32, must give the same tokens, and `want_solo`
    where given. Returns (launch counts by run,
    model config, engine, the solo request's tokens)."""
    import numpy as np

    name, path = lane["name"], lane["path"]
    t0 = time.perf_counter()
    mc, engine = build_engine(lane["model"], lane["mode"],
                              lane["float_scale"], lane.get("layers"))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    prompts = np.random.default_rng(0).integers(
        0, mc.vocab_size, (SERVE_REQUESTS, PROMPT_LEN))
    # The same request alone before and after the loaded run: identical
    # tokens (deterministic, no state left behind by the run).
    solo = engine.infer(request(prompts[0])).token_ids

    if lane.get("sync_check"):
        sync_canary(torch, engine.runner)
    launches, resps, line = serve_run(torch, engine, mc, lane, prompts,
                                      path, lane.get("sync_check", False))
    repeat = lane.get("repeat", True)
    if repeat and engine.infer(request(prompts[0])).token_ids != solo:
        raise AssertionError("a repeated request gave other tokens")
    if want_solo is not None and solo != want_solo:
        raise AssertionError(f"{name}: the solo request's tokens differ "
                             f"from lane {lane['solo_as']}'s")
    emit({**line, "engine_build_s": build_s, "repeat_identical": repeat,
          **({"solo_tokens_equal_to": lane["solo_as"]}
             if want_solo is not None else {}),
          "batched_vs_solo_same_tokens": sum(
              a == b for a, b in zip(resps[0].token_ids, solo)) / OUTPUT_LEN})
    by_run = {name: launches}
    if lane.get("small"):
        small_path = tuple(k for k in path if k != "moe_bmm") + (
            (GROUPED_DECODE,) if "moe_grouped" in path else ())
        for conc in (1, 4):
            launches, _, line = serve_run(
                torch, engine, mc, lane, np.random.default_rng(conc).integers(
                    0, mc.vocab_size, (conc, PROMPT_LEN)), small_path)
            emit(line)
            by_run[f"{name} c={conc}"] = launches
    return by_run, mc, engine, solo


# Lanes F and G: the KV cache's other forms on lane A's weights. Two
# waves of 16 requests, each a 192-token prefix shared by all and 64
# tokens of its own, 64 tokens generated.
FG_REQUESTS, FG_SHARED, FG_OWN, FG_OUT = 16, 192, 64, 64
# Lane G's paged pool: below the ~13 blocks a sequence holds at its
# longest (256 + 64 tokens and the windows' lookahead) times 16.
G_BLOCKS = 150


def fg_waves(mc):
    """The two waves' prompts: one shared prefix, own tails per wave."""
    import numpy as np
    shared = np.random.default_rng(100).integers(0, mc.vocab_size,
                                                 FG_SHARED)
    return [[np.concatenate([shared, np.random.default_rng(
        200 + 50 * w + i).integers(0, mc.vocab_size, FG_OWN)])
        for i in range(FG_REQUESTS)] for w in range(2)]


def fg_engine(mc, params, **kv):
    """An engine on lane A's params (built already: nothing requantized
    or fused again) with A's settings and the KV fields `kv`."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    cfg = EngineConfig(
        max_num_seqs=SERVE_REQUESTS, max_model_len=1024,
        prefill_chunk_size=PROMPT_LEN, max_num_batched_tokens=2048,
        kv_block_size=PAGE, decode_multi_step=8, seed=0,
        decode_bucket_spec="1,8", decode_t_spec="1:32",
        adaptive_windows=False, **kv)
    return EngineBuilder(cfg).with_model(mc, params).build()


def fg_serve(torch, engine, mc, waves, sync_check=False):
    """Each wave's requests at once, the next wave after; the kernels'
    launches over the run (counts from 0), per-wave metric deltas and
    tokens. sync_check: every dispatch under set_sync_debug_mode
    ("error")."""
    import dataclasses
    from concurrent.futures import ThreadPoolExecutor

    from ferrum_tpu_torch.ops import kernels as K
    runner = engine.runner
    K.reset_launch_counts()
    runner.sync_debug = "error" if sync_check else None
    out, deltas = [], []
    t0 = time.perf_counter()
    try:
        for prompts in waves:
            m0 = dataclasses.replace(engine.metrics_snapshot())
            with ThreadPoolExecutor(len(prompts)) as ex:
                resps = list(ex.map(engine.infer, [
                    request(p, FG_OUT) for p in prompts]))
            m1 = engine.metrics_snapshot()
            deltas.append({k: getattr(m1, k) - getattr(m0, k) for k in (
                "tokens_prefilled", "tokens_decoded", "requests_completed",
                "prefix_cache_hits", "prefix_cache_misses",
                "prefix_cache_saved_tokens")})
            for r in resps:
                if r.completion_tokens != FG_OUT or not all(
                        0 <= t < mc.vocab_size for t in r.token_ids):
                    raise AssertionError(f"{r.request_id}: "
                                         f"{r.completion_tokens} tokens")
            out.append([r.token_ids for r in resps])
        torch.cuda.synchronize()
    finally:
        runner.sync_debug = None
    return out, deltas, counts(K), time.perf_counter() - t0


def same_share(a, b):
    """The share of greedy tokens equal position by position."""
    pairs = [(x, y) for wa, wb in zip(a, b) for ra, rb in zip(wa, wb)
             for x, y in zip(ra, rb)]
    return sum(x == y for x, y in pairs) / len(pairs)


def check_path(name, launches, path):
    idle = [k for k in path if launches[k] == 0]
    stray = [k for k in off_path({"path": path}) if launches[k] != 0]
    if idle or stray:
        raise AssertionError(f"{name}: never launched {idle}, launched "
                             f"{stray} off the path")


def lane_f_logits(torch, mc, engine, prompts):
    """On lane F's engine, idle after its waves, two prompts sharing the
    192-token prefix. The first is prefilled into slot 0 in the chunks
    the engine gives it (192, then 64), and its prefix blocks copied to
    the store. The second's first-step logits (a) with the prefix
    restored from the store into slot 1 and its 64 own tokens prefilled
    over it, (b) prefilled whole into slot 2 in the same chunks with no
    store -- the same arithmetic when the store round trip is exact --,
    (c) as (a) through every kernel's plain version, and (d) prefilled
    in one 256-token chunk (its own tokens then attend the prefix
    unquantized: the int8 KV's effect, reported). (a) against (b) and
    (c): lane A's tolerance."""
    from ferrum_tpu_torch.engine import runner as runner_mod
    from ferrum_tpu_torch.models import llama_family as lf
    from ferrum_tpu_torch.ops.kernels import kv_append
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm

    runner = engine.runner
    params, kv, dev = runner.params, runner.kv, runner.device
    n_pre = FG_SHARED // PAGE
    store_blocks = engine.prefix_cache.pool.allocate(n_pre)

    def prefill(slot, toks, start, end, restore=False):
        base = slot * runner.max_pages
        if restore:
            runner.copy_prefix_blocks(store_blocks, list(range(
                base, base + n_pre)), to_store=False)
        toks = torch.as_tensor(toks, device=dev)
        pos = torch.arange(start, end, device=dev)
        h, _ = lf.prefill_forward_batched(
            params, mc, kv, toks[start:end][None], pos[None],
            runner._tables(torch.tensor([slot], device=dev)),
            torch.tensor([end], device=dev), (slot * 1024 + pos)[None],
            ctx_pad=runner.ctx_bucket(end), inv_freq=runner.inv_freq)
        return lf.logits_from_hidden(params, mc, h[0, -1:])

    src, req = prompts
    n = len(req)
    prefill(0, src, 0, FG_SHARED)
    prefill(0, src, FG_SHARED, n)
    runner.copy_prefix_blocks(list(range(n_pre)), store_blocks,
                              to_store=True)
    reused = prefill(1, req, FG_SHARED, n, restore=True)
    prefill(2, req, 0, FG_SHARED)
    whole = prefill(2, req, FG_SHARED, n)
    one_chunk = prefill(3, req, 0, n)
    swaps = [(qmm, "w4a8tl_decode", qmm.w4a8tl_plain),
             (qmm, "w4a8tl_prefill", qmm.w4a8tl_plain),
             (lf, "append_rows_pairs", kv_append.append_rows_pairs_plain),
             (lf, "append_pages_pairs", kv_append.append_pages_pairs_plain),
             (runner_mod, "append_pages_pairs",
              kv_append.append_pages_pairs_plain)]
    saved = [(m, k, getattr(m, k)) for m, k, _ in swaps]
    for m, k, fn in swaps:
        setattr(m, k, fn)
    try:
        plain = prefill(4, req, FG_SHARED, n, restore=True)
    finally:
        for m, k, fn in saved:
            setattr(m, k, fn)
    torch.cuda.synchronize()
    scale = whole.abs().max().item()

    def rel(x):
        return (reused - x).abs().max().item() / scale

    line = {"tolerance_rel": LANES[0]["tol"], "logit_scale": scale,
            "reused_vs_prefilled_whole_rel": rel(whole),
            "reused_vs_plain_rel": rel(plain),
            "reused_vs_one_chunk_rel": rel(one_chunk),
            "finite": bool(torch.isfinite(reused).all())}
    if not (line["finite"] and line["reused_vs_prefilled_whole_rel"]
            <= LANES[0]["tol"] and line["reused_vs_plain_rel"]
            <= LANES[0]["tol"]):
        raise AssertionError(f"lane F logits: {line}")
    return line


def lane_f(torch, mc, params):
    """Lane F: lane A's weights, kv_dtype int8, the linear layout with
    the prefix store (auto size). Two waves: the second's hits and reused
    tokens counted, its prefill tokens down by the reused share, one
    kv_append_rows launch a window carrying four arrays (K, V and their
    scales); the reused-prefix logits checks (lane_f_logits); the share
    of wave 2's greedy tokens equal to the same engine's with no store."""
    import numpy as np

    from ferrum_tpu_torch.models import llama_family as lf
    engine = fg_engine(mc, params, kv_layout="linear", kv_dtype="int8",
                       enable_prefix_cache=True, prefix_cache_blocks=-1)
    if not (engine.runner.kv.quantized
            and engine.runner.prefix_store is not None):
        raise AssertionError("lane F: no int8 pool or no prefix store")
    waves = fg_waves(mc)
    rows_pairs = []
    orig = lf.append_rows_pairs

    def recorded(pairs, *a):
        rows_pairs.append(len(pairs))
        return orig(pairs, *a)

    buckets0 = dict(engine.runner.windows_by_bucket)
    lf.append_rows_pairs = recorded
    try:
        toks, deltas, launches, wall = fg_serve(torch, engine, mc, waves)
    finally:
        lf.append_rows_pairs = orig
    windows = sum(engine.runner.windows_by_bucket.values()) \
        - sum(buckets0.values())
    check_path("F", launches, LLAMA_PATH)
    w1, w2 = deltas
    reused = FG_REQUESTS * FG_SHARED
    ok = (w2["prefix_cache_hits"] == FG_REQUESTS
          and w2["prefix_cache_saved_tokens"] == reused
          and w1["tokens_prefilled"] == FG_REQUESTS * (FG_SHARED + FG_OWN)
          and w2["tokens_prefilled"] == w1["tokens_prefilled"] - reused
          and launches["kv_append_rows"] == windows == len(rows_pairs)
          and set(rows_pairs) == {4})
    line = {"phase": "serve_int8_prefix", "lane": "F llama-3.1-8b w4a8 "
            "two-level, int8 KV, linear + prefix store",
            "requests_per_wave": FG_REQUESTS, "shared_prefix": FG_SHARED,
            "own_tokens": FG_OWN, "output_len": FG_OUT, "wall_s": wall,
            "output_tok_s": 2 * FG_REQUESTS * FG_OUT / wall,
            "store_blocks": engine.runner.prefix_store.num_blocks,
            "waves": deltas, "windows": windows,
            "kv_append_rows_per_window": launches["kv_append_rows"]
            / max(windows, 1), "arrays_per_rows_launch": sorted(
                set(rows_pairs)), "launches": launches, "card": smi_line()}
    if not ok:
        emit(line)
        raise AssertionError("lane F: counts off")
    rng = np.random.default_rng(999)
    line["logits"] = lane_f_logits(torch, mc, engine, [
        np.concatenate([waves[0][0][:FG_SHARED],
                        rng.integers(0, mc.vocab_size, FG_OWN)])
        for _ in range(2)])
    engine.stop()
    del engine
    torch.cuda.empty_cache()
    # The reused wave alone through an engine with no store: the same
    # requests prefilled whole.
    base = fg_engine(mc, params, kv_layout="linear", kv_dtype="int8",
                     prefix_cache_blocks=0)
    plain_toks = fg_serve(torch, base, mc, waves[1:])[0]
    base.stop()
    line["tokens_equal_to_no_store_share"] = same_share(toks[1:],
                                                        plain_toks)
    emit(line)
    return launches


def lane_g(torch, mc, params):
    """Lane G: lane A's weights, the paged layout with the prefix cache,
    a pool of G_BLOCKS: every request of both waves completes, at least
    one sequence is preempted and recomputed, the second wave's prefix
    blocks are shared, and no dispatch syncs the host (the no-sync
    check); the share of wave 1's greedy tokens (the preempted wave)
    equal to a pool where nothing is preempted: the offload form's wave
    1 (lane_g_offload). Returns the launch counts of both forms."""
    engine = fg_engine(mc, params, kv_layout="paged",
                       kv_num_blocks=G_BLOCKS, enable_prefix_cache=True)
    if engine.runner.attn_impl != "ref":
        raise AssertionError("lane G: not the paged layout")
    sync_canary(torch, engine.runner)
    waves = fg_waves(mc)
    toks, deltas, launches, wall = fg_serve(torch, engine, mc, waves,
                                            sync_check=True)
    check_path("G", launches, LLAMA_PATH)
    pool = engine.pool
    line = {"phase": "serve_paged", "lane": "G llama-3.1-8b w4a8 "
            "two-level, paged + prefix cache", "kv_blocks": G_BLOCKS,
            "requests_per_wave": FG_REQUESTS, "output_len": FG_OUT,
            "wall_s": wall, "output_tok_s": 2 * FG_REQUESTS * FG_OUT / wall,
            "waves": deltas,
            "preemptions": engine.scheduler.stats.preemptions,
            "shared_blocks_adopted": deltas[1]["prefix_cache_saved_tokens"]
            // PAGE, "pool_shares": pool.stats.cow_shares,
            "prefix_evictions": engine.prefix_cache.stats.evictions,
            "no_sync_checked": True, "launches": launches,
            "card": smi_line()}
    engine.stop()
    if not (line["preemptions"] >= 1 and deltas[1]["prefix_cache_hits"] >= 1
            and line["shared_blocks_adopted"] >= 1
            and all(d["requests_completed"] == FG_REQUESTS for d in deltas)):
        emit(line)
        raise AssertionError("lane G: checks failed")
    del engine
    torch.cuda.empty_cache()
    off_launches, roomy_toks, roomy_preemptions = lane_g_offload(
        torch, mc, params, waves, toks)
    line["roomy_preemptions"] = roomy_preemptions
    line["tokens_equal_to_roomy_pool_share"] = same_share(toks[:1],
                                                          roomy_toks)
    emit(line)
    if roomy_preemptions:
        raise AssertionError("lane G: the roomy pool preempted")
    return launches, off_launches


# Lane G's offload form: a 64 MiB host tier (the int8 strategy) behind
# the prefix cache; the wave's shared prefix is FG_SHARED / PAGE = 6
# block groups of 4 MiB (bf16 K and V, 32 layers), ~2 MiB each held.
G_OFFLOAD_MB = 64
G_SHARED_BLOCKS = FG_SHARED // PAGE
def wait_released(engine, timeout_s=60.0):
    """Until no sequence runs and no window is in flight (a paged
    sequence's blocks go back after its last window is read)."""
    t0 = time.perf_counter()
    while engine.scheduler.running or engine._inflight_q:
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError("the engine did not release its sequences")
        time.sleep(0.01)


def prefill_device_ms(torch, params, cfg, tokens, reps=3):
    """One sequence's batched prefill of `tokens` (a fresh bf16 cache of
    its pages): the device ms -- its kernels' time summed by
    torch.profiler, a mean over `reps` runs after a warm-up (CUDA events
    around ~2000 eager launches would count the host's pace once the
    launch queue fills) -- and the host-clock ms of one run, waited for."""
    from torch.profiler import ProfilerActivity, profile

    from ferrum_tpu_torch.models import llama_family as lf
    dev = torch.device("cuda")
    n = len(tokens)
    kv = lf.PagedKvCache.create(cfg, n // PAGE, PAGE, dtype=torch.bfloat16,
                                device=dev)
    toks = torch.tensor([int(t) for t in tokens], device=dev)[None]
    pos = torch.arange(n, device=dev)[None]
    tables = torch.arange(n // PAGE, device=dev)[None]
    lens = torch.tensor([n], device=dev)

    def run():
        lf.prefill_forward_batched(params, cfg, kv, toks, pos, tables, lens,
                                   pos, ctx_pad=n)

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    busy_us = sum(getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
                  for e in prof.key_averages()
                  if e.device_type.name == "CUDA")
    if busy_us <= 0:
        raise AssertionError("the profiler saw no device time")
    return busy_us / 1e3 / reps, host_ms


def block_io_costs(torch, engine, blocks, reps=3):
    """Per block group (host clock, medians over `blocks` x reps): the
    spill -- read_kv_block (its blocking copy) and the tier's compress
    -- and the restore -- decompress and write_kv_block until the upload
    has landed; the restores go to a block taken from the pool for the
    purpose."""
    runner, tier = engine.runner, engine.prefix_cache.offload
    scratch = engine.pool.allocate(1)[0]
    out = {k: [] for k in ("read", "compress", "decompress", "upload")}
    try:
        for b in blocks:
            for _ in range(reps):
                t0 = time.perf_counter()
                arrays = runner.read_kv_block(b)
                t1 = time.perf_counter()
                comp = [tier.strategy.compress(a) for a in arrays]
                t2 = time.perf_counter()
                back = [tier.strategy.decompress(c) for c in comp]
                t3 = time.perf_counter()
                runner.write_kv_block(scratch, back)
                torch.cuda.synchronize()
                t4 = time.perf_counter()
                for key, a, z in (("read", t0, t1), ("compress", t1, t2),
                                  ("decompress", t2, t3),
                                  ("upload", t3, t4)):
                    out[key].append((z - a) * 1e3)
    finally:
        engine.pool.free(scratch)
    ms = {f"{k}_ms": statistics.median(v) for k, v in out.items()}
    ms["spill_ms"] = ms["read_ms"] + ms["compress_ms"]
    ms["restore_ms"] = ms["decompress_ms"] + ms["upload_ms"]
    return ms


def none_roundtrip(torch, engine, block):
    """One block group read, kept with the `none` strategy, written into
    another block and read back: equal bit for bit, on the host and in
    the pool."""
    from ferrum_tpu_torch.kv.compression import NoCompression
    none = NoCompression()
    runner, kv = engine.runner, engine.runner.kv
    other = engine.pool.allocate(1)[0]
    try:
        arrays = runner.read_kv_block(block)
        runner.write_kv_block(other, tuple(none.decompress(none.compress(a))
                                           for a in arrays))
        again = runner.read_kv_block(other)
        return all(torch.equal(a, b) for a, b in zip(arrays, again)) \
            and all(torch.equal(t[:, block], t[:, other])
                    for t in (kv.k, kv.v))
    finally:
        engine.pool.free(other)


def lane_g_offload(torch, mc, params, waves, g_toks):
    """Lane G's offload form: lane A's params (built already), the paged
    layout with the prefix cache and a G_OFFLOAD_MB host tier (bf16 KV,
    the int8 strategy), the pool autosized (nothing preempted). Wave 1;
    the release waited for; every cached block evicted (each spills to
    the tier); wave 2, whose shared prefix comes back from the tier.
    Checks: >= G_SHARED_BLOCKS saves and restores, every wave-2 request
    reusing the prefix, rows 1-4 launched and no other kernel, and a
    block group kept with the `none` strategy coming back bit for bit.
    Printed: the share of wave 2's greedy tokens equal to lane G's wave
    2 (no eviction there), the spill and restore ms per block group
    against the device ms of prefilling the prefix. Not under the
    no-sync check: each spill is a declared host sync. Returns (launch
    counts, wave 1's tokens, wave 1's preemptions)."""
    from ferrum_tpu_torch.kv.prefix_cache import _hash_chain

    engine = fg_engine(mc, params, kv_layout="paged",
                       enable_prefix_cache=True,
                       prefix_offload_mb=G_OFFLOAD_MB)
    cache, pool, runner = engine.prefix_cache, engine.pool, engine.runner
    tier = cache.offload
    if tier is None or tier.strategy.name != "int8" \
            or runner.kv.k.dtype != torch.bfloat16:
        raise AssertionError("lane G offload: no int8 tier on a bf16 cache")
    try:
        w1, d1, l1, wall1 = fg_serve(torch, engine, mc, waves[:1])
        preempted = engine.scheduler.stats.preemptions
        wait_released(engine)
        t0 = time.perf_counter()
        evicted = cache.evict(min_free_target=pool.num_blocks)
        evict_s = time.perf_counter() - t0
        spilled = dict(vars(tier.stats))
        w2, d2, l2, wall2 = fg_serve(torch, engine, mc, waves[1:])
        stats = dict(vars(tier.stats))
        launches = {k: l1[k] + l2[k] for k in l1}
        check_path("G offload", launches, LLAMA_PATH)
        parent, chain = 0, []
        shared = [int(t) for t in waves[1][0][:FG_SHARED]]
        for i in range(G_SHARED_BLOCKS):
            parent = _hash_chain(parent, shared[i * PAGE:(i + 1) * PAGE])
            chain.append(cache._by_hash[parent])
        none_equal = none_roundtrip(torch, engine, chain[0])
        costs = block_io_costs(torch, engine, chain)
        prefill_ms, prefill_host_ms = prefill_device_ms(
            torch, runner.params, mc, shared)
        audit = [k for site, k in runner.compile_log if site == "kv_block_io"]
    finally:
        engine.stop()
    line = {"phase": "serve_paged_offload",
            "lane": "G llama-3.1-8b w4a8 two-level, paged + prefix cache "
            "+ host offload tier", "offload_mb": G_OFFLOAD_MB,
            "algo": tier.strategy.name, "kv_blocks": pool.num_blocks,
            "requests_per_wave": FG_REQUESTS, "output_len": FG_OUT,
            "wall_s": [wall1, wall2], "waves": d1 + d2,
            "wave1_preemptions": preempted, "evicted_blocks": evicted,
            "evict_s": evict_s, "tier_after_evict": spilled,
            "tier": stats, "kv_block_io_audit": audit,
            "none_roundtrip_equal": none_equal,
            "wave2_tokens_equal_to_lane_g_share": same_share(g_toks[1:2],
                                                             w2),
            "per_block_group": {**costs, "bytes": 2 * mc.num_layers * PAGE
                                * mc.kv_size * 2},
            "prefix_prefill_device_ms": prefill_ms,
            "prefix_prefill_host_ms": prefill_host_ms,
            "prefill_device_ms_per_block": prefill_ms / G_SHARED_BLOCKS,
            "launches": launches, "card": smi_line()}
    emit(line)
    reused = d2[0]["prefix_cache_saved_tokens"]
    if not (stats["saves"] >= G_SHARED_BLOCKS
            and stats["restores"] >= G_SHARED_BLOCKS
            and reused >= FG_REQUESTS * FG_SHARED and none_equal
            and all(d["requests_completed"] == FG_REQUESTS
                    for d in d1 + d2) and audit):
        raise AssertionError("lane G offload: checks failed")
    del engine
    torch.cuda.empty_cache()
    return launches, w1, preempted


# ---------------------------------------------------------------------------
# Lane H: local HF checkpoint directories, written here and served
# ---------------------------------------------------------------------------

# H1: llama-3.1-8b at full width, 4 layers, GPTQ int4 g128 (layers 1 and
# 3 act-order, so both the fused path and the unfused, permuted one
# run), f16 scales, bf16 embed / norms / lm_head, two shards; H2:
# qwen3-30b-a3b at full width (128 experts, top-8), 2 layers, GPTQ
# experts. Each with its tokenizer.json (Llama-3's and Qwen2's forms).
H_LAYERS = {"llama-3.1-8b": 4, "qwen3-30b-a3b": 2}
H_ACT_ORDER = (1, 3)
H_REQUESTS, H_OUT, H_MERGES = 32, 32, 300
H_WORDS = ("the model serves requests from a local checkpoint with weights "
           "in safetensors shards and a tokenizer that reads its json file "
           "quantized groups of one hundred twenty eight rows share a scale "
           "and a zero the engine batches decode steps across lanes while "
           "prefill chunks fill pages of the cache experts route tokens to "
           "eight of their number each step").split()
H_EXTRA = ("Ünïcödé text: 日本語のテキスト, 中文 and emoji 🙂🚀 stay whole; "
           "numbers 1234567 and 3.14159 too.")
LLAMA3_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
                r"|\p{N}{1,3}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+"
                r"|\s+(?!\S)|\s+")
QWEN2_SPLIT = (r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+"
               r"|\p{N}| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+")
# (split regex, normalizer, specials by id, bos, eos token, eos list)
H_TOKENIZERS = {
    "llama-3.1-8b": (LLAMA3_SPLIT, None, {
        128000: "<|begin_of_text|>", 128001: "<|end_of_text|>",
        128009: "<|eot_id|>"}, "<|begin_of_text|>", "<|eot_id|>",
        [128001, 128008, 128009]),
    "qwen3-30b-a3b": (QWEN2_SPLIT, {"type": "NFC"}, {
        151643: "<|endoftext|>", 151644: "<|im_start|>",
        151645: "<|im_end|>"}, None, "<|im_end|>", [151645, 151643]),
}


def h_prompts():
    """H_REQUESTS seeded prompts of 40-80 words, the first with
    non-ASCII text."""
    import numpy as np
    rng = np.random.default_rng(7)
    out = [" ".join(rng.choice(H_WORDS, rng.integers(40, 81)))
           for _ in range(H_REQUESTS)]
    out[0] = out[0] + " " + H_EXTRA
    return out


def h_tokenizer_json(model, corpus):
    """A tokenizer.json in the checkpoint's form: the byte alphabet, the
    first H_MERGES merges of a plain BPE training on `corpus` (pre-tokens
    by the form's split regex), its specials; Llama-3's adds its BOS."""
    import collections
    import re

    from ferrum_tpu_torch.tokenizer import BYTE_SYMBOL, translate_regex

    split, norm, specials, bos, _, _ = H_TOKENIZERS[model]
    rx = re.compile(translate_regex(split))
    words = collections.Counter(
        tuple(BYTE_SYMBOL[b] for b in w.encode())
        for text in corpus for w in rx.findall(text))
    vocab = {BYTE_SYMBOL[b]: b for b in range(256)}
    merges = []
    while len(merges) < H_MERGES:
        pairs = collections.Counter()
        for w, c in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += c
        if not pairs:
            break
        best = max(pairs, key=lambda p: (pairs[p], p))
        merges.append(f"{best[0]} {best[1]}")
        vocab[best[0] + best[1]] = len(vocab)
        merged = collections.Counter()
        for w, c in words.items():
            out, i = [], 0
            while i < len(w):
                if w[i:i + 2] == best:
                    out.append(best[0] + best[1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += c
        words = merged
    post = {"type": "ByteLevel", "add_prefix_space": True,
            "trim_offsets": False, "use_regex": True}
    if bos is not None:
        bos_id = next(i for i, s in specials.items() if s == bos)
        post = {"type": "Sequence", "processors": [post, {
            "type": "TemplateProcessing",
            "single": [{"SpecialToken": {"id": bos, "type_id": 0}},
                       {"Sequence": {"id": "A", "type_id": 0}}],
            "special_tokens": {bos: {"id": bos, "ids": [bos_id],
                                     "tokens": [bos]}}}]}
    return {
        "version": "1.0", "truncation": None, "padding": None,
        "added_tokens": [{"id": i, "content": s, "single_word": False,
                          "lstrip": False, "rstrip": False,
                          "normalized": False, "special": True}
                         for i, s in sorted(specials.items())],
        "normalizer": norm,
        "pre_tokenizer": {"type": "Sequence", "pretokenizers": [
            {"type": "Split", "pattern": {"Regex": split},
             "behavior": "Isolated", "invert": False},
            {"type": "ByteLevel", "add_prefix_space": False,
             "trim_offsets": True, "use_regex": False}]},
        "post_processor": post,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True,
                    "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None,
                  "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False,
                  "byte_fallback": False,
                  "ignore_merges": model == "llama-3.1-8b",
                  "vocab": vocab, "merges": merges}}


def h_hf_config(mc, layers):
    """config.json of a preset at `layers` layers, GPTQ int4 g128."""
    d = {"vocab_size": mc.vocab_size, "hidden_size": mc.hidden_size,
         "num_hidden_layers": layers, "num_attention_heads": mc.num_heads,
         "num_key_value_heads": mc.num_kv_heads, "head_dim": mc.head_dim,
         "intermediate_size": mc.intermediate_size,
         "rms_norm_eps": mc.rms_norm_eps, "rope_theta": mc.rope_theta,
         "max_position_embeddings": mc.max_position_embeddings,
         "tie_word_embeddings": mc.tie_word_embeddings,
         "bos_token_id": mc.bos_token_id,
         "eos_token_id": list(mc.eos_token_ids), "torch_dtype": "bfloat16",
         "quantization_config": {"quant_method": "gptq", "bits": 4,
                                 "group_size": 128, "desc_act": True,
                                 "sym": True, "checkpoint_format": "gptq"}}
    if mc.moe is None:
        rs = mc.rope_scaling
        d.update(architectures=["LlamaForCausalLM"], rope_scaling={
            "rope_type": rs.rope_type, "factor": rs.factor,
            "low_freq_factor": rs.low_freq_factor,
            "high_freq_factor": rs.high_freq_factor,
            "original_max_position_embeddings":
            rs.original_max_position_embeddings})
    else:
        d.update(architectures=["Qwen3MoeForCausalLM"],
                 num_experts=mc.moe.num_experts,
                 num_experts_per_tok=mc.moe.num_experts_per_tok,
                 moe_intermediate_size=mc.moe.moe_intermediate_size,
                 norm_topk_prob=mc.moe.norm_topk_prob,
                 decoder_sparse_step=1, mlp_only_layers=[])
    return d


def h_tensors(torch, mc, layers, seed=0):
    """The checkpoint's tensors, HF names, made on the card from a seed:
    GPTQ qweight / qzeros (stored zeros 6..8, AutoGPTQ's z - 1) / f16
    scales in [1e-3, 4e-3] / g_idx (a permuted group map in the
    H_ACT_ORDER layers of a dense model) for every projection and expert,
    bf16 embed, norms, router and lm_head."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf = torch.bfloat16

    def normal(*shape, std=0.02):
        return (std * torch.randn(*shape, generator=gen, device=dev)).to(bf)

    def norm(n):
        return (1 + 0.05 * torch.randn(n, generator=gen, device=dev)).to(bf)

    def gptq(out, prefix, in_f, out_f, act_order):
        g = in_f // 128
        qw = torch.randint(-2 ** 31, 2 ** 31, (in_f // 8, out_f),
                           generator=gen, device=dev, dtype=torch.int64)
        nz = torch.randint(6, 9, (g, out_f // 8, 8), generator=gen,
                           device=dev, dtype=torch.int64)
        qz = (nz << (4 * torch.arange(8, device=dev))).sum(-1)
        gi = torch.arange(in_f, device=dev, dtype=torch.int32) // 128
        if act_order:
            gi = gi[torch.randperm(in_f, generator=gen, device=dev)]
        out.update({
            f"{prefix}.qweight": qw.to(torch.int32),
            f"{prefix}.qzeros": torch.where(qz >= 2 ** 31, qz - 2 ** 32,
                                            qz).to(torch.int32),
            f"{prefix}.scales": torch.empty(g, out_f, device=dev).uniform_(
                1e-3, 4e-3, generator=gen).half(),
            f"{prefix}.g_idx": gi})

    h = mc.hidden_size
    t = {"model.embed_tokens.weight": normal(mc.vocab_size, h)}
    for i in range(layers):
        p = f"model.layers.{i}"
        act = mc.moe is None and i in H_ACT_ORDER
        t[f"{p}.input_layernorm.weight"] = norm(h)
        t[f"{p}.post_attention_layernorm.weight"] = norm(h)
        for name, i_f, o_f in (("q", h, mc.q_size), ("k", h, mc.kv_size),
                               ("v", h, mc.kv_size), ("o", mc.q_size, h)):
            gptq(t, f"{p}.self_attn.{name}_proj", i_f, o_f, act)
        if mc.qk_norm:
            t[f"{p}.self_attn.q_norm.weight"] = norm(mc.head_dim)
            t[f"{p}.self_attn.k_norm.weight"] = norm(mc.head_dim)
        if mc.moe is None:
            inter = mc.intermediate_size
            for name, i_f, o_f in (("gate", h, inter), ("up", h, inter),
                                   ("down", inter, h)):
                gptq(t, f"{p}.mlp.{name}_proj", i_f, o_f, act)
        else:
            e, mi = mc.moe.num_experts, mc.moe.moe_intermediate_size
            t[f"{p}.mlp.gate.weight"] = normal(e, h)
            for x in range(e):
                for name, i_f, o_f in (("gate", h, mi), ("up", h, mi),
                                       ("down", mi, h)):
                    gptq(t, f"{p}.mlp.experts.{x}.{name}_proj", i_f, o_f,
                         False)
    t["model.norm.weight"] = norm(h)
    t["lm_head.weight"] = normal(mc.vocab_size, h)
    return t


def write_h_checkpoint(torch, d, model, prompts):
    """Write lane H's checkpoint of `model` under `d` (two shards, by
    layer halves); returns (ModelConfig of the preset, bytes written)."""
    import os

    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.safetensors_io import write_safetensors

    mc, layers = preset(model), H_LAYERS[model]
    tensors = h_tensors(torch, mc, layers)
    first = [n for n in tensors
             if n.startswith("model.embed") or any(
                 n.startswith(f"model.layers.{i}.")
                 for i in range(layers // 2))]
    rest = [n for n in tensors if n not in set(first)]
    for k, names in enumerate((first, rest)):
        write_safetensors(os.path.join(
            d, f"model-0000{k + 1}-of-00002.safetensors"),
            {n: tensors[n] for n in names}, metadata={"format": "pt"})
    del tensors
    _, _, specials, bos, eos, eos_list = H_TOKENIZERS[model]
    files = {"config.json": h_hf_config(mc, layers),
             "generation_config.json": {"bos_token_id": mc.bos_token_id,
                                        "eos_token_id": eos_list},
             "tokenizer.json": h_tokenizer_json(
                 model, prompts + [H_EXTRA] + [" ".join(H_WORDS)] * 4),
             "tokenizer_config.json": {
                 "bos_token": bos, "eos_token": eos,
                 "chat_template": "{% for m in messages %}{{ m.content }}"
                                  "{% endfor %}",
                 "added_tokens_decoder": {
                     str(i): {"content": s, "special": True}
                     for i, s in specials.items()}}}
    for name, obj in files.items():
        with open(os.path.join(d, name), "w", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False)
    nbytes = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
    return mc, nbytes


def tensor_leaves(obj, path=""):
    """(path, tensor) of every tensor in a params tree."""
    import dataclasses
    import torch
    if isinstance(obj, torch.Tensor):
        yield path, obj
    elif isinstance(obj, (list, tuple)):
        for i, x in enumerate(obj):
            yield from tensor_leaves(x, f"{path}[{i}]")
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from tensor_leaves(getattr(obj, f.name),
                                     f"{path}.{f.name}")


def rss_gib():
    """The process's current RSS (VmRSS) in GiB."""
    with open("/proc/self/status") as f:
        return next(int(line.split()[1]) for line in f
                    if line.startswith("VmRSS:")) / 2 ** 20


def peak_rss_gib():
    """The process's peak RSS so far (getrusage) in GiB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


class RssSampler:
    """VmRSS sampled every 2 ms on a thread over a `with` block: its
    peak there (the process's getrusage peak cannot be reset, and the
    earlier phases set it)."""

    def __enter__(self):
        import threading
        self.before = self.peak = rss_gib()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def _run(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, rss_gib())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, rss_gib())


def h_load_check(torch, d):
    """Check 1: the directory loaded onto the card equals, leaf for leaf
    and bit for bit, the directory loaded on the CPU and moved to the
    card. Returns the card load's numbers."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.models.loader import load_checkpoint

    peak0 = peak_rss_gib()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with RssSampler() as rss:
        t0 = time.perf_counter()
        _, on_card, _ = load_checkpoint(d, EngineConfig(model=d), "cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    _, on_cpu, _ = load_checkpoint(d, EngineConfig(model=d), "cpu")
    cpu_load_s = time.perf_counter() - t0
    card, host = list(tensor_leaves(on_card)), list(tensor_leaves(on_cpu))
    if [p for p, _ in card] != [p for p, _ in host]:
        raise AssertionError("the card and CPU loads differ in their leaves")
    differ = [p for (p, a), (_, b) in zip(card, host)
              if a.dtype != b.dtype or a.shape != b.shape
              or not torch.equal(a, b.to(a.device))]
    if differ:
        raise AssertionError(f"card load != CPU load at {differ[:5]}")
    return {"load_s": load_s, "cpu_load_s": cpu_load_s,
            "leaves_equal": len(card),
            "host_peak_rss_before_gib": peak0,
            "host_peak_rss_gib": peak_rss_gib(),
            "load_host_rss_before_gib": rss.before,
            "load_host_rss_peak_gib": rss.peak,
            "load_max_memory_allocated_gib": peak / 2 ** 30}


def h_serve(torch, engine, mc, lane, prompts):
    """Check 2: H_REQUESTS text prompts at once (the launch counts from 0
    around them: every kernel of the lane's path, no other), and the
    first prompt alone before and after: the same tokens each time, and
    the batch's tokens for it. Returns (launches, the emitted line)."""
    from concurrent.futures import ThreadPoolExecutor

    from ferrum_tpu_torch.ops import kernels as K
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    def req(text):
        return InferenceRequest(prompt=text, sampling=SamplingParams(
            max_tokens=H_OUT, ignore_eos=True))

    solo = engine.infer(req(prompts[0])).token_ids
    K.reset_launch_counts()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(prompts)) as ex:
        resps = list(ex.map(engine.infer, map(req, prompts)))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(K)
    check_path(lane["name"], launches, lane["path"])
    for r in resps:
        if r.completion_tokens != H_OUT or not all(
                0 <= t < mc.vocab_size for t in r.token_ids):
            raise AssertionError(f"{lane['name']}: {r.completion_tokens} "
                                 f"tokens or a token out of the vocabulary")
    repeat = engine.infer(req(prompts[0])).token_ids
    if repeat != solo:
        raise AssertionError(f"{lane['name']}: a repeated request gave "
                             f"other tokens")
    # Batched and solo decode compute the same tokens here. (Lane B's
    # random MoE engine does not: its bf16 router GEMM rounds by row
    # count and its top-8 of 128 has near-ties. These seeded weights
    # have none on these prompts.)
    if resps[0].token_ids != solo:
        raise AssertionError(f"{lane['name']}: the batch's tokens for the "
                             f"first prompt differ from the solo's")
    tok = engine.tokenizer
    line = {"requests": len(prompts), "output_len": H_OUT,
            "prompt_tokens": [min(r.prompt_tokens for r in resps),
                              max(r.prompt_tokens for r in resps)],
            "wall_s": wall, "batched_vs_solo_same_tokens": True,
            "repeat_identical": True,
            "stream_text_equals_decode_share": sum(
                r.text == tok.decode(r.token_ids) for r in resps)
            / len(resps),
            "launches": launches}
    return launches, line


def h_tokenizer_check(engine, mc, model, prompts):
    """Check 4: encode -> decode round-trips the prompts (with and
    without the BOS, which decode skips as special), a special token in
    text is one id, and generation_config.json's eos ids reach the
    model config."""
    tok = engine.tokenizer
    _, _, specials, bos, eos, eos_list = H_TOKENIZERS[model]
    for text in prompts:
        for add in (True, False):
            ids = tok.encode(text, add_special_tokens=add)
            if tok.decode(ids) != text:
                raise AssertionError(f"{model}: {text[:40]!r} does not "
                                     f"round-trip")
    with_bos = tok.encode(prompts[1])
    if bos is not None and with_bos[0] != tok.token_to_id(bos):
        raise AssertionError(f"{model}: no BOS")
    ids = tok.encode(f"a{eos}b", add_special_tokens=False)
    if tok.token_to_id(eos) not in ids or tok.decode(
            ids, skip_special_tokens=False) != f"a{eos}b":
        raise AssertionError(f"{model}: the special {eos} is not one id")
    if not set(eos_list) <= set(mc.eos_token_ids) \
            or tuple(tok.eos_token_ids) != tuple(mc.eos_token_ids):
        raise AssertionError(f"{model}: eos ids {mc.eos_token_ids} lack "
                             f"generation_config's {eos_list}")
    tokens = sum(len(tok.encode(t, add_special_tokens=False))
                 for t in prompts)
    return {"tokenizer_vocab": tok.vocab_size,
            "chars_per_token": sum(map(len, prompts)) / tokens,
            "eos_token_ids": list(mc.eos_token_ids),
            "bos_token_id": tok.bos_token_id}


H_LANES = (
    dict(name="H1 llama-3.1-8b GPTQ checkpoint (act-order layers 1, 3)",
         model="llama-3.1-8b", path=LLAMA_PATH, lanes=(1, 1, 1, 1),
         tol=1e-3, min_rows=1.0, depths=(None,), tag="_ckpt_llama",
         guided=True),
    dict(name="H2 qwen3-30b-a3b GPTQ checkpoint", model="qwen3-30b-a3b",
         path=MOE_PATH, lanes=(32, 32, 1, 1), tol=1e-3, min_rows=1.0,
         depths=(None,), tag="_ckpt_moe"),
)


def checkpoint_phase(torch):
    """Lane H: for each of H1 and H2, write the checkpoint directory
    (temporary, removed after), check its card load against its CPU load
    (check 1), build an engine from the directory with the default
    EngineConfig and serve it (check 2), run the logits check on the
    loaded weights (check 3, lane A's tolerance and form), check the
    tokenizer and eos ids (check 4). Returns launch counts by run."""
    import shutil
    import tempfile

    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder

    by_run = {}
    prompts = h_prompts()
    for lane in H_LANES:
        model = lane["model"]
        t_phase = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="ferrum_ckpt_") as d:
            t0 = time.perf_counter()
            mc0, nbytes = write_h_checkpoint(torch, d, model, prompts)
            torch.cuda.synchronize()
            write_s = time.perf_counter() - t0
            free_gib = shutil.disk_usage(d).free / 2 ** 30
            torch.cuda.empty_cache()
            line = {"phase": f"checkpoint{lane['tag']}",
                    "lane": lane["name"], "checkpoint_gib": nbytes / 2 ** 30,
                    "layers": H_LAYERS[model], "write_s": write_s,
                    "disk_free_after_write_gib": free_gib,
                    **h_load_check(torch, d)}
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            engine = EngineBuilder(EngineConfig(model=d)).build()
            torch.cuda.synchronize()
            line["engine_build_s"] = time.perf_counter() - t0
            mc = engine.runner.model_cfg
            if (mc.hidden_size, mc.vocab_size, mc.moe) != (
                    mc0.hidden_size, mc0.vocab_size, mc0.moe):
                raise AssertionError(f"{model}: config.json read as {mc}")
            # act-order layers keep q / k / v and gate / up apart, each
            # with its input permutation; the others are fused.
            layers = engine.runner.params.layers
            line["act_order_layers"] = [
                i for i, lp in enumerate(layers)
                if lp.qkv is None and lp.q.input_perm is not None]
            line["fused_layers"] = [i for i, lp in enumerate(layers)
                                    if lp.qkv is not None]
            if mc.moe is None and line["act_order_layers"] != list(
                    H_ACT_ORDER):
                raise AssertionError(f"{model}: act-order layers "
                                     f"{line['act_order_layers']}")
            line.update(h_tokenizer_check(engine, mc, model, prompts))
            launches, serve = h_serve(torch, engine, mc, lane, prompts)
            line["serve"] = serve
            if lane.get("guided"):
                by_run[f"{lane['name']} guided"], line["guided"] = \
                    h_guided(torch, engine, mc, lane, prompts)
            line["kv_layout"] = engine.cfg.kv_layout
            line["max_memory_allocated_gib"] = \
                torch.cuda.max_memory_allocated() / 2 ** 30
            routes = logits_phase(torch, mc, engine, lane)
            check_path(f"{lane['name']} logits run", routes, lane["path"])
            engine.stop()
            del engine
            torch.cuda.empty_cache()
        line["phase_s"] = time.perf_counter() - t_phase
        line["card"] = smi_line()
        emit(line)
        by_run[lane["name"]] = launches
    return by_run


# The window check's frame: 8 lanes (bucket 8) at 256-token prompts.
WCHECK_LANES = 8
# Its tolerance on the hidden states (bf16): the share of token rows
# whose every value is within one bf16 step of the per-step form's
# (bf16_step_check's bound), and the largest difference over the scale.
WCHECK_MIN_ROWS, WCHECK_MAX_REL = 0.95, 5e-2


def window_check(torch, mc, engine):
    """From one state (8 lanes, each with its 256-token prompt prefilled),
    a T = 8 decode window through decode_forward's window form with one
    append_window_kv, against 8 per-step decode_forward calls on the same
    tokens, at the lane's full width. The window form computes the same
    attention over the frozen cache and the window's earlier steps (not
    cached yet), so its f32 sums run in another order: the hidden
    states must agree within WCHECK_MIN_ROWS /
    WCHECK_MAX_REL, layer 0's window rows of the cache bit for bit (their
    K/V precede any attention), the rest of the window rows within the
    same bound, and every other cache row stays as it was."""
    import numpy as np

    from ferrum_tpu_torch.models import llama_family as lf

    params, dev = engine.runner.params, torch.device("cuda")
    s, t, max_len = WCHECK_LANES, WIN_T, 512
    bps = max_len // PAGE
    rng = np.random.default_rng(5)
    toks = torch.from_numpy(rng.integers(0, mc.vocab_size,
                                         (s, PROMPT_LEN))).to(dev)
    fed = torch.from_numpy(rng.integers(0, mc.vocab_size, (t, s))).to(dev)
    tables = (torch.arange(s, device=dev)[:, None] * bps
              + torch.arange(bps, device=dev)[None])
    kv = lf.PagedKvCache.create(mc, s * bps, PAGE, dtype=torch.bfloat16,
                                device=dev)
    pos = torch.arange(PROMPT_LEN, device=dev)[None].expand(s, -1)
    lf.prefill_forward_batched(
        params, mc, kv, toks, pos, tables,
        torch.full((s,), PROMPT_LEN, device=dev),
        tables[:, :1] * PAGE + pos, ctx_pad=PROMPT_LEN)
    state = (kv.k.clone(), kv.v.clone())
    p0 = torch.full((s,), PROMPT_LEN, device=dev)
    flat = [torch.arange(s, device=dev) * max_len + PROMPT_LEN + i
            for i in range(t)]
    per_step = []
    for i in range(t):
        h, _ = lf.decode_forward(params, mc, kv, fed[i], p0 + i, tables,
                                 p0 + i + 1, flat[i], ctx_pad=max_len)
        per_step.append(h)
    want_k, want_v = kv.k.clone(), kv.v.clone()
    kv.k.copy_(state[0])
    kv.v.copy_(state[1])
    f = kv.kv_heads * kv.head_dim
    win = {"k": torch.zeros((mc.num_layers, t, s, kv.kv_heads, kv.head_dim),
                            dtype=kv.k.dtype, device=dev),
           "cache_len": p0 + 1,
           "k_lins": [kv.k[li].view(s, -1, f)[:, :max_len]
                      for li in range(mc.num_layers)],
           "v_lins": [kv.v[li].view(s, -1, f)[:, :max_len]
                      for li in range(mc.num_layers)]}
    win["v"] = torch.zeros_like(win["k"])
    windowed = []
    for i in range(t):
        win["step"] = i
        win["valid"] = (torch.arange(t, device=dev) < i)[None].expand(s, t)
        h, win = lf.decode_forward(params, mc, kv, fed[i], p0 + i, None,
                                   p0 + i + 1, None, ctx_pad=max_len,
                                   win=win)
        windowed.append(h)
    lf.append_window_kv(kv, win["k"], win["v"], torch.stack(flat))
    torch.cuda.synchronize()
    got, want = torch.stack(windowed), torch.stack(per_step)
    scale = want.float().abs().max().item()
    rows = torch.cat([((g.float() - w.float()).abs()
                       <= 2.0 ** -7 * w.float().abs() + 2.0 ** -12 * scale
                       ).all(-1) for g, w in zip(got, want)])
    h_rel = (got.float() - want.float()).abs().max().item() / scale
    written = torch.zeros(s * bps * PAGE, dtype=torch.bool, device=dev)
    written[torch.stack(flat).reshape(-1)] = True
    written = written.view(s * bps, PAGE)
    cache = {}
    for name, a, w, s0 in (("k", kv.k, want_k, state[0]),
                           ("v", kv.v, want_v, state[1])):
        cache[name] = {
            "others_unchanged": bool(torch.equal(a[:, ~written],
                                                 s0[:, ~written])),
            "layer0_window_rows_equal": bool(torch.equal(
                a[0][written], w[0][written])),
            "window_rows_max_rel": ((a[:, written].float()
                                     - w[:, written].float()).abs().max()
                                    / w[:, written].float().abs().max()
                                    ).item()}
    ok = (rows.float().mean().item() >= WCHECK_MIN_ROWS
          and h_rel <= WCHECK_MAX_REL
          and all(c["others_unchanged"] and c["layer0_window_rows_equal"]
                  and c["window_rows_max_rel"] <= WCHECK_MAX_REL
                  for c in cache.values()))
    line = {"phase": "window_check", "lanes": s, "steps": t,
            "prompt_len": PROMPT_LEN,
            "tolerance": f">= {WCHECK_MIN_ROWS} of token rows within one "
                         f"bf16 step, every value within {WCHECK_MAX_REL} "
                         f"of the scale",
            "rows_within_bf16_step": rows.float().mean().item(),
            "hidden_max_rel_diff": h_rel, "hidden_scale": scale,
            "identical": bool(torch.equal(got, want)), "cache": cache,
            "ok": ok}
    emit(line)
    del kv, state, want_k, want_v, win
    torch.cuda.empty_cache()
    if not ok:
        raise AssertionError(f"window form differs from the per-step form: "
                             f"{line}")


def plain_swaps():
    """(module, name, plain version) of every kernel wrapper the model
    calls: set by name for a comparison run through the plain versions
    only."""
    from ferrum_tpu_torch.models import llama_family as lf
    from ferrum_tpu_torch.ops import moe
    from ferrum_tpu_torch.ops.kernels import kv_append, moe_gemm
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm

    return [(qmm, "w4a8tl_decode", qmm.w4a8tl_plain),
            (qmm, "w4a8tl_gd_decode", qmm.w4a8tl_gd_plain),
            (qmm, "w4a8tl_prefill", qmm.w4a8tl_plain),
            (qmm, "w4a8_decode", qmm.w4a8_plain),
            (qmm, "w4a16_gemm", qmm.w4a16_plain),
            (lf, "append_rows_pairs", kv_append.append_rows_pairs_plain),
            (lf, "append_pages_pairs", kv_append.append_pages_pairs_plain),
            (moe, "quant_bmm_all_experts", moe_gemm.bmm_plain),
            (moe_gemm, "grouped_w4a8tl", moe_gemm.grouped_plain),
            (moe_gemm, "grouped_w4a16", moe_gemm.grouped_w4a16_plain)]


def forward_logits(torch, params, cfg, prompt, lanes, others, fed=None,
                   last_only=False):
    """Logits of a 256-token prefill of `prompt` [1, 256] and one decode
    step per entry of `lanes` (n rows: the previous step's argmax in lane
    0, others[step, 1:n] in the rest, only lane 0 writing the cache), at
    full width on the card; bf16 KV, pages of PAGE. Decode steps take
    the argmax of the previous step's logits, or the tokens `fed` (a
    kernel run's: bf16 logits tie often over a 100k+ vocabulary, and an
    argmax flipped by one ulp would feed two runs different tokens).
    last_only: the prefill's logits of its last row alone (as the engine
    computes them). Returns (logits by step, the tokens fed)."""
    from ferrum_tpu_torch.models import llama_family as lf

    max_len = 1024
    n_blocks = max_len // PAGE
    dev = torch.device("cuda")
    tables = torch.arange(n_blocks, device=dev)[None]
    kv = lf.PagedKvCache.create(cfg, n_blocks, PAGE, dtype=torch.bfloat16,
                                device=dev)
    pos = torch.arange(PROMPT_LEN, device=dev)[None]
    h, kv = lf.prefill_forward_batched(
        params, cfg, kv, prompt, pos, tables,
        torch.tensor([PROMPT_LEN], device=dev), pos, ctx_pad=256)
    out = [lf.logits_from_hidden(params, cfg,
                                 h[0, -1:] if last_only else h[0])]
    toks_fed = []
    tok = out[0][-1:].argmax(-1)
    for step, n in enumerate(lanes):
        tok = tok if fed is None else fed[step]
        toks_fed.append(tok)
        p = torch.full((n,), PROMPT_LEN + step, device=dev)
        toks = torch.cat([tok, others[step, 1:n]])
        flat = torch.full_like(p, lf.OOB_SENTINEL)
        flat[0] = PROMPT_LEN + step
        h, kv = lf.decode_forward(params, cfg, kv, toks, p,
                                  tables.expand(n, -1), p + 1, flat,
                                  ctx_pad=512)
        out.append(lf.logits_from_hidden(params, cfg, h))
        tok = out[-1][:1].argmax(-1)
    torch.cuda.synchronize()
    return out, toks_fed


def plain_run(fn):
    """fn() with every kernel wrapper the model calls set to its plain
    version (plain_swaps), restored after."""
    swaps = plain_swaps()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, plain in swaps:
        setattr(mod, name, plain)
    try:
        return fn()
    finally:
        for mod, name, fn_ in saved:
            setattr(mod, name, fn_)


def logits_phase(torch, mc, engine, lane):
    """One 256-token prefill + one decode step per entry of lane["lanes"]
    of one prompt at full width, through the kernels and then through
    their plain versions (both on the card, on the serve phase's weights),
    at each depth of lane["depths"] (the model's first d layers). A step
    with n > 1 lanes runs n rows: the prompt's token in lane 0 and seeded
    random tokens in the others, every lane reading the prompt's cache and
    only lane 0 writing it (as the runner's inactive lanes). Returns the
    launch counts of the full-depth kernel run."""
    import dataclasses

    import numpy as np

    from ferrum_tpu_torch.ops import kernels as K

    lanes, tol = lane["lanes"], lane["tol"]
    rng = np.random.default_rng(1)
    prompt = torch.from_numpy(rng.integers(0, mc.vocab_size, PROMPT_LEN)
                              ).to("cuda")[None]
    others = torch.from_numpy(rng.integers(
        0, mc.vocab_size, (len(lanes), max(lanes)))).to("cuda")

    def run(params, cfg, fed=None):
        return forward_logits(torch, params, cfg, prompt, lanes, others, fed)

    full = engine.runner.params
    by_depth, launches = [], None
    for depth in [d for d in lane["depths"]
                  if d is None or d < mc.num_layers]:
        d = mc.num_layers if depth is None else depth
        cfg = dataclasses.replace(mc, num_layers=d)
        params = dataclasses.replace(full, layers=full.layers[:d])
        K.reset_launch_counts()
        with_kernels, fed = run(params, cfg)
        if depth is None:
            launches = counts(K)
        plain, _ = plain_run(lambda: run(params, cfg, fed))
        diff = max((a - b).abs().max().item()
                   for a, b in zip(with_kernels, plain))
        scale = max(b.abs().max().item() for b in plain)
        finite = all(bool(torch.isfinite(a).all()) for a in with_kernels)
        # Share of token rows (of every step) whose every logit is within
        # the tolerance.
        rows_ok = torch.cat([((a - b).abs() <= tol * scale).all(-1)
                             for a, b in zip(with_kernels, plain)])
        by_depth.append({"layers": d, "max_abs_diff": diff,
                         "max_rel_diff": diff / scale, "logit_scale": scale,
                         "rows_within_tol": rows_ok.float().mean().item(),
                         "finite": finite, "identical": diff == 0.0})
    # Lanes A, B: the kernels match their plain versions bit for bit, so
    # both runs do the same arithmetic: every logit within 1e-3 of the
    # logit scale only leaves room for library reductions that are not
    # run-to-run stable. Lanes C, D: the w4a16 kernels' f32 sums run in
    # another order than the plain versions' float64 ones, one bf16 step
    # apart on ~0.2% of outputs. On these random weights a token's hidden
    # state is dominated by a few huge components, and such a step can
    # flip a router's top-k or the sign of a cancelling one, which moves
    # that token's whole row: 99% of the token rows (measured 99.6-100%)
    # must have every logit within 2e-2 of the logit scale.
    last = by_depth[-1]
    ok = all(r["finite"] for r in by_depth) \
        and last["rows_within_tol"] >= lane["min_rows"]
    emit({"phase": f"logits{lane['tag']}",
          "steps": f"prefill {PROMPT_LEN} + decode at lanes {list(lanes)}",
          "tolerance_rel": tol, "min_rows_within_tol": lane["min_rows"],
          **{k: v for k, v in last.items() if k != "layers"},
          "by_depth": by_depth, "launches": launches})
    if not ok:
        raise AssertionError(f"logits differ: {by_depth}")
    return launches


def profile_phase(torch, mc, engine, tag, output_len=16):
    """torch.profiler over 32 concurrent 256/`output_len` requests on the
    served engine; device time by kernel and the device's busy share of
    the wall time (the profiler's own host cost inflates the wall time,
    so the busy share is a lower bound)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    prompts = np.random.default_rng(2).integers(
        0, mc.vocab_size, (SERVE_REQUESTS, PROMPT_LEN))
    reqs = [request(p, output_len) for p in prompts]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(SERVE_REQUESTS) as ex:
            list(ex.map(engine.infer, reqs))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0 and e.device_type.name == "CUDA":
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    emit({"phase": f"profile{tag}",
          "requests": SERVE_REQUESTS,
          "prompt_len": PROMPT_LEN, "output_len": output_len,
          "wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
          "device_busy_share": busy_ms / (wall * 1e3),
          "launches": sum(r[1] for r in rows),
          "top": [{"kernel": k[:90], "ms": us / 1e3, "count": n}
                  for us, n, k in rows[:20]],
          "card": smi_line()})


# ---------------------------------------------------------------------------
# bench, profile sink, cli (the measuring modules)
# ---------------------------------------------------------------------------

# bench's cells on lane A's engine: concurrency -> requests, each at
# BENCH_REPEATS repeats, 256/128 (bench.py's cell shape); one wave a
# repeat (two at c = 1 and 4 before lane I joined), for the run's time.
BENCH_CELLS = {1: 1, 4: 4, 32: 32}
BENCH_REPEATS = 2
# The phase times are rounded to the millisecond in the report.
ROUND_S = 1.5e-3


def bench_phase(torch, engine):
    """bench/bench_engine.py's `run_bench` on lane A's engine (no new
    engine): every cell and repeat completes its requests without error,
    meets no program key for the first time (the runner's compile audit;
    the warm-up before each cell's first repeat), runs decode steps, and
    its three phase times are >= 0 and sum to no more than its wall
    time; the last cell carries its stats over the repeats. Kernels 1-4
    must launch during the cells and no other kernel, and the engine's
    metrics count every request of the phase (warm-ups too) completed
    with its OUTPUT_LEN tokens. One line per cell."""
    import dataclasses

    from ferrum_tpu_torch.bench import bench_engine as be
    from ferrum_tpu_torch.ops import kernels as K

    reps, warm = [], []
    run_cell = be.run_cell
    runner = engine.runner
    siblings = runner.warm_prefill_siblings

    def recorded(*args, **kw):
        t = time.perf_counter()
        reps.append(run_cell(*args, **kw))
        # The call's seconds outside the cell: the warm-up wave and the
        # sibling warm-up (first repeat only), request set-up.
        reps[-1] = dict(reps[-1], call_s=time.perf_counter() - t)
        return reps[-1]

    def timed_siblings():
        t = time.perf_counter()
        keys = siblings()
        warm.append({"siblings_s": time.perf_counter() - t,
                     "sibling_keys": keys})
        return keys

    be.run_cell = recorded
    runner.warm_prefill_siblings = timed_siblings
    K.reset_launch_counts()
    m0 = dataclasses.replace(engine.metrics_snapshot())
    t0 = time.perf_counter()
    try:
        report = be.run_bench(
            engine, concurrencies=tuple(BENCH_CELLS),
            num_requests_per_cell=BENCH_CELLS, input_len=PROMPT_LEN,
            output_len=OUTPUT_LEN, model_label="random-int4 llama-3.1-8b",
            n_repeats=BENCH_REPEATS)
    finally:
        be.run_cell = run_cell
        del runner.warm_prefill_siblings
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(K)
    m1 = engine.metrics_snapshot()
    # run_cell's warm-up wave: max(concurrency, 2) requests, first
    # repeat only.
    n_req = sum(max(c, 2) + BENCH_REPEATS * n for c, n in BENCH_CELLS.items())
    done = m1.requests_completed - m0.requests_completed
    decoded = m1.tokens_decoded - m0.tokens_decoded
    if done != n_req or decoded != n_req * (OUTPUT_LEN - 1):
        raise AssertionError(f"bench: {done} of {n_req} requests, {decoded} "
                             f"decode tokens")
    lane = LANES[0]
    idle = [k for k in lane["path"] if launches[k] == 0]
    stray = [k for k in off_path(lane) if launches[k] != 0]
    if idle or stray:
        raise AssertionError(f"bench: never launched {idle}, launched "
                             f"{stray}")
    if report["schema"] != "ferrum-tpu-bench/v1" \
            or len(reps) != len(BENCH_CELLS) * BENCH_REPEATS:
        raise AssertionError("bench: report schema or repeat count")
    smi = smi_line()
    for i, (conc, cell) in enumerate(zip(BENCH_CELLS, report["cells"])):
        mine = reps[i * BENCH_REPEATS:(i + 1) * BENCH_REPEATS]
        for r in mine:
            pt = r["phase_times"]
            parts = (pt["decode_dispatch_s"], pt["decode_sync_s"],
                     pt["prefill_s"])
            if r["completed"] != r["requested"] or r["errors"]:
                raise AssertionError(f"bench c={conc}: {r['completed']} of "
                                     f"{r['requested']}, errors "
                                     f"{r['error_samples']}")
            if r["compilations_during_cell"]:
                raise AssertionError(f"bench c={conc}: keys first met in the "
                                     f"cell: {r['compiled_in_cell']}")
            if pt["decode_steps"] <= 0 or min(parts) < 0 \
                    or sum(parts) > r["wall_s"] + ROUND_S:
                raise AssertionError(f"bench c={conc}: phase times {pt}, "
                                     f"wall {r['wall_s']}")
        stats = cell.get("output_tok_s_stats")
        if stats is None or stats["n"] != BENCH_REPEATS:
            raise AssertionError(f"bench c={conc}: stats {stats}")
        first = mine[0]
        emit({"phase": "bench", "lane": lane["name"], "concurrency": conc,
              "requests": cell["requested"], "prompt_len": PROMPT_LEN,
              "output_len": OUTPUT_LEN, "repeats": BENCH_REPEATS,
              # Before the first repeat: the warm-up wave (max(c, 2)
              # requests) and the no-op sibling dispatches.
              "warmup_s": first["call_s"] - first["wall_s"],
              **warm[i],
              **{k: cell[k] for k in cell if k.endswith("_stats")},
              "per_repeat": [{
                  "wall_s": r["wall_s"], "output_tok_s": r["output_tok_s"],
                  "ttft_p50_ms": r["ttft_p50_ms"],
                  "tpot_p50_ms": r["tpot_p50_ms"],
                  "itl_p95_ms": r["itl_p95_ms"],
                  "compilations_during_cell": r["compilations_during_cell"],
                  "phase_times": r["phase_times"],
                  "phase_shares": {
                      k: r["phase_times"][k] / r["wall_s"]
                      for k in ("decode_dispatch_s", "decode_sync_s",
                                "prefill_s")}} for r in mine],
              "env_hash": report["env_hash"], "card": smi})
    emit({"phase": "bench_done", "wall_s": wall, "launches": launches,
          "requests_completed": done, "tokens_decoded": decoded,
          "compilations": engine.runner.compilations, "card": smi})


def profile_sink_phase(torch, engine):
    """The profile sink (utils/profile.py) at detail debug and sample rate
    1.0, with a memory sink, over one short extra cell on lane A (c = 32,
    32 requests, 256/32; after the timed cells, so its spans cost them
    nothing): every line schema 2 with a known kind and status, one
    window.dispatch per window the runner dispatched, one engine.compile
    per key the runner's audit counted, an engine.memory line from an
    emit_memory() with the card's bytes in use, and
    tools/analyze_profile.py's load / analyze / render accept the file."""
    import os

    from ferrum_tpu_torch.bench.bench_engine import run_cell
    from ferrum_tpu_torch.utils import profile as prof

    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    import analyze_profile

    os.makedirs("chiprun_out", exist_ok=True)
    path, mem = "chiprun_out/profile.jsonl", "chiprun_out/memory.jsonl"
    for f in (path, mem):
        if os.path.exists(f):
            os.remove(f)
    runner = engine.runner
    windows0 = sum(runner.windows_by_bucket.values())
    comp0 = runner.compilations
    sink = prof.configure_global_profile(path, entrypoint="synthetic",
                                         sample_rate=1.0, detail="debug",
                                         memory_path=mem)
    try:
        cell = run_cell(engine, concurrency=SERVE_REQUESTS,
                        num_requests=SERVE_REQUESTS, input_len=PROMPT_LEN,
                        output_len=32, seed=7, warmup=0)
        torch.cuda.synchronize()
        prof.emit_memory({"phase": "profile_sink"})
    finally:
        counters = (sink.events_emitted, sink.events_sampled_out,
                    sink.events_detail_gated)
        prof.configure_global_profile(None)
    windows = sum(runner.windows_by_bucket.values()) - windows0
    compiled = runner.compilations - comp0
    events = [json.loads(x) for x in open(path) if x.strip()]
    bad = [e for e in events if e["schema"] != prof.SCHEMA_VERSION
           or e["kind"] not in prof.KINDS or e["status"] not in prof.STATUSES]
    if bad:
        raise AssertionError(f"profile_sink: malformed lines {bad[:3]}")
    by = {}
    for e in events:
        by[e["event"]] = by.get(e["event"], 0) + 1
    if by.get("window.dispatch", 0) != windows or windows == 0:
        raise AssertionError(f"profile_sink: {by.get('window.dispatch')} "
                             f"window.dispatch lines, {windows} windows")
    if by.get("engine.compile", 0) != compiled:
        raise AssertionError(f"profile_sink: {by.get('engine.compile')} "
                             f"engine.compile lines, {compiled} keys")
    mem_lines = [json.loads(x) for x in open(mem) if x.strip()]
    last = mem_lines[-1] if mem_lines else {}
    if last.get("event") != "engine.memory" \
            or last["attrs"].get("device_bytes_in_use", 0) <= 0:
        raise AssertionError(f"profile_sink: memory sink {mem_lines[-2:]}")
    report = analyze_profile.analyze(analyze_profile.load(path))
    text = analyze_profile.render(report)
    if cell["completed"] != SERVE_REQUESTS or not text:
        raise AssertionError("profile_sink: cell or analyzer")
    emit({"phase": "profile_sink", "requests": SERVE_REQUESTS,
          "prompt_len": PROMPT_LEN, "output_len": 32, "lines": len(events),
          "by_event": by, "windows": windows, "compilations": compiled,
          "sink_counters": counters, "memory_lines": len(mem_lines),
          "device_bytes_in_use": last["attrs"]["device_bytes_in_use"],
          "wall_s": cell["wall_s"], "output_tok_s": cell["output_tok_s"],
          "analyzer_keys": sorted(report),
          "card": smi_line()})


# The cli phase: the port's CLI on the card, dense bf16
# random:qwen3-0.6b (the JAX CLI's random: source), in two processes:
# "plain" serves it through decode windows, "spec" with the same preset
# as its speculative draft (--spec-draft random:, K = 4). The dense
# random:llama-3.1-8b's ~8 G host normals (~200 s of a host core) would
# bound the lanes after A; the three 0.6b draws are ~1/9 of them.
CLI_BASE = ("bench", "random:qwen3-0.6b", "--concurrency", "4",
            "--num-requests", "4", "--input-len", "256", "--output-len",
            "32", "--max-model-len", "1024", "--max-num-seqs", "4",
            "--kv-layout", "linear", "--no-prefix-cache")
CLI_RUNS = {
    "plain": CLI_BASE + ("--output", "chiprun_out/cli_bench.json"),
    "spec": CLI_BASE + ("--spec-draft", "random:qwen3-0.6b", "--spec-k",
                        "4", "--output", "chiprun_out/cli_spec_bench.json"),
}
# Each run's FERRUM_* variables, read by the CLI's config resolution:
# window lengths fixed as before adaptive windows became the default;
# the plain run serves its tied embedding squeezed to int8 (the tied
# int8 logits on the card), which its line's embed_dtype shows.
CLI_ENV = {
    "plain": {"FERRUM_ADAPTIVE_WINDOWS": "0", "FERRUM_SQUEEZE_EMBED": "1"},
    "spec": {"FERRUM_ADAPTIVE_WINDOWS": "0"},
}
# Runs `python -m ferrum_tpu_torch ...` through runpy, times the weight
# draws (init_random_params) and fails if jax was ever imported. Its
# bench waits for a line on stdin (after the engine is built), so the
# card runs it alone once the lanes are done; after it, the engine's
# decode windows and steps and its spec.stats (None without a draft).
CLI_PRELUDE = """
import json, runpy, sys, time
T0 = time.perf_counter()
import ferrum_tpu_torch.bench.bench_engine as be
import ferrum_tpu_torch.models.llama_family as lf
run_bench = be.run_bench
def gated(*a, **kw):
    ready = time.perf_counter()
    sys.stdin.readline()
    print(json.dumps({"ready_after_s": ready - T0,
                      "gate_wait_s": time.perf_counter() - ready}),
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    out = run_bench(*a, **kw)
    eng = a[0]
    st = eng.spec.stats if eng.spec is not None else None
    emb = eng.runner.params.embed
    print(json.dumps({"run_bench_s": time.perf_counter() - t0,
                      "embed_dtype": str(getattr(emb, "q", emb).dtype),
                      "windows": sum(eng.runner.windows_by_bucket.values()),
                      "decode_steps": eng.runner.decode_steps,
                      "spec_stats": st and {
                          "proposals": st.proposals,
                          "drafted_tokens": st.drafted_tokens,
                          "accepted_tokens": st.accepted_tokens,
                          "acceptance_rate": st.acceptance_rate}}),
          file=sys.stderr, flush=True)
    return out
be.run_bench = gated
init = lf.init_random_params
def timed(*a, **kw):
    t0 = time.perf_counter()
    out = init(*a, **kw)
    print(json.dumps({"init_random_params_s": time.perf_counter() - t0}),
          file=sys.stderr, flush=True)
    return out
lf.init_random_params = timed
sys.argv = ["ferrum_tpu_torch", *ARGS]
t0 = time.perf_counter()
try:
    runpy.run_module("ferrum_tpu_torch", run_name="__main__")
    rc = 0
except SystemExit as e:
    rc = e.code
print(json.dumps({"cli_s": time.perf_counter() - t0}), file=sys.stderr)
assert "jax" not in sys.modules, "the port imported jax"
sys.exit(rc)
"""


def cli_start():
    """Start the cli phase's processes, one a CLI_RUNS entry (they draw
    their weights on the host while later phases run; see main)."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "chiprun_out"), exist_ok=True)
    procs = {}
    for name, args in CLI_RUNS.items():
        code = CLI_PRELUDE.replace("ARGS", repr(list(args)))
        procs[name] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-c", code], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=here, env={**os.environ, **CLI_ENV[name]}))
    return procs


def cli_stop(procs):
    """Kill what is left of the cli phase's processes."""
    for _, proc in (procs or {}).values():
        if proc.poll() is None:
            proc.kill()
            proc.communicate()


def cli_finish(procs, timeout_s=600):
    """Let the cli phase's processes run their benches one after the
    other (the lanes are done) and wait for each: exit code 0, its
    report's one cell completed 4 requests with no error, jax never
    imported; the plain run served through decode windows and ran no
    round, the spec run ran speculative rounds (the engine's
    spec.stats)."""
    import os

    here = os.path.dirname(os.path.abspath(__file__))
    try:
        for name, (t0, proc) in procs.items():
            out, err = proc.communicate(input="go\n", timeout=timeout_s)
            tag = f"cli {name}"
            if proc.returncode != 0:
                raise AssertionError(f"{tag}: exit {proc.returncode}\n"
                                     f"{err[-3000:]}")
            args = CLI_RUNS[name]
            with open(os.path.join(
                    here, args[args.index("--output") + 1])) as f:
                report = json.load(f)
            cell = report["cells"][0]
            if cell["completed"] != 4 or cell["errors"] != 0:
                raise AssertionError(f"{tag}: {cell['completed']} completed,"
                                     f" {cell['error_samples']}")
            timing = {"init_random_params_s": []}   # target's, draft's
            for line in err.splitlines():
                if line.startswith("{"):
                    got = json.loads(line)
                    draws = got.pop("init_random_params_s", None)
                    if draws is not None:
                        timing["init_random_params_s"].append(draws)
                    timing.update(got)
            st = timing.get("spec_stats")
            if name == "spec" and not (st and st["proposals"] > 0):
                raise AssertionError(f"{tag}: no speculative round ran: "
                                     f"{timing}")
            if name == "plain" and (st is not None
                                    or timing.get("windows", 0) <= 0
                                    or timing.get("decode_steps", 0) <= 0):
                raise AssertionError(f"{tag}: no decode window ran: "
                                     f"{timing}")
            if name == "plain" and timing.get("embed_dtype") != "torch.int8":
                raise AssertionError(f"{tag}: FERRUM_SQUEEZE_EMBED=1 left "
                                     f"the embedding {timing}")
            emit({"phase": "cli", "run": name,
                  "command": "python -m ferrum_tpu_torch " + " ".join(args),
                  "rc": proc.returncode, "no_jax": True,
                  "schema": report["schema"], "completed": cell["completed"],
                  "errors": cell["errors"],
                  "output_tok_s": cell["output_tok_s"],
                  "ttft_p50_ms": cell["ttft_p50_ms"],
                  "tpot_p50_ms": cell["tpot_p50_ms"],
                  "compilations_during_cell":
                      cell["compilations_during_cell"],
                  "phase_times": cell["phase_times"], **timing,
                  "started_t_s": t0 - T0,
                  "process_wall_s": time.perf_counter() - t0,
                  "card": smi_line()})
    finally:
        cli_stop(procs)


# The server phase (lane A's engine): greedy chat requests of
# SERVER_TOKENS tokens (a bucket-1 window is 32 steps, so a c = 1
# request costs one window however few of them it keeps).
SERVER_TOKENS, SERVER_PROMPTS, SCORE_LEN = 32, 2, 256


def _http(port, method, path, body=None, timeout=300.0):
    """(status, JSON body or SSE events, seconds, seconds to the first
    SSE text) over one stdlib http.client connection."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.perf_counter()
    first = None
    try:
        conn.request(method, path, body=None if body is None
                     else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.getheader("Content-Type", "").startswith("text/event-stream"):
            events = []
            while True:
                line = resp.readline()
                if not line:
                    break
                line = line.decode().strip()
                if not line.startswith("data:"):
                    continue
                payload = line[5:].strip()
                if payload == "[DONE]":
                    events.append("DONE")
                    continue
                ev = json.loads(payload)
                ch = (ev.get("choices") or [{}])[0]
                if first is None and ((ch.get("delta") or {}).get("content")
                                      or ch.get("text")):
                    first = time.perf_counter() - t0
                events.append(ev)
            out = events
        else:
            out = json.loads(resp.read())
        return resp.status, out, time.perf_counter() - t0, first
    finally:
        conn.close()


def _sse_text(events):
    if not events or events[-1] != "DONE":
        raise AssertionError("server: SSE stream without [DONE]")
    text = ""
    for ev in events[:-1]:
        for ch in ev.get("choices") or []:
            text += (ch.get("delta") or {}).get("content") or \
                ch.get("text") or ""
    return text


def server_phase(torch, mc, engine):
    """The port's OpenAI-compatible server (server/app.py) in this
    process on lane A's engine, on a free localhost port, spoken to with
    stdlib http.client only, the launch counts set to 0 just before and
    read just after:
      * 8 concurrent greedy chat completions (SERVER_PROMPTS prompts,
        each streaming and not, and more): every one completes with
        `usage` equal to its chunks' count and a well-formed SSE stream;
      * each prompt alone, non-streaming, streaming and through
        engine.infer on the rendered prompt's ids: the three texts equal,
        and the usage counts equal the engine's;
      * a /v1/completions request with a stop string taken from the
        greedy text: finish "stop", the text a prefix of the greedy text
        without the stop string;
      * an echo + logprobs scoring request of SCORE_LEN prompt tokens:
        its logprobs equal engine.infer's score entries, and those a
        teacher-forced forward of the plain versions on the card within
        lane A's logits tolerance (argmax equal where the plain run's
        top two are further apart than the largest difference);
      * a seeded sampled request sent twice: the same tokens;
      * bench-serve (bench/bench_serve.py) at c = 1 and 4: no failure;
      * engine.abort on a long request: its last chunk says abort and
        running_requests returns to 0.
    Kernels 1-3 must launch and no kernel off lane A's path. Returns the
    launch counts ("A server")."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ferrum_tpu_torch.bench.bench_serve import run_bench_serve
    from ferrum_tpu_torch.models import llama_family as lf
    from ferrum_tpu_torch.ops import kernels as K
    from ferrum_tpu_torch.server.app import FerrumServer
    from ferrum_tpu_torch.types import (FinishReason, InferenceRequest,
                                        SamplingParams)

    lane = LANES[0]
    app = FerrumServer(engine, model_name=lane["model"])
    K.reset_launch_counts()
    t_phase = time.perf_counter()
    srv = app.start()
    port = srv.port
    info = {}
    try:
        rng = np.random.default_rng(7)
        words = ["alpha", "stream", "matrix", "delta", "cloud", "prime"]
        prompts = [" ".join(rng.choice(words, 24)) for _ in
                   range(SERVER_PROMPTS)]

        def chat(text, stream, **kw):
            return {"model": lane["model"], "messages": [
                {"role": "user", "content": text}], "max_tokens":
                SERVER_TOKENS, "temperature": 0, "ignore_eos": True,
                "stream": stream, **kw}

        # 1. 8 concurrent: each prompt streaming and not, then two more
        # pairs of fresh prompts.
        extra = [" ".join(rng.choice(words, 16)) for _ in range(2)]
        bodies = [chat(p, s) for p in prompts + extra for s in (False, True)]
        if len(bodies) != 8:
            raise AssertionError("server: 8 concurrent requests expected")
        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as ex:
            conc = list(ex.map(lambda b: _http(port, "POST",
                                               "/v1/chat/completions", b),
                               bodies))
        conc_wall = time.perf_counter() - t0
        same_pairs = 0
        for b, (status, out, _, _) in zip(bodies, conc):
            if status != 200:
                raise AssertionError(f"server: concurrent status {status} "
                                     f"{out}")
            if b["stream"]:
                usage = [e for e in out[:-1] if e.get("usage")]
                finish = [e for e in out[:-1] if e.get("choices")
                          and e["choices"][0].get("finish_reason")]
                if usage or not finish or finish[-1]["choices"][0][
                        "finish_reason"] != "length":
                    raise AssertionError("server: concurrent stream form")
            elif out["usage"]["completion_tokens"] != SERVER_TOKENS \
                    or out["usage"]["total_tokens"] != \
                    out["usage"]["prompt_tokens"] + SERVER_TOKENS:
                raise AssertionError(f"server: usage {out['usage']}")
        for i in range(0, 8, 2):
            same_pairs += conc[i][1]["choices"][0]["message"]["content"] \
                == _sse_text(conc[i + 1][1])

        # 2. each prompt alone: non-streaming, streaming (with usage),
        # engine.infer on the same ids.
        alone = []
        for p in prompts:
            s1, whole, t_whole, _ = _http(port, "POST",
                                          "/v1/chat/completions",
                                          chat(p, False))
            s2, events, t_stream, ttft = _http(
                port, "POST", "/v1/chat/completions",
                chat(p, True, stream_options={"include_usage": True}))
            ids = engine.tokenizer.encode(app.renderer.render(
                [{"role": "user", "content": p}]))
            r = engine.infer(InferenceRequest(
                prompt_token_ids=ids, sampling=SamplingParams(
                    max_tokens=SERVER_TOKENS, ignore_eos=True)))
            text = whole["choices"][0]["message"]["content"]
            usage = [e for e in events[:-1] if e.get("usage")][-1]["usage"]
            if (s1, s2) != (200, 200) or text != _sse_text(events) \
                    or text != r.text:
                raise AssertionError(f"server: HTTP text != SSE deltas != "
                                     f"engine.infer ({text!r}, {r.text!r})")
            if whole["usage"] != usage or usage != {
                    "prompt_tokens": r.prompt_tokens,
                    "completion_tokens": r.completion_tokens,
                    "total_tokens": r.prompt_tokens + r.completion_tokens}:
                raise AssertionError(f"server: usage {usage} vs engine "
                                     f"{r.prompt_tokens}/{r.completion_tokens}")
            # TPOT = (e2e - TTFT) / (tokens - 1), over HTTP from the
            # stream's first text and its end.
            n1 = max(r.completion_tokens - 1, 1)
            alone.append({"http_e2e_s": t_whole, "http_stream_e2e_s":
                          t_stream, "http_ttft_s": ttft,
                          "http_tpot_ms": (t_stream - ttft) / n1 * 1e3,
                          "infer_e2e_s": r.e2e_latency,
                          "infer_ttft_s": r.ttft,
                          "infer_tpot_ms": (r.e2e_latency - r.ttft) / n1
                          * 1e3})
        info["alone"] = alone

        # 3. a stop string from the greedy text.
        body = {"model": lane["model"], "prompt": prompts[0],
                "max_tokens": SERVER_TOKENS, "temperature": 0,
                "ignore_eos": True}
        _, full, _, _ = _http(port, "POST", "/v1/completions", body)
        full_text = full["choices"][0]["text"]
        # The shortest string from the text's middle whose first match
        # is there.
        mid = len(full_text) // 2
        stop = next((full_text[mid:mid + n] for n in range(3, 64)
                     if full_text.find(full_text[mid:mid + n]) == mid),
                    full_text[mid:])
        _, cut, _, _ = _http(port, "POST", "/v1/completions",
                             {**body, "stop": stop})
        cut_text = cut["choices"][0]["text"]
        if cut["choices"][0]["finish_reason"] != "stop" \
                or not full_text.startswith(cut_text) or stop in cut_text \
                or cut["usage"]["completion_tokens"] >= SERVER_TOKENS:
            raise AssertionError(f"server: stop {stop!r} gave {cut}")
        info["stop"] = {"stop": stop, "completion_tokens":
                        cut["usage"]["completion_tokens"]}

        # 4. scoring against a teacher-forced plain forward.
        score_prompt = "".join(chr(c) for c in rng.integers(
            32, 127, SCORE_LEN))
        status, scored, t_score, _ = _http(port, "POST", "/v1/completions", {
            "model": lane["model"], "prompt": score_prompt, "max_tokens": 0,
            "echo": True, "logprobs": 1})
        ids = engine.tokenizer.encode(score_prompt)
        r = engine.infer(InferenceRequest(
            prompt=score_prompt, echo=True,
            sampling=SamplingParams(max_tokens=0, logprobs=1)))
        lp_http = scored["choices"][0]["logprobs"]["token_logprobs"]
        if status != 200 or len(ids) != SCORE_LEN \
                or lp_http != [e["logprob"] for e in r.logprobs]:
            raise AssertionError("server: scoring over HTTP != engine.infer")
        dev = engine.runner.device
        kv = lf.PagedKvCache.create(mc, SCORE_LEN // PAGE, PAGE,
                                    dtype=torch.bfloat16, device=dev)
        tok = torch.tensor(ids, device=dev)[None]
        pos = torch.arange(SCORE_LEN, device=dev)[None]
        saved = [(m, n, getattr(m, n)) for m, n, _ in plain_swaps()]
        for m, n, fn in plain_swaps():
            setattr(m, n, fn)
        try:
            h, _ = lf.prefill_forward_batched(
                engine.runner.params, mc, kv, tok, pos,
                torch.arange(SCORE_LEN // PAGE, device=dev)[None],
                torch.tensor([SCORE_LEN], device=dev), pos,
                ctx_pad=SCORE_LEN)
            logits = lf.logits_from_hidden(engine.runner.params, mc,
                                           h[0]).float()
        finally:
            for m, n, fn in saved:
                setattr(m, n, fn)
        lsm = torch.log_softmax(logits, -1)
        tgt = torch.tensor(ids[1:], device=dev)
        want_lp = lsm[:-1].gather(1, tgt[:, None])[:, 0].cpu().numpy()
        top2 = torch.topk(logits[:-1], 2, dim=-1).values
        gap = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        want_am = logits[:-1].argmax(-1).cpu().numpy()
        got_lp = np.array([e["logprob"] for e in r.logprobs[1:]])
        got_am = np.array([e["argmax_id"] for e in r.logprobs[1:]])
        scale = float(logits.abs().max())
        diff = float(np.abs(got_lp - want_lp).max())
        clear = gap > 2 * diff
        if diff > 2 * lane["tol"] * scale \
                or (got_am[clear] != want_am[clear]).any():
            raise AssertionError(f"server: scoring vs plain {diff} (scale "
                                 f"{scale}), argmax differs at "
                                 f"{np.nonzero(got_am != want_am)[0][:8]}")
        info["score"] = {"tokens": SCORE_LEN, "http_s": t_score,
                         "max_abs_logprob_diff_vs_plain": diff,
                         "logit_scale": scale, "tolerance_rel":
                         lane["tol"], "argmax_checked": int(clear.sum()),
                         "argmax_equal": int((got_am == want_am).sum())}

        # 5. a seeded sampled request, twice.
        seeded = {"model": lane["model"], "prompt": prompts[1],
                  "max_tokens": SERVER_TOKENS, "temperature": 1.0,
                  "top_k": 40, "seed": 1234, "ignore_eos": True}
        runs = [_http(port, "POST", "/v1/completions", seeded)[1]
                for _ in range(2)]
        if runs[0]["choices"][0]["text"] != runs[1]["choices"][0]["text"]:
            raise AssertionError("server: a seeded request gave two texts")

        # 6. bench-serve at c = 1 and 4.
        rep = run_bench_serve(f"http://127.0.0.1:{port}", lane["model"],
                              concurrencies=(1, 4), num_requests=4,
                              input_len=48, output_len=16, timeout=300)
        for cell in rep["cells"]:
            if cell["errors"] or cell["completed"] != 4:
                raise AssertionError(f"server: bench-serve {cell}")
        info["bench_serve"] = [
            {k: c[k] for k in ("concurrency", "completed", "errors", "wall_s",
                               "output_tok_s", "ttft_p50_ms", "tpot_p50_ms",
                               "e2e_p50_ms")} for c in rep["cells"]]

        # 7. abort a long request.
        long_req = InferenceRequest(
            prompt_token_ids=ids[:64], sampling=SamplingParams(
                max_tokens=512, ignore_eos=True))
        q = engine.submit(long_req)
        chunk = q.get(timeout=300)
        engine.abort(long_req.request_id)
        while not chunk.finished:
            chunk = q.get(timeout=300)
        deadline = time.monotonic() + 60
        while engine.metrics_snapshot().running_requests \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        if chunk.finish_reason != FinishReason.ABORT \
                or engine.metrics_snapshot().running_requests:
            raise AssertionError(f"server: abort gave {chunk.finish_reason}, "
                                 f"{engine.metrics_snapshot()}")
        info["abort"] = {"completion_tokens_at_abort":
                         chunk.completion_tokens}
    finally:
        srv.stop()
    if engine.runner.device.type == "cuda":
        torch.cuda.synchronize()
    launches = counts(K)
    idle = [k for k in ("w4a8tl_decode", "w4a8tl_prefill", "kv_append_rows")
            if launches[k] == 0]
    stray = [k for k in off_path(lane) if launches[k] != 0]
    if idle or stray:
        raise AssertionError(f"server: never launched {idle}, launched "
                             f"{stray}")
    emit({"phase": "server", "lane": lane["name"],
          "wall_s": time.perf_counter() - t_phase,
          "concurrent": {"requests": 8, "wall_s": conc_wall,
                         "stream_equals_nonstream_pairs": same_pairs},
          **info, "launches": launches, "card": smi_line()})
    return launches


# ---------------------------------------------------------------------------
# guided decoding (lane A over HTTP and engine.infer; lane H1's checkpoint)
# ---------------------------------------------------------------------------

GUIDED_TOKENS = 48
GUIDED_SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "n": {"type": "integer"}},
    "required": ["ok", "n"]}
# tests/test_guided_device.py's engine patterns, and one FSM that
# build_token_fsm refuses (a state tells U+0100 from U+0101 apart): the
# host-masked path, not forced.
GUIDED_PATTERNS = (r"(yes|no)", r"-?\d\d", r"(foo|bar)+x")
GUIDED_REFUSED = "[a-z]+(ā)?"
GUIDED_TOOLS = [{"type": "function", "function": {
    "name": "weather", "description": "the weather in a city",
    "parameters": {"type": "object", "properties": {
        "city": {"type": "string"}}, "required": ["city"]}}}]


def _in_language(pattern, text, finish):
    """The text is the pattern's (finish "stop"), or a prefix the DFA
    can still walk (finish "length")."""
    from ferrum_tpu_torch.sampling.regex_dfa import compile_regex
    dfa = compile_regex(pattern)
    if finish == "stop":
        return dfa.fullmatch(text)
    return finish == "length" and dfa.walk(dfa.start, text) is not None


def _guided_req(prompt, guided, max_tokens=GUIDED_TOKENS, **sp):
    from ferrum_tpu_torch.types import (GuidedOptions, InferenceRequest,
                                        SamplingParams)
    return InferenceRequest(
        prompt=prompt, guided=None if guided is None
        else GuidedOptions(**guided),
        sampling=SamplingParams(max_tokens=max_tokens,
                                **{"temperature": 0.0, **sp}))


def _host_path(engine, fn):
    """fn() with the device-FSM setup off: every guided request takes
    the host-masked path."""
    engine._setup_device_guided = lambda seq, opts: None
    try:
        return fn()
    finally:
        del engine._setup_device_guided


def _check_launches(name, launches, lane):
    idle = [k for k in ("w4a8tl_decode", "w4a8tl_prefill", "kv_append_rows")
            if launches[k] == 0]
    stray = [k for k in off_path(lane) if launches[k] != 0]
    if idle or stray:
        raise AssertionError(f"{name}: never launched {idle}, launched "
                             f"{stray}")


def guided_launches(torch, runner, vocab, reps=20):
    """The kernels guided decoding adds, counted by torch.profiler (CUDA
    activity) on the card over `reps` repetitions at a bucket-1 lane:
    a step's (guided_mask_rows, the mask's `where` in sample_step,
    guided_advance over every codepoint column) and a window's (the
    init row's drain, the lanes' gather and scatter of their states),
    with each form's device time from CUDA events. None when the
    profiler sees no device kernel."""
    from torch.profiler import ProfilerActivity, profile

    from ferrum_tpu_torch.sampling import device as sd

    gtrans, gmask, gcps, _ = runner._guided_tables()
    dev = runner.device
    st = torch.ones(1, dtype=torch.int32, device=dev)
    slots = torch.zeros(1, dtype=torch.int64, device=dev)
    logits = torch.zeros(1, vocab, device=dev)
    tok = torch.zeros(1, dtype=torch.int64, device=dev)
    gi = torch.full((runner.num_slots + 1,), -1, dtype=torch.int64,
                    device=dev)

    def step():
        torch.where(sd.guided_mask_rows(gmask, st, vocab), logits,
                    float("-inf"))
        sd.guided_advance(gtrans, gcps, st, tok)

    def window():
        runner._drain_ginit(gi)
        runner.gstates.index_copy_(0, slots, runner.gstates[slots])

    out = {}
    for name, fn in (("step", step), ("window", window)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        n = sum(e.count for e in prof.key_averages()
                if e.device_type.name == "CUDA")
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            fn()
        t1.record()
        t1.synchronize()
        out[name] = {"kernels": n / reps if n else None,
                     "ms": t0.elapsed_time(t1) / reps}
    return out


def guided_phase(torch, mc, engine):
    """Guided decoding on lane A's engine (the server phase's process,
    built and warm), every dispatch under the no-sync check
    (runner.sync_debug = "error", after sync_canary shows it raises),
    the launch counts set to 0 just before and read just after:
      1. over HTTP, greedy, max_tokens 48, each streaming and not:
         guided_regex (yes|no), guided_choice of two words, guided_json
         and a strict response_format.json_schema (GUIDED_SCHEMA),
         response_format json_object, tool_choice="required" with
         GUIDED_TOOLS. Each text is its DFA's (finish stop) or a prefix
         it can walk (length); a strict-schema answer validates or is
         the server's 400 naming response_format.json_schema; the
         required tool call is a tool call or the 400 naming
         tool_choice; the SSE outcome equals the non-streaming one; the
         completions texts equal engine.infer's;
      2. eight requests (four guided by two patterns, four unguided)
         submitted while the loop is held, so that they share bucket-8
         windows: each text equals the same request's alone (the FREE
         row leaves unguided lanes as they were);
      3. the device-FSM path against the host-masked path on the same
         engine over GUIDED_PATTERNS: the same tokens; GUIDED_REFUSED
         takes the host path unforced (its FSM refused) and stays in its
         language;
      4. a seeded sampled guided request twice over HTTP: the same text,
         in the language;
      5. guided_mask_rows and guided_advance on the card against the
         same functions on the CPU, bit for bit, on the registered
         tables;
      6. kernels 1-3 launch, none off lane A's path.
    Part 1's requests (with the completions cases' engine.infer twins)
    and part 4's pair go at once; part 3's sets each at once. Measured
    beside them: the FSM build at the model's vocabulary (vocab_table,
    then build_token_fsm of the schema, JSON mode and (yes|no)), the
    registered table bytes, TPOT p50 at c = 1 (part 2's alone runs: 2
    guided by [a-z ]+, 4 plain, 33 tokens each), and the kernels and
    device time guided decoding adds a step and a window
    (guided_launches).
    Returns the launch counts ("A guided")."""
    import threading
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ferrum_tpu_torch.ops import kernels as K
    from ferrum_tpu_torch.sampling import device as sd
    from ferrum_tpu_torch.sampling.guided import JsonModeProcessor
    from ferrum_tpu_torch.sampling.regex_dfa import compile_regex
    from ferrum_tpu_torch.sampling.schema import (
        schema_to_regex, validate_json_against_subset)
    from ferrum_tpu_torch.sampling.token_fsm import build_token_fsm, vocab_table
    from ferrum_tpu_torch.server.app import FerrumServer

    lane = LANES[0]
    runner = engine.runner
    tok = engine.tokenizer
    schema_re = schema_to_regex(GUIDED_SCHEMA)
    t0 = time.perf_counter()
    vt = vocab_table(tok, mc.vocab_size)
    fsm_info = {"vocab": mc.vocab_size, "vocab_table_s":
                time.perf_counter() - t0,
                "token_codepoints_max": int(vt.token_cps.shape[1]),
                "fsms": {}}
    for name, pat in (("json_schema", schema_re),
                      ("json_object", JsonModeProcessor.JSON_REGEX),
                      ("yes_no", "(yes|no)")):
        t0 = time.perf_counter()
        fsm = build_token_fsm(compile_regex(pat), vt, mc.vocab_size)
        fsm_info["fsms"][name] = {"build_s": time.perf_counter() - t0,
                                  "rows": fsm.num_states}
    sync_canary(torch, runner)
    prompt = "Answer the question about the weather in Paris today."
    app = FerrumServer(engine, model_name=lane["model"])
    K.reset_launch_counts()
    t_phase = time.perf_counter()
    runner.sync_debug = "error"
    srv = app.start()
    port = srv.port
    info = {}
    try:
        # 1. the HTTP requests, each streaming and not, the completions
        # cases' engine.infer twins and a seeded sampled pair, all at
        # once (lane A's windows are batch-invariant: part 2 checks it).
        def msgs():
            return [{"role": "user", "content": prompt}]
        cmpl = {"prompt": prompt}
        cases = [
            ("guided_regex", "/v1/completions",
             {**cmpl, "guided_regex": "(yes|no)"}, "(yes|no)",
             {"regex": "(yes|no)"}),
            ("guided_choice", "/v1/completions",
             {**cmpl, "guided_choice": ["sunny", "rainy"]}, "sunny|rainy",
             {"regex": "sunny|rainy"}),
            ("guided_json", "/v1/completions",
             {**cmpl, "guided_json": GUIDED_SCHEMA}, schema_re,
             {"json_schema": GUIDED_SCHEMA}),
            ("json_schema", "/v1/chat/completions",
             {"messages": msgs(), "response_format": {
                 "type": "json_schema", "json_schema": {
                     "name": "answer", "strict": True,
                     "schema": GUIDED_SCHEMA}}}, schema_re, None),
            ("json_object", "/v1/chat/completions",
             {"messages": msgs(), "response_format": {
                 "type": "json_object"}}, JsonModeProcessor.JSON_REGEX,
             None),
            ("tool_required", "/v1/chat/completions",
             {"messages": msgs(), "tools": GUIDED_TOOLS,
              "tool_choice": "required"}, None, None),
        ]
        seeded = {"model": lane["model"], "prompt": prompt,
                  "guided_regex": "(ab|cd)+ [a-z]{2,8}",
                  "max_tokens": 24, "temperature": 1.0, "top_k": 40,
                  "seed": 4321}
        jobs = [("http", (path, {"model": lane["model"],
                                 "max_tokens": GUIDED_TOKENS,
                                 "temperature": 0, "stream": stream,
                                 **extra}))
                for _, path, extra, _, _ in cases for stream in (False, True)]
        jobs += [("infer", _guided_req(prompt, opts))
                 for _, _, _, _, opts in cases if opts is not None]
        jobs += [("http", ("/v1/completions", seeded))] * 2

        def run(job):
            kind, arg = job
            if kind == "infer":
                return engine.infer(arg)
            return _http(port, "POST", *arg)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(jobs)) as ex:
            results = list(ex.map(run, jobs))
        http_s = time.perf_counter() - t0
        infers = iter(r for (kind, _), r in zip(jobs, results)
                      if kind == "infer")

        def outcome(stream, res):
            status, out = res[0], res[1]
            if stream:
                errs = [e for e in out[:-1] if "error" in e]
                if errs:
                    return ("error", errs[0]["error"]["param"])
                fin = [e["choices"][0]["finish_reason"] for e in out[:-1]
                       if e.get("choices")
                       and e["choices"][0].get("finish_reason")]
                calls = [d for e in out[:-1] for d in
                         ((e.get("choices") or [{}])[0].get("delta")
                          or {}).get("tool_calls") or []]
                return ("ok", "" if calls else _sse_text(out), fin[-1],
                        len(calls))
            if status != 200:
                return ("error", out["error"]["param"])
            ch = out["choices"][0]
            text = ch.get("text")
            calls = (ch.get("message") or {}).get("tool_calls") or []
            if text is None:
                text = "" if calls else ch["message"]["content"] or ""
            return ("ok", text, ch["finish_reason"], len(calls))

        http = {}
        for i, (name, _, _, pattern, opts) in enumerate(cases):
            got, streamed = outcome(False, results[2 * i]), \
                outcome(True, results[2 * i + 1])
            if got != streamed:
                raise AssertionError(f"guided {name}: streaming {streamed}"
                                     f" != non-streaming {got}")
            if got[0] == "error":
                want = "tool_choice" if name == "tool_required" \
                    else "response_format.json_schema"
                if got[1] != want or name not in ("json_schema",
                                                  "tool_required"):
                    raise AssertionError(f"guided {name}: 400 {got}")
            elif name == "tool_required":
                if got[2] != "tool_calls" or not got[3]:
                    raise AssertionError(f"guided {name}: {got}")
            else:
                if not _in_language(pattern, got[1], got[2]):
                    raise AssertionError(f"guided {name}: {got[1]!r} "
                                         f"({got[2]}) is not in the "
                                         f"language")
                if (name == "json_schema" or (name == "guided_json"
                                              and got[2] == "stop")) \
                        and not validate_json_against_subset(
                            got[1], GUIDED_SCHEMA):
                    raise AssertionError(f"guided {name}: {got[1]!r} "
                                         f"fails the schema")
            if opts is not None:
                r = next(infers)
                if got[0] != "ok" or r.text != got[1] \
                        or r.finish_reason.value != got[2]:
                    raise AssertionError(f"guided {name}: HTTP {got} != "
                                         f"engine.infer {r.text!r}")
            http[name] = {"outcome": got[0], "finish": got[2] if got[0] ==
                          "ok" else None, "chars": len(got[1]) if got[0] ==
                          "ok" else 0, "param": got[1] if got[0] == "error"
                          else None}
        info["http"] = http
        info["http_wall_s"] = http_s

        # 4. the seeded sampled guided pair (in the same burst).
        runs = [res[1]["choices"][0] for res in results[-2:]]
        if runs[0] != runs[1] or not _in_language(
                seeded["guided_regex"], runs[0]["text"],
                runs[0]["finish_reason"]):
            raise AssertionError(f"guided: seeded {runs}")
        info["seeded"] = {"text": runs[0]["text"]}

        # 2. eight requests sharing bucket-8 windows vs each alone; the
        # alone runs of [a-z ]+ (guided) and of the unguided prompts are
        # the c = 1 TPOT samples (33 tokens: one bucket-1 window).
        pats = ("[a-z ]+", "(yes|no)")
        specs = [(f"{prompt} Case {i}.", {"regex": pats[i % 2]} if i < 4
                  else None) for i in range(8)]

        def req8(p, g):
            return _guided_req(p, g, max_tokens=33, ignore_eos=True)
        alone = [engine.infer(req8(p, g)) for p, g in specs]
        tpot = {}
        for name, rs in (("guided", alone[0:4:2]), ("plain", alone[4:])):
            tpot[name] = statistics.median(
                (r.e2e_latency - r.ttft) / (r.completion_tokens - 1) * 1e3
                for r in rs)
        info["tpot_p50_ms"] = tpot
        info["tpot_tokens"] = [r.completion_tokens for r in alone]
        b0 = dict(runner.windows_by_bucket)
        gate = threading.Event()
        run_iteration = engine.run_iteration

        def held():
            gate.wait()
            return run_iteration()
        engine.run_iteration = held
        try:
            time.sleep(0.2)                # the loop reaches the gate
            queues = [engine.submit(req8(p, g)) for p, g in specs]
        finally:
            del engine.run_iteration
            gate.set()
        together = []
        for q in queues:
            text, chunk = "", None
            while chunk is None or not chunk.finished:
                chunk = q.get(timeout=300)
                text += chunk.text
            together.append((text, chunk.finish_reason.value))
        buckets = {b: n - b0.get(b, 0) for b, n in
                   runner.windows_by_bucket.items() if n - b0.get(b, 0)}
        if [(r.text, r.finish_reason.value) for r in alone] != together:
            raise AssertionError(f"guided: batched texts differ from alone "
                                 f"{together} vs {[r.text for r in alone]}")
        if not buckets.get(8) or buckets.get(32):
            raise AssertionError(f"guided: the 8 rode windows {buckets}")
        for (p, g), (text, fin) in zip(specs, together):
            if g is not None and not _in_language(g["regex"], text, fin):
                raise AssertionError(f"guided: {text!r} not in {g}")
        info["batch8"] = {"windows_by_bucket": buckets,
                          "texts_equal_alone": 8}

        # 3. device-FSM path vs host-masked path (each set at once); a
        # refused FSM on the host path, unforced.
        def burst(reqs):
            with ThreadPoolExecutor(len(reqs)) as ex:
                return list(ex.map(engine.infer, reqs))
        device = burst([_guided_req(prompt, {"regex": p})
                        for p in GUIDED_PATTERNS])
        t0 = time.perf_counter()
        host = _host_path(engine, lambda: burst([
            _guided_req(prompt, {"regex": p}) for p in GUIDED_PATTERNS]))
        host_s = time.perf_counter() - t0
        if [r.token_ids for r in device] != [r.token_ids for r in host]:
            raise AssertionError(f"guided: device {[r.text for r in device]}"
                                 f" != host {[r.text for r in host]}")
        for p, r in zip(GUIDED_PATTERNS, device):
            if not _in_language(p, r.text, r.finish_reason.value):
                raise AssertionError(f"guided: {r.text!r} not in {p}")
        refused = engine.infer(_guided_req(prompt, {"regex": GUIDED_REFUSED},
                                           max_tokens=12))
        if engine._fsm_cache[(GUIDED_REFUSED, False, False)][0] is not None \
                or not _in_language(GUIDED_REFUSED, refused.text,
                                    refused.finish_reason.value):
            raise AssertionError(f"guided: refused FSM {refused.text!r}")
        info["device_vs_host"] = {
            "patterns": list(GUIDED_PATTERNS),
            "texts": [r.text for r in device], "tokens_equal": True,
            "host_tokens": sum(r.completion_tokens for r in host),
            "host_s": host_s, "refused_fsm_text": refused.text}
    finally:
        srv.stop()
        runner.sync_debug = None
    torch.cuda.synchronize()
    launches = counts(K)
    _check_launches("guided", launches, lane)

    # 5. the device functions on the card vs the CPU, registered tables.
    gtrans, gmask, gcps, rows = runner._guided_tables()
    gen = np.random.default_rng(3)
    st = torch.from_numpy(gen.integers(0, rows, 64).astype(np.int32))
    tk = torch.from_numpy(gen.integers(0, mc.vocab_size, 64))
    dev = runner.device
    for what, got, want in (
            ("guided_mask_rows",
             sd.guided_mask_rows(gmask, st.to(dev), mc.vocab_size).cpu(),
             sd.guided_mask_rows(gmask.cpu(), st, mc.vocab_size)),
            ("guided_advance",
             sd.guided_advance(gtrans, gcps, st.to(dev), tk.to(dev)).cpu(),
             sd.guided_advance(gtrans.cpu(), gcps.cpu(), st, tk))):
        if not torch.equal(got, want):
            raise AssertionError(f"guided: {what} on the card != CPU")
    added = guided_launches(torch, runner, mc.vocab_size)
    emit({"phase": "guided", "lane": lane["name"],
          "wall_s": time.perf_counter() - t_phase, "fsm_build": fsm_info,
          "registered_fsms": len(runner._fsm_offsets),
          "table_rows_bucket": rows,
          "table_bytes": runner.guided_table_bytes(), **info,
          "device_functions_equal_cpu": True, "no_sync_checked": True,
          "guided_adds": added,
          "launches": launches, "card": smi_line()})
    return launches


def h_guided(torch, engine, mc, lane, prompts):
    """Lane H1 (the checkpoint's Llama-3-form tokenizer.json, the paged
    layout), through engine.infer, greedy: a strict json schema, and a
    regex over the corpus words whose matches cross multi-byte tokens;
    each text in its language (the schema's validated at finish stop),
    at least one token of several characters, and the device-FSM path's
    tokens equal to the host-masked path's. Every dispatch under the
    no-sync check; kernels 1-3 launch, none off the lane's path.
    Returns (launches, the line's fields)."""
    from ferrum_tpu_torch.ops import kernels as K
    from ferrum_tpu_torch.sampling.schema import (
        schema_to_regex, validate_json_against_subset)

    regex = r"(the model|a checkpoint) [a-z ]{8,60}\."
    cases = (("json_schema", {"json_schema": GUIDED_SCHEMA},
              schema_to_regex(GUIDED_SCHEMA)),
             ("regex", {"regex": regex}, regex))
    # Two prompts' words: over 64 tokens, so the prefill takes kernel 2.
    prompt = prompts[1] + " " + prompts[2]
    runner = engine.runner
    K.reset_launch_counts()
    runner.sync_debug = "error"
    out = {}
    try:
        for name, g, pat in cases:
            t0 = time.perf_counter()
            dev = engine.infer(_guided_req(prompt, g))
            dev_s = time.perf_counter() - t0
            host = _host_path(engine, lambda: engine.infer(
                _guided_req(prompt, g)))
            fin = dev.finish_reason.value
            if dev.token_ids != host.token_ids \
                    or not _in_language(pat, dev.text, fin):
                raise AssertionError(f"{lane['name']} guided {name}: "
                                     f"{dev.text!r} / {host.text!r}")
            if name == "json_schema" and fin == "stop" and \
                    not validate_json_against_subset(dev.text, GUIDED_SCHEMA):
                raise AssertionError(f"{lane['name']}: {dev.text!r}")
            widths = [len(engine.tokenizer.decode([t]))
                      for t in dev.token_ids]
            out[name] = {"text": dev.text, "finish": fin, "tokens":
                         dev.completion_tokens, "chars_per_token_max":
                         max(widths), "device_s": dev_s,
                         "host_tokens_equal": True}
        if max(v["chars_per_token_max"] for v in out.values()) < 2:
            raise AssertionError(f"{lane['name']}: no multi-byte token")
    finally:
        runner.sync_debug = None
    torch.cuda.synchronize()
    launches = counts(K)
    _check_launches(f"{lane['name']} guided", launches, lane)
    return launches, {**out, "table_bytes": runner.guided_table_bytes()}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# lane I: gemma-3-12b (windowed attention) at full width
# ---------------------------------------------------------------------------

# The text config of Google's published google/gemma-3-12b-it (its
# config.json's "text_config", wrapped as Gemma3ForConditionalGeneration
# as the file is), every field the port's mapping reads written out: the
# published file leaves head_dim, query_pre_attn_scalar, the rope bases,
# rms_norm_eps and the vocabulary to Gemma3TextConfig's defaults, which
# the mapping does not share (head_dim would fall to 3840 / 16 = 240).
GEMMA3_12B = {
    "architectures": ["Gemma3ForConditionalGeneration"],
    "eos_token_id": [1, 106],
    "text_config": {
        "hidden_size": 3840, "intermediate_size": 15360,
        "num_hidden_layers": 48, "num_attention_heads": 16,
        "num_key_value_heads": 8, "head_dim": 256,
        "query_pre_attn_scalar": 256, "sliding_window": 1024,
        "sliding_window_pattern": 6, "rope_theta": 1000000.0,
        "rope_local_base_freq": 10000.0,
        "rope_scaling": {"rope_type": "linear", "factor": 8.0},
        "vocab_size": 262208, "rms_norm_eps": 1e-6,
        "max_position_embeddings": 131072, "tie_word_embeddings": True,
        "final_logit_softcapping": None, "attn_logit_softcapping": None,
        "bos_token_id": 2, "eos_token_id": [1, 106]},
}
# 8 of its 48 layers: layer 5 global, the other seven local (cut from
# 12 to make room for lane K in the run's time).
I_LAYERS = 8
# The kernel cases keep the 12-layer shapes PERF.md's numbers were
# taken at.
I_KV_LAYERS = 12
I_MAX_LEN = 2048
I_LONG, I_LONG_OUT, I_LONG_REQS = 1536, 64, 4
I_DECODE_STEPS = 16
# gemma-3-12b's projections (K, N), q|k|v and gate|up fused; rows 1 and 2
# at a decode window's 32 lanes and a batched prefill's 2048 rows.
I_SHAPES = {"qkv": (3840, 8192), "o": (4096, 3840),
            "gate_up": (3840, 30720), "down": (15360, 3840)}
I_M = (32, 2048)
LANE_I = dict(name="I gemma-3-12b w4a8 two-level", model="gemma-3-12b",
              mode={}, path=LLAMA_PATH, tag="_gemma3")


def gemma_config():
    """Lane I's model config: GEMMA3_12B through the port's mapping, cut
    to I_LAYERS."""
    import dataclasses

    from ferrum_tpu_torch.models.configs import config_from_hf_dict
    mc = config_from_hf_dict(GEMMA3_12B)
    return dataclasses.replace(mc, num_layers=I_LAYERS)


def gemma_rows(torch, timer):
    """Rows 1 and 2 (w4a8tl_decode at m = 32, w4a8tl_prefill at m = 2048)
    at gemma-3-12b's four projections -- the first dense K (3840) that is
    not a multiple of 512, and K = 15360 --, exact against their plain
    versions, timed beside torch._int_mm on the int8 w8; then one line
    summing a layer's projections a size."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(12)
    kernels = {32: ("w4a8tl_decode", qmm.w4a8tl_decode),
               2048: ("w4a8tl_prefill", qmm.w4a8tl_prefill)}
    rows = []
    for site, (k, n) in I_SHAPES.items():
        p = make_gemm_weight(torch, k, n, gen)
        w8_cm = int_mm_weight(torch, p)
        for m in I_M:
            x = torch.randn(m, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            xq, xs = qmm.quantize_activation_rows(x)
            kernel, fn = kernels[m]
            row = {"kernel": kernel, "site": site, "m": m, "k": k, "n": n,
                   "model": "gemma-3-12b"}
            if kernel == "w4a8tl_decode":
                row["plan"] = qmm.w4a8tl_decode_plan(m, n, k)
            two_level_case(rows, timer, row, fn, qmm.w4a8tl_plain, p,
                           w8_cm, xq, xs)
        del p, w8_cm
        torch.cuda.empty_cache()
    for m in I_M:
        sel = [c for c in rows if c["m"] == m]
        emit({"phase": "kernel_layer", "model": "gemma-3-12b",
              "kernel": sel[0]["kernel"], **_summed(sel, f"m={m}"),
              "card": smi_line()})
    return rows


def gemma_kv_cases(torch, timer):
    """Rows 3 and 4 at lane I's 4 KiB rows (8 kv heads x 256 x bf16; the
    lanes before had 2 KiB): a paged decode step's K and V (12 layers x
    32 lanes scattered over a 2049-block pool, 4 pad lanes dropped), bf16
    and int8 with its scale planes (F = 2048 int8 values and 8 scales a
    row), and a batched prefill's pages (2048 rows: 64 pages a layer)
    in the same two forms, each bit for bit against its plain version."""
    from ferrum_tpu_torch.ops.kernels.kv_append import (
        append_pages_pairs, append_pages_pairs_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(13)
    layers, lanes, pool = I_KV_LAYERS, 32, 2049
    b = layers * pool
    pos = torch.randint(0, I_MAX_LEN, (lanes,), generator=gen,
                        device="cuda")
    lane_blk = torch.randperm(pool, generator=gen, device="cuda")[:lanes]
    blk = torch.arange(layers, device="cuda")[:, None] * pool \
        + lane_blk[None]
    blk[:, -4:] = OOB_SENTINEL
    blk = blk.reshape(-1).to(torch.int32).contiguous()
    off = (pos % PAGE).repeat(layers).to(torch.int32).contiguous()
    forms = (("bf16 K, V", [("bfloat16", 2048)] * 2),
             ("int8 K, V, K scales, V scales",
              [("int8", 2048)] * 2 + [("float32", 8)] * 2))
    rows = kv_rows_form_cases(
        torch, timer, gen, blk, off, b, forms,
        {"model": "gemma-3-12b", "form": "paged step",
         "at": f"{layers} layers x {lanes} lanes, F = 2048"})
    n_pg = PREFILL_ROWS // PAGE
    ids = (torch.arange(layers, device="cuda")[:, None] * pool
           + torch.randperm(pool, generator=gen, device="cuda")[:n_pg][None])
    ids[0, 3] = OOB_SENTINEL
    ids = ids.reshape(-1).to(torch.int32).contiguous()
    for label, kinds in forms:
        pairs = [(kv_array(torch, gen, getattr(torch, dt), (b, PAGE, w)),
                  kv_array(torch, gen, getattr(torch, dt),
                           (ids.numel(), PAGE, w))) for dt, w in kinds]
        ref = append_pages_pairs_plain([(c.clone(), s) for c, s in pairs],
                                       ids)
        append_pages_pairs(pairs, ids)
        torch.cuda.synchronize()
        valid = int((ids < b).sum().item())
        row = {"kernel": "kv_append_pages", "dtype": label,
               "arrays": len(pairs), "pages": ids.numel(),
               "f": kinds[0][1], "model": "gemma-3-12b", "form": "pairs",
               "equal": all(bool(torch.equal(c, w))
                            for (c, _), w in zip(pairs, ref)),
               "max_abs_err": max((c.float() - w.float()).abs().max().item()
                                  for (c, _), w in zip(pairs, ref))}
        del ref
        row["bound_ms"], row["bound_by"] = bound_ms(
            sum(2 * valid * s[0].nbytes for _, s in pairs) + ids.nbytes, 0)
        row["kernel_ms"] = timer(lambda: append_pages_pairs(pairs, ids))
        row["plain_ms"] = timer(
            lambda: append_pages_pairs_plain(pairs, ids), reps=10)
        row["library_ms"] = None
        rows.append(row)
        emit({"phase": "kernel_case", **row})
        if not row["equal"]:
            raise AssertionError(f"kv_append_pages {label} at F = 2048: "
                                 f"differs by {row['max_abs_err']}")
        del pairs
        torch.cuda.empty_cache()
    return rows


def attention_window_phase(torch, device):
    """The windowed attention at lane I's shapes (Hq = 16, Hkv = 8, D =
    256, scale 256^-0.5): decode over 32 slots with caches of up to 2048
    tokens and prefill chunks of 128 over 1152 cached tokens, sliding
    window 1024, without and with a softcap of 50, a bf16 cache and an
    int8 one (values and f32 scales), on `device` against the same
    function on CPU copies of the inputs (every product and sum in f32,
    the JAX package's precision); attention_phase's tolerance. The
    window bites: on the card the same inputs without it give other
    outputs."""
    from ferrum_tpu_torch.ops.attention import (flat_decode_attention,
                                                flat_prefill_attention)
    hq, hkv, d, sw = 16, 8, 256, 1024
    f, scale = hkv * d, 256 ** -0.5
    gen = torch.Generator(device="cpu")
    gen.manual_seed(14)

    def rnd(*shape, std=1.0):
        return (torch.randn(*shape, generator=gen) * std).to(torch.bfloat16)

    def cache(kv, *shape):
        if kv == "bf16":
            return rnd(*shape), None
        vals = torch.randint(-127, 128, shape, generator=gen,
                             dtype=torch.int8)
        return vals, torch.rand(*shape[:-1], hkv, generator=gen) * 0.02

    s, c = SERVE_REQUESTS, I_MAX_LEN
    b, t, cp = 2, 128, 1152
    pos = torch.arange(t)[None] + torch.tensor([cp, 1000])[:, None]
    total = torch.tensor([cp + t, 1000 + 100])
    pos[1, 100:] = 1 << 20                        # pad rows past the end
    out = {"phase": "attention_window", "card": smi_line(),
           "heads": [hq, hkv, d], "sliding_window": sw,
           "tolerance": f"<= {ATTN_DIFF_SHARE} of outputs differ, each by "
                        f"<= 2^-7 of max |out|"}
    for kv in ("bf16", "int8"):
        kd, ksd = cache(kv, s, c, f)
        vd, vsd = cache(kv, s, c, f)
        dec = [rnd(s, hq, d, std=6.0), kd, vd,
               torch.randint(1, c + 1, (s,), generator=gen),
               rnd(s, hkv, d), rnd(s, hkv, d)]
        kp, ksp = cache(kv, b, cp, f)
        vp, vsp = cache(kv, b, cp, f)
        pre = [rnd(b, t, hq, d, std=6.0), kp, vp, pos, total,
               rnd(b, t, hkv, d), rnd(b, t, hkv, d)]
        for cap in (None, 50.0):
            for name, fn, args, scales in (
                    ("decode", flat_decode_attention, dec, (ksd, vsd)),
                    ("prefill", flat_prefill_attention, pre, (ksp, vsp))):
                kw = dict(hkv=hkv, scale=scale, sliding_window=sw,
                          softcap=cap, k_scale=scales[0], v_scale=scales[1])
                want = fn(*args, **kw).float()
                dkw = {k: (v.to(device) if torch.is_tensor(v) else v)
                       for k, v in kw.items()}
                dargs = [a.to(device) for a in args]
                got = fn(*dargs, **dkw).float().cpu()
                unwindowed = fn(*dargs, **{**dkw, "sliding_window": None}
                                ).float().cpu()
                if name == "prefill":
                    real = pos < total[:, None]
                    got, want = got[real], want[real]
                    unwindowed = unwindowed[real]
                diff = (got - want).abs()
                share = (diff > 0).float().mean().item()
                worst = diff.max().item() / want.abs().max().item()
                key = f"{name} {kv}" + (f" softcap {cap}" if cap else "")
                out[key] = {"share_differing": share,
                            "max_abs_diff_over_max_out": worst,
                            "window_changes_output": not torch.equal(
                                unwindowed, got)}
                if share > ATTN_DIFF_SHARE or worst > 2 ** -7 \
                        or not out[key]["window_changes_output"]:
                    emit(out)
                    raise AssertionError(f"windowed {key} attention on "
                                         f"{device}: {out[key]}")
    emit(out)


def gemma_params(torch, mc, seed=0):
    """Random bf16 weights of lane I's model drawn on the card
    (torch.Generator(seed)): init_random_params' layout (normal 0.02
    linears and embedding, the sandwich norms present) with the
    zero-centred norm weights drawn too (normal 0.1), so the (1 + w)
    form is exercised; the host never holds them."""
    from ferrum_tpu_torch.models.llama_family import LayerParams, ModelParams
    from ferrum_tpu_torch.ops.linear import DenseLinearParams
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)

    def normal(*shape, std=0.02):
        return (torch.randn(*shape, generator=gen, device="cuda")
                * std).to(torch.bfloat16)

    def lin(i, o):
        return DenseLinearParams(w=normal(i, o), bias=None)

    def norm(n):
        return normal(n, std=0.1)

    h, inter = mc.hidden_size, mc.intermediate_size
    layers = [LayerParams(
        input_norm=norm(h), q=lin(h, mc.q_size), k=lin(h, mc.kv_size),
        v=lin(h, mc.kv_size), o=lin(mc.q_size, h),
        q_norm=norm(mc.head_dim), k_norm=norm(mc.head_dim),
        pre_mlp_norm=norm(h), gate=lin(h, inter), up=lin(h, inter),
        down=lin(inter, h), post_attn_norm=norm(h), post_mlp_norm=norm(h))
        for _ in range(mc.num_layers)]
    return ModelParams(embed=normal(mc.vocab_size, h), layers=layers,
                       final_norm=norm(h), lm_head=None)


def gemma_engine(mc, params, **kw):
    """The default EngineConfig at max_model_len 2048 (two-level w4a8, the
    paged layout with the prefix cache), and `kw`."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    return EngineBuilder(EngineConfig(max_model_len=I_MAX_LEN, **kw)) \
        .with_model(mc, params).build()


def gemma_logits(torch, mc, params):
    """One 1536-token prompt through a batched prefill and 16 one-lane
    decode steps, through the kernels and through their plain versions
    (both on the card, the plain run fed the kernel run's tokens): every
    logit within 1e-3 of the logit scale (the kernels are exact). The
    witness: the plain prefill with the window widened past the prompt
    (4096: the same ten local layers on their local RoPE, nothing
    masked) equals the windowed one at positions < 1024 and differs at
    positions >= 1024. Returns the kernel run's launch counts."""
    import dataclasses

    import numpy as np

    from ferrum_tpu_torch.models import llama_family as lf
    from ferrum_tpu_torch.ops import kernels as K

    dev = torch.device("cuda")
    n_blocks = I_MAX_LEN // PAGE
    prompt = torch.from_numpy(np.random.default_rng(21).integers(
        0, mc.vocab_size, I_LONG)).to(dev)[None]
    tables = torch.arange(n_blocks, device=dev)[None]

    def run(cfg, fed=None, decode=True):
        kv = lf.PagedKvCache.create(cfg, n_blocks, PAGE,
                                    dtype=torch.bfloat16, device=dev)
        pos = torch.arange(I_LONG, device=dev)[None]
        h, kv = lf.prefill_forward_batched(
            params, cfg, kv, prompt, pos, tables,
            torch.tensor([I_LONG], device=dev), pos, ctx_pad=PAGE)
        out = [lf.logits_from_hidden(params, cfg, h[0])]
        toks = []
        tok = out[0][-1:].argmax(-1)
        for step in range(I_DECODE_STEPS if decode else 0):
            tok = tok if fed is None else fed[step]
            toks.append(tok)
            p = torch.full((1,), I_LONG + step, device=dev)
            h, kv = lf.decode_forward(params, cfg, kv, tok, p, tables,
                                      p + 1, p, ctx_pad=I_MAX_LEN)
            out.append(lf.logits_from_hidden(params, cfg, h))
            tok = out[-1].argmax(-1)
        torch.cuda.synchronize()
        return out, toks

    K.reset_launch_counts()
    with_kernels, fed = run(mc)
    launches = counts(K)
    missed = [k for k in LANE_I["path"] if launches[k] == 0]
    stray = [k for k in off_path(LANE_I) if launches[k] != 0]
    if missed or stray:
        raise AssertionError(f"lane I logits run: never launched {missed}, "
                             f"launched {stray}")
    swaps = plain_swaps()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        plain, _ = run(mc, fed)
        wide, _ = run(dataclasses.replace(mc, sliding_window=4096),
                      decode=False)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    scale = max(b.abs().max().item() for b in plain)
    diff = max((a - b).abs().max().item()
               for a, b in zip(with_kernels, plain))
    finite = all(bool(torch.isfinite(a).all()) for a in with_kernels)
    w_diff = (wide[0] - plain[0]).abs().amax(-1)          # per position
    line = {"phase": "logits_gemma3", "lane": LANE_I["name"],
            "layers": mc.num_layers,
            "steps": f"prefill {I_LONG} + {I_DECODE_STEPS} decode steps",
            "tolerance_rel": 1e-3, "max_abs_diff": diff,
            "max_rel_diff": diff / scale, "logit_scale": scale,
            "finite": finite, "identical": diff == 0.0,
            "window_witness": {
                "below_1024_max_abs_diff": w_diff[:1024].max().item(),
                "from_1024_min_row_max_abs_diff": w_diff[1024:].min().item(),
                "from_1024_rows_differing":
                    (w_diff[1024:] > 0).float().mean().item()},
            "launches": launches, "card": smi_line()}
    emit(line)
    wit = line["window_witness"]
    if not finite or diff > 1e-3 * scale:
        raise AssertionError(f"lane I logits differ: {line}")
    if wit["below_1024_max_abs_diff"] != 0.0 \
            or wit["from_1024_rows_differing"] < 1.0:
        raise AssertionError(f"lane I: the sliding window does not bite "
                             f"as it should: {wit}")
    del with_kernels, plain, wide
    torch.cuda.empty_cache()
    return launches


def gemma_long(torch, engine, mc, tag):
    """I_LONG_REQS requests of a 1536-token prompt and 64 greedy tokens,
    each alone (one after another), then all at once: the tokens of each
    request, alone and batched."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    prompts = np.random.default_rng(22).integers(
        0, mc.vocab_size, (I_LONG_REQS, I_LONG))
    t0 = time.perf_counter()
    alone = [engine.infer(request(p, I_LONG_OUT)).token_ids
             for p in prompts]
    t1 = time.perf_counter()
    with ThreadPoolExecutor(I_LONG_REQS) as ex:
        batched = [r.token_ids for r in ex.map(
            engine.infer, [request(p, I_LONG_OUT) for p in prompts])]
    t2 = time.perf_counter()
    emit({"phase": f"long{tag}", "requests": I_LONG_REQS,
          "prompt_len": I_LONG, "output_len": I_LONG_OUT,
          "alone_s": t1 - t0, "batched_s": t2 - t1,
          "batched_equal_alone": batched == alone})
    return alone, batched


def lane_i(torch):
    """Lane I: gemma-3-12b at full width, 8 of its 48 layers, random bf16
    weights drawn on the card (seed 0) -> quantize_model_params -> the
    default engine (two-level w4a8, paged + prefix cache) at
    max_model_len 2048: the logits check, 32 x 256/128 served (every
    request 128 tokens, rows 1-4 launched and no other kernel; TTFT,
    TPOT), its profile (busy share), then 4 requests of 1536/64 alone
    and batched on the paged layout and on the linear one: the greedy
    tokens equal across the four runs. Returns the 32-request serve
    run's launch counts."""
    import numpy as np

    from ferrum_tpu_torch.models.quantize import quantize_model_params

    t0 = time.perf_counter()
    mc = gemma_config()
    params = quantize_model_params(gemma_params(torch, mc))
    engine = gemma_engine(mc, params)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    by_run = {}
    try:
        gemma_logits(torch, mc, engine.runner.params)
        prompts = np.random.default_rng(0).integers(
            0, mc.vocab_size, (SERVE_REQUESTS, PROMPT_LEN))
        launches, _, line = serve_run(torch, engine, mc, LANE_I, prompts,
                                      LANE_I["path"])
        emit({**line, "engine_build_s": build_s,
              "kv_layout": engine.cfg.kv_layout,
              "sliding_window": mc.sliding_window,
              "local_layers": sum(mc.layer_sliding_window(i) is not None
                                  for i in range(mc.num_layers))})
        by_run[LANE_I["name"]] = launches
        profile_phase(torch, mc, engine, LANE_I["tag"])
        runs = {"paged": gemma_long(torch, engine, mc, "_gemma3_paged")}
    finally:
        engine.stop()
    params = engine.runner.params
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    linear = gemma_engine(mc, params, kv_layout="linear",
                          enable_prefix_cache=False)
    try:
        runs["linear"] = gemma_long(torch, linear, mc, "_gemma3_linear")
    finally:
        linear.stop()
    del linear, params
    gc.collect()
    torch.cuda.empty_cache()
    ref = runs["paged"][0]
    streams = {f"{layout} {form}": toks for layout, pair in runs.items()
               for form, toks in zip(("alone", "batched"), pair)}
    equal = {k: toks == ref for k, toks in streams.items()}
    share = {k: float(np.mean([a == b for x, y in zip(toks, ref)
                               for a, b in zip(x, y)]))
             for k, toks in streams.items()}
    emit({"phase": "long_gemma3", "equal_to_paged_alone": equal,
          "token_share_equal": share, "card": smi_line()})
    if not all(equal.values()):
        raise AssertionError(f"lane I: the long-prompt tokens differ "
                             f"across layouts / batching: {share}")
    return by_run


# Lane J: speculative decoding. The target qwen3-8b at full width, 4 of
# its 36 layers (cut from 12 to 8 to make room for lane K, and to 4 for
# lanes G's offload form and L: a round's host time, ~20 s of the
# lane's serves at 8 layers); the draft
# qwen3-0.6b at full width, 4 of its 28 (both cut for the run's time:
# the run must stay near 800 s on the usual host, and a round's host
# time grows with the layers of both models); two-level w4a8 random
# weights (seed 0), K = 4.
J_TARGET, J_TARGET_LAYERS = "qwen3-8b", 4
# The kernel cases keep the 12-layer shapes PERF.md's numbers were
# taken at.
J_KV_LAYERS = 12
J_DRAFT, J_DRAFT_LAYERS = "qwen3-0.6b", 4
J_K, J_OUT, J_SAME_REQS = 4, 64, 8
# qwen3-8b's projections (K, N), q|k|v and gate|up fused: row 2 at the
# verify's m = 32 x (K+1); qwen3-0.6b's: row 1 at the draft's 32 lanes.
J_TARGET_SHAPES = {"qkv": (4096, 6144), "o": (4096, 4096),
                   "gate_up": (4096, 24576), "down": (12288, 4096)}
J_DRAFT_SHAPES = {"qkv": (1024, 4096), "o": (2048, 1024),
                  "gate_up": (1024, 6144), "down": (3072, 1024)}
J_VERIFY_M = SERVE_REQUESTS * (J_K + 1)
LANE_J = dict(name="J qwen3-8b + qwen3-0.6b draft, speculative",
              model=J_TARGET, mode={}, path=LLAMA_PATH, tag="_spec")


def spec_rows(torch, timer):
    """Rows 1 and 2 at lane J's shapes, exact against their plain
    versions, timed beside torch._int_mm on the int8 w8: w4a8tl_decode
    at the draft's four projections at m = 32 (a draft step), and
    w4a8tl_prefill at the target's at m = 160 (a verify pass: 32 lanes x
    K + 1 = 5 positions); then one line summing a layer's projections
    each."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(15)
    rows = []
    for model, shapes, m, kernel, fn in (
            (J_DRAFT, J_DRAFT_SHAPES, SERVE_DECODE_M, "w4a8tl_decode",
             qmm.w4a8tl_decode),
            (J_TARGET, J_TARGET_SHAPES, J_VERIFY_M, "w4a8tl_prefill",
             qmm.w4a8tl_prefill)):
        sel = []
        for site, (k, n) in shapes.items():
            p = make_gemm_weight(torch, k, n, gen)
            w8_cm = int_mm_weight(torch, p)
            x = torch.randn(m, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            xq, xs = qmm.quantize_activation_rows(x)
            row = {"kernel": kernel, "site": site, "m": m, "k": k, "n": n,
                   "model": model, "form": "speculative"}
            if kernel == "w4a8tl_decode":
                row["plan"] = qmm.w4a8tl_decode_plan(m, n, k)
            two_level_case(sel, timer, row, fn, qmm.w4a8tl_plain, p, w8_cm,
                           xq, xs)
            del p, w8_cm
            torch.cuda.empty_cache()
        emit({"phase": "kernel_layer", "model": model, "kernel": kernel,
              **_summed(sel, f"m={m}"), "card": smi_line()})
        rows += sel
    return rows


def spec_kv_cases(torch, timer):
    """Rows 3 and 4 at lane J's shapes, bit for bit: the verify's K and V
    rows (12 layers x 32 lanes x 5 positions, each lane's run starting
    off the page grid, 4 dead lanes dropped) and a draft step's (4
    layers x 32 lanes) into a 1025-block pool (the pool's size is no
    part of the work), bf16; the target prompt prefill's pages (12 layers
    x 64 pages) in the pairs form, K and V."""
    from ferrum_tpu_torch.ops.kernels.kv_append import (
        append_pages_pairs, append_pages_pairs_plain)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(16)
    pool, lanes, k1 = 1025, SERVE_REQUESTS, J_K + 1
    rows = []
    for layers, steps, form in ((J_KV_LAYERS, k1, "verify rows"),
                                (J_DRAFT_LAYERS, 1, "draft step")):
        b = layers * pool
        start = torch.randint(0, 240, (lanes,), generator=gen,
                              device="cuda") * 4 + 1      # off the grid
        pos = start[:, None] + torch.arange(steps, device="cuda")[None]
        # Each lane's own blocks (no two lanes share one).
        tables = torch.randperm(pool, generator=gen, device="cuda")[
            :lanes * 32].view(lanes, 32)
        blk_l = torch.gather(tables, 1, pos // PAGE)          # [S, steps]
        blk_l[-4:] = OOB_SENTINEL
        blk = torch.where(blk_l[None] < OOB_SENTINEL,
                          torch.arange(layers, device="cuda")[:, None, None]
                          * pool + blk_l[None], OOB_SENTINEL)
        blk = blk.reshape(-1).to(torch.int32).contiguous()
        off = (pos % PAGE).reshape(-1).repeat(layers).to(
            torch.int32).contiguous()
        rows += kv_rows_form_cases(
            torch, timer, gen, blk, off, b, (ROWS_BF16,),
            {"model": J_TARGET if steps > 1 else J_DRAFT, "form": form,
             "at": f"{layers} layers x {lanes} lanes x {steps}"})
    layers = J_KV_LAYERS
    b = layers * pool
    n_pg = PREFILL_ROWS // PAGE
    ids = (torch.arange(layers, device="cuda")[:, None] * pool
           + torch.randperm(pool, generator=gen, device="cuda")[:n_pg][None])
    ids[0, 5] = OOB_SENTINEL
    ids = ids.reshape(-1).to(torch.int32).contiguous()
    pairs = [(kv_array(torch, gen, torch.bfloat16, (b, PAGE, 1024)),
              kv_array(torch, gen, torch.bfloat16, (ids.numel(), PAGE, 1024)))
             for _ in range(2)]
    ref = append_pages_pairs_plain([(c.clone(), p) for c, p in pairs], ids)
    append_pages_pairs(pairs, ids)
    torch.cuda.synchronize()
    valid = int((ids < b).sum().item())
    row = {"kernel": "kv_append_pages", "dtype": "bf16 K, V", "arrays": 2,
           "pages": ids.numel(), "f": 1024, "model": J_TARGET,
           "form": "pairs, prompt prefill",
           "equal": all(bool(torch.equal(c, w))
                        for (c, _), w in zip(pairs, ref)),
           "max_abs_err": max((c.float() - w.float()).abs().max().item()
                              for (c, _), w in zip(pairs, ref))}
    del ref
    row["bound_ms"], row["bound_by"] = bound_ms(
        sum(2 * valid * p[0].nbytes for _, p in pairs) + ids.nbytes, 0)
    row["kernel_ms"] = timer(lambda: append_pages_pairs(pairs, ids))
    row["plain_ms"] = timer(lambda: append_pages_pairs_plain(pairs, ids),
                            reps=10)
    flat_ids = ids.long()[ids < b]
    srcs = [(c, p[ids < b]) for c, p in pairs]
    row["library_ms"] = timer(lambda: [c.index_copy_(0, flat_ids, p)
                                       for c, p in srcs])
    rows.append(row)
    emit({"phase": "kernel_case", **row})
    if not row["equal"]:
        raise AssertionError(f"kv_append_pages at lane J's prefill: differs "
                             f"by {row['max_abs_err']}")
    del pairs, srcs
    torch.cuda.empty_cache()
    return rows


def j_models(torch):
    """Lane J's target and draft: (config, two-level params) each, drawn
    on the card (seed 0); the draft's q|k|v and gate|up fused as
    EngineBuilder fuses the target's (it serves a draft as given)."""
    import dataclasses

    from ferrum_tpu_torch.engine.builder import fuse_projections
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.quantize import init_random_quant_params
    out = []
    for name, layers in ((J_TARGET, J_TARGET_LAYERS),
                         (J_DRAFT, J_DRAFT_LAYERS)):
        mc = dataclasses.replace(preset(name), num_layers=layers)
        out.append((mc, fuse_projections(init_random_quant_params(mc,
                                                                  seed=0))))
    return out


def j_engine(target, draft=None, **kw):
    """The default EngineConfig (two-level w4a8, the paged layout with the
    prefix cache, T = 8, KV autosized), K = J_K, and `kw`."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    b = EngineBuilder(EngineConfig(spec_num_tokens=J_K, **kw)) \
        .with_model(*target)
    if draft is not None:
        b = b.with_draft_model(*draft)
    return b.build()


def j_serve(torch, engine, mc, prompts, label, sync_check=False):
    """len(prompts) concurrent greedy 256/J_OUT requests, the launch
    counts from 0; every request J_OUT tokens, rows 1-4 launched and no
    other kernel. Returns (launches, token lists, the line)."""
    from concurrent.futures import ThreadPoolExecutor

    from ferrum_tpu_torch.ops import kernels as K

    import dataclasses

    runner = engine.runner
    st0 = dataclasses.astuple(engine.spec.stats) if engine.spec else None
    rounds0 = engine.spec.rounds if engine.spec else 0
    runner.sync_debug = "error" if sync_check else None
    K.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with ThreadPoolExecutor(len(prompts)) as ex:
            resps = list(ex.map(engine.infer,
                                [request(p, J_OUT) for p in prompts]))
        torch.cuda.synchronize()
    finally:
        runner.sync_debug = None
    wall = time.perf_counter() - t0
    launches = counts(K)
    for r in resps:
        if r.completion_tokens != J_OUT or len(r.token_ids) != J_OUT \
                or not all(0 <= t < mc.vocab_size for t in r.token_ids):
            raise AssertionError(f"lane J {label}: {r.request_id} gave "
                                 f"{len(r.token_ids)} tokens")
    missed = [k for k in LANE_J["path"] if launches[k] == 0]
    stray = [k for k in off_path(LANE_J) if launches[k] != 0]
    if missed or stray:
        raise AssertionError(f"lane J {label}: never launched {missed}, "
                             f"launched {stray}")
    ttft = [r.ttft for r in resps]
    tpot = [(r.e2e_latency - r.ttft) / (J_OUT - 1) for r in resps]
    line = {"phase": "serve_spec", "lane": LANE_J["name"], "run": label,
            "requests": len(prompts), "prompt_len": PROMPT_LEN,
            "output_len": J_OUT, "wall_s": wall,
            "output_tok_s": len(prompts) * J_OUT / wall,
            "ttft_p50_ms": statistics.median(ttft) * 1e3,
            "tpot_p50_ms": statistics.median(tpot) * 1e3,
            "no_sync_checked": sync_check, "launches": launches,
            "kv_layout": engine.cfg.kv_layout, "card": smi_line()}
    if engine.spec is not None:
        st = [a - b for a, b in zip(dataclasses.astuple(engine.spec.stats),
                                    st0)]
        line.update(spec_k=engine.spec.k, rounds=engine.spec.rounds - rounds0,
                    proposals=st[0], drafted_tokens=st[1],
                    accepted_tokens=st[2],
                    acceptance_rate=st[2] / max(st[1], 1))
    emit(line)
    return launches, [r.token_ids for r in resps], line


def j_teacher_forced(torch, mc, params, prompts, streams):
    """Each stream against the argmax of a teacher-forced forward of the
    plain versions on the card over prompt + stream (one batched
    prefill of 8 sequences at a time): a token may differ only where the
    plain top two logits are within 1e-3 of the logit scale (a near-tie
    the bf16 attention sums can flip). Returns the counts."""
    from ferrum_tpu_torch.models import llama_family as lf
    dev = torch.device("cuda")
    n_tok = PROMPT_LEN + J_OUT
    t_pad = -(-n_tok // PAGE) * PAGE
    out = {"positions": 0, "equal": 0, "near_ties": 0, "near_tie_flips": 0,
           "flips": 0, "min_gap_rel": None}
    saved = [(m, n, getattr(m, n)) for m, n, _ in plain_swaps()]
    for m, n, fn in plain_swaps():
        setattr(m, n, fn)
    try:
        for i in range(0, len(prompts), 8):
            seqs = [list(map(int, p)) + list(s)
                    for p, s in zip(prompts[i:i + 8], streams[i:i + 8])]
            b = len(seqs)
            nb = t_pad // PAGE
            kv = lf.PagedKvCache.create(mc, b * nb, PAGE,
                                        dtype=torch.bfloat16, device=dev)
            tok = torch.zeros(b, t_pad, dtype=torch.int64, device=dev)
            tok[:, :n_tok] = torch.tensor(seqs, device=dev)
            pos = torch.arange(t_pad, device=dev)[None].expand(b, t_pad)
            flat = torch.where(pos < n_tok, pos + torch.arange(
                b, device=dev)[:, None] * t_pad, OOB_SENTINEL)
            h, _ = lf.prefill_forward_batched(
                params, mc, kv, tok, pos.contiguous(),
                torch.arange(b * nb, device=dev).view(b, nb),
                torch.full((b,), n_tok, device=dev), flat, ctx_pad=t_pad)
            gen = h[:, PROMPT_LEN - 1:n_tok - 1]
            logits = lf.logits_from_hidden(
                params, mc, gen.reshape(-1, gen.shape[-1])).float()
            scale = logits.abs().max()
            top2 = torch.topk(logits, 2, dim=-1).values
            gap = ((top2[:, 0] - top2[:, 1]) / scale).cpu()
            am = logits.argmax(-1).cpu()
            got = torch.tensor([s[PROMPT_LEN:] for s in seqs]).reshape(-1)
            near = gap <= 1e-3
            eq = am == got
            out["positions"] += got.numel()
            out["equal"] += int(eq.sum())
            out["near_ties"] += int(near.sum())
            out["near_tie_flips"] += int((~eq & near).sum())
            out["flips"] += int((~eq & ~near).sum())
            g = float(gap.min())
            out["min_gap_rel"] = g if out["min_gap_rel"] is None \
                else min(out["min_gap_rel"], g)
            del h, logits, kv
            torch.cuda.empty_cache()
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)
    return out


def j_verify_logits(torch, mc, params):
    """One round's verify pass, kernels against plain versions on the same
    inputs: 8 sequences of 250 prompt tokens prefilled (kernels), then
    prefill_forward_batched(append="rows") over 5 positions from 250 --
    off the page grid -- through the kernels and, from a copy of the same
    cache, through the plain versions: every logit within 1e-3 of the
    logit scale, and the appended rows equal."""
    import numpy as np

    from ferrum_tpu_torch.models import llama_family as lf
    dev = torch.device("cuda")
    b, n, k1, ctx = 8, 250, J_K + 1, 512
    nb = ctx // PAGE
    rng = np.random.default_rng(23)
    kv = lf.PagedKvCache.create(mc, b * nb, PAGE, dtype=torch.bfloat16,
                                device=dev)
    tables = torch.arange(b * nb, device=dev).view(b, nb)
    t_pad = 256
    tok = torch.zeros(b, t_pad, dtype=torch.int64, device=dev)
    tok[:, :n] = torch.from_numpy(rng.integers(0, mc.vocab_size, (b, n)))
    pos = torch.arange(t_pad, device=dev)[None].expand(b, t_pad).contiguous()
    flat = torch.where(pos < n, tables[:, :1] * PAGE + pos, OOB_SENTINEL)
    lf.prefill_forward_batched(params, mc, kv, tok, pos, tables,
                               torch.full((b,), n, device=dev), flat,
                               ctx_pad=t_pad)
    vt = torch.from_numpy(rng.integers(0, mc.vocab_size, (b, k1))).to(dev)
    vp = (n + torch.arange(k1, device=dev))[None].expand(b, k1).contiguous()
    vf = tables[:, :1] * PAGE + vp
    plain_kv = lf.PagedKvCache(k=kv.k.clone(), v=kv.v.clone(), page=PAGE,
                               kv_heads=kv.kv_heads, head_dim=kv.head_dim)

    def verify(cache):
        h, _ = lf.prefill_forward_batched(
            params, mc, cache, vt, vp, tables,
            torch.full((b,), n + k1, device=dev), vf, ctx_pad=ctx,
            attn_impl="ref", append="rows")
        return lf.logits_from_hidden(params, mc,
                                     h.reshape(b * k1, -1)).float()

    got = verify(kv)
    saved = [(m, nm, getattr(m, nm)) for m, nm, _ in plain_swaps()]
    for m, nm, fn in plain_swaps():
        setattr(m, nm, fn)
    try:
        want = verify(plain_kv)
    finally:
        for m, nm, fn in saved:
            setattr(m, nm, fn)
    torch.cuda.synchronize()
    scale = want.abs().max().item()
    diff = (got - want).abs().max().item()
    rows_equal = bool(torch.equal(kv.k, plain_kv.k)
                      and torch.equal(kv.v, plain_kv.v))
    line = {"phase": "verify_logits_spec", "sequences": b,
            "positions": f"{n}..{n + k1 - 1}", "max_abs_diff": diff,
            "logit_scale": scale, "max_rel_diff": diff / scale,
            "tolerance_rel": 1e-3, "cache_equal": rows_equal,
            "card": smi_line()}
    emit(line)
    if not (diff <= 1e-3 * scale and rows_equal
            and bool(torch.isfinite(got).all())):
        raise AssertionError(f"lane J verify logits: {line}")


def lane_j(torch):
    """Lane J (see J_TARGET): the verify logits check; the plain engine and
    the spec engine (draft qwen3-0.6b) each serving 32 x 256/64 greedy
    (the spec run under the no-sync check), a spec engine with draft =
    target serving 8 x 256/64 (beside the plain engine's 8); every spec
    stream against a teacher-forced plain forward; a seeded sampled
    request twice. Returns the launch counts by run."""
    import numpy as np

    t0 = time.perf_counter()
    target, draft = j_models(torch)
    mc = target[0]
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    j_verify_logits(torch, mc, target[1])
    prompts = np.random.default_rng(30).integers(
        0, mc.vocab_size, (SERVE_REQUESTS, PROMPT_LEN))
    by_run, lines, streams = {}, {}, {}
    plain = j_engine(target)
    try:
        sync_canary(torch, plain.runner)
        for label, sel in (("plain c=32", prompts),
                           ("plain c=8", prompts[:J_SAME_REQS])):
            launches, streams[label], lines[label] = j_serve(
                torch, plain, mc, sel, label)
    finally:
        plain.stop()
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    for label, d, sel in (("spec c=32", draft, prompts),
                          ("spec draft=target c=8", target,
                           prompts[:J_SAME_REQS])):
        engine = j_engine(target, d)
        try:
            launches, streams[label], lines[label] = j_serve(
                torch, engine, mc, sel, label, sync_check=True)
            by_run[f"{LANE_J['name']} {label}"] = launches
            if label == "spec c=32":
                from ferrum_tpu_torch.types import (InferenceRequest,
                                                    SamplingParams)
                seeded = [engine.infer(InferenceRequest(
                    prompt_token_ids=[int(t) for t in prompts[0][:100]],
                    sampling=SamplingParams(
                        max_tokens=J_OUT, temperature=0.8, top_k=40,
                        seed=4321, ignore_eos=True))) for _ in range(2)]
                if seeded[0].token_ids != seeded[1].token_ids:
                    raise AssertionError("lane J: a seeded sampled request "
                                         "gave two texts")
        finally:
            engine.stop()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    # The plain engine's streams too, for information: its decode steps
    # attend through the paged layout's f32 reference, the forward here
    # through the flat bf16 prefill attention.
    forced = {label: j_teacher_forced(torch, mc, target[1],
                                      prompts[:len(streams[label])],
                                      streams[label])
              for label in ("spec c=32", "spec draft=target c=8",
                            "plain c=32")}
    share = {label: float(np.mean([a == b for x, y in zip(
        streams[label], streams["plain c=32"]) for a, b in zip(x, y)]))
        for label in ("spec c=32", "spec draft=target c=8")}
    emit({"phase": "lane_j", "lane": LANE_J["name"],
          "target": f"{J_TARGET} at {J_TARGET_LAYERS} of 36 layers",
          "draft": f"{J_DRAFT} at {J_DRAFT_LAYERS} of 28 layers",
          "spec_k": J_K, "weights_draw_s": draw_s,
          "teacher_forced": forced, "seeded_twice_equal": True,
          "token_share_equal_to_plain": share,
          "acceptance_rate": {k: v.get("acceptance_rate")
                              for k, v in lines.items()},
          "output_tok_s": {k: v["output_tok_s"] for k, v in lines.items()},
          "ttft_p50_ms": {k: v["ttft_p50_ms"] for k, v in lines.items()},
          "tpot_p50_ms": {k: v["tpot_p50_ms"] for k, v in lines.items()},
          "card": smi_line()})
    bad = {k: v for k, v in forced.items()
           if v["flips"] and k.startswith("spec")}
    if bad:
        raise AssertionError(f"lane J: spec tokens off the plain argmax "
                             f"outside near-ties: {bad}")
    del target, draft
    gc.collect()
    torch.cuda.empty_cache()
    return by_run


# ---------------------------------------------------------------------------
# Lane K: the engine's remaining settings at their JAX defaults
# ---------------------------------------------------------------------------

# qwen3-30b-a3b at 2 of its 48 layers (lane B's model and depth), random
# two-level int4 weights drawn on the card (seed 0), with EngineConfig()'s
# defaults (adaptive windows, the paged layout with the prefix cache, KV
# autosized) and the settings below.
K_MODEL, K_LAYERS = "qwen3-30b-a3b", 2
K_SETTINGS = dict(squeeze_embeddings=True, fuse_sites="qkv,gate_up,moe",
                  slot_slack=2, scheduler="priority")
K_OUT = 64
K_LM_HEAD = (2048, 151936)          # the lm_head's (K, N)
K_GATE_UP = (2048, 2 * 768)         # the fused expert gate|up stack
K_GROUPED_A = (256, 16384)          # a 32-token decode, a batched prefill
K_PATH = MOE_PATH + ("w4a8_decode",)
K_NAME = ("K qwen3-30b-a3b settings (squeeze, moe fusion, slack, priority, "
          "adaptive windows)")
K_PRIORITY = (16, 4)                # priority 0 requests, then priority 1


def k_rows(torch, timer):
    """Lane K's kernel cases, each exact against its plain version:
    row 6 (w4a8_decode) at the squeezed lm_head (the builder quantizes it
    after the two-level pass: float-scale) at m = 1 and 32, with its plan
    and the f32 split planes' bytes; row 1 (w4a8tl_decode) at that shape
    with a two-level lm_head (a squeezed random draw's), beside
    torch._int_mm; rows 11 (moe_bmm, t = 32) and 10 (moe_grouped at 256
    and 16384 rows) on the fused gate|up expert stack (N = 1536)."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    from ferrum_tpu_torch.ops.quant import dequantize, requantize_two_level
    gen = torch.Generator(device="cuda")
    gen.manual_seed(27)
    rows = []
    k, n = K_LM_HEAD
    fs = make_gemm_weight(torch, k, n, gen, two_level=False)
    tl = requantize_two_level(fs)
    w8_cm = int_mm_weight(torch, tl)
    wbytes = fs.qweight.nbytes + fs.scales.nbytes + fs.zeros.nbytes
    for m in (1, SERVE_DECODE_M):
        x = torch.randn(m, k, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        xq, xs = qmm.quantize_activation_rows(x)
        plan = qmm.w4a8_decode_plan(m, n, k)
        row = {"kernel": "w4a8_decode", "model": K_MODEL, "site": "lm_head",
               "m": m, "k": k, "n": n, "plan": plan,
               "plane_bytes": 4 * m * n * plan["planes"]}
        row["bound_ms"], row["bound_by"] = bound_ms(
            wbytes + xq.nbytes + xs.nbytes + 2 * m * n, 2.0 * m * k * n)
        check_case(rows, row, timer,
                   lambda: qmm.w4a8_decode(xq, xs, fs, torch.bfloat16),
                   lambda: qmm.w4a8_plain(xq, xs, fs, torch.bfloat16),
                   None, exact=True)
        if not scratch_zero(torch):
            raise AssertionError("w4a8_decode lm_head: split-K counters "
                                 "not zero after the case")
        two_level_case(rows, timer, {
            "kernel": "w4a8tl_decode", "model": K_MODEL, "site": "lm_head",
            "m": m, "k": k, "n": n,
            "plan": qmm.w4a8tl_decode_plan(m, n, k)},
            qmm.w4a8tl_decode, qmm.w4a8tl_plain, tl, w8_cm, xq, xs)
    del fs, tl, w8_cm
    torch.cuda.empty_cache()
    k, n = K_GATE_UP
    p = make_moe_stack(torch, k, n, gen)
    w_bf16 = dequantize(p, torch.bfloat16)
    tag = {"model": f"{K_MODEL} gate|up fused"}
    bmm_case(torch, rows, timer, p, w_bf16, "gate_up", SERVE_BMM_T, 1, gen,
             **tag)
    for a in K_GROUPED_A:
        grouped_case(torch, rows, timer, p, w_bf16, "gate_up", a, gen, **tag)
    del p, w_bf16
    torch.cuda.empty_cache()
    return rows


def dense_moe_cases(torch, timer):
    """One qwen3-30b-a3b MoE layer with dense bf16 expert stacks (128
    experts, full width; an f32 router, so that the card and the CPU
    route alike) through ops/moe.py's dense route (ragged_dot: bf16
    operands, f32 sums) at t = 32 tokens (256 rows) and 256 tokens (2048
    rows), against the same function on the CPU (the plain form the CPU
    tests hold against the JAX package: bf16 operands widened to f32,
    f32 sums): every output within two bf16 steps, 2^-6 |want| + 2^-10
    max|want| (the card's sums run in another order, and a bf16 rounding
    of the activation can move). Timed beside its bound (the active
    experts' bf16 stacks and bf16 ops)."""
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.llama_family import MoeLayerParams
    from ferrum_tpu_torch.ops.linear import DenseLinearParams
    from ferrum_tpu_torch.ops.moe import moe_mlp, route_topk

    mc = preset(K_MODEL)
    h, e = mc.hidden_size, mc.moe.num_experts
    inter = mc.moe.moe_intermediate_size
    gen = torch.Generator(device="cuda")
    gen.manual_seed(24)

    def normal(*shape, std=0.02, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device="cuda") * std
                ).to(dtype)

    p = MoeLayerParams(
        router=DenseLinearParams(w=normal(h, e, dtype=torch.float32),
                                 bias=None),
        gate=normal(e, h, inter), up=normal(e, h, inter),
        down=normal(e, inter, h))
    on_cpu = MoeLayerParams(
        router=DenseLinearParams(w=p.router.w.cpu(), bias=None),
        gate=p.gate.cpu(), up=p.up.cpu(), down=p.down.cpu())
    out = []
    for t in (SERVE_DECODE_M, PROMPT_LEN):
        x = normal(t, h, std=1.0)
        got = moe_mlp(x, p, mc)
        want = moe_mlp(x.cpu(), on_cpu, mc).to("cuda")
        g, w = got.float(), want.float()
        diff = (g - w).abs()
        ok = bool((diff <= 2.0 ** -6 * w.abs() + 2.0 ** -10 * w.abs().max()
                   ).all())
        _, ids = route_topk(x.float() @ p.router.w, mc.moe.num_experts_per_tok,
                            mc.moe.norm_topk_prob)
        active = int(torch.unique(ids).numel())
        rows = t * mc.moe.num_experts_per_tok
        line = {"phase": "dense_moe", "model": K_MODEL, "tokens": t,
                "rows": rows, "experts": e, "active_experts": active,
                "ok": ok, "max_abs_err": diff.max().item(),
                "share_differing": (diff > 0).float().mean().item(),
                "tolerance": "2^-6 |want| + 2^-10 max|want|",
                "ms": timer(lambda: moe_mlp(x, p, mc), reps=5, warmup=1)}
        line["bound_ms"], line["bound_by"] = bound_ms(
            active * 3 * h * inter * 2 + x.nbytes + got.nbytes,
            2.0 * rows * 3 * h * inter, BF16_FLOPS_PER_S)
        emit({**line, "card": smi_line()})
        out.append(line)
        if not ok:
            raise AssertionError(f"dense MoE at t = {t}: {line}")
    del p, on_cpu
    torch.cuda.empty_cache()
    return out


def k_draw(mc):
    """Lane K's weights, drawn on the card (the same for every call)."""
    from ferrum_tpu_torch.models.quantize import init_random_quant_params
    return init_random_quant_params(mc, seed=0)


def k_engine(mc, params, **kw):
    """An engine at EngineConfig()'s defaults with K_SETTINGS and `kw`."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    return EngineBuilder(EngineConfig(**{**K_SETTINGS, **kw})) \
        .with_model(mc, params).build()


def k_logits(torch, mc, engine):
    """(b) Logits for fed tokens on the squeezed, moe-fused engine's
    weights -- a 256-token prefill (its last row's logits, as the engine
    computes them), two decode steps at 32 lanes (the all-experts route)
    and two at 1 (sort + grouped) -- through the kernels and through
    their plain versions: equal bit for bit (every kernel on this path
    is integer-exact; the lm_head is float-scale row 6 at m <= 32).
    (c) The same weights built with fuse_proj=False (split q / k / v and
    expert gate / up): the same logits bit for bit. Returns the kernel
    run's logits."""
    import numpy as np

    from ferrum_tpu_torch.models.llama_family import QuantEmbedding
    from ferrum_tpu_torch.ops.quant import QuantLinearParams

    params = engine.runner.params
    if not isinstance(params.embed, QuantEmbedding) \
            or params.lm_head.scales2 is not None \
            or params.layers[0].moe.gate_up is None:
        raise AssertionError("lane K: the build did not squeeze (int8 "
                             "table, float-scale lm_head) or fuse the moe "
                             "site")
    lanes = (32, 32, 1, 1)
    rng = np.random.default_rng(3)
    prompt = torch.from_numpy(rng.integers(0, mc.vocab_size, PROMPT_LEN)
                              ).to("cuda")[None]
    others = torch.from_numpy(rng.integers(
        0, mc.vocab_size, (len(lanes), max(lanes)))).to("cuda")
    got, fed = forward_logits(torch, params, mc, prompt, lanes, others,
                              last_only=True)
    plain, _ = plain_run(lambda: forward_logits(
        torch, params, mc, prompt, lanes, others, fed, last_only=True))
    split_engine = k_engine(mc, k_draw(mc), fuse_proj=False,
                            kv_num_blocks=64)
    split = split_engine.runner.params
    split_engine.stop()
    if split.layers[0].qkv is not None or split.layers[0].moe.gate_up \
            is not None or not isinstance(split.lm_head, QuantLinearParams):
        raise AssertionError("lane K: fuse_proj=False fused or left the "
                             "lm_head unsqueezed")
    unfused, _ = forward_logits(torch, split, mc, prompt, lanes, others,
                                fed, last_only=True)
    line = {"phase": "logits_k", "steps": f"prefill {PROMPT_LEN} (last "
            f"row) + decode at lanes {list(lanes)}",
            "equal_to_plain": all(torch.equal(a, b)
                                  for a, b in zip(got, plain)),
            "fuse_proj_off_equal": all(torch.equal(a, b)
                                       for a, b in zip(got, unfused)),
            "finite": all(bool(torch.isfinite(a).all()) for a in got),
            "max_abs_diff_plain": max((a - b).abs().max().item()
                                      for a, b in zip(got, plain)),
            "max_abs_diff_unfused": max((a - b).abs().max().item()
                                        for a, b in zip(got, unfused)),
            "logit_scale": max(a.abs().max().item() for a in got)}
    emit(line)
    del split, unfused, plain
    gc.collect()
    torch.cuda.empty_cache()
    if not (line["equal_to_plain"] and line["fuse_proj_off_equal"]
            and line["finite"]):
        raise AssertionError(f"lane K logits: {line}")


def k_memory(torch, mc):
    """(f) The card's memory with and without the squeeze, each on fresh
    weights and a 1024-block pool: the weights' bytes, the embedding's
    and the lm_head's, the allocation once drawn, the peak over the
    build (the squeeze's transients), the allocation after it and the
    peak over a 4 x 256/64 serve."""
    import numpy as np

    from ferrum_tpu_torch.engine.builder import params_nbytes

    out = {}
    prompts = np.random.default_rng(5).integers(0, mc.vocab_size,
                                                (4, PROMPT_LEN))
    for squeeze in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        params = k_draw(mc)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        engine = k_engine(mc, params, kv_num_blocks=1024,
                          squeeze_embeddings=squeeze)
        del params
        p = engine.runner.params
        torch.cuda.synchronize()
        after = torch.cuda.memory_allocated()
        build_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for r in [request(x, K_OUT) for x in prompts]:
            engine.infer(r)
        torch.cuda.synchronize()
        out["squeezed" if squeeze else "bf16"] = {
            "weights_gib": params_nbytes(p) / 2**30,
            "embed_bytes": params_nbytes(p.embed),
            "lm_head_bytes": params_nbytes(p.lm_head),
            "drawn_gib": base / 2**30,
            "build_peak_gib": build_peak / 2**30,
            "allocated_after_build_gib": after / 2**30,
            "serve_peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        engine.stop()
        del engine, p
    gc.collect()
    torch.cuda.empty_cache()
    return out


def k_serve(torch, engine, mc):
    """(d) run_cell at 32 concurrent 256/64 requests (64 in all: each
    ending request's worker submits the next), then at 4 (4 in all);
    each cell after its warm-up meets no program key.
    The windows by length: 16-step windows at <= 4 lanes (adaptive
    doubling) and halved 4-step ones while requests wait (the first
    admission wave). Every kernel of K_PATH launches (moe_grouped's
    decode-sized loop too) and no other. Returns (launches, line)."""
    from ferrum_tpu_torch.bench.bench_engine import run_cell
    from ferrum_tpu_torch.ops import kernels as K

    runner = engine.runner
    log = []
    start = runner.start_decode_window

    def logged(seqs, t, **kw):
        log.append((t, len(seqs), len(engine.scheduler.waiting)))
        return start(seqs, t, **kw)

    runner.start_decode_window = logged
    K.reset_launch_counts()
    cells = {}
    try:
        for conc, n in ((SERVE_REQUESTS, 2 * SERVE_REQUESTS), (4, 4)):
            cell = run_cell(engine, concurrency=conc, num_requests=n,
                            input_len=PROMPT_LEN, output_len=K_OUT)
            cells[conc] = cell
            if cell["completed"] != n or cell["errors"] \
                    or cell["compilations_during_cell"]:
                raise AssertionError(f"lane K c={conc}: {cell['completed']}"
                                     f" of {n}, {cell['error_samples']}, "
                                     f"{cell['compiled_in_cell']}")
    finally:
        del runner.start_decode_window
    launches = counts(K)
    by_len = {}
    for t, lanes, _ in log:
        by_len[t] = by_len.get(t, 0) + 1
    doubled = sum(1 for t, lanes, _ in log if t == 16 and lanes <= 4)
    halved = sum(1 for t, _, waiting in log if t == 4 and waiting)
    idle = [k for k in K_PATH + (GROUPED_DECODE,) if launches[k] == 0]
    stray = [k.name for k in K.KERNELS
             if k.name not in K_PATH and launches[k.name] != 0]
    line = {"phase": "serve_k", "lane": K_NAME,
            "windows_by_length": by_len, "doubled_at_le_4_lanes": doubled,
            "halved_while_waiting": halved,
            "slack_admissions": engine.slack_admissions,
            "num_slots": runner.num_slots,
            "kv_blocks": runner.kv.num_blocks,
            "cells": {c: {k: v[k] for k in (
                "completed", "output_tok_s", "ttft_p50_ms", "tpot_p50_ms",
                "compilations_during_cell")} for c, v in cells.items()},
            "launches": launches}
    emit({**line, "card": smi_line()})
    if idle or stray or not doubled or not halved:
        raise AssertionError(f"lane K serve: never launched {idle}, "
                             f"launched {stray}, {line}")
    return launches


def hold_loop(engine):
    """Hold the engine's loop at the head of its next iteration (the
    windows it dispatched stay in flight); returns the release."""
    import threading

    gate = threading.Event()
    run = engine.run_iteration

    def held():
        gate.wait()
        return run()

    engine.run_iteration = held
    time.sleep(0.2)                 # the loop ends the pass it is in

    def release():
        gate.set()
        del engine.run_iteration
    return release


def k_slack(torch, engine, mc):
    """(d) The slack witness: 32 requests of 256/64 decoding; with the
    loop held (windows in flight), 4 are aborted and 4 new ones
    submitted. The aborted ones' releases wait for the windows in
    flight (paged), and the new ones take the two slack lanes meanwhile
    (engine.slack_admissions). (A request ending at max_tokens is
    released when its last window is read: the port dispatches no window
    past it, so the cells above defer no release.)"""
    import numpy as np

    prompts = np.random.default_rng(9).integers(
        0, mc.vocab_size, (SERVE_REQUESTS + 4, PROMPT_LEN))
    reqs = [request(x, K_OUT) for x in prompts[:SERVE_REQUESTS]]
    queues = [engine.submit(r) for r in reqs]
    for q in queues:
        q.get(timeout=300)          # decoding: its first token came
    before = engine.slack_admissions
    release = hold_loop(engine)
    try:
        for r in reqs[:4]:
            engine.abort(r.request_id)
        queues += [engine.submit(request(x, K_OUT))
                   for x in prompts[SERVE_REQUESTS:]]
    finally:
        release()
    for q in queues:
        while not q.get(timeout=300).finished:
            pass
    line = {"phase": "slack_k", "aborted": 4, "submitted": 4,
            "slack_admissions": engine.slack_admissions - before,
            "num_slots": engine.runner.num_slots}
    emit(line)
    if line["slack_admissions"] < 1:
        raise AssertionError(f"lane K: no slack admission: {line}")


def k_priority(torch, engine, mc, trace):
    """(e) 16 requests of priority 0, then 4 of priority 1, submitted
    while the loop is held: the trace JSONL, read back, admits the 4
    first."""
    import numpy as np

    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    lo, hi = K_PRIORITY
    prompts = np.random.default_rng(7).integers(0, mc.vocab_size,
                                                (lo + hi, PROMPT_LEN))
    reqs = [InferenceRequest(
        prompt_token_ids=[int(t) for t in x], priority=int(i >= lo),
        sampling=SamplingParams(max_tokens=8, ignore_eos=True))
        for i, x in enumerate(prompts)]
    release = hold_loop(engine)
    try:
        queues = [engine.submit(r) for r in reqs]
    finally:
        release()
    for q in queues:
        while not q.get(timeout=300).finished:
            pass
    ids = {r.request_id: r.priority for r in reqs}
    with open(trace) as f:
        admitted = [rid for line in f for rid in json.loads(line)["admitted"]
                    if rid in ids]
    first = [ids[rid] for rid in admitted[:hi]]
    emit({"phase": "priority_k", "admitted_priorities": [
        ids[rid] for rid in admitted], "trace_records_read": True})
    if len(admitted) != lo + hi or first != [1] * hi:
        raise AssertionError(f"lane K priority: admitted {admitted}")


def lane_k(torch):
    """Lane K (see K_SETTINGS): the logits checks (b, c), the serve cells
    and the slack witness (d), priority admission through the trace (e)
    and the memory with and without the squeeze (f); the kernel cases
    (a) are k_rows. The
    engine's trace file lives in a temporary directory, removed after.
    Returns the launch counts by run."""
    import dataclasses
    import os
    import tempfile

    from ferrum_tpu_torch.models.configs import preset

    mc = dataclasses.replace(preset(K_MODEL), num_layers=K_LAYERS)
    memory = k_memory(torch, mc)
    with tempfile.TemporaryDirectory() as d:
        trace = os.path.join(d, "scheduler_trace.jsonl")
        t0 = time.perf_counter()
        engine = k_engine(mc, k_draw(mc), scheduler_trace_path=trace)
        build_s = time.perf_counter() - t0
        try:
            k_logits(torch, mc, engine)
            launches = k_serve(torch, engine, mc)
            k_slack(torch, engine, mc)
            k_priority(torch, engine, mc, trace)
        finally:
            engine.stop()
    cfg = engine.cfg
    emit({"phase": "lane_k", "lane": K_NAME,
          "model": f"{K_MODEL} at {K_LAYERS} of 48 layers",
          "settings": K_SETTINGS, "adaptive_windows": cfg.adaptive_windows,
          "kv_layout": cfg.kv_layout, "prefix_cache": cfg.enable_prefix_cache,
          "engine_build_s": build_s, "memory": memory, "card": smi_line()})
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return {K_NAME: launches}


# ---------------------------------------------------------------------------
# Lane L: LoRA adapters over the two-level int4 base
# ---------------------------------------------------------------------------

# llama-3.1-8b at full width, 4 of its 32 layers (H_LAYERS' depth), random
# two-level int4 (seed 0) drawn on the card; a PEFT adapter with r = 16,
# lora_alpha = 32 on all seven projections of every layer, bf16 A / B
# drawn from seed 1, applied before the build at EngineConfig()'s
# defaults. The adapter keeps every projection split: rows 1 and 2 run
# at the split shapes (L_SPLIT).
L_MODEL, L_LAYERS = "llama-3.1-8b", H_LAYERS["llama-3.1-8b"]
L_RANK, L_ALPHA, L_OUT = 16, 32, 64
L_NAME = "L llama-3.1-8b LoRA r=16 over two-level int4"
L_SITES = {"q": "self_attn.q_proj", "k": "self_attn.k_proj",
           "v": "self_attn.v_proj", "o": "self_attn.o_proj",
           "gate": "mlp.gate_proj", "up": "mlp.up_proj",
           "down": "mlp.down_proj"}
# llama-3.1-8b's split projections (K, N) and the sites of each shape.
L_SPLIT = {(4096, 4096): ("q", "o"), (4096, 1024): ("k", "v"),
           (4096, 14336): ("gate", "up"), (14336, 4096): ("down",)}
L_M = (SERVE_DECODE_M, SERVE_PREFILL_M)


def lora_rows(torch, timer):
    """Rows 1 and 2 (w4a8tl_decode at m = 32, w4a8tl_prefill at m = 2048)
    at llama-3.1-8b's split projections (lane L's path: an adapter keeps
    q / k / v and gate / up unfused), exact against their plain versions,
    timed beside torch._int_mm; then one line a size summing a layer's
    seven projections (each shape times its sites)."""
    from ferrum_tpu_torch.ops.kernels import quant_matmul as qmm
    gen = torch.Generator(device="cuda")
    gen.manual_seed(25)
    kernels = {SERVE_DECODE_M: ("w4a8tl_decode", qmm.w4a8tl_decode),
               SERVE_PREFILL_M: ("w4a8tl_prefill", qmm.w4a8tl_prefill)}
    rows = []
    for (k, n), sites in L_SPLIT.items():
        p = make_gemm_weight(torch, k, n, gen)
        w8_cm = int_mm_weight(torch, p)
        for m in L_M:
            x = torch.randn(m, k, generator=gen, device="cuda",
                            dtype=torch.bfloat16)
            xq, xs = qmm.quantize_activation_rows(x)
            kernel, fn = kernels[m]
            row = {"kernel": kernel, "site": ", ".join(sites), "m": m,
                   "k": k, "n": n, "model": f"{L_MODEL} split"}
            if kernel == "w4a8tl_decode":
                row["plan"] = qmm.w4a8tl_decode_plan(m, n, k)
            two_level_case(rows, timer, row, fn, qmm.w4a8tl_plain, p,
                           w8_cm, xq, xs)
        del p, w8_cm
        torch.cuda.empty_cache()
    for m in L_M:
        sel = [c for c in rows if c["m"] == m]

        def tot(key):
            vals = [c.get(key) for c in sel]
            return None if None in vals else sum(
                v * len(c["site"].split(", ")) for v, c in zip(vals, sel))
        emit({"phase": "kernel_layer", "model": f"{L_MODEL} split",
              "kernel": sel[0]["kernel"], "m": m,
              "ms": tot("kernel_ms"), "plain_ms": tot("plain_ms"),
              "library_ms": tot("library_ms"), "bound_ms": tot("bound_ms"),
              "sites": "q, k, v, o, gate, up, down", "card": smi_line()})
    return rows


def l_write_adapter(torch, mc, d, zero_b=False):
    """A PEFT adapter directory written with the port's safetensors
    writer: adapter_config.json (r, lora_alpha) and lora_A [r, in] /
    lora_B [out, r] of every projection of every layer, bf16, N(0, 0.02)
    from seed 1 (B zeros with zero_b)."""
    import os

    from ferrum_tpu_torch.models.safetensors_io import write_safetensors
    shapes = {"q": (mc.hidden_size, mc.q_size),
              "k": (mc.hidden_size, mc.kv_size),
              "v": (mc.hidden_size, mc.kv_size),
              "o": (mc.q_size, mc.hidden_size),
              "gate": (mc.hidden_size, mc.intermediate_size),
              "up": (mc.hidden_size, mc.intermediate_size),
              "down": (mc.intermediate_size, mc.hidden_size)}
    gen = torch.Generator()
    gen.manual_seed(1)
    tensors = {}
    for li in range(mc.num_layers):
        for attr, (k, n) in shapes.items():
            p = f"base_model.model.model.layers.{li}.{L_SITES[attr]}"
            a = 0.02 * torch.randn(L_RANK, k, generator=gen)
            b = 0.02 * torch.randn(n, L_RANK, generator=gen)
            tensors[f"{p}.lora_A.weight"] = a.to(torch.bfloat16)
            tensors[f"{p}.lora_B.weight"] = (
                torch.zeros_like(b) if zero_b else b).to(torch.bfloat16)
    os.makedirs(d)
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"r": L_RANK, "lora_alpha": L_ALPHA, "peft_type": "LORA",
                   "target_modules": [v.split(".")[1]
                                      for v in L_SITES.values()]}, f)
    write_safetensors(os.path.join(d, "adapter_model.safetensors"), tensors)


def l_engine(mc, params):
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    return EngineBuilder(EngineConfig()).with_model(mc, params).build()


def l_serve(torch, engine, mc, prompts, label):
    """len(prompts) concurrent greedy 256/L_OUT requests, the launch
    counts from 0: every request L_OUT tokens, rows 1-4 launched and no
    other kernel. Returns (launches, token lists, the line)."""
    from concurrent.futures import ThreadPoolExecutor

    from ferrum_tpu_torch.ops import kernels as K

    K.reset_launch_counts()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(prompts)) as ex:
        resps = list(ex.map(engine.infer,
                            [request(p, L_OUT) for p in prompts]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = counts(K)
    for r in resps:
        if r.completion_tokens != L_OUT or not all(
                0 <= t < mc.vocab_size for t in r.token_ids):
            raise AssertionError(f"lane L {label}: {r.request_id} gave "
                                 f"{r.completion_tokens} tokens")
    check_path(f"L {label}", launches, LLAMA_PATH)
    ttft = [r.ttft for r in resps]
    tpot = [(r.e2e_latency - r.ttft) / (L_OUT - 1) for r in resps]
    line = {"phase": "serve_lora", "lane": L_NAME, "run": label,
            "requests": len(prompts), "prompt_len": PROMPT_LEN,
            "output_len": L_OUT, "wall_s": wall,
            "output_tok_s": len(prompts) * L_OUT / wall,
            "ttft_p50_ms": statistics.median(ttft) * 1e3,
            "tpot_p50_ms": statistics.median(tpot) * 1e3,
            "launches": launches, "kv_layout": engine.cfg.kv_layout,
            "card": smi_line()}
    emit(line)
    return launches, [r.token_ids for r in resps], line


def l_logits(torch, mc, engine):
    """A 256-token prefill and decode steps at 32 and 1 lanes on the
    adapter engine's built params, through the kernels and through their
    plain versions (the low-rank products are the same torch.matmul in
    both): every logit within 1e-3 of the logit scale (lane A's rule)."""
    import numpy as np

    params = engine.runner.params
    lanes = (32, 32, 1, 1)
    rng = np.random.default_rng(13)
    prompt = torch.from_numpy(rng.integers(0, mc.vocab_size, PROMPT_LEN)
                              ).to("cuda")[None]
    others = torch.from_numpy(rng.integers(
        0, mc.vocab_size, (len(lanes), max(lanes)))).to("cuda")
    got, fed = forward_logits(torch, params, mc, prompt, lanes, others)
    plain, _ = plain_run(lambda: forward_logits(torch, params, mc, prompt,
                                                lanes, others, fed))
    scale = max(a.abs().max().item() for a in got)
    diff = max((a - b).abs().max().item() for a, b in zip(got, plain))
    line = {"phase": "logits_lora", "lane": L_NAME,
            "steps": f"prefill {PROMPT_LEN} + decode at lanes {list(lanes)}",
            "max_abs_diff": diff, "logit_scale": scale,
            "within_rule": diff <= 1e-3 * scale,
            "finite": all(bool(torch.isfinite(a).all()) for a in got),
            "card": smi_line()}
    emit(line)
    del got, plain
    if not (line["within_rule"] and line["finite"]):
        raise AssertionError(f"lane L logits: {line}")


def l_split(params) -> bool:
    """Every projection of every layer a LoRA wrapper over a two-level
    base, none fused."""
    from ferrum_tpu_torch.ops.linear import LoraLinearParams
    return all(lp.qkv is None and lp.gate_up is None and all(
        isinstance(getattr(lp, a), LoraLinearParams)
        and getattr(lp, a).base.scales2 is not None for a in L_SITES)
        for lp in params.layers)


def lane_l(torch):
    """Lane L: the base engine, the adapter engine (built params split,
    logits == plain, served beside the base) and a B = 0 adapter engine,
    whose greedy tokens must equal the base engine's bit for bit; the
    base params keep their split linears through both builds. Returns
    the launch counts by run."""
    import dataclasses
    import os
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.lora import apply_lora, load_lora_adapter
    from ferrum_tpu_torch.models.quantize import init_random_quant_params

    mc = dataclasses.replace(preset(L_MODEL), num_layers=L_LAYERS)
    base_params = init_random_quant_params(mc, seed=0)
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        l_write_adapter(torch, mc, os.path.join(d, "adapter"))
        l_write_adapter(torch, mc, os.path.join(d, "zero"), zero_b=True)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        adapter, scale = load_lora_adapter(os.path.join(d, "adapter"))
        zero, zscale = load_lora_adapter(os.path.join(d, "zero"))
        load_s = time.perf_counter() - t0
    if len(adapter) != 7 * L_LAYERS or scale != L_ALPHA / L_RANK:
        raise AssertionError(f"lane L: {len(adapter)} pairs, scale {scale}")
    prompts = np.random.default_rng(11).integers(
        0, mc.vocab_size, (SERVE_REQUESTS, PROMPT_LEN))
    warm = np.random.default_rng(12).integers(0, mc.vocab_size,
                                              (4, PROMPT_LEN))
    runs, lines = {}, {}
    for label, ad, sc in (("base", None, None), ("adapter", adapter, scale),
                          ("B = 0", zero, zscale)):
        params = base_params if ad is None else apply_lora(base_params, ad,
                                                           sc)
        t0 = time.perf_counter()
        engine = l_engine(mc, params)
        build_s = time.perf_counter() - t0
        try:
            if ad is not None and not l_split(engine.runner.params):
                raise AssertionError(f"lane L {label}: the build fused or "
                                     f"did not requantize an adapter site")
            if label == "adapter":
                l_logits(torch, mc, engine)
            # A warm-up wave, so no engine's measured serve is its first.
            with ThreadPoolExecutor(len(warm)) as ex:
                list(ex.map(engine.infer, [request(p, 4) for p in warm]))
            launches, toks, line = l_serve(torch, engine, mc, prompts, label)
        finally:
            engine.stop()
        runs[label] = (launches, toks)
        lines[label] = {**line, "engine_build_s": build_s}
        del engine, params
        gc.collect()
        torch.cuda.empty_cache()
    base_kept = all(lp.qkv is None and lp.q is not None
                    for lp in base_params.layers)
    zero_equal = runs["B = 0"][1] == runs["base"][1]
    moved = 1.0 - same_share([runs["adapter"][1]], [runs["base"][1]])
    emit({"phase": "lane_l", "lane": L_NAME,
          "model": f"{L_MODEL} at {L_LAYERS} of 32 layers",
          "rank": L_RANK, "lora_alpha": L_ALPHA, "pairs": len(adapter),
          "adapter_write_s": write_s, "adapter_load_s": load_s,
          "runs": {k: {f: v[f] for f in ("output_tok_s", "ttft_p50_ms",
                                          "tpot_p50_ms", "wall_s",
                                          "engine_build_s")}
                   for k, v in lines.items()},
          "zero_adapter_tokens_equal_base": zero_equal,
          "adapter_tokens_differing_from_base_share": moved,
          "base_params_kept_split": base_kept, "card": smi_line()})
    if not (zero_equal and base_kept and moved > 0):
        raise AssertionError("lane L: the B = 0 tokens differ from the "
                             "base's, the base params changed, or the "
                             "adapter moved no token")
    del base_params
    gc.collect()
    torch.cuda.empty_cache()
    return {f"{L_NAME} {k}": v[0] for k, v in runs.items()}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from ferrum_tpu_torch.ops import kernels as K
    from ferrum_tpu_torch.ops.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    nvcc = subprocess.run([build.nvcc_path(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    emit({"phase": "env", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc.strip().splitlines()[-1],
          "device": torch.cuda.get_device_name(0)})
    t0 = time.perf_counter()
    build.build_all()
    for name in build.SOURCES:
        build.library(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0})

    timer = Timer(torch)
    cases = (gemm_rows(torch, timer) + group_dot_rows(torch, timer)
             + float_scale_rows(torch, timer)
             + kv_rows_cases(torch, timer) + kv_window_case(torch, timer)
             + kv_paged_step_case(torch, timer)
             + kv_pages_cases(torch, timer)
             + kv_pages_pairs_cases(torch, timer)
             + moe_cases(torch, timer)
             + gemma_rows(torch, timer) + gemma_kv_cases(torch, timer)
             + spec_rows(torch, timer) + spec_kv_cases(torch, timer)
             + k_rows(torch, timer) + lora_rows(torch, timer))
    dense_moe_cases(torch, timer)
    onehot_cases(torch)
    prefill_exact_cases(torch)
    decode_exact_cases(torch, timer)
    float_scale_exact_cases(torch, timer)
    bmm_exact_cases(torch, timer)
    grouped_exact_cases(torch, timer)
    summary = summarize(cases)
    emit({"phase": "kernels", "card": smi, "summary": summary})
    sampling_phase(torch, timer)
    del timer
    torch.cuda.empty_cache()
    attention_phase(torch, "cuda")
    attention_window_phase(torch, "cuda")

    # Each served path: its kernels' counts from 0 over its serve run.
    by_path, solos = {}, {}
    # Lane H: checkpoint directories written, loaded and served.
    by_path.update(checkpoint_phase(torch))
    torch.cuda.empty_cache()
    cli = None
    try:
        for lane in LANES:
            by_run, mc, engine, solos[lane["name"]] = serve_phase(
                torch, lane, solos.get(lane.get("solo_as")))
            by_path.update(by_run)
            if lane.get("window_check"):
                window_check(torch, mc, engine)
            routes = logits_phase(torch, mc, engine, lane)
            # A 1-lane MoE decode step takes the sort route: 8 rows
            # through moe_grouped's decode-sized loop.
            missed = [k for k in lane["path"]
                      + ((GROUPED_DECODE,) if "moe_grouped" in lane["path"]
                         else ()) if routes[k] == 0]
            stray = [k for k in off_path(lane) if routes[k] != 0]
            if missed or stray:
                raise AssertionError(f"{lane['name']} logits run: never "
                                     f"launched {missed}, launched {stray}")
            if lane["profile"]:
                profile_phase(torch, mc, engine, lane["tag"])
            if lane.get("bench"):
                bench_phase(torch, engine)
                profile_sink_phase(torch, engine)
                by_path["A server"] = server_phase(torch, mc, engine)
                by_path["A guided"] = guided_phase(torch, mc, engine)
            params = engine.runner.params
            engine.stop()
            del engine
            # The servers' apps hold the engine in reference cycles (the
            # router's bound methods): without a collection its cache
            # and weights stayed on the card through lanes F-C.
            gc.collect()
            torch.cuda.empty_cache()
            if lane.get("bench"):
                # The cli processes draw their weights on the host while
                # the next lanes run (the card holds them); their benches
                # run after the last lane (cli_finish).
                cli = cli_start()
            if lane.get("fg"):
                # Lanes F and G on lane A's weights.
                by_path["F llama-3.1-8b int8 KV, linear + prefix store"] = \
                    lane_f(torch, mc, params)
                (by_path["G llama-3.1-8b paged + prefix cache"],
                 by_path["G offload: paged + prefix cache + host tier"]) \
                    = lane_g(torch, mc, params)
            del params, mc
            gc.collect()
            torch.cuda.empty_cache()
        cli_finish(cli)
        # Lane I: gemma-3-12b, windowed attention, on the card alone.
        by_path.update(lane_i(torch))
        # Lane J: speculative decoding.
        by_path.update(lane_j(torch))
        # Lane K: the engine's remaining settings.
        by_path.update(lane_k(torch))
        # Lane L: LoRA adapters over the two-level int4 base.
        by_path.update(lane_l(torch))
    finally:
        cli_stop(cli)

    print(json.dumps({"kernels": [
        {"name": k.name, "route": "cuda", "source": k.source,
         "replaces": k.replaces,
         "launches": sum(c[k.name] for c in by_path.values()),
         "launches_by_path": {m: c[k.name] for m, c in by_path.items()},
         **({"launches_at_most_256_rows_by_path": {
             m: c[GROUPED_DECODE] for m, c in by_path.items()}}
            if k.name == "moe_grouped" else {}),
         "max_abs_err": summary[k.name]["max_abs_err"],
         "ms": summary[k.name]["ms"],
         "plain_ms": summary[k.name]["plain_ms"],
         "bound_ms": summary[k.name]["bound_ms"],
         "bound_by": summary[k.name]["bound_by"],
         "library_ms": summary[k.name]["library_ms"]}
        for k in K.KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
