"""The port's measuring modules against the JAX package's (CPU).

- utils/profile.py: the same emits, with the same seed, give the same
  lines (apart from `t_start`) and counters at every detail level and
  sample rate; the locked schema constants are equal.
- bench/bench_engine.py: `ScalarStats` and `_pct` equal on seeded
  inputs; `env_hash`; `run_cell`'s key set equals the JAX cell's;
  every cell and repeat of `run_bench` on tiny-quant (buckets 1, 8;
  c = 1, 2, 4) meets no program key first inside it; the open-loop
  cell completes every request it launched.
- engine metrics: both engines serve the same greedy requests (tiny-quant,
  converted weights, the unpipelined loop, c = 3) and count the same
  requests and tokens.
- runner counters: decode steps, prefill chunks, phase times and the
  compile audit (sites within the JAX runner's, a second wave adds
  none, `warm_prefill_siblings` covers a new batch size).
- models/llama_family.py `init_random_params`: bit for bit the JAX
  weights on tiny-test and tiny-quant; llama-3.1-8b's shape and dtype
  table from both packages with the draws stubbed out.
- utils/replay.py: a JAX bundle loads, a port bundle replays, and an
  unported field raises.
- models/quantize.py `quantize_model_params` and bench/accuracy.py:
  the packed bytes and scales, teacher-forced logits, logit and weight
  error metrics against the JAX package's; determinism and divergence
  on the port's engine.
"""

import dataclasses
import json
import re
import threading
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_engine import (LINEAR, MAX_TOKENS, PROMPTS, UNPIPELINED,
                               _engine_kw, _serve)
from torch_parity import (flatten_jax_params, jax_model, route_w4a8tl,
                          torch_config)

REPO = Path(__file__).resolve().parent.parent


# ---------------------------------------------------------------------------
# profile sink
# ---------------------------------------------------------------------------

# (method, args, kwargs): every kind, every gate, forced and sampled spans.
EMITS = [
    ("emit", ("engine.iteration", 0.01, {"decode": 3}), {}),
    ("emit", ("window.dispatch", 0.002, {"steps": 8, "bucket": 8}), {}),
    ("emit", ("window.fetch", 0.001, None), {}),
    ("emit", ("prefill.batch", 0.003, {"b": 2}), {}),
    ("emit", ("sched.decision", 0.0, {"held": True}), {}),
    ("emit", ("request.span", 0.5, {"rid": "r1"}), {}),
    ("emit_instant", ("engine.compile", {"site": "window"},
                      "diagnostic_only"), {}),
    ("emit", ("kv.blocks", 0.0, {"free": 3}), {"kind": "resource"}),
    ("emit_error", ("error", "boom", {"where": "loop"}), {}),
    ("emit", ("engine.iteration", 0.02, None), {"force": True}),
    ("emit", ("request.span", 0.1, None), {"status": "failure"}),
] * 6


def _run_sink(mod, path, detail, rate):
    sink = mod.ProfileSink(str(path), entrypoint="serve", sample_rate=rate,
                           seed=7, detail=detail)
    for method, args, kw in EMITS:
        getattr(sink, method)(*args, **kw)
    sink.close()
    lines = [json.loads(x) for x in open(path) if x.strip()]
    for line in lines:
        del line["t_start"]
    return lines, (sink.events_emitted, sink.events_sampled_out,
                   sink.events_detail_gated)


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("detail", ["off", "basic", "debug", "full"])
def test_profile_lines_match_jax(tmp_path, detail, rate):
    from ferrum_tpu.utils import profile as jp
    from ferrum_tpu_torch.utils import profile as tp

    mine = _run_sink(tp, tmp_path / "port.jsonl", detail, rate)
    ref = _run_sink(jp, tmp_path / "jax.jsonl", detail, rate)
    assert mine == ref
    if detail == "debug" and rate == 1.0:
        assert {x["event"] for x in mine[0]} >= {"window.dispatch",
                                                 "engine.compile"}


def test_profile_schema_constants_match_jax():
    from ferrum_tpu.utils import profile as jp
    from ferrum_tpu_torch.utils import profile as tp

    for name in ("SCHEMA_VERSION", "KINDS", "STATUSES", "DETAILS",
                 "_BASIC_EVENTS", "_DEBUG_PREFIXES"):
        assert getattr(tp, name) == getattr(jp, name), name
    assert [f.name for f in dataclasses.fields(tp.ProfileEvent)] == \
        [f.name for f in dataclasses.fields(jp.ProfileEvent)]
    for v in ("bench-serve", "SERVE", "nope", "run"):
        assert tp.parse_entrypoint(v) == jp.parse_entrypoint(v)
    for v in ("debug", "verbose", " full "):
        assert tp.parse_detail(v) == jp.parse_detail(v)


def test_memory_snapshot_on_the_cpu(tmp_path):
    """Host RSS only (no card in use); `emit_memory` writes one memory
    line to the memory sink, none to the event file."""
    from ferrum_tpu_torch.utils import profile as tp

    snap = tp.snapshot_memory()
    assert snap["host_rss_bytes"] > 0
    assert not [k for k in snap if k.startswith("device_")]
    ev, mem = tmp_path / "ev.jsonl", tmp_path / "mem.jsonl"
    tp.configure_global_profile(str(ev), detail="basic", memory_path=str(mem))
    try:
        tp.emit_memory({"iterations": 3})
        tp.emit("engine.iteration", 0.0, force=True)
    finally:
        tp.configure_global_profile(None)
    (line,) = [json.loads(x) for x in open(mem)]
    assert line["kind"] == "memory" and line["event"] == "engine.memory"
    assert line["attrs"]["iterations"] == 3 and line["schema"] == 2
    assert [json.loads(x)["event"] for x in open(ev)] == ["engine.iteration"]


# ---------------------------------------------------------------------------
# bench statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 2, 7, 100])
def test_stats_match_jax(n):
    from ferrum_tpu.bench import bench_engine as jb
    from ferrum_tpu_torch.bench import bench_engine as tb

    xs = np.random.default_rng(n).exponential(3.0, n).tolist()
    assert dataclasses.asdict(tb.ScalarStats.of(xs)) == \
        dataclasses.asdict(jb.ScalarStats.of(xs))
    for p in (50, 95, 99):
        assert tb._pct(xs, p) == jb._pct(xs, p)
    m = tb.RequestMetrics(ttft=0.5, e2e=2.5, itls=[], output_tokens=n)
    assert m.tpot == jb.RequestMetrics(0.5, 2.5, [], n).tpot


def test_env_hash():
    from ferrum_tpu_torch.bench.bench_engine import env_hash

    a, b = env_hash({"model": "a"}), env_hash({"model": "b"})
    assert re.fullmatch(r"[0-9a-f]{16}", a) and a != b
    assert env_hash({"model": "a"}) == a


# ---------------------------------------------------------------------------
# engine metrics and runner counters
# ---------------------------------------------------------------------------

def _port_engine(cfg, params, **kw):
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    return EngineBuilder(EngineConfig(device="cpu", **{
        **_engine_kw(), **LINEAR, **kw})).with_model(cfg, params).build()


def test_engine_metrics_match_jax(monkeypatch):
    """The same greedy requests through both engines (unpipelined, c = 3):
    equal request and token counts."""
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.engine.builder import EngineBuilder as JaxBuilder
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.types import SamplingParams as JSamp
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    route_w4a8tl(monkeypatch)
    jcfg, jparams = jax_model("tiny-quant", quantized=True, seed=3)
    port = _port_engine(torch_config(jcfg),
                        params_from_numpy(flatten_jax_params(jparams), "cpu"),
                        **UNPIPELINED)
    mine_toks = _serve(port, InferenceRequest, SamplingParams)[0]
    jax_engine = JaxBuilder(JaxConfig(
        model="parity", dtype="f32", kv_layout="linear",
        enable_prefix_cache=False, adaptive_windows=False, **UNPIPELINED,
        **_engine_kw())).with_model(jcfg, jparams).build()
    ref_toks = _serve(jax_engine, JReq, JSamp)[0]
    assert mine_toks == ref_toks
    mine, ref = port.metrics_snapshot(), jax_engine.metrics_snapshot()
    for name in ("requests_submitted", "requests_completed",
                 "tokens_prefilled", "tokens_decoded"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert mine.requests_completed == len(PROMPTS)
    assert mine.tokens_prefilled == sum(len(p) for p in PROMPTS)
    assert mine.tokens_decoded == len(PROMPTS) * (MAX_TOKENS - 1)
    assert mine.iterations_total > 0 and ref.iterations_total > 0
    assert mine.kv_blocks_total == 4 * 256 // 16 == mine.kv_blocks_free
    assert mine.running_requests == mine.waiting_requests == 0


def _jax_compile_sites():
    src = (REPO / "ferrum_tpu" / "engine" / "runner.py").read_text()
    return set(re.findall(r'_note_compile\("(\w+)"', src))


def _wave(engine, prompts, max_tokens=6):
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    out = [None] * len(prompts)

    def one(i):
        out[i] = engine.infer(InferenceRequest(
            prompt_token_ids=list(prompts[i]),
            sampling=SamplingParams(max_tokens=max_tokens, ignore_eos=True)))

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def _tiny_quant(**kw):
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.quantize import init_random_quant_params
    mc = preset("tiny-quant")
    return _port_engine(mc, init_random_quant_params(mc, seed=0,
                                                     device="cpu"), **kw)


def test_runner_counters_and_compile_audit():
    """The pipelined loop with mixed prefill at c = 4: decode_steps is
    the windows' steps, prefill_steps the chunks dispatched (riding ones
    too), the phase times grow, the compile log names only the JAX
    runner's sites (and kernel_build). The same requests one at a time
    (a schedule the threads cannot change), repeated, add no key; after
    warm_prefill_siblings every batch size of each prefill key seen is a
    key (the port runs the exact batch: no power-of-two padding), and a
    concurrent wave at a new batch size adds no prefill key."""
    engine = _tiny_quant(decode_bucket_spec="1,2", decode_t_spec="1:6")
    runner = engine.runner
    rec = {"steps": 0, "chunks": 0}
    start, prefill = runner.start_decode_window, runner.run_prefill_batch

    def start_rec(seqs, num_steps, prev=None, pf_chunk=None):
        rec["steps"] += num_steps
        rec["chunks"] += pf_chunk is not None
        return start(seqs, num_steps, prev, pf_chunk)

    def prefill_rec(chunks):
        rec["chunks"] += len(chunks)
        return prefill(chunks)

    runner.start_decode_window, runner.run_prefill_batch = start_rec, \
        prefill_rec
    prompts = [list(range(3, 3 + n)) for n in (7, 40, 13, 20)]
    try:
        _wave(engine, prompts)
        # A prompt arriving while another request decodes rides its
        # window (one chunk: refill-first does not hold).
        from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
        q = engine.submit(InferenceRequest(
            prompt_token_ids=prompts[2],
            sampling=SamplingParams(max_tokens=40, ignore_eos=True)))
        assert q.get(timeout=60).token_ids
        _wave(engine, prompts[:1])
        while not q.get(timeout=60).finished:
            pass
        assert runner.decode_steps == rec["steps"] > 0
        assert runner.prefill_steps == rec["chunks"] > len(prompts)
        assert runner.mixed_windows > 0
        for t in ("decode_device_time", "decode_sync_time",
                  "prefill_device_time"):
            assert getattr(runner, t) > 0, t
        sites = {site for site, _ in runner.compile_log}
        assert {"window", "prefill"} <= sites
        assert sites <= _jax_compile_sites() | {"kernel_build"}
        assert runner.compilations == len(runner.compile_log)
        for _ in range(2):
            n0 = runner.compilations
            for p in prompts:
                _wave(engine, [p])
        assert runner.compilations == n0, runner.compile_log[n0:]
        runner.warm_prefill_siblings()
        keys = runner._prefill_keys
        for (_, t_pad, ctx, greedy, *rest) in keys:
            assert {(b, t_pad, ctx, greedy, *rest)
                    for b in (1, 2, 3, 4)} <= keys
        n1 = len(runner.compile_log)
        _wave(engine, prompts[:3])
        assert not [e for e in runner.compile_log[n1:] if e[0] == "prefill"]
    finally:
        engine.stop()


# ---------------------------------------------------------------------------
# run_cell / run_bench / run_cell_open_loop
# ---------------------------------------------------------------------------

CELL = dict(concurrency=2, num_requests=4, input_len=8, output_len=4,
            warmup=2)


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}.")
    return out


GUIDED_SCHEMA = {"type": "object", "properties": {"ok": {"type": "boolean"},
                                                 "n": {"type": "integer"}},
                 "required": ["ok", "n"]}


def _jax_cell(**kw):
    """The JAX run_cell on tiny-quant, built as tests/test_engine_e2e.py's
    tiny_engine builds its model."""
    import jax.numpy as jnp

    from ferrum_tpu.bench.bench_engine import run_cell as jax_run_cell
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.engine.builder import EngineBuilder as JaxBuilder
    from ferrum_tpu.models.configs import preset
    from ferrum_tpu.models.llama_family import init_random_params
    from ferrum_tpu.tokenizer import make_byte_tokenizer

    mc = preset("tiny-quant")
    jax_engine = JaxBuilder(JaxConfig(
        model="test", max_num_seqs=2, kv_num_blocks=64, kv_block_size=8,
        max_model_len=256, max_num_batched_tokens=128,
        prefill_chunk_size=32, dtype="f32", kv_dtype="f32", seed=0)) \
        .with_model(mc, init_random_params(mc, seed=0, dtype=jnp.float32)) \
        .with_tokenizer(make_byte_tokenizer(
            vocab_extra=mc.vocab_size - 258)).build()
    try:
        return jax_run_cell(jax_engine, **CELL, **kw)
    finally:
        jax_engine.stop()


def test_run_cell_keys_match_jax():
    """The port's cell report has the JAX cell's keys exactly (the JAX
    engine on tiny-quant, built as tests/test_engine_e2e.py's
    tiny_engine builds its model)."""
    from ferrum_tpu_torch.bench.bench_engine import run_cell

    ref = _jax_cell()
    engine = _tiny_quant(max_num_seqs=2)
    try:
        cell = run_cell(engine, **CELL)
    finally:
        engine.stop()
    assert _keys(cell) == _keys(ref)
    assert cell["completed"] == cell["requested"] == 4
    assert cell["errors"] == 0 and cell["compilations_during_cell"] == 0
    assert cell["phase_times"]["decode_steps"] > 0


def test_run_bench_cells_meet_no_new_key():
    """tiny-quant at buckets 1 and 8 (T = 8), cells c = 1, 2 and 4 at two
    repeats on one engine: every cell and repeat after its own warm-up
    first meets no program key; the report carries each cell's stats
    over the repeats and the schema string."""
    from ferrum_tpu_torch.bench import bench_engine as be

    engine = _tiny_quant(max_num_seqs=8, decode_bucket_spec="1,8")
    reps = []
    run_cell = be.run_cell

    def recorded(*a, **kw):
        reps.append(run_cell(*a, **kw))
        return reps[-1]

    be.run_cell = recorded
    try:
        report = be.run_bench(engine, concurrencies=(1, 2, 4),
                              num_requests_per_cell={1: 2, 2: 4, 4: 4},
                              input_len=16, output_len=12, n_repeats=2,
                              model_label="tiny-quant")
    finally:
        be.run_cell = run_cell
        engine.stop()
    assert report["schema"] == "ferrum-tpu-bench/v1"
    assert report["workload"] == {"input_len": 16, "output_len": 12,
                                  "mode": "closed-loop"}
    assert len(reps) == 6
    for r in reps:
        assert r["completed"] == r["requested"] and r["errors"] == 0
        assert r["compilations_during_cell"] == 0, r["compiled_in_cell"]
        pt = r["phase_times"]
        assert pt["decode_steps"] > 0 and pt["prefill_calls"] >= r["requested"]
        assert min(pt["decode_dispatch_s"], pt["decode_sync_s"],
                   pt["prefill_s"]) >= 0
        assert pt["decode_dispatch_s"] + pt["decode_sync_s"] \
            + pt["prefill_s"] <= r["wall_s"] + 3e-3    # rounded to 1 ms
    for cell in report["cells"]:
        st = cell["output_tok_s_stats"]
        assert st["n"] == 2 and st["mean"] == cell["output_tok_s"]


def test_open_loop_cell_completes_all_launched():
    from ferrum_tpu_torch.bench.bench_engine import run_cell_open_loop

    engine = _tiny_quant()
    try:
        cell = run_cell_open_loop(engine, rate_rps=4.0, duration_s=2.0,
                                  input_len=8, output_len=4, seed=0,
                                  warmup=1)
    finally:
        engine.stop()
    assert cell["mode"] == "open-loop" and cell["launched"] >= 1
    assert cell["completed"] == cell["launched"] and cell["errors"] == 0
    assert cell["ttft_p50_ms"] > 0 and cell["output_tok_s"] > 0


def test_guided_cell_matches_jax():
    """run_cell with guided_schema: every request carries the schema
    (unmasked by strictness, as the JAX cells attach it) on the
    device-FSM path. The cell's keys and its request, completion and
    error counts equal the JAX run_cell's; no key is first met inside
    the cell (the guided window and prefill keys are warmed)."""
    from ferrum_tpu_torch.bench import bench_engine as be

    ref = _jax_cell(guided_schema=GUIDED_SCHEMA)
    engine = _tiny_quant(max_num_seqs=2)
    submitted = []
    submit = engine.submit

    def recorded(req):
        submitted.append(req.guided)
        return submit(req)

    engine.submit = recorded
    try:
        cell = be.run_cell(engine, **CELL, guided_schema=GUIDED_SCHEMA)
        keys = engine.runner._window_keys | engine.runner._prefill_keys
    finally:
        engine.stop()
    assert _keys(cell) == _keys(ref)
    for k in ("requested", "completed", "errors"):
        assert cell[k] == ref[k], k
    assert cell["completed"] == 4 and cell["compilations_during_cell"] == 0
    assert submitted and all(g is not None and g.json_schema == GUIDED_SCHEMA
                             and not g.strict for g in submitted)
    assert any(k[-2] for k in keys)          # a guided key was dispatched


# ---------------------------------------------------------------------------
# init_random_params
# ---------------------------------------------------------------------------

def _flatten_port(params):
    """The port's ModelParams → {dotted name: tensor}, named as
    torch_parity.flatten_jax_params names the JAX fields."""
    out = {"embed": params.embed, "final_norm": params.final_norm}
    if params.lm_head is not None:
        out["lm_head.w"] = params.lm_head.w
    for i, lp in enumerate(params.layers):
        for name in ("input_norm", "pre_mlp_norm", "q_norm", "k_norm"):
            if getattr(lp, name) is not None:
                out[f"layers.{i}.{name}"] = getattr(lp, name)
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            if getattr(lp, name) is not None:
                out[f"layers.{i}.{name}.w"] = getattr(lp, name).w
        if lp.moe is not None:
            out[f"layers.{i}.moe.router.w"] = lp.moe.router.w
            for name in ("gate", "up", "down"):
                out[f"layers.{i}.moe.{name}"] = getattr(lp.moe, name)
    return out


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("name", ["tiny-test", "tiny-quant"])
def test_init_random_params_equals_jax(name, dtype):
    import jax.numpy as jnp

    from ferrum_tpu.models.configs import preset as jax_preset
    from ferrum_tpu.models.llama_family import init_random_params as jinit
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.llama_family import init_random_params

    jd, td = {"bf16": (jnp.bfloat16, torch.bfloat16),
              "f32": (jnp.float32, torch.float32)}[dtype]
    ref = flatten_jax_params(jinit(jax_preset(name), seed=5, dtype=jd))
    mine = _flatten_port(init_random_params(preset(name), seed=5, dtype=td,
                                            device="cpu"))
    assert set(mine) == set(ref)
    for k, t in mine.items():
        assert t.dtype == td, k
        assert np.array_equal(t.float().numpy(), ref[k]), k


def _stub_draws(monkeypatch):
    """Both packages' init_random_params without drawing: every normal is
    a stand-in that keeps its shape and dtype (a ShapeDtypeStruct on the
    JAX side, `Drawn` on the port's)."""
    import jax
    import jax.numpy as jnp

    from ferrum_tpu.models import llama_family as jl
    from ferrum_tpu_torch.models import llama_family as tl

    class Drawn:
        def __init__(self, shape, dtype=None):
            self.shape, self.dtype = tuple(shape), dtype

        def astype(self, dtype):
            return self

        def to(self, where):
            if isinstance(where, torch.dtype):
                return Drawn(self.shape, where)
            return self

    class Rng:
        def normal(self, loc, scale, shape):
            return Drawn(shape)

    fake_np = types.SimpleNamespace(
        float32=np.float32,
        random=types.SimpleNamespace(default_rng=lambda seed: Rng()))
    fake_jnp = types.SimpleNamespace(
        asarray=lambda x, dtype: jax.ShapeDtypeStruct(x.shape, dtype),
        ones=lambda n, dtype: jax.ShapeDtypeStruct((n,), dtype),
        zeros=lambda n, dtype: jax.ShapeDtypeStruct((n,), dtype),
        bfloat16=jnp.bfloat16, float32=jnp.float32)
    monkeypatch.setattr(jl, "np", fake_np)
    monkeypatch.setattr(jl, "jnp", fake_jnp)
    monkeypatch.setattr(tl, "np", fake_np)
    real_from_numpy = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda x: x if isinstance(
        x, Drawn) else real_from_numpy(x))


def test_llama_8b_shape_table_matches_jax(monkeypatch):
    import jax.numpy as jnp

    from ferrum_tpu.models.configs import preset as jax_preset
    from ferrum_tpu.models.llama_family import init_random_params as jinit
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.llama_family import init_random_params

    _stub_draws(monkeypatch)
    ref = jinit(jax_preset("llama-3.1-8b"), seed=0, dtype=jnp.bfloat16)
    mine = init_random_params(preset("llama-3.1-8b"), seed=0, device="cpu")

    def table(flat):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in flat.items()}

    ref_flat = {"embed": ref.embed, "final_norm": ref.final_norm,
                "lm_head.w": ref.lm_head.w}
    for i, lp in enumerate(ref.layers):
        for name in ("input_norm", "pre_mlp_norm"):
            ref_flat[f"layers.{i}.{name}"] = getattr(lp, name)
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            ref_flat[f"layers.{i}.{name}.w"] = getattr(lp, name).w
    got = table(_flatten_port(mine))
    assert got == table(ref_flat)
    assert got["embed"] == ((128256, 4096), "bfloat16")
    assert len(got) == 3 + 32 * 9


# ---------------------------------------------------------------------------
# replay bundles
# ---------------------------------------------------------------------------

def test_jax_bundle_loads_in_the_port(tmp_path):
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.types import SamplingParams as JSamp
    from ferrum_tpu.utils import replay as jr
    from ferrum_tpu_torch.utils import replay as tr

    req = JReq(prompt_token_ids=[5, 9, 17], request_id="r7",
               sampling=JSamp(temperature=0.7, top_k=3, top_p=0.9,
                              repetition_penalty=1.1, max_tokens=5,
                              min_tokens=1, stop_token_ids=[4],
                              ignore_eos=True))
    path = str(tmp_path / "b.json")
    jr.save_bundle(jr.capture_bundle(req, JaxConfig(model="random:tiny-test"),
                                     "random:tiny-test", [1, 2]), path)
    assert tr.BUNDLE_SCHEMA == jr.BUNDLE_SCHEMA
    mine = tr.request_from_bundle(tr.load_bundle(path))
    ref = jr.request_from_bundle(jr.load_bundle(path))
    assert (mine.prompt, mine.prompt_token_ids, mine.request_id) == \
        (ref.prompt, ref.prompt_token_ids, ref.request_id)
    for f in dataclasses.fields(mine.sampling):
        assert getattr(mine.sampling, f.name) == \
            getattr(ref.sampling, f.name), f.name


def test_port_bundle_replays(tmp_path):
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    from ferrum_tpu_torch.utils import replay as tr

    cfg = EngineConfig(model="random:tiny-test", device="cpu",
                       max_model_len=256, max_num_seqs=2,
                       kv_layout="linear", prefix_cache_blocks=0)
    engine = EngineBuilder(cfg).build()
    try:
        req = InferenceRequest(prompt="replay me", request_id="r1",
                               sampling=SamplingParams(max_tokens=5))
        got = engine.infer(req).token_ids
        path = str(tmp_path / "b.json")
        tr.save_bundle(tr.capture_bundle(req, cfg, cfg.model, got), path)
        rec = tr.replay_bundle(path, engine)
        assert rec["matches_observed"] and rec["token_ids"] == got
        assert rec["request_id"] == "r1-replay"
    finally:
        engine.stop()


@pytest.mark.parametrize("field,value", [
    ("stop", ["\n"]), ("seed", 3), ("logprobs", 2)])
def test_ported_sampling_fields_load_from_bundle(field, value):
    """Stop strings, seeds and logprobs (ported with the server) load
    from a JAX bundle into the port's SamplingParams."""
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.utils import replay as jr
    from ferrum_tpu_torch.utils import replay as tr

    bundle = jr.capture_bundle(JReq(prompt_token_ids=[1, 2]),
                               JaxConfig(model="m"), "m")
    bundle["request"]["sampling"][field] = value
    req = tr.request_from_bundle(bundle)
    assert getattr(req.sampling, field) == value
    assert req.request_id == bundle["request"]["request_id"] + "-replay"


@pytest.mark.parametrize("guided", [
    {"regex": "a+", "json_schema": None, "json_mode": False, "strict": True},
    {"regex": None, "json_schema": {"type": "object", "properties": {
        "a": {"type": "integer"}}}, "json_mode": False, "strict": False},
    {"regex": None, "json_schema": None, "json_mode": True, "strict": True}])
def test_guided_bundle_round_trips(guided):
    """A JAX bundle's guided options load into the port's GuidedOptions,
    and the port's capture writes them back as the JAX capture does."""
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.types import GuidedOptions as JOpts
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.utils import replay as jr
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.types import GuidedOptions
    from ferrum_tpu_torch.utils import replay as tr

    bundle = jr.capture_bundle(JReq(prompt_token_ids=[1, 2],
                                    guided=JOpts(**guided)),
                               JaxConfig(model="m"), "m")
    req = tr.request_from_bundle(bundle)
    assert req.guided == GuidedOptions(**guided)
    again = tr.capture_bundle(req, EngineConfig(), "m")
    assert again["request"]["guided"] == bundle["request"]["guided"] \
        == guided


@pytest.mark.parametrize("field,value", [
    ("lora_rank", 4), ("top_a", 0.1), ("min_p", 0.05)])
def test_unported_bundle_field_raises(tmp_path, field, value):
    from ferrum_tpu.config import EngineConfig as JaxConfig
    from ferrum_tpu.types import InferenceRequest as JReq
    from ferrum_tpu.utils import replay as jr
    from ferrum_tpu_torch.types import InvalidRequestError
    from ferrum_tpu_torch.utils import replay as tr

    bundle = jr.capture_bundle(JReq(prompt_token_ids=[1, 2]),
                               JaxConfig(model="m"), "m")
    bundle["request"]["sampling"][field] = value
    with pytest.raises(InvalidRequestError, match="not yet ported") as e:
        tr.request_from_bundle(bundle)
    assert e.value.param == field


# ---------------------------------------------------------------------------
# quantize_model_params and the accuracy functions
# ---------------------------------------------------------------------------

def _both_quantized(dtype):
    import jax.numpy as jnp

    from ferrum_tpu.models.configs import preset as jax_preset
    from ferrum_tpu.models.llama_family import init_random_params as jinit
    from ferrum_tpu.models.quantize import quantize_model_params as jq
    from ferrum_tpu_torch.models.configs import preset
    from ferrum_tpu_torch.models.llama_family import init_random_params
    from ferrum_tpu_torch.models.quantize import quantize_model_params

    jd, td = {"bf16": (jnp.bfloat16, torch.bfloat16),
              "f32": (jnp.float32, torch.float32)}[dtype]
    jf = jinit(jax_preset("tiny-quant"), seed=2, dtype=jnp.float32)
    tf = init_random_params(preset("tiny-quant"), seed=2,
                            dtype=torch.float32, device="cpu")
    return (jf, jq(jf, 128, dtype=jd)), (tf, quantize_model_params(
        tf, 128, dtype=td))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_quantize_model_params_equals_jax(dtype):
    from ferrum_tpu_torch.models.convert import params_from_numpy

    (_, jqp), (_, tqp) = _both_quantized(dtype)
    ref = params_from_numpy(flatten_jax_params(jqp), "cpu")
    for a, b in zip(tqp.layers, ref.layers):
        for name in ("q", "k", "v", "o", "gate", "up", "down"):
            x, y = getattr(a, name), getattr(b, name)
            assert torch.equal(x.qweight, y.qweight), name
            assert torch.equal(x.zeros, y.zeros), name
            assert torch.equal(x.scales.float(), y.scales), name
    assert torch.equal(tqp.embed, ref.embed)


def test_quantize_expert_stack_equals_jax():
    import jax.numpy as jnp

    from ferrum_tpu.models.quantize import _quant_expert_stack as jstack
    from ferrum_tpu_torch.models.quantize import _quant_expert_stack

    w = np.random.default_rng(4).normal(0, 0.02, (3, 256, 128)).astype(
        np.float32)
    ref = jstack(jnp.asarray(w), 128, jnp.float32)
    mine = _quant_expert_stack(torch.from_numpy(w), 128, torch.float32)
    assert np.array_equal(mine.qweight.numpy(), np.asarray(ref.qweight))
    assert np.array_equal(mine.scales.numpy(), np.asarray(ref.scales))
    assert np.array_equal(mine.zeros.numpy(), np.asarray(ref.zeros))


def test_accuracy_metrics_match_jax():
    """teacher_forced_logits within 1e-5 of the logit scale of the JAX
    reference forward (both f32); quant_logit_metrics and
    weight_quant_error equal the JAX package's on the same inputs."""
    from ferrum_tpu.bench import accuracy as ja
    from ferrum_tpu.models.configs import preset as jax_preset
    from ferrum_tpu_torch.bench import accuracy as ta
    from ferrum_tpu_torch.models.configs import preset

    (jf, jqp), (tf, tqp) = _both_quantized("f32")
    toks = [5, 9, 17, 3, 44, 101, 7, 250, 12]
    ref = np.asarray(ja.teacher_forced_logits(jf, jax_preset("tiny-quant"),
                                              toks))
    mine = ta.teacher_forced_logits(tf, preset("tiny-quant"), toks).numpy()
    assert mine.shape == ref.shape == (len(toks), 1024)
    assert np.abs(mine - ref).max() <= 1e-5 * np.abs(ref).max()
    rng = np.random.default_rng(1)
    lf = rng.normal(0, 1, (6, 50))
    lq = lf + rng.normal(0, 0.1, (6, 50))
    assert ta.quant_logit_metrics(lf, lq) == ja.quant_logit_metrics(lf, lq)
    assert ta.weight_quant_error(tf, tqp) == ja.weight_quant_error(jf, jqp)


def test_determinism_and_divergence_on_the_port():
    from ferrum_tpu_torch.bench import accuracy as ta
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder

    engine = EngineBuilder(EngineConfig(
        model="random:tiny-test", device="cpu", max_model_len=256,
        max_num_seqs=2, kv_layout="linear", prefix_cache_blocks=0)).build()
    try:
        prompts = ta.DEFAULT_PROMPTS[:2]
        rep = ta.greedy_self_determinism(engine, prompts, max_tokens=8)
        assert rep.passed and rep.token_agreement == 1.0
        div = ta.quant_token_divergence(engine, engine, prompts,
                                        max_tokens=8)
        assert div.tokens_compared == 16 and div.divergence_rate == 0.0
    finally:
        engine.stop()
