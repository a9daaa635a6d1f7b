"""`python -m ferrum_tpu_torch`: the port's CLI (run / serve / bench /
bench-serve / replay / list).

Port of `ferrum_tpu/cli.py`'s engine flags and its `run` (one-shot
`--prompt`, or the REPL with /exit, /clear, /system), `serve` (the
OpenAI-compatible server, server/app.py; `--asr-model`, `--tts-model`
and `--embed-model` are not yet ported and exit 1), `bench`,
`bench-serve` (bench/bench_serve.py against a running server),
`replay` and `list` subcommands; `embed`, `transcribe`, `tts`, `pull`,
`stop` and `route` wait for their modules (ROADMAP Queue 1). Every JAX
engine flag is accepted (`--scheduler continuous|fifo|priority` among
them), and one whose feature the port does not have yet (`--tp 2`,
`--quantization gguf_q4k`) raises InvalidRequestError, as
`EngineConfig.resolve` does for a FERRUM_* variable or a ferrum.toml
key (FERRUM_PREFIX_OFFLOAD_MB, ...); `main` turns it into exit code 1
and `error: ...` on stderr. The engine settings without a flag come
from FERRUM_* variables as in the JAX CLI (FERRUM_ADAPTIVE_WINDOWS,
FERRUM_SLOT_SLACK, FERRUM_SQUEEZE_EMBED, FERRUM_FUSE_PROJ,
FERRUM_FUSE_SITES, FERRUM_ENABLE_CHUNKED_PREFILL,
FERRUM_SCHEDULER_TRACE_JSONL, ...). `--device` (default: the CUDA card) picks
the device; `--device cpu` runs the plain PyTorch versions. The model
is `random:<preset>` or a local HF checkpoint directory (config.json,
safetensors shards, tokenizer.json; `--quantization gptq_int4`
quantizes a dense one on load). `--spec-draft` (a checkpoint directory
or random:<preset>) and `--spec-k` serve with speculative decoding in
`run`, `serve` and `bench`.

Usage: python -m ferrum_tpu_torch bench random:llama-3.1-8b [...]
       python -m ferrum_tpu_torch bench /path/to/checkpoint [...]
       python -m ferrum_tpu_torch serve /path/to/checkpoint --port 8000
       python -m ferrum_tpu_torch run random:tiny-test --device cpu \
           --prompt hello --max-tokens 8
       python -m ferrum_tpu_torch bench random:qwen3-0.6b \
           --spec-draft random:qwen3-0.6b --spec-k 4
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Any, Dict

from .config import EngineConfig
from .types import (FerrumError, InferenceRequest, InvalidRequestError,
                    SamplingParams)


def _add_engine_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("model", help="checkpoint dir (HF config.json, "
                                 "safetensors, tokenizer.json) or "
                                 "random:<preset>")
    p.add_argument("--device", default=None,
                   help="cuda (default: the CUDA card) or cpu")
    p.add_argument("--max-num-seqs", type=int, default=None)
    p.add_argument("--max-num-batched-tokens", type=int, default=None)
    p.add_argument("--max-model-len", type=int, default=None)
    p.add_argument("--kv-capacity", type=int, default=None,
                   help="KV blocks of the paged pool (0 = autosize)")
    p.add_argument("--kv-block-size", type=int, default=None)
    p.add_argument("--kv-dtype", default=None, choices=["bf16", "f32", "int8"])
    p.add_argument("--kv-layout", default=None,
                   choices=["paged", "linear", "auto"],
                   help="auto (default): linear when every slot's region "
                        "fits the card, else paged")
    p.add_argument("--quantization", default=None,
                   choices=["none", "gptq_int4", "gguf_q4k"])
    p.add_argument("--enable-prefix-cache", action="store_true", default=None)
    p.add_argument("--no-prefix-cache", dest="enable_prefix_cache",
                   action="store_false")
    p.add_argument("--scheduler", default=None,
                   choices=["continuous", "fifo", "priority"])
    p.add_argument("--prefill-chunk", type=int, default=None)
    p.add_argument("--decode-multi-step", type=int, default=None)
    p.add_argument("--tp", type=int, default=None, dest="tensor_parallel")
    p.add_argument("--spec-draft", default=None, dest="spec_draft_model",
                   help="draft model for speculative decoding "
                        "(checkpoint dir or random:<preset>)")
    p.add_argument("--spec-k", type=int, default=None,
                   dest="spec_num_tokens",
                   help="speculative draft length (tokens per round)")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--config", default="ferrum.toml",
                   help="ferrum.toml path (CLI > env > file precedence)")
    # The profile sink (utils/profile.py, schema v2).
    p.add_argument("--profile-jsonl", default=None, dest="profile_path",
                   help="write sampled profile events (JSONL, schema v2)")
    p.add_argument("--profile-detail", default=None,
                   choices=["off", "basic", "debug", "full"])
    p.add_argument("--profile-sample-rate", type=float, default=None)
    p.add_argument("--memory-profile-jsonl", default=None,
                   dest="memory_profile_path",
                   help="separate sink for periodic memory snapshots")


def _build_engine(args) -> Any:
    from .engine.builder import EngineBuilder

    overrides: Dict[str, Any] = {
        "model": args.model,
        "device": args.device,
        "max_num_seqs": args.max_num_seqs,
        "max_num_batched_tokens": args.max_num_batched_tokens,
        "max_model_len": args.max_model_len,
        "kv_num_blocks": args.kv_capacity,
        "kv_block_size": args.kv_block_size,
        "kv_dtype": args.kv_dtype,
        "kv_layout": args.kv_layout,
        "quantization": args.quantization,
        "enable_prefix_cache": args.enable_prefix_cache,
        "scheduler": args.scheduler,
        "prefill_chunk_size": args.prefill_chunk,
        "decode_multi_step": args.decode_multi_step,
        "tensor_parallel": args.tensor_parallel,
        "spec_draft_model": args.spec_draft_model,
        "spec_num_tokens": args.spec_num_tokens,
        "seed": args.seed,
        "profile_path": args.profile_path,
        "profile_detail": args.profile_detail,
        "profile_sample_rate": args.profile_sample_rate,
        "memory_profile_path": args.memory_profile_path,
    }
    # Base layer (lowest precedence), as the JAX CLI's: the layout
    # "auto", which the builder resolves (engine/builder.py).
    cfg = EngineConfig.resolve(cli_overrides=overrides,
                               toml_path=args.config, kv_layout="auto")
    return EngineBuilder(cfg).build()


def cmd_run(args) -> int:
    """One-shot generation (`--prompt`) or the REPL, through the model's
    chat template."""
    engine = _build_engine(args)
    from .server.chat_template import ChatTemplateRenderer

    renderer = ChatTemplateRenderer(
        template=getattr(engine.tokenizer, "chat_template", None),
        family=engine.runner.model_cfg.family)
    sampling = SamplingParams(temperature=args.temperature,
                              top_p=args.top_p, max_tokens=args.max_tokens)

    def generate(messages):
        prompt = renderer.render(messages)
        req = InferenceRequest(
            prompt_token_ids=engine.tokenizer.encode(prompt),
            sampling=SamplingParams(**sampling.__dict__))
        t0 = time.monotonic()
        n_tok = 0
        out = []
        for chunk in engine.infer_stream(req):
            if chunk.text:
                if not args.json:
                    print(chunk.text, end="", flush=True)
                out.append(chunk.text)
            n_tok = chunk.completion_tokens
        dt = time.monotonic() - t0
        print("", flush=True)
        print(f"[{n_tok} tokens, {n_tok / max(dt, 1e-9):.1f} tok/s]",
              file=sys.stderr)
        return "".join(out)

    try:
        if args.prompt is not None:  # one-shot
            msgs = []
            if args.system:
                msgs.append({"role": "system", "content": args.system})
            msgs.append({"role": "user", "content": args.prompt})
            text = generate(msgs)
            if args.json:
                print(json.dumps({"response": text}))
            return 0

        history = []
        system = args.system
        print("ferrum-tpu REPL — /exit, /clear, /system <msg>",
              file=sys.stderr)
        while True:
            try:
                line = input(">>> ")
            except (EOFError, KeyboardInterrupt):
                return 0
            if line.strip() == "/exit":
                return 0
            if line.strip() == "/clear":
                history.clear()
                continue
            if line.startswith("/system"):
                system = line[len("/system"):].strip()
                continue
            history.append({"role": "user", "content": line})
            msgs = ([{"role": "system", "content": system}] if system
                    else []) + history
            reply = generate(msgs)
            history.append({"role": "assistant", "content": reply})
    finally:
        engine.stop()


def cmd_serve(args) -> int:
    for flag, value in (("--asr-model", args.asr_model),
                        ("--tts-model", args.tts_model),
                        ("--embed-model", args.embed_model)):
        if value:
            raise InvalidRequestError(
                f"{flag} is not yet ported (ROADMAP Queue 1 item 14)",
                param=flag)
    engine = _build_engine(args)
    from .server.app import serve

    def announce(port):
        print(f"serving {args.model} on http://{args.host}:{port}",
              file=sys.stderr, flush=True)

    try:
        serve(engine, model_name=args.served_model_name or args.model,
              host=args.host, port=args.port, api_key=args.api_key,
              on_start=announce)
    finally:
        engine.stop()
    return 0


def cmd_bench_serve(args) -> int:
    from .bench.bench_serve import run_bench_serve

    report = run_bench_serve(
        base_url=args.base_url, model=args.model,
        concurrencies=tuple(int(c) for c in args.concurrency.split(",")),
        num_requests=args.num_requests, input_len=args.input_len,
        output_len=args.output_len, n_repeats=args.n_repeats)
    out = json.dumps(report, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
    print(out)
    return 0


def cmd_replay(args) -> int:
    """Re-run a captured request bundle and compare its tokens with the
    observed ones (exit 2 on a mismatch)."""
    from .utils.replay import replay_bundle

    engine = _build_engine(args)
    try:
        record = replay_bundle(args.bundle, engine)
        print(json.dumps(record, indent=2))
        return 0 if record["matches_observed"] else 2
    finally:
        engine.stop()


def cmd_bench(args) -> int:
    engine = _build_engine(args)
    from .bench.bench_engine import run_bench, run_cell_open_loop

    try:
        if args.open_loop_rps:
            report = run_cell_open_loop(
                engine, rate_rps=args.open_loop_rps,
                duration_s=args.duration, input_len=args.input_len,
                output_len=args.output_len)
        else:
            concs = tuple(int(c) for c in args.concurrency.split(","))
            report = run_bench(
                engine, concurrencies=concs,
                num_requests_per_cell={c: args.num_requests for c in concs},
                input_len=args.input_len, output_len=args.output_len,
                model_label=args.model)
    finally:
        engine.stop()
    out = json.dumps(report, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
    print(out)
    return 0


# The JAX CLI's listed presets; the port has those in models/configs.py.
LISTED = ("llama-3.1-8b", "qwen3-0.6b", "qwen3-4b", "qwen3-8b",
          "qwen3-30b-a3b")
PORT_EXTRA = ("qwen3-15b-a3b", "tiny-quant", "tiny-test")


def cmd_list(args) -> int:
    from .models.configs import preset

    print(f"{'PRESET':24} {'FAMILY':10} {'SHAPE':14} KIND")
    missing = []
    for n in LISTED + PORT_EXTRA:
        try:
            c = preset(n)
        except ValueError:
            missing.append(n)
            continue
        print(f"{n:24} {c.family:10} {f'{c.num_layers}L/{c.hidden_size}H':14} "
              f"{'moe' if c.moe else 'dense'}")
    if missing:
        print("\nnot yet ported:", ", ".join(missing))
    cache = os.path.expanduser(os.environ.get(
        "FERRUM_MODELS_DIR", "~/.cache/ferrum-tpu/models"))
    if os.path.isdir(cache):
        local = [d for d in sorted(os.listdir(cache))
                 if os.path.isdir(os.path.join(cache, d))]
        if local:
            print("\nlocal checkpoints under", cache)
            for d in local:
                print(" ", d)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="ferrum-tpu-torch")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run", help="interactive chat / one-shot generation")
    _add_engine_flags(p)
    p.add_argument("--prompt", default=None)
    p.add_argument("--system", default=None)
    p.add_argument("--temperature", type=float, default=0.7)
    p.add_argument("--top-p", type=float, default=0.95)
    p.add_argument("--max-tokens", type=int, default=512)
    p.add_argument("--json", action="store_true")
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("serve", help="OpenAI-compatible HTTP server")
    _add_engine_flags(p)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000,
                   help="0 binds a free port (printed on stderr)")
    p.add_argument("--api-key", default=None)
    p.add_argument("--served-model-name", default=None)
    p.add_argument("--asr-model", default=None, help="not yet ported")
    p.add_argument("--tts-model", default=None, help="not yet ported")
    p.add_argument("--embed-model", default=None, help="not yet ported")
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("bench", help="offline engine benchmark")
    _add_engine_flags(p)
    p.add_argument("--concurrency", default="1,4,16,32")
    p.add_argument("--num-requests", type=int, default=64)
    p.add_argument("--input-len", type=int, default=256)
    p.add_argument("--output-len", type=int, default=128)
    p.add_argument("--output", default=None)
    p.add_argument("--open-loop-rps", type=float, default=None,
                   help="Poisson arrival rate (req/s): open-loop mode")
    p.add_argument("--duration", type=float, default=30.0,
                   help="open-loop launch window in seconds")
    p.set_defaults(fn=cmd_bench)

    p = sub.add_parser(
        "bench-serve", help="HTTP serving benchmark against a server")
    p.add_argument("--base-url", default="http://127.0.0.1:8000")
    p.add_argument("--model", default="default")
    p.add_argument("--concurrency", default="1,4,16,32")
    p.add_argument("--num-requests", type=int, default=64)
    p.add_argument("--input-len", type=int, default=256)
    p.add_argument("--output-len", type=int, default=128)
    p.add_argument("--n-repeats", type=int, default=1)
    p.add_argument("--output", default=None)
    p.set_defaults(fn=cmd_bench_serve)

    p = sub.add_parser("list", help="list model presets")
    p.set_defaults(fn=cmd_list)

    p = sub.add_parser(
        "replay", help="re-run a captured request bundle (repro gate)")
    _add_engine_flags(p)
    p.add_argument("--bundle", required=True, help="bundle JSON path")
    p.set_defaults(fn=cmd_replay)

    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    except FerrumError as e:
        print(f"error: {e.message}", file=sys.stderr)
        return 1
