"""The port's CLI (`python -m ferrum_tpu_torch`) on the CPU.

Run as a subprocess the way tests/test_cli.py runs the JAX CLI, with a
`-c` prelude that fails if `jax` was ever imported: `bench` with
tests/test_cli.py's flags, `list`, `replay` (its tokens equal the JAX
CLI's replay of the same bundle: `random:tiny-test` gives both packages
the same weights), and an unported flag or FERRUM_* value ending in
exit code 1 with `error:` on stderr. Also `EngineConfig.resolve`'s
precedence, CLI > env > file > base.
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Both CLIs serve random:tiny-test in f32 (FERRUM_DTYPE), so their greedy
# tokens are compared without bf16 rounding in the way.
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "FERRUM_DTYPE": "f32"}
SMALL = ["--max-model-len", "256", "--max-num-seqs", "2"]


def run_cli(*args, env=None, timeout=180):
    """The port's CLI in a fresh interpreter; fails if jax is imported."""
    code = ("import sys\n"
            "from ferrum_tpu_torch.cli import main\n"
            f"rc = main({list(args)!r})\n"
            "assert 'jax' not in sys.modules, 'the port imported jax'\n"
            "sys.exit(rc)\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, env=env or ENV,
                          cwd=REPO)


def run_jax_cli(*args, timeout=300):
    return subprocess.run(
        [sys.executable, "-c",
         "import jax; jax.config.update('jax_platforms','cpu');"
         "from ferrum_tpu.cli import main; import sys;"
         f"sys.exit(main({list(args)!r}))"],
        capture_output=True, text=True, timeout=timeout, env=ENV, cwd=REPO)


def test_bench_offline():
    r = run_cli("bench", "random:tiny-test", "--device", "cpu",
                "--concurrency", "2", "--num-requests", "4",
                "--input-len", "8", "--output-len", "4",
                "--max-model-len", "256", "--max-num-seqs", "2")
    assert r.returncode == 0, r.stderr[-2000:]
    rep = json.loads(r.stdout[r.stdout.index("{"):])
    assert rep["schema"] == "ferrum-tpu-bench/v1"
    cell = rep["cells"][0]
    assert cell["completed"] == 4 and cell["errors"] == 0
    assert cell["compilations_during_cell"] == 0, cell["compiled_in_cell"]


def test_list():
    r = run_cli("list")
    assert r.returncode == 0, r.stderr
    assert "llama-3.1-8b" in r.stdout and "qwen3-30b-a3b" in r.stdout
    # Every preset the JAX CLI lists is ported.
    for name in ("qwen3-0.6b", "qwen3-4b", "qwen3-8b"):
        assert name in r.stdout
    assert "not yet ported" not in r.stdout


def test_replay_matches_the_jax_cli(tmp_path):
    """A bundle captured without observed tokens replays through both
    CLIs to the same tokens; with those tokens as observed the port's
    replay matches (exit 0), with them corrupted it reports the
    mismatch (exit 2)."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams
    from ferrum_tpu_torch.utils.replay import capture_bundle, save_bundle

    req = InferenceRequest(prompt="replay me", request_id="r1",
                           sampling=SamplingParams(max_tokens=6))
    bundle = capture_bundle(req, EngineConfig(model="random:tiny-test"),
                            "random:tiny-test")
    path = str(tmp_path / "bundle.json")
    save_bundle(bundle, path)
    flags = ["--bundle", path, *SMALL]
    ref = run_jax_cli("replay", "random:tiny-test", *flags)
    assert ref.returncode == 0, ref.stderr[-2000:]
    r = run_cli("replay", "random:tiny-test", "--device", "cpu", *flags)
    assert r.returncode == 0, r.stderr[-2000:]
    toks = json.loads(r.stdout)["token_ids"]
    assert len(toks) == 6 and toks == json.loads(ref.stdout)["token_ids"]
    bundle["observed"]["response_token_ids"] = toks
    save_bundle(bundle, path)
    r = run_cli("replay", "random:tiny-test", "--device", "cpu", *flags)
    assert r.returncode == 0 and json.loads(r.stdout)["matches_observed"]
    bundle["observed"]["response_token_ids"] = [t + 1 for t in toks]
    save_bundle(bundle, path)
    r = run_cli("replay", "random:tiny-test", "--device", "cpu", *flags)
    assert r.returncode == 2, r.stdout + r.stderr


def test_unported_flag_exits_1_in_a_subprocess():
    r = run_cli("bench", "random:tiny-test", "--device", "cpu",
                "--tp", "2", *SMALL)
    assert r.returncode == 1, r.stdout + r.stderr
    assert "error:" in r.stderr and "tensor_parallel" in r.stderr \
        and "not yet ported" in r.stderr


# The KV layout, KV dtype, capacity and prefix-cache settings are ported:
# each flag or FERRUM_* value reaches the port's EngineConfig as the JAX
# CLI's resolve sets it (CLI > env > file > the CLI's base of "auto").
KV_FIELDS = ("kv_layout", "kv_dtype", "kv_num_blocks", "enable_prefix_cache",
             "prefix_cache_policy", "prefix_cache_blocks")


class _Built(Exception):
    """Raised by a stubbed EngineBuilder.build with the config it got."""


def _resolved_cfg(monkeypatch, builder_mod, main_or_build, argv):
    def build(self):
        raise _Built(self.cfg)

    monkeypatch.setattr(builder_mod.EngineBuilder, "build", build)
    with pytest.raises(_Built) as got:
        main_or_build(argv)
    return got.value.args[0]


@pytest.mark.parametrize("flags,env", [
    (["--kv-layout", "paged"], {}),
    (["--kv-dtype", "int8"], {}),
    ([], {"FERRUM_KV_DTYPE": "int8"}),
    ([], {"FERRUM_KV_LAYOUT": "paged"}),
    (["--kv-capacity", "64"], {}),
    ([], {"FERRUM_KV_MAX_BLOCKS": "64"}),
    (["--enable-prefix-cache"], {"FERRUM_ENABLE_PREFIX_CACHE": "0"}),
    (["--no-prefix-cache"], {"FERRUM_PREFIX_CACHE_POLICY": "clock",
                             "FERRUM_PREFIX_CACHE_BLOCKS": "0"}),
    (["--kv-layout", "linear"], {"FERRUM_KV_LAYOUT": "paged",
                                 "FERRUM_KV_DTYPE": "f32"}),
])
def test_kv_settings_reach_the_config(monkeypatch, tmp_path, flags, env):
    import argparse

    from ferrum_tpu import cli as jax_cli
    from ferrum_tpu.engine import builder as jax_builder
    from ferrum_tpu_torch import cli
    from ferrum_tpu_torch.engine import builder

    for k in [k for k in os.environ if k.startswith("FERRUM_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = ["random:tiny-test", "--config", str(tmp_path / "none.toml"),
            *SMALL, *flags]
    mine = _resolved_cfg(monkeypatch, builder, cli.main,
                         ["bench", "--device", "cpu", *argv])

    def jax_build(a):
        p = argparse.ArgumentParser()
        jax_cli._add_engine_flags(p)
        return jax_cli._build_engine(p.parse_args(a))

    ref = _resolved_cfg(monkeypatch, jax_builder, jax_build, argv)
    for name in KV_FIELDS:
        assert getattr(mine, name) == getattr(ref, name), name
    assert mine.kv_layout in ("auto", "linear", "paged")


@pytest.mark.parametrize("flags,env,field", [
    (["--tp", "2"], {}, "tensor_parallel"),
    (["--quantization", "gguf_q4k"], {}, "quantization"),
    ([], {"FERRUM_QUANT": "gguf_q4k"}, "quantization"),
    ([], {"FERRUM_GDN_CHUNKED": "0"}, "gdn_chunk_block"),
    ([], {"FERRUM_DP": "2"}, "data_parallel"),
])
def test_unported_settings_exit_1(monkeypatch, capsys, tmp_path, flags, env,
                                  field):
    """Each unported flag or FERRUM_* value: exit code 1 and `error:`
    naming the field, before any engine is built."""
    from ferrum_tpu_torch.cli import main

    for k, v in env.items():
        monkeypatch.setenv(k, v)
    rc = main(["bench", "random:tiny-test", "--device", "cpu", "--config",
               str(tmp_path / "none.toml"), *SMALL, *flags])
    err = capsys.readouterr().err
    assert rc == 1 and err.startswith("error:") and field in err, err
    assert "not yet ported" in err


# The engine settings ported since (scheduler policies, the trace,
# adaptive windows, slack lanes, the squeeze, fusion, unchunked prefill):
# each flag or FERRUM_* value resolves to the JAX CLI's value.
@pytest.mark.parametrize("flags,env,field", [
    (["--scheduler", "priority"], {}, "scheduler"),
    (["--scheduler", "fifo"], {}, "scheduler"),
    ([], {"FERRUM_SCHEDULER_TRACE_JSONL": "trace.jsonl"},
     "scheduler_trace_path"),
    ([], {"FERRUM_ADAPTIVE_WINDOWS": "0"}, "adaptive_windows"),
    ([], {"FERRUM_SLOT_SLACK": "2"}, "slot_slack"),
    ([], {"FERRUM_SQUEEZE_EMBED": "1"}, "squeeze_embeddings"),
    ([], {"FERRUM_FUSE_PROJ": "0"}, "fuse_proj"),
    ([], {"FERRUM_FUSE_SITES": "qkv,gate_up,moe"}, "fuse_sites"),
    ([], {"FERRUM_ENABLE_CHUNKED_PREFILL": "0"}, "enable_chunked_prefill"),
    ([], {"FERRUM_PREFIX_OFFLOAD_MB": "64"}, "prefix_offload_mb"),
    ([], {"FERRUM_PREFIX_OFFLOAD_ALGO": "int4"}, "prefix_offload_algo"),
])
def test_ported_settings_resolve_as_jax(monkeypatch, tmp_path, flags, env,
                                        field):
    import argparse

    from ferrum_tpu import cli as jax_cli
    from ferrum_tpu.engine import builder as jax_builder
    from ferrum_tpu_torch import cli
    from ferrum_tpu_torch.engine import builder

    for k in [k for k in os.environ if k.startswith("FERRUM_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    argv = ["random:tiny-test", "--config", str(tmp_path / "none.toml"),
            *SMALL, *flags]
    mine = _resolved_cfg(monkeypatch, builder, cli.main,
                         ["bench", "--device", "cpu", *argv])

    def jax_build(a):
        p = argparse.ArgumentParser()
        jax_cli._add_engine_flags(p)
        return jax_cli._build_engine(p.parse_args(a))

    ref = _resolved_cfg(monkeypatch, jax_builder, jax_build, argv)
    assert getattr(mine, field) == getattr(ref, field)
    assert getattr(mine, field) != getattr(type(mine)(), field)


def test_unknown_model_source_exits_1(capsys, tmp_path):
    from ferrum_tpu_torch.cli import main

    # A preset of the JAX package's the port lacks (qwen3_next: ROADMAP
    # Queue 1 item 11), an empty directory, a hub id.
    for src in ("random:qwen3-next-80b-a3b", str(tmp_path), "hf-org/model"):
        rc = main(["bench", src, "--device", "cpu", *SMALL])
        assert rc == 1 and capsys.readouterr().err.startswith("error:")


def test_resolve_precedence(tmp_path):
    """CLI > env > file > base on the port's fields; the fields the port
    fixes pass at their fixed value and raise at any other."""
    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.types import InvalidRequestError

    toml = tmp_path / "ferrum.toml"
    toml.write_text("[runtime]\nmax_num_seqs = 6\nmax_model_len = 512\n"
                    "decode_multi_step = 4\nkv_layout = 'linear'\n"
                    "unknown_key = 1\n")
    env = {"FERRUM_MAX_MODEL_LEN": "1024", "FERRUM_DECODE_MULTI_STEP": "2",
           "FERRUM_SEED": "9", "OTHER": "x"}
    cfg = EngineConfig.resolve(
        cli_overrides={"decode_multi_step": 3, "seed": None},
        environ=env, toml_path=str(toml), max_num_seqs=5, max_model_len=64,
        prefill_chunk_size=256, kv_layout="auto")
    assert cfg.max_num_seqs == 6            # file over base
    assert cfg.max_model_len == 1024        # env over file
    assert cfg.decode_multi_step == 3       # CLI over env
    assert cfg.seed == 9                    # an unset CLI value is no layer
    assert cfg.prefill_chunk_size == 256    # base
    base = EngineConfig.resolve(environ={}, toml_path=None)
    assert base == EngineConfig()
    with pytest.raises(InvalidRequestError, match="not yet ported"):
        EngineConfig.resolve(environ={"FERRUM_TP": "2"})
    with pytest.raises(InvalidRequestError, match="unknown config field"):
        EngineConfig.resolve(environ={}, bogus=1)


def _checkpoint(tmp_path, name):
    from test_torch_loader import make_dir
    from test_torch_tokenizer import write_tokenizer_dir

    d = make_dir(tmp_path, name)
    write_tokenizer_dir(d, "qwen2", eos=[5, 6])
    return d


def test_bench_serves_a_checkpoint_directory(tmp_path):
    """`bench <dir> --device cpu` on a tiny GPTQ checkpoint with its
    tokenizer.json, in a process that never imports jax."""
    d = _checkpoint(tmp_path, "qwen3_gptq_tied")
    r = run_cli("bench", d, "--device", "cpu", "--concurrency", "2",
                "--num-requests", "2", "--input-len", "8",
                "--output-len", "4", *SMALL)
    assert r.returncode == 0, r.stderr[-2000:]
    rep = json.loads(r.stdout[r.stdout.index("{"):])
    cell = rep["cells"][0]
    assert cell["completed"] == 2 and cell["errors"] == 0
    assert rep["model"] == d


@pytest.mark.parametrize("quant", ["gptq_int4", None])
def test_quantization_flag_quantizes_a_dense_directory(monkeypatch, tmp_path,
                                                       quant):
    """`--quantization gptq_int4` on a dense directory quantizes it on
    load (int4 g128, as the JAX CLI's); without it the linears stay
    dense. The flag and FERRUM_QUANT both reach the config."""
    from ferrum_tpu_torch import cli
    from ferrum_tpu_torch.engine import builder
    from ferrum_tpu_torch.ops.linear import DenseLinearParams
    from ferrum_tpu_torch.ops.quant import QuantLinearParams

    d = _checkpoint(tmp_path, "llama_dense_quantize_on_load")
    built = {}
    build = builder.EngineBuilder.build

    def keep(self):
        built["engine"] = build(self)
        return built["engine"]

    monkeypatch.setattr(builder.EngineBuilder, "build", keep)
    monkeypatch.setattr(cli, "cmd_bench", lambda args: (
        cli._build_engine(args).stop(), 0)[1])
    flags = ["--quantization", quant] if quant else []
    assert cli.main(["bench", d, "--device", "cpu", "--config",
                     str(tmp_path / "none.toml"), *SMALL, *flags]) == 0
    engine = built["engine"]
    qkv = engine.runner.params.layers[0].qkv
    want = QuantLinearParams if quant else DenseLinearParams
    assert isinstance(qkv, want)
    assert engine.cfg.quantization == (quant or "none")
    if quant:
        monkeypatch.setenv("FERRUM_QUANT", quant)
        assert cli.main(["bench", d, "--device", "cpu", "--config",
                         str(tmp_path / "none.toml"), *SMALL]) == 0
        assert isinstance(built["engine"].runner.params.layers[0].qkv,
                          QuantLinearParams)
