"""The port's OpenAI-compatible server against the JAX package's.

Both servers run in this process on tiny engines with the same weights
(the JAX tiny-test engine of tests/test_engine_e2e.py: qwen3 family,
byte tokenizer, paged KV with the prefix cache; the JAX engine with
adaptive windows off, which the port has not yet), each bound to port
0. Every request of tests/test_server.py and tests/test_logprobs_server.py
that needs no modality engine, and more of the same contract, goes to
both over stdlib `http.client`:

  * "exact": the same status and JSON body (ids, `created` masked;
    logprobs within 5e-3) or the same SSE event sequence;
  * "sampled": a request at the default temperature 1.0, whose text
    comes from each package's own random stream: the same status and
    body with the text, completion counts and finish reason masked,
    and the SSE events without their text deltas; each such case also
    runs at temperature 0 as an "exact" one;
  * "param": a rejection whose message text differs (pydantic's): the
    same status, type and param.

The guided requests (response_format json_object and strict
json_schema, guided_regex / guided_json / guided_choice,
tool_choice="required"), greedy, streaming and not: the same status
and body. Also: the
port's request validators against the JAX package's pydantic models on
field values of every JSON type, the accuracy HTTP helpers, bench-serve,
the CLI's run / serve / bench-serve, and a fresh interpreter's imports.
Every HTTP call and subprocess has its own timeout; every server and
engine stops in a finally.
"""

import asyncio
import http.client
import json
import math
import os
import subprocess
import sys
import threading
import time

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 60
ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "FERRUM_DTYPE": "f32"}
CHAT = "/v1/chat/completions"
CMPL = "/v1/completions"


# ---------------------------------------------------------------------------
# Engines and servers
# ---------------------------------------------------------------------------

def _engine_kw():
    return dict(max_num_seqs=4, kv_num_blocks=64, kv_block_size=8,
                max_model_len=256, max_num_batched_tokens=128,
                prefill_chunk_size=32, enable_prefix_cache=True,
                dtype="f32", kv_dtype="f32", seed=0, kv_layout="paged")


def _model():
    import jax.numpy as jnp

    from ferrum_tpu.models.configs import ModelConfig
    from ferrum_tpu.models.llama_family import init_random_params

    mc = ModelConfig(
        family="qwen3", vocab_size=512, hidden_size=64, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=16, intermediate_size=128,
        qk_norm=True, tie_word_embeddings=True, rope_theta=10000.0,
        eos_token_ids=(257,))
    return mc, init_random_params(mc, seed=0, dtype=jnp.float32)


def _jax_engine(mc, params):
    from ferrum_tpu.config import EngineConfig
    from ferrum_tpu.engine.builder import EngineBuilder
    from ferrum_tpu.tokenizer import make_byte_tokenizer

    cfg = EngineConfig(model="test", adaptive_windows=False, **_engine_kw())
    return EngineBuilder(cfg).with_model(mc, params).with_tokenizer(
        make_byte_tokenizer(vocab_extra=512 - 258)).build()


def _torch_engine(mc, params):
    from torch_parity import flatten_jax_params, torch_config

    from ferrum_tpu_torch.config import EngineConfig
    from ferrum_tpu_torch.engine.builder import EngineBuilder
    from ferrum_tpu_torch.models.convert import params_from_numpy
    from ferrum_tpu_torch.tokenizer import make_byte_tokenizer

    cfg = EngineConfig(model="test", device="cpu", **_engine_kw())
    return EngineBuilder(cfg).with_model(
        torch_config(mc), params_from_numpy(flatten_jax_params(params),
                                            "cpu")).with_tokenizer(
        make_byte_tokenizer(vocab_extra=512 - 258)).build()


class JaxServer:
    """The JAX FerrumServer on aiohttp in a thread, on a free port."""

    def __init__(self, engine, **kw):
        from aiohttp import web

        from ferrum_tpu.server.app import FerrumServer

        self.loop = asyncio.new_event_loop()
        ready = threading.Event()

        def run():
            asyncio.set_event_loop(self.loop)
            app = FerrumServer(engine, model_name="tiny-test", **kw)
            self.runner = web.AppRunner(app.make_app())
            self.loop.run_until_complete(self.runner.setup())
            site = web.TCPSite(self.runner, "127.0.0.1", 0)
            self.loop.run_until_complete(site.start())
            self.port = site._server.sockets[0].getsockname()[1]
            ready.set()
            self.loop.run_forever()
            self.loop.run_until_complete(self.runner.cleanup())

        self.thread = threading.Thread(target=run, daemon=True)
        self.thread.start()
        assert ready.wait(TIMEOUT)

    def stop(self):
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(TIMEOUT)


class PortServer:
    def __init__(self, engine, **kw):
        from ferrum_tpu_torch.server.app import FerrumServer

        self.app = FerrumServer(engine, model_name="tiny-test", **kw)
        self.thread = self.app.start()
        self.port = self.thread.port

    def stop(self):
        self.thread.stop(TIMEOUT)


@pytest.fixture(scope="module")
def pair():
    """(jax server, port server) on engines with the same weights."""
    mc, params = _model()
    engines, servers = [], []
    try:
        engines.append(_jax_engine(mc, params))
        engines.append(_torch_engine(mc, params))
        servers.append(JaxServer(engines[0]))
        servers.append(PortServer(engines[1]))
        yield servers
    finally:
        for s in servers:
            s.stop()
        for e in engines:
            e.stop()


# ---------------------------------------------------------------------------
# Client and comparison
# ---------------------------------------------------------------------------

def call(port, method, path, body=None, headers=None, raw=None):
    """(status, content type, parsed body): JSON, the SSE events (dicts
    and "DONE"), or text."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=TIMEOUT)
    try:
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        conn.request(method, path, body=data, headers=hdrs)
        resp = conn.getresponse()
        payload = resp.read()
        ctype = resp.getheader("Content-Type", "")
    finally:
        conn.close()
    if ctype.startswith("text/event-stream"):
        events = []
        for line in payload.decode().split("\n"):
            if line.startswith("data:"):
                p = line[5:].strip()
                events.append("DONE" if p == "[DONE]" else json.loads(p))
        return resp.status, "sse", events
    if ctype.startswith("application/json"):
        return resp.status, "json", json.loads(payload)
    return resp.status, "text", payload.decode()


_IDS = ("chatcmpl-", "cmpl-", "call_")


def norm(obj):
    """Mask response ids and `created`."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k == "created" or (k == "id" and isinstance(v, str)
                                  and v.startswith(_IDS)):
                out[k] = "<masked>"
            else:
                out[k] = norm(v)
        return out
    if isinstance(obj, list):
        return [norm(v) for v in obj]
    return obj


def assert_same(got, want, path="$", tol=5e-3):
    """Equal after norm(); floats (logprobs) within tol."""
    if isinstance(want, float) and isinstance(got, float):
        assert math.isclose(got, want, abs_tol=tol), (path, got, want)
        return
    assert type(got) is type(want), (path, got, want)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            assert_same(got[k], want[k], f"{path}.{k}", tol)
    elif isinstance(want, list):
        assert len(got) == len(want), (path, got, want)
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]", tol)
    else:
        assert got == want, (path, got, want)


_SAMPLED_KEYS = {"content", "text", "completion_tokens", "total_tokens",
                 "finish_reason"}


def mask_sampled(obj):
    if isinstance(obj, dict):
        return {k: "<sampled>" if k in _SAMPLED_KEYS else mask_sampled(v)
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [mask_sampled(v) for v in obj]
    return obj


def _has_text(ev):
    if not isinstance(ev, dict) or not ev.get("choices"):
        return False
    ch = ev["choices"][0]
    return bool(ch.get("text") or (ch.get("delta") or {}).get("content"))


def compare(pair, mode, method, path, body=None, headers=None, raw=None):
    """Send one request to both servers and compare as `mode` says;
    returns the port's (status, kind, body)."""
    jax_srv, port_srv = pair
    want = call(jax_srv.port, method, path, body, headers, raw)
    got = call(port_srv.port, method, path, body, headers, raw)
    assert got[:2] == want[:2], (got, want)
    if mode == "exact":
        assert_same(norm(got[2]), norm(want[2]))
    elif mode == "sampled":
        g, w = got[2], want[2]
        if got[1] == "sse":
            g = [e for e in g if not _has_text(e)]
            w = [e for e in w if not _has_text(e)]
        assert_same(mask_sampled(norm(g)), mask_sampled(norm(w)))
    elif mode == "param":
        for key in ("type", "param", "code"):
            assert got[2]["error"][key] == want[2]["error"][key], key
    else:
        raise ValueError(mode)
    return got


def chat_body(**kw):
    body = {"model": "tiny-test",
            "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 6}
    body.update(kw)
    return body


def cmpl_body(**kw):
    body = {"model": "t", "prompt": "hello", "max_tokens": 4}
    body.update(kw)
    return body


TOOLS = [{"type": "function", "function": {
    "name": "weather", "parameters": {"type": "object", "properties": {
        "city": {"type": "string"}}}}}]

# (id, mode, path, body): the cases of tests/test_server.py and
# tests/test_logprobs_server.py without guided decoding or a modality
# engine, their greedy twins, and more of the same contract.
CASES = [
    ("chat_basic", "sampled", CHAT, chat_body()),
    ("chat_basic_greedy", "exact", CHAT, chat_body(temperature=0.0)),
    ("chat_stream_usage", "sampled", CHAT, chat_body(
        stream=True, stream_options={"include_usage": True})),
    ("chat_stream_usage_greedy", "exact", CHAT, chat_body(
        stream=True, stream_options={"include_usage": True},
        temperature=0.0)),
    ("chat_determinism", "exact", CHAT, chat_body(
        messages=[{"role": "user", "content": "determinism check"}],
        temperature=0.0)),
    ("chat_determinism_stream", "exact", CHAT, chat_body(
        messages=[{"role": "user", "content": "determinism check"}],
        temperature=0.0, stream=True)),
    ("reject_n", "exact", CHAT, chat_body(n=2)),
    ("reject_logit_bias", "exact", CHAT, chat_body(logit_bias={"5": 1.0})),
    ("reject_logprobs", "exact", CHAT, chat_body(logprobs=True)),
    ("reject_top_logprobs", "exact", CHAT, chat_body(top_logprobs=3)),
    ("reject_stream_options", "exact", CHAT, chat_body(
        stream_options={"include_usage": True})),
    ("reject_tools", "exact", CHAT, chat_body(tools=[{"type": "retrieval"}])),
    ("reject_tool_choice", "exact", CHAT, chat_body(tool_choice="banana")),
    ("reject_response_format", "exact", CHAT, chat_body(
        response_format={"type": "yaml"})),
    ("reject_enable_thinking", "exact", CHAT, chat_body(
        chat_template_kwargs={"enable_thinking": "yes"})),
    ("reject_multimodal", "exact", CHAT, chat_body(messages=[
        {"role": "user", "content": [
            {"type": "image_url", "image_url": {"url": "http://x"}}]}])),
    ("reject_undeclared_tool", "exact", CHAT, chat_body(
        tools=TOOLS,
        tool_choice={"type": "function", "function": {"name": "other"}})),
    ("reject_undeclared_function", "exact", CHAT, chat_body(
        functions=[{"name": "f"}], function_call={"name": "g"})),
    ("reject_role", "exact", CHAT, chat_body(
        messages=[{"role": "robot", "content": "x"}])),
    ("reject_strict_schema", "param", CHAT, chat_body(response_format={
        "type": "json_schema", "json_schema": {"strict": True, "schema": {
            "type": "object", "properties": {"x": {"type": "object"}}}}})),
    ("reject_schema_missing", "exact", CHAT, chat_body(
        response_format={"type": "json_schema"})),
    ("reject_required_without_tools", "exact", CHAT, chat_body(
        tool_choice="required")),
    ("reject_temperature", "exact", CHAT, chat_body(temperature=-1)),
    ("reject_top_p", "exact", CHAT, chat_body(top_p=0)),
    ("reject_model_type", "param", CHAT, chat_body(model=5)),
    ("reject_model_missing", "param", CHAT,
     {"messages": [{"role": "user", "content": "x"}]}),
    ("reject_messages_type", "param", CHAT, chat_body(messages="hi")),
    ("reject_max_tokens_float", "param", CHAT, chat_body(max_tokens=2.5)),
    ("reject_stream_type", "param", CHAT, chat_body(stream="maybe")),
    ("reject_body_list", "param", CHAT, [1, 2]),
    ("chat_tools_auto", "exact", CHAT, chat_body(
        tools=TOOLS, temperature=0.0)),
    ("chat_tools_auto_stream", "exact", CHAT, chat_body(
        tools=TOOLS, temperature=0.0, stream=True)),
    ("chat_tools_none", "exact", CHAT, chat_body(
        tools=TOOLS, tool_choice="none", temperature=0.0, stream=True)),
    ("chat_tool_named", "exact", CHAT, chat_body(
        tools=TOOLS, temperature=0.0,
        tool_choice={"type": "function", "function": {"name": "weather"}})),
    ("chat_functions", "exact", CHAT, chat_body(
        functions=[{"name": "weather", "parameters": {}}],
        temperature=0.0)),
    ("chat_history", "exact", CHAT, chat_body(messages=[
        {"role": "system", "content": "be brief"},
        {"role": "user", "content": "ab"},
        {"role": "assistant", "content": "cd",
         "tool_calls": [{"id": "c1", "type": "function", "function": {
             "name": "weather", "arguments": "{}"}}]},
        {"role": "tool", "content": "sunny", "tool_call_id": "c1"},
        {"role": "user", "content": [{"type": "text", "text": "é"},
                                     {"type": "text", "text": "f"}]}],
        temperature=0.0)),
    ("chat_coerced_fields", "exact", CHAT, chat_body(
        max_tokens="3", temperature="0", n=1.0, stream="false",
        ignore_eos=1, top_k="0", extra_field={"kept": True})),
    ("chat_penalty_min_tokens", "exact", CHAT, chat_body(
        temperature=0.0, repetition_penalty=1.3, min_tokens=3,
        max_completion_tokens=5)),
    ("chat_thinking_kwarg", "exact", CHAT, chat_body(
        temperature=0.0, chat_template_kwargs={"enable_thinking": False})),
    ("chat_nonstrict_schema", "exact", CHAT, chat_body(
        temperature=0.0, response_format={
            "type": "json_schema", "json_schema": {"schema": {}}})),
    ("chat_seeded", "sampled", CHAT, chat_body(seed=11, top_k=20)),
    ("chat_prompt_too_long", "exact", CHAT, chat_body(
        messages=[{"role": "user", "content": "x" * 300}])),
    ("cmpl_basic", "sampled", CMPL, cmpl_body()),
    ("cmpl_basic_greedy", "exact", CMPL, cmpl_body(temperature=0)),
    ("cmpl_prompt_array", "exact", CMPL, cmpl_body(prompt=["a", "b"])),
    ("cmpl_stream", "sampled", CMPL, cmpl_body(prompt="st", stream=True)),
    ("cmpl_stream_greedy", "exact", CMPL, cmpl_body(
        prompt="st", stream=True, temperature=0,
        stream_options={"include_usage": True})),
    ("cmpl_guided_conflict", "exact", CMPL, cmpl_body(
        prompt="x", guided_regex="a+", guided_choice=["b"])),
    ("cmpl_logprobs_without_echo", "exact", CMPL, cmpl_body(
        prompt="x", logprobs=1)),
    ("cmpl_echo_with_generation", "exact", CMPL, cmpl_body(
        prompt="x", echo=True, logprobs=1, max_tokens=4)),
    ("cmpl_echo_without_logprobs", "exact", CMPL, cmpl_body(
        prompt="x", echo=True, max_tokens=0)),
    ("cmpl_echo_stream", "exact", CMPL, cmpl_body(
        prompt="x", echo=True, logprobs=1, max_tokens=0, stream=True)),
    ("cmpl_stream_options_without_stream", "exact", CMPL, cmpl_body(
        stream_options={"include_usage": True})),
    ("cmpl_score", "exact", CMPL, cmpl_body(
        prompt="Hello scoring world", max_tokens=0, echo=True, logprobs=1)),
    ("cmpl_score_chunked", "exact", CMPL, cmpl_body(
        prompt="chunked scoring " * 8, max_tokens=0, echo=True,
        logprobs=True)),
    ("cmpl_max_tokens_zero", "sampled", CMPL, cmpl_body(max_tokens=0)),
    ("cmpl_ignore_eos_min", "exact", CMPL, cmpl_body(
        temperature=0, ignore_eos=True, min_tokens=2, max_tokens=9)),
    ("embeddings", "exact", "/v1/embeddings", {"model": "t", "input": "hi"}),
    ("embeddings_base64", "exact", "/v1/embeddings",
     {"model": "t", "input": "x", "encoding_format": "base64"}),
    ("transcriptions", "exact", "/v1/audio/transcriptions", {}),
    ("speech", "exact", "/v1/audio/speech", {"input": "hi"}),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_requests_match_jax_server(pair, case):
    _, mode, path, body = case
    compare(pair, mode, "POST", path, body)


@pytest.mark.parametrize("path", ["/v1/models", "/health", "/"])
def test_get_endpoints_match(pair, path):
    compare(pair, "exact", "GET", path)


def test_metrics_names_match(pair):
    jax_srv, port_srv = pair
    names = []
    for srv in pair:
        status, kind, text = call(srv.port, "GET", "/metrics")
        assert status == 200 and kind == "text"
        names.append([ln.split()[0] for ln in text.splitlines()])
    assert names[0] == names[1]
    assert "ferrum_requests_completed" in names[1]


def test_not_json_and_unknown_routes(pair):
    compare(pair, "exact", "POST", CHAT, raw=b"{not json")
    compare(pair, "exact", "POST", CMPL, raw=b"\xff\xfe")
    jax_srv, port_srv = pair
    for method, path, status in (("GET", "/nope", 404),
                                 ("GET", CHAT, 405),
                                 ("POST", "/health", 405)):
        for srv in pair:
            assert call(srv.port, method, path)[0] == status


def test_session_cache_matches(pair):
    """X-Ferrum-Session: the turn is kept and /metrics counts it."""
    counts = []
    for srv in pair:
        for i in range(2):
            status, _, body = call(
                srv.port, "POST", CHAT, chat_body(temperature=0.0),
                headers={"X-Ferrum-Session": f"sess-{i % 2}"})
            assert status == 200, body
        text = call(srv.port, "GET", "/metrics")[2]
        line = [ln for ln in text.splitlines()
                if ln.startswith("ferrum_session_cache_sessions")][0]
        counts.append(int(line.split()[-1]))
    assert counts[1] == counts[0] >= 2
    # A session's history goes into the next turn's prompt on both.
    compare(pair, "exact", "POST", CHAT, chat_body(temperature=0.0),
            headers={"X-Ferrum-Session": "sess-0"})


def test_stop_strings_match(pair):
    """A stop string taken from the greedy text: both cut there."""
    jax_srv, port_srv = pair
    _, _, full = call(port_srv.port, "POST", CMPL,
                      cmpl_body(prompt="stop here", max_tokens=12,
                                temperature=0, ignore_eos=True))
    text = full["choices"][0]["text"]
    assert len(text) >= 4, text
    for stop in (text[2:4], [text[3], "never"], text[-1]):
        for stream in (False, True):
            compare(pair, "exact", "POST", CMPL, cmpl_body(
                prompt="stop here", max_tokens=12, temperature=0,
                ignore_eos=True, stop=stop, stream=stream))
    compare(pair, "exact", "POST", CHAT, chat_body(
        temperature=0, stop=[text[1]], max_tokens=10))


def test_api_key_matches():
    """A server with an API key: 401 without it on /v1/ paths only."""
    mc, params = _model()
    engines, servers = [], []
    try:
        engines = [_jax_engine(mc, params), _torch_engine(mc, params)]
        servers = [JaxServer(engines[0], api_key="sk-test"),
                   PortServer(engines[1], api_key="sk-test")]
        body = chat_body(temperature=0.0, max_tokens=2)
        compare(servers, "exact", "POST", CHAT, body)
        compare(servers, "exact", "POST", CHAT, body,
                headers={"Authorization": "Bearer wrong"})
        compare(servers, "exact", "POST", CHAT, body,
                headers={"Authorization": "Bearer sk-test"})
        compare(servers, "exact", "GET", "/health")
        compare(servers, "exact", "GET", "/v1/models")
    finally:
        for s in servers:
            s.stop()
        for e in engines:
            e.stop()


STRICT = {"name": "obj", "strict": True, "schema": {
    "type": "object", "properties": {"ok": {"type": "boolean"}},
    "required": ["ok"]}}
GUIDED_CASES = [
    ("cmpl_guided_regex", cmpl_body(guided_regex="(yes|no)")),
    ("cmpl_guided_choice", cmpl_body(guided_choice=["alpha", "beta"],
                                     max_tokens=8)),
    ("cmpl_guided_json_outside_subset", cmpl_body(
        guided_json={"type": "object"})),
    ("chat_json_object", chat_body(response_format={"type": "json_object"})),
    ("chat_strict_schema_outside_subset", chat_body(response_format={
        "type": "json_schema", "json_schema": {
            "strict": True, "schema": {"type": "object"}}})),
    ("chat_tool_choice_required", chat_body(tools=TOOLS,
                                            tool_choice="required")),
    ("cmpl_guided_json", cmpl_body(guided_json=STRICT["schema"],
                                   max_tokens=24)),
    ("chat_strict_schema", chat_body(response_format={
        "type": "json_schema", "json_schema": STRICT}, max_tokens=24)),
    ("chat_strict_schema_cut", chat_body(response_format={
        "type": "json_schema", "json_schema": STRICT}, max_tokens=3)),
    ("chat_loose_schema", chat_body(response_format={
        "type": "json_schema", "json_schema": dict(STRICT, strict=False)})),
    ("cmpl_guided_regex_stop", cmpl_body(guided_regex="[a-z]+", stop=["e"],
                                         max_tokens=8)),
]


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("case,body", GUIDED_CASES,
                         ids=[c[0] for c in GUIDED_CASES])
def test_guided_requests_match_jax(pair, case, body, stream):
    """Every guided request the port refused before, and more, greedy:
    the same status and JSON body, or the same SSE events (buffered for
    a strict schema, JSON mode and parsed tools), as the JAX server; a
    400 names the same param. Texts are the DFA's: a regex output is in
    its language or a live prefix of it."""
    body = dict(body, temperature=0.0, stream=stream)
    path = CHAT if "messages" in body else CMPL
    if stream and case == "cmpl_guided_json_outside_subset":
        # Both servers open the SSE stream before the engine refuses the
        # schema, and the connection ends with no event (ROADMAP Queue 3).
        for srv in pair:
            with pytest.raises(http.client.IncompleteRead):
                call(srv.port, "POST", path, body)
        return
    status, kind, got = compare(pair, "exact", "POST", path, body)
    if status != 200:
        assert status == 400 and kind == "json"
        assert got["error"]["type"] == "invalid_request_error"
        return
    if "guided_regex" in body and not stream:
        from ferrum_tpu_torch.sampling.regex_dfa import compile_regex
        dfa = compile_regex(body["guided_regex"])
        text = got["choices"][0]["text"]
        assert dfa.walk(dfa.start, text) is not None, text


def test_http_text_equals_engine_infer(pair):
    """Non-streaming text = the SSE deltas = engine.infer on the ids."""
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    port_srv = pair[1]
    body = chat_body(messages=[{"role": "user", "content": "compare me"}],
                     temperature=0.0, max_tokens=10)
    _, _, whole = call(port_srv.port, "POST", CHAT, body)
    _, _, events = call(port_srv.port, "POST", CHAT, {**body, "stream": True})
    text = "".join((e["choices"][0]["delta"].get("content") or "")
                   for e in events if isinstance(e, dict) and e["choices"])
    assert whole["choices"][0]["message"]["content"] == text
    app = port_srv.app
    prompt = app.renderer.render([{"role": "user", "content": "compare me"}])
    r = app.engine.infer(InferenceRequest(
        prompt_token_ids=app.engine.tokenizer.encode(prompt),
        sampling=SamplingParams(max_tokens=10)))
    assert r.text == text
    assert whole["usage"]["completion_tokens"] == r.completion_tokens
    assert whole["usage"]["prompt_tokens"] == r.prompt_tokens


# ---------------------------------------------------------------------------
# Request validators against the pydantic models
# ---------------------------------------------------------------------------

VALUES = [None, True, False, 0, 1, 2, -3, 5.0, 5.5, float("inf"), "5",
          " 5 ", "5.0", "1e3", "0x10", "1_000", "+5", "", "abc", "inf",
          "true", "FALSE", "yes", "off", "t", "1", "0", "01", ".5", [],
          ["a"], [1], [{"type": "text"}], {}, {"a": 1}, {"include_usage": 1},
          10 ** 20]
FIELDS = {
    "ChatCompletionRequest": [
        "model", "messages", "max_tokens", "temperature", "top_k", "n",
        "stop", "stream", "stream_options", "logit_bias", "logprobs",
        "seed", "user", "tools", "tool_choice", "function_call",
        "response_format", "chat_template_kwargs", "ignore_eos"],
    "CompletionRequest": [
        "prompt", "max_tokens", "echo", "logprobs", "guided_choice",
        "guided_json", "stop", "top_p"],
    "ChatMessage": ["role", "content", "name", "tool_calls",
                    "function_call"],
    "EmbeddingsRequest": ["input", "encoding_format"],
}
BASE = {
    "ChatCompletionRequest": {"model": "m", "messages": []},
    "CompletionRequest": {"model": "m", "prompt": "p"},
    "ChatMessage": {"role": "user"},
    "EmbeddingsRequest": {"model": "m", "input": "x"},
}


def _dump(obj):
    """A validated model as plain data (pydantic's or the port's)."""
    if hasattr(obj, "model_dump"):
        return obj.model_dump()
    if hasattr(obj, "FIELDS"):
        out = {k: _dump(v) for k, v in vars(obj).items()}
        return out
    if isinstance(obj, list):
        return [_dump(v) for v in obj]
    if isinstance(obj, dict):
        return {k: _dump(v) for k, v in obj.items()}
    return obj


@pytest.mark.parametrize("model", sorted(FIELDS))
def test_validators_accept_what_pydantic_accepts(model):
    from ferrum_tpu.server import openai_types as jt
    from ferrum_tpu_torch.server import openai_types as pt

    jcls, pcls = getattr(jt, model), getattr(pt, model)
    checked = 0
    for field in FIELDS[model]:
        for v in VALUES:
            data = {**BASE[model], field: v, "extra": 1}
            try:
                want = _dump(jcls.model_validate(data))
            except Exception:                        # noqa: BLE001
                want = "rejected"
            try:
                got = _dump(pcls.model_validate(data))
            except pt._Invalid:
                got = "rejected"
            if want != "rejected":
                # pydantic's dump lists every field, extras last.
                assert got != "rejected", (model, field, v)
                assert {k: got[k] for k in want} == want, (model, field, v)
            else:
                assert got == "rejected", (model, field, v, got)
            checked += 1
    assert checked == len(FIELDS[model]) * len(VALUES)


# ---------------------------------------------------------------------------
# Accuracy helpers and bench-serve over HTTP
# ---------------------------------------------------------------------------

def test_accuracy_helpers_match(pair, monkeypatch):
    import urllib.request

    from ferrum_tpu.bench import accuracy as ja
    from ferrum_tpu_torch.bench import accuracy as pa

    urlopen = urllib.request.urlopen      # both packages' calls: <= 60 s
    monkeypatch.setattr(urllib.request, "urlopen", lambda *a, **kw: urlopen(
        *a, **{**kw, "timeout": min(kw.get("timeout", TIMEOUT), TIMEOUT)}))

    jb = f"http://127.0.0.1:{pair[0].port}"
    pb = f"http://127.0.0.1:{pair[1].port}"
    j = ja.completions_logprobs(jb, "Hello scoring world")
    p = pa.completions_logprobs(pb, "Hello scoring world")
    assert_same(p, j)
    for ctx, cont in (("Hello scoring", " world"), ("ab", "cdef")):
        jl, pl = ja.loglikelihood(jb, ctx, cont), pa.loglikelihood(pb, ctx,
                                                                   cont)
        assert pl["is_greedy"] == jl["is_greedy"]
        assert pl["loglikelihood"] == pytest.approx(jl["loglikelihood"],
                                                    abs=2e-2)
    texts = ["Hello scoring world", "abc abc"]
    jp, pp = ja.perplexity(jb, texts), pa.perplexity(pb, texts)
    assert pp["tokens"] == jp["tokens"]
    assert pp["perplexity"] == pytest.approx(jp["perplexity"], rel=1e-2)
    res = {"mmlu": 0.60, "gsm8k": 0.40}
    for base in ({"mmlu": 0.61}, {"mmlu": 0.75}):
        assert pa.compare_to_baseline(res, base) == \
            ja.compare_to_baseline(res, base)
    assert pa.lm_eval_light(pb) == ja.lm_eval_light(jb)


def test_bench_serve_report_matches_jax_keys(pair, monkeypatch):
    import aiohttp

    from ferrum_tpu.bench.bench_serve import run_bench_serve as jax_bs
    from ferrum_tpu_torch.bench.bench_serve import run_bench_serve

    timeout = aiohttp.ClientTimeout      # the JAX client's: <= 60 s
    monkeypatch.setattr(aiohttp, "ClientTimeout",
                        lambda total=None: timeout(total=TIMEOUT))

    kw = dict(model="tiny-test", concurrencies=(1, 2), num_requests=3,
              input_len=6, output_len=3)
    want = jax_bs(f"http://127.0.0.1:{pair[0].port}", **kw)
    got = run_bench_serve(f"http://127.0.0.1:{pair[1].port}", timeout=TIMEOUT,
                          **kw)
    assert sorted(got) == sorted(want)
    assert got["schema"] == want["schema"]
    for gc, wc in zip(got["cells"], want["cells"]):
        assert sorted(gc) == sorted(wc)
        assert gc["errors"] == 0 and gc["completed"] == 3
        assert gc["output_tok_s_stats"].keys() == \
            wc["output_tok_s_stats"].keys()


# ---------------------------------------------------------------------------
# CLI and imports
# ---------------------------------------------------------------------------

SMALL = ["--max-model-len", "256", "--max-num-seqs", "2",
         "--max-num-batched-tokens", "256", "--prefill-chunk", "64"]


def test_cli_run_one_shot_equals_engine_infer(capsys):
    import argparse

    from ferrum_tpu_torch import cli
    from ferrum_tpu_torch.server.chat_template import ChatTemplateRenderer
    from ferrum_tpu_torch.types import InferenceRequest, SamplingParams

    args = ["random:tiny-test", "--device", "cpu", *SMALL]
    rc = cli.main(["run", *args, "--prompt", "hello there",
                   "--temperature", "0", "--max-tokens", "8", "--json"])
    assert rc == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    p = argparse.ArgumentParser()
    cli._add_engine_flags(p)
    engine = cli._build_engine(p.parse_args(args))
    try:
        prompt = ChatTemplateRenderer(
            None, engine.runner.model_cfg.family).render(
                [{"role": "user", "content": "hello there"}])
        r = engine.infer(InferenceRequest(
            prompt_token_ids=engine.tokenizer.encode(prompt),
            sampling=SamplingParams(max_tokens=8, top_p=0.95)))
    finally:
        engine.stop()
    assert got == {"response": r.text}


def test_cli_serve_and_bench_serve_subprocess():
    """`serve --port 0` in a fresh interpreter (no jax): /health, a chat
    request, then `bench-serve` against it."""
    code = ("import sys\n"
            "from ferrum_tpu_torch.cli import main\n"
            "rc = main(sys.argv[1:])\n"
            "assert 'jax' not in sys.modules\n"
            "sys.exit(rc)\n")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "serve", "random:tiny-test",
         "--device", "cpu", "--port", "0", "--served-model-name", "tt",
         *SMALL], stderr=subprocess.PIPE, stdout=subprocess.DEVNULL,
        text=True, env=ENV, cwd=REPO)
    try:
        import select

        port = None
        deadline = time.monotonic() + TIMEOUT
        while port is None and time.monotonic() < deadline:
            ready, _, _ = select.select([proc.stderr], [], [],
                                        max(0.0, deadline - time.monotonic()))
            if not ready:
                break
            line = proc.stderr.readline()
            if not line:
                break
            if line.startswith("serving "):
                port = int(line.rsplit(":", 1)[1])
        assert port, "server did not start"
        status, _, health = call(port, "GET", "/health")
        assert status == 200 and health["model"] == "tt"
        status, _, body = call(port, "POST", CHAT,
                               chat_body(temperature=0.0, max_tokens=3))
        assert status == 200 and body["usage"]["completion_tokens"] == 3
        r = subprocess.run(
            [sys.executable, "-m", "ferrum_tpu_torch", "bench-serve",
             "--base-url", f"http://127.0.0.1:{port}", "--model", "tt",
             "--concurrency", "2", "--num-requests", "2", "--input-len", "4",
             "--output-len", "2"], capture_output=True, text=True,
            timeout=TIMEOUT, env=ENV, cwd=REPO)
        assert r.returncode == 0, r.stderr[-2000:]
        rep = json.loads(r.stdout)
        assert rep["schema"] == "ferrum-tpu-bench-serve/v1"
        assert rep["cells"][0]["errors"] == 0
        assert rep["cells"][0]["completed"] == 2
    finally:
        proc.terminate()
        try:
            proc.wait(TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(TIMEOUT)


def test_imports_load_no_jax_or_web_libraries():
    code = ("import sys\n"
            "import ferrum_tpu_torch.server.app\n"
            "import ferrum_tpu_torch.bench.bench_serve\n"
            "import ferrum_tpu_torch.bench.accuracy\n"
            "import ferrum_tpu_torch.cli\n"
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'ferrum_tpu', 'aiohttp', 'pydantic', 'jinja2', "
            "'requests'})\n"
            "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=TIMEOUT, env=ENV, cwd=REPO)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_unported_serve_lanes_exit_1(capsys):
    from ferrum_tpu_torch.cli import main

    for flag in ("--asr-model", "--tts-model", "--embed-model"):
        rc = main(["serve", "random:tiny-test", "--device", "cpu", flag,
                   "dir", *SMALL])
        err = capsys.readouterr().err
        assert rc == 1 and "not yet ported" in err and flag in err


# ---------------------------------------------------------------------------
# The HTTP layer (server/http.py) on its own
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def echo_server():
    """An HttpServer whose handler echoes the request, streams on
    /stream and fails on /boom."""
    from ferrum_tpu_torch.server import http as h

    async def handler(req):
        if req.path == "/stream":
            resp = h.StreamResponse(req, headers={
                "Content-Type": "text/event-stream"})
            await resp.prepare()
            for i in range(3):
                await resp.write(f"data: {i}\n\n".encode())
            return resp
        if req.path == "/boom":
            raise RuntimeError("handler failed")
        if req.path == "/teapot":
            raise h.HTTPError(418)
        return h.json_response({"method": req.method, "path": req.path,
                                "query": req.query_string,
                                "body": req.body.decode("latin-1"),
                                "agent": req.headers.get("x-agent")})

    srv = h.ServerThread(handler)
    try:
        yield srv
    finally:
        srv.stop(TIMEOUT)


def _raw(port, data, read_until_close=True):
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT) as s:
        s.sendall(data)
        if not read_until_close:
            return s.recv(65536)
        out = b""
        while True:
            part = s.recv(65536)
            if not part:
                return out
            out += part


def test_http_keep_alive_and_bodies(echo_server):
    conn = http.client.HTTPConnection("127.0.0.1", echo_server.port,
                                      timeout=TIMEOUT)
    try:
        for i in range(3):              # one connection, three requests
            conn.request("POST", f"/p%20{i}?q=1", body=b"x" * i,
                         headers={"X-Agent": "t"})
            r = conn.getresponse()
            assert r.status == 200
            assert json.loads(r.read()) == {
                "method": "POST", "path": f"/p {i}", "query": "q=1",
                "body": "x" * i, "agent": "t"}
        conn.request("GET", "/stream")
        r = conn.getresponse()
        assert r.getheader("Transfer-Encoding") == "chunked"
        assert r.read() == b"data: 0\n\ndata: 1\n\ndata: 2\n\n"
        conn.request("GET", "/again")
        assert conn.getresponse().status == 200
    finally:
        conn.close()


def test_http_chunked_request_and_expect_continue(echo_server):
    out = _raw(echo_server.port,
               b"POST /c HTTP/1.1\r\nHost: x\r\nTransfer-Encoding: chunked"
               b"\r\nConnection: close\r\n\r\n3\r\nabc\r\n2;ext=1\r\nde\r\n"
               b"0\r\n\r\n")
    assert out.startswith(b"HTTP/1.1 200") and b'"body": "abcde"' in out
    assert b"Connection: close" in out
    out = _raw(echo_server.port,
               b"POST /e HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n"
               b"Expect: 100-continue\r\n\r\n", read_until_close=False)
    assert out.startswith(b"HTTP/1.1 100 Continue")


def test_http_1_0_closes(echo_server):
    out = _raw(echo_server.port, b"GET /old HTTP/1.0\r\n\r\n")
    assert out.startswith(b"HTTP/1.1 200") and b"Connection: close" in out
    out = _raw(echo_server.port, b"GET /stream HTTP/1.0\r\n\r\n")
    assert out.endswith(b"data: 2\n\n") and b"chunked" not in out


@pytest.mark.parametrize("data,status", [
    (b"NONSENSE\r\n\r\n", 400),
    (b"GET / HTTP/1.1\r\nno colon here\r\n\r\n", 400),
    (b"POST / HTTP/1.1\r\nContent-Length: -4\r\n\r\n", 400),
    (b"POST / HTTP/1.1\r\nContent-Length: 99999999999\r\n\r\n", 413),
    (b"GET / HTTP/1.1\r\nX-Big: " + b"a" * (70 * 1024) + b"\r\n\r\n", 431),
    (b"GET /boom HTTP/1.1\r\nConnection: close\r\n\r\n", 500),
    (b"GET /teapot HTTP/1.1\r\nConnection: close\r\n\r\n", 418),
])
def test_http_errors(echo_server, data, status):
    out = _raw(echo_server.port, data)
    assert out.startswith(f"HTTP/1.1 {status} ".encode()), out[:80]


def test_http_server_stop_closes_idle_connections():
    """stop() returns with a client's keep-alive connection still open."""
    from ferrum_tpu_torch.server import http as h

    async def handler(req):
        return h.text_response("ok")

    srv = h.ServerThread(handler)
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=TIMEOUT)
    try:
        conn.request("GET", "/")
        assert conn.getresponse().read() == b"ok"
        t0 = time.monotonic()
        srv.stop(TIMEOUT)
        assert time.monotonic() - t0 < 10
        assert not srv._thread.is_alive()
    finally:
        conn.close()
