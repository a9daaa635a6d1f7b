"""OpenAI-compatible HTTP server on the standard library.

Port of `ferrum_tpu/server/app.py` onto server/http.py in place of
aiohttp: the same endpoints -- /v1/chat/completions, /v1/completions
(with the echo + logprobs scoring round), /v1/models, /v1/embeddings,
/v1/audio/transcriptions, /v1/audio/speech, /health, /metrics, / --
the same explicit-400 contract and error bodies, SSE streaming ending
in `data: [DONE]` with stream_options.include_usage, tool-call parsing
(buffered streaming while tools are parsed), the API-key check on
/v1/ paths and the opt-in X-Ferrum-Session cache. The engine is driven
from the event loop through `run_in_executor`, as in the JAX server.

Guided requests as the JAX server answers them: response_format
json_object (JSON mode), a strict json_schema (outside the subset a 400
before generation, param "response_format.json_schema"; the output
validated after it, a 400 if it fails), and on /v1/completions
guided_regex / guided_json / guided_choice. A non-strict json_schema
runs unmasked. Streaming is buffered for a strict schema, JSON mode and
parsed tools. tool_choice="required" puts no mask on the output: with
no valid tool call in it the answer is a 400 (param "tool_choice").

Differences, on purpose:
  * /v1/embeddings and /v1/audio/* have no engine to attach yet: they
    answer as the JAX server does without one (400, param "model").
  * Request validation is openai_types.py's, not pydantic's: the same
    status, type and param; other message text.
"""

from __future__ import annotations

import asyncio
import collections
import json
import time
from typing import Any, Dict, List, Optional

from ..sampling.schema import schema_to_regex, validate_json_against_subset
from ..types import (FerrumError, FinishReason, InferenceRequest,
                     InvalidRequestError, NotSupportedError, SamplingParams)
from .chat_template import ChatTemplateRenderer
from .http import (Request, Router, ServerThread, StreamResponse,
                   json_response, text_response)
from .openai_types import (
    ChatCompletionRequest, CompletionRequest, EmbeddingsRequest, chat_chunk,
    chat_response, completion_id, error_body, flatten_content,
    guided_from_chat, guided_from_completion, parse_request,
    sampling_from_chat, validate_chat_request, validate_completion_request)
from .tool_calls import parse_tool_calls

SSE_HEADERS = {"Content-Type": "text/event-stream",
               "Cache-Control": "no-cache"}


def _schema_failed() -> InvalidRequestError:
    return InvalidRequestError(
        "generated output failed strict schema validation",
        param="response_format.json_schema")


def _no_tool_call() -> InvalidRequestError:
    return InvalidRequestError(
        "model did not produce a valid required tool call",
        param="tool_choice")


class SessionCache:
    """Opt-in per-session message history with entry and token budgets."""

    def __init__(self, max_entries: int = 64, max_tokens: int = 8192):
        self.max_entries = max_entries
        self.max_tokens = max_tokens
        self._store: "collections.OrderedDict[str, List[Dict]]" = \
            collections.OrderedDict()

    def get(self, sid: str) -> List[Dict]:
        msgs = self._store.get(sid, [])
        if sid in self._store:
            self._store.move_to_end(sid)
        return list(msgs)

    def extend(self, sid: str, msgs: List[Dict], approx_tokens_fn) -> None:
        hist = self._store.setdefault(sid, [])
        hist.extend(msgs)
        # Token budget: drop from the front (keep a leading system msg).
        while len(hist) > 2 and sum(
                approx_tokens_fn(m.get("content") or "")
                for m in hist) > self.max_tokens:
            drop_idx = 1 if hist and hist[0].get("role") == "system" else 0
            hist.pop(drop_idx)
        self._store.move_to_end(sid)
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)

    @property
    def sessions(self) -> int:
        return len(self._store)


class FerrumServer:
    def __init__(self, engine, model_name: str,
                 chat_template: Optional[str] = None,
                 api_key: Optional[str] = None):
        self.engine = engine
        self.model_name = model_name
        self.api_key = api_key
        family = engine.runner.model_cfg.family
        self.renderer = ChatTemplateRenderer(
            template=chat_template
            or getattr(engine.tokenizer, "chat_template", None),
            family=family)
        cfg = engine.cfg
        self.sessions = SessionCache(cfg.session_cache_entries,
                                     cfg.session_cache_tokens)
        self.started_at = time.time()
        self.router = Router()
        for method, path, fn in (
                ("POST", "/v1/chat/completions", self.chat_completions),
                ("POST", "/v1/completions", self.completions),
                ("POST", "/v1/embeddings", self.embeddings),
                ("POST", "/v1/audio/transcriptions", self.transcriptions),
                ("POST", "/v1/audio/speech", self.speech),
                ("GET", "/v1/models", self.models),
                ("GET", "/health", self.health),
                ("GET", "/metrics", self.metrics),
                ("GET", "/", self.root)):
            self.router.add(method, path, fn)

    # ------------------------------------------------------------------
    async def handle(self, request: Request):
        """The JAX app's middlewares: the API key on /v1/ paths (inner),
        then the error bodies (outer)."""
        try:
            if self.api_key and request.path.startswith("/v1/"):
                auth = request.headers.get("authorization", "")
                if auth != f"Bearer {self.api_key}":
                    return json_response(
                        error_body("invalid API key", "authentication_error"),
                        status=401)
            return await self.router.resolve(request)(request)
        except (InvalidRequestError, NotSupportedError) as e:
            return json_response(
                error_body(e.message, "invalid_request_error", e.param),
                status=400)
        except FerrumError as e:
            return json_response(error_body(e.message, e.code), status=500)

    def start(self, host: str = "127.0.0.1", port: int = 0) -> ServerThread:
        """Serve in a background thread (port 0: a free one)."""
        return ServerThread(self.handle, host, port)

    # ------------------------------------------------------------------
    @staticmethod
    def _parse_json(request: Request, model_cls):
        try:
            data = request.json()
        except Exception:
            raise InvalidRequestError("request body is not valid JSON")
        return parse_request(model_cls, data)

    async def _submit(self, inf_req: InferenceRequest):
        loop = asyncio.get_running_loop()
        return await loop.run_in_executor(None, self.engine.submit, inf_req)

    async def _collect(self, inf_req: InferenceRequest):
        loop = asyncio.get_running_loop()
        q = await self._submit(inf_req)
        chunks = []
        while True:
            chunk = await loop.run_in_executor(None, q.get)
            chunks.append(chunk)
            if chunk.finished:
                return chunks

    # ------------------------------------------------------------------
    async def chat_completions(self, request: Request):
        req = self._parse_json(request, ChatCompletionRequest)
        validate_chat_request(req)

        session_id = request.headers.get("x-ferrum-session")
        messages = [
            {"role": m.role, "content": flatten_content(m.content),
             **({"tool_calls": m.tool_calls} if m.tool_calls else {}),
             **({"function_call": m.function_call} if m.function_call else {}),
             **({"name": m.name} if m.name else {})}
            for m in req.messages
        ]
        if session_id:
            messages = self.sessions.get(session_id) + messages

        tools = req.tools or (
            [{"type": "function", "function": f} for f in req.functions]
            if req.functions else None)
        prompt = self.renderer.render(
            messages, add_generation_prompt=True, tools=tools,
            chat_template_kwargs=req.chat_template_kwargs)

        sampling = sampling_from_chat(req)
        guided = guided_from_chat(req)
        strict_schema = None
        if guided is not None and guided.json_schema is not None:
            if guided.strict:
                # Fail fast outside the subset (an explicit 400).
                try:
                    schema_to_regex(guided.json_schema)
                except NotSupportedError as e:
                    raise InvalidRequestError(
                        f"unsupported json_schema subset: {e.message}",
                        param="response_format.json_schema")
                strict_schema = guided.json_schema
            else:
                guided = None  # non-strict schema: best effort, no mask

        tool_choice = req.tool_choice
        if tool_choice == "none":
            declared_names = None
            parse_tools = False
        else:
            declared_names = [
                (t.get("function") or {}).get("name") for t in (tools or [])]
            parse_tools = bool(tools)
        required_tool = None
        if isinstance(tool_choice, dict):
            required_tool = (tool_choice.get("function") or {}).get("name")

        inf_req = InferenceRequest(
            prompt_token_ids=self.engine.tokenizer.encode(prompt),
            sampling=sampling, guided=guided)

        rid = completion_id()
        if req.stream:
            return await self._stream_chat(
                request, req, inf_req, rid, strict_schema, parse_tools,
                declared_names, required_tool, session_id, messages)

        chunks = await self._collect(inf_req)
        text = "".join(c.text for c in chunks)
        last = chunks[-1]
        finish = (last.finish_reason or FinishReason.STOP).value

        if strict_schema is not None and \
                not validate_json_against_subset(text, strict_schema):
            raise _schema_failed()

        tool_calls = []
        content = text
        if parse_tools:
            content, tool_calls = parse_tool_calls(
                text, declared_names, required_tool)
            if tool_choice == "required" and not tool_calls:
                raise _no_tool_call()
        function_call = None
        if req.functions and tool_calls:
            function_call = dict(tool_calls[0]["function"])
            tool_calls = []

        if session_id:
            self._remember(session_id, messages, text)

        return json_response(chat_response(
            self.model_name, content, finish, last.prompt_tokens,
            last.completion_tokens, tool_calls or None, function_call,
            rid=rid))

    def _remember(self, session_id: str, messages: List[Dict],
                  text: str) -> None:
        self.sessions.extend(
            session_id,
            messages[len(self.sessions.get(session_id)):] + [
                {"role": "assistant", "content": text}],
            lambda s: max(1, len(s) // 4))

    async def _stream_chat(self, request, req, inf_req, rid, strict_schema,
                           parse_tools, declared_names, required_tool,
                           session_id, rendered_messages):
        resp = StreamResponse(request, headers={**SSE_HEADERS,
                                                "Connection": "keep-alive"})
        await resp.prepare()

        async def send(obj):
            await resp.write(f"data: {json.dumps(obj)}\n\n".encode())

        loop = asyncio.get_running_loop()
        q = await self._submit(inf_req)
        await send(chat_chunk(rid, self.model_name,
                              {"role": "assistant", "content": ""}))

        # A strict schema, JSON mode and tool parsing can't stream raw
        # deltas: the text is buffered.
        buffered = strict_schema is not None or parse_tools \
            or (inf_req.guided is not None and inf_req.guided.json_mode)
        full_text = []
        last = None
        while True:
            chunk = await loop.run_in_executor(None, q.get)
            last = chunk
            if chunk.text:
                full_text.append(chunk.text)
                if not buffered:
                    await send(chat_chunk(rid, self.model_name,
                                          {"content": chunk.text}))
            if chunk.finished:
                break

        text = "".join(full_text)
        finish = (last.finish_reason or FinishReason.STOP).value
        if buffered:
            failed = None
            if strict_schema is not None and \
                    not validate_json_against_subset(text, strict_schema):
                failed = _schema_failed()
            content, tool_calls = (text, [])
            if failed is None and parse_tools:
                content, tool_calls = parse_tool_calls(
                    text, declared_names, required_tool)
                if req.tool_choice == "required" and not tool_calls:
                    failed = _no_tool_call()
            if failed is not None:
                await send(error_body(failed.message, param=failed.param))
                await resp.write(b"data: [DONE]\n\n")
                return resp
            if tool_calls:
                if req.functions:
                    await send(chat_chunk(
                        rid, self.model_name,
                        {"function_call": tool_calls[0]["function"]}))
                else:
                    deltas = [{**tc, "index": i}
                              for i, tc in enumerate(tool_calls)]
                    await send(chat_chunk(rid, self.model_name,
                                          {"tool_calls": deltas}))
                finish = "tool_calls"
            elif content:
                await send(chat_chunk(rid, self.model_name,
                                      {"content": content}))

        await send(chat_chunk(rid, self.model_name, {}, finish_reason=finish))
        if req.stream_options and req.stream_options.include_usage:
            await send(chat_chunk(rid, self.model_name, {}, usage={
                "prompt_tokens": last.prompt_tokens,
                "completion_tokens": last.completion_tokens,
                "total_tokens": last.prompt_tokens + last.completion_tokens,
            }))
        await resp.write(b"data: [DONE]\n\n")

        if session_id:
            self._remember(session_id, rendered_messages, text)
        return resp

    # ------------------------------------------------------------------
    def _completion_obj(self, rid: str, **fields) -> Dict[str, Any]:
        return {"id": rid, "object": "text_completion",
                "created": int(time.time()), "model": self.model_name,
                **fields}

    async def completions(self, request: Request):
        req = self._parse_json(request, CompletionRequest)
        validate_completion_request(req)
        stop = req.stop if isinstance(req.stop, list) else (
            [req.stop] if req.stop else [])
        score = bool(req.echo and req.logprobs)
        sampling = SamplingParams(
            temperature=req.temperature if req.temperature is not None else 1.0,
            top_p=req.top_p if req.top_p is not None else 1.0,
            top_k=req.top_k or 0,
            max_tokens=0 if score else (req.max_tokens or 16),
            min_tokens=req.min_tokens or 0,
            logprobs=req.logprobs if score else None,
            stop=stop, seed=req.seed, ignore_eos=bool(req.ignore_eos))
        inf_req = InferenceRequest(prompt=req.prompt, sampling=sampling,
                                   echo=score,
                                   guided=guided_from_completion(req))
        rid = completion_id("cmpl")

        if score:
            # Prompt scoring (lm_eval local-completions loglikelihood):
            # one blocking round returns the OpenAI logprobs object for
            # the echoed prompt; no text is generated.
            chunks = await self._collect(inf_req)
            last = chunks[-1]
            return json_response(self._completion_obj(
                rid, choices=[{"index": 0, "text": req.prompt,
                               "logprobs": self._openai_logprobs(
                                   last.logprobs or []),
                               "finish_reason": "length"}],
                usage={"prompt_tokens": last.prompt_tokens,
                       "completion_tokens": 0,
                       "total_tokens": last.prompt_tokens}))

        if req.stream:
            resp = StreamResponse(request, headers=SSE_HEADERS)
            await resp.prepare()

            async def send(obj):
                await resp.write(f"data: {json.dumps(obj)}\n\n".encode())

            loop = asyncio.get_running_loop()
            q = await self._submit(inf_req)
            last = None
            while True:
                chunk = await loop.run_in_executor(None, q.get)
                last = chunk
                if chunk.text:
                    await send(self._completion_obj(
                        rid, choices=[{"index": 0, "text": chunk.text,
                                       "finish_reason": None}]))
                if chunk.finished:
                    break
            fin = (last.finish_reason or FinishReason.STOP).value
            await send(self._completion_obj(
                rid, choices=[{"index": 0, "text": "",
                               "finish_reason": fin}]))
            if req.stream_options and req.stream_options.include_usage:
                await send(self._completion_obj(
                    rid, choices=[],
                    usage={"prompt_tokens": last.prompt_tokens,
                           "completion_tokens": last.completion_tokens,
                           "total_tokens": last.prompt_tokens
                           + last.completion_tokens}))
            await resp.write(b"data: [DONE]\n\n")
            return resp

        chunks = await self._collect(inf_req)
        text = "".join(c.text for c in chunks)
        last = chunks[-1]
        return json_response(self._completion_obj(
            rid, choices=[{"index": 0, "text": text, "logprobs": None,
                           "finish_reason":
                           (last.finish_reason or FinishReason.STOP).value}],
            usage={"prompt_tokens": last.prompt_tokens,
                   "completion_tokens": last.completion_tokens,
                   "total_tokens": last.prompt_tokens
                   + last.completion_tokens}))

    def _openai_logprobs(self, entries) -> Dict[str, List]:
        """The engine's per-prompt-token entries as OpenAI's logprobs
        object: tokens, token_logprobs, top_logprobs (the argmax, and the
        token itself), text_offset."""
        decode = self.engine.tokenizer.decode
        toks, tok_lps, top_lps, offs = [], [], [], []
        off = 0
        for e in entries:
            text_tok = decode([e["token_id"]])
            toks.append(text_tok)
            offs.append(off)
            off += len(text_tok)
            tok_lps.append(e["logprob"])
            if e["logprob"] is None:
                top_lps.append(None)
            else:
                top = {decode([e["argmax_id"]]): e["argmax_logprob"]}
                top.setdefault(text_tok, e["logprob"])
                top_lps.append(top)
        return {"tokens": toks, "token_logprobs": tok_lps,
                "top_logprobs": top_lps, "text_offset": offs}

    # ------------------------------------------------------------------
    async def transcriptions(self, request: Request):
        raise NotSupportedError(
            "this server is not running an ASR model "
            "(start with --asr-model <whisper checkpoint dir>)",
            param="model")

    async def speech(self, request: Request):
        raise NotSupportedError(
            "this server is not running a TTS model "
            "(start with --tts-model <checkpoint dir>)",
            param="model")

    async def embeddings(self, request: Request):
        req = self._parse_json(request, EmbeddingsRequest)
        if req.encoding_format != "float":
            raise InvalidRequestError(
                "only encoding_format=float is supported",
                param="encoding_format")
        raise NotSupportedError(
            "this server is not running an embedding model", param="model")

    async def models(self, request: Request):
        return json_response({"object": "list", "data": [{
            "id": self.model_name, "object": "model",
            "created": int(self.started_at), "owned_by": "ferrum-tpu"}]})

    async def health(self, request: Request):
        m = self.engine.metrics_snapshot()
        return json_response({
            "status": "ok",
            "model": self.model_name,
            "prefix_cache": "block_hash" if self.engine.prefix_cache.enabled
            else "off",
            "kv_real_reuse": self.engine.prefix_cache.enabled,
            "running": m.running_requests,
            "waiting": m.waiting_requests,
        })

    async def metrics(self, request: Request):
        m = self.engine.metrics_snapshot()
        lines = ["# Prometheus exposition (subset)"]
        for k, v in m.to_dict().items():
            lines.append(f"ferrum_{k} {v}")
        lines.append(f"ferrum_session_cache_sessions {self.sessions.sessions}")
        return text_response("\n".join(lines) + "\n")

    async def root(self, request: Request):
        return json_response({
            "name": "ferrum-tpu", "model": self.model_name,
            "endpoints": ["/v1/chat/completions", "/v1/completions",
                          "/v1/embeddings", "/v1/models", "/health",
                          "/metrics"]})


def serve(engine, model_name: str, host: str = "127.0.0.1",
          port: int = 8000, chat_template: Optional[str] = None,
          api_key: Optional[str] = None, on_start=None) -> None:
    """Serve in the foreground until interrupted; `on_start(port)` is
    called once the socket is bound."""
    thread = FerrumServer(engine, model_name, chat_template,
                          api_key).start(host, port)
    if on_start is not None:
        on_start(thread.port)
    try:
        thread.wait()
    except KeyboardInterrupt:
        pass
    finally:
        thread.stop()
