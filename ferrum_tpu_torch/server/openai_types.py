"""OpenAI-compatible request/response types and field-level validation.

Port of `ferrum_tpu/server/openai_types.py` without pydantic, which the
card's machine lacks. Each request model is a plain class whose fields
are checked and coerced by small validators that accept and reject what
the JAX package's pydantic models (v2, lax mode, from a decoded JSON
body) do: an int field takes an int, a bool, an integral float or a
numeric string; a float field an int, a float, a bool or a float
string; a bool field a bool, 0 / 1 and the strings pydantic reads as
one; a str field only a str. Every model keeps unknown keys as
attributes (`extra="allow"`), except StreamOptions, which drops them
(pydantic's default). A failed check raises InvalidRequestError with
no `param`, as the JAX server turns a pydantic error into one; the
message names the field and differs from pydantic's text. Every
unsupported field rejects with HTTP 400 and a `param` pointer instead
of being dropped (`validate_chat_request`, `validate_completion_request`).
"""

from __future__ import annotations

import math
import re
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..types import GuidedOptions, InvalidRequestError, SamplingParams


# ---------------------------------------------------------------------------
# Validators (pydantic v2 lax mode on JSON values)
# ---------------------------------------------------------------------------

class _Invalid(Exception):
    pass


Validator = Callable[[Any], Any]

_INT_STR = re.compile(r"[+-]?\d+(?:_\d+)*")
_INT_DOT_ZERO = re.compile(r"([+-]?\d+(?:_\d+)*)\.0+")
_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}


def v_int(x: Any) -> int:
    if isinstance(x, bool):
        return int(x)
    if isinstance(x, int):
        return x
    if isinstance(x, float):
        if math.isfinite(x) and x == int(x):
            return int(x)
        raise _Invalid("expected an integer")
    if isinstance(x, str):
        s = x.strip()
        if _INT_STR.fullmatch(s):
            return int(s)
        m = _INT_DOT_ZERO.fullmatch(s)
        if m:
            return int(m.group(1))
    raise _Invalid("expected an integer")


def v_float(x: Any) -> float:
    if isinstance(x, (bool, int, float)):
        return float(x)
    if isinstance(x, str) and x.isascii():
        try:
            return float(x)
        except ValueError:
            pass
    raise _Invalid("expected a number")


def v_bool(x: Any) -> bool:
    if isinstance(x, bool):
        return x
    if isinstance(x, (int, float)) and x in (0, 1):
        return bool(x)
    if isinstance(x, str):
        low = x.lower()
        if low in _TRUE:
            return True
        if low in _FALSE:
            return False
    raise _Invalid("expected a boolean")


def v_str(x: Any) -> str:
    if isinstance(x, str):
        return x
    raise _Invalid("expected a string")


def v_any(x: Any) -> Any:
    return x


def v_opt(inner: Validator) -> Validator:
    def check(x):
        return None if x is None else inner(x)
    return check


def v_list(inner: Validator) -> Validator:
    def check(x):
        if not isinstance(x, list):
            raise _Invalid("expected a list")
        out = []
        for i, item in enumerate(x):
            try:
                out.append(inner(item))
            except _Invalid as e:
                raise _Invalid(f"[{i}]: {e}") from None
        return out
    return check


def v_dict(inner: Validator) -> Validator:
    def check(x):
        if not isinstance(x, dict):
            raise _Invalid("expected an object")
        out = {}
        for k, item in x.items():
            try:
                out[v_str(k)] = inner(item)
            except _Invalid as e:
                raise _Invalid(f"[{k!r}]: {e}") from None
        return out
    return check


def v_union(*members: Validator) -> Validator:
    """The first member that accepts (the unions here are str against a
    list or an object: disjoint on JSON values)."""
    def check(x):
        for m in members:
            try:
                return m(x)
            except _Invalid:
                continue
        raise _Invalid("no member of the union accepts the value")
    return check


_REQUIRED = object()


class _Model:
    """A request model: FIELDS maps a name to (validator, default);
    `_REQUIRED` marks a field without one."""

    FIELDS: Dict[str, Tuple[Validator, Any]] = {}
    EXTRA_ALLOW = True

    @classmethod
    def model_validate(cls, data: Any) -> "_Model":
        if isinstance(data, cls):
            return data
        if not isinstance(data, dict):
            raise _Invalid(f"{cls.__name__}: expected an object")
        obj = cls.__new__(cls)
        for name, (check, default) in cls.FIELDS.items():
            if name not in data:
                if default is _REQUIRED:
                    raise _Invalid(f"{name}: field required")
                setattr(obj, name, default)
                continue
            try:
                setattr(obj, name, check(data[name]))
            except _Invalid as e:
                raise _Invalid(f"{name}: {e}") from None
        if cls.EXTRA_ALLOW:
            for name, value in data.items():
                if name not in cls.FIELDS and isinstance(name, str):
                    setattr(obj, name, value)
        return obj


def parse_request(cls, data: Any) -> "_Model":
    """`cls.model_validate(data)`, a failure raised as the JAX server
    raises a pydantic one: InvalidRequestError with no param."""
    try:
        return cls.model_validate(data)
    except _Invalid as e:
        raise InvalidRequestError(f"request validation failed: {e}")


# ---------------------------------------------------------------------------
# Requests
# ---------------------------------------------------------------------------

_STR_OR_LIST = v_opt(v_union(v_str, v_list(v_str)))
_LIST_DICT = v_list(v_dict(v_any))


class ChatMessage(_Model):
    FIELDS = {
        "role": (v_str, _REQUIRED),
        "content": (v_opt(v_union(v_str, _LIST_DICT)), None),
        "name": (v_opt(v_str), None),
        "tool_calls": (v_opt(_LIST_DICT), None),
        "tool_call_id": (v_opt(v_str), None),
        "function_call": (v_opt(v_dict(v_any)), None),
    }


class StreamOptions(_Model):
    FIELDS = {"include_usage": (v_bool, False)}
    EXTRA_ALLOW = False


class ResponseFormat(_Model):
    FIELDS = {
        "type": (v_str, "text"),
        "json_schema": (v_opt(v_dict(v_any)), None),
    }


class ChatCompletionRequest(_Model):
    FIELDS = {
        "model": (v_str, _REQUIRED),
        "messages": (v_list(ChatMessage.model_validate), _REQUIRED),
        "max_tokens": (v_opt(v_int), None),
        "max_completion_tokens": (v_opt(v_int), None),
        "temperature": (v_opt(v_float), None),
        "top_p": (v_opt(v_float), None),
        "top_k": (v_opt(v_int), None),
        "n": (v_int, 1),
        "stop": (_STR_OR_LIST, None),
        "stream": (v_bool, False),
        "stream_options": (v_opt(StreamOptions.model_validate), None),
        "presence_penalty": (v_opt(v_float), None),
        "frequency_penalty": (v_opt(v_float), None),
        "repetition_penalty": (v_opt(v_float), None),
        "logit_bias": (v_opt(v_dict(v_float)), None),
        "logprobs": (v_opt(v_bool), None),
        "top_logprobs": (v_opt(v_int), None),
        "seed": (v_opt(v_int), None),
        "user": (v_opt(v_str), None),
        "tools": (v_opt(_LIST_DICT), None),
        "tool_choice": (v_opt(v_union(v_str, v_dict(v_any))), None),
        "functions": (v_opt(_LIST_DICT), None),
        "function_call": (v_opt(v_union(v_str, v_dict(v_any))), None),
        "response_format": (v_opt(ResponseFormat.model_validate), None),
        "chat_template_kwargs": (v_opt(v_dict(v_any)), None),
        "min_tokens": (v_opt(v_int), None),
        "ignore_eos": (v_opt(v_bool), None),
    }


class CompletionRequest(_Model):
    FIELDS = {
        "model": (v_str, _REQUIRED),
        "prompt": (v_any, _REQUIRED),
        "max_tokens": (v_opt(v_int), 16),
        "temperature": (v_opt(v_float), None),
        "top_p": (v_opt(v_float), None),
        "top_k": (v_opt(v_int), None),
        "n": (v_int, 1),
        "stop": (_STR_OR_LIST, None),
        "stream": (v_bool, False),
        "stream_options": (v_opt(StreamOptions.model_validate), None),
        "seed": (v_opt(v_int), None),
        "echo": (v_bool, False),
        "logprobs": (v_opt(v_int), None),
        "ignore_eos": (v_opt(v_bool), None),
        "min_tokens": (v_opt(v_int), None),
        "guided_regex": (v_opt(v_str), None),
        "guided_json": (v_opt(v_dict(v_any)), None),
        "guided_choice": (v_opt(v_list(v_str)), None),
    }


class EmbeddingsRequest(_Model):
    FIELDS = {
        "model": (v_str, _REQUIRED),
        "input": (v_any, _REQUIRED),
        "encoding_format": (v_str, "float"),
    }


# ---------------------------------------------------------------------------
# Validation (explicit 400 rejection table)
# ---------------------------------------------------------------------------

def _reject(msg: str, param: str):
    raise InvalidRequestError(msg, param=param)


def validate_chat_request(req: ChatCompletionRequest) -> None:
    if req.n != 1:
        _reject("only n=1 is supported", "n")
    if req.logit_bias:
        _reject("logit_bias is not supported", "logit_bias")
    if req.logprobs:
        _reject("logprobs is not supported", "logprobs")
    if req.top_logprobs and req.top_logprobs > 0:
        _reject("top_logprobs is not supported", "top_logprobs")
    if req.stream_options is not None and not req.stream:
        _reject("stream_options requires stream=true", "stream_options")
    if req.tools:
        for t in req.tools:
            if t.get("type") != "function":
                _reject("only function tools are supported", "tools")
    if req.tool_choice is not None:
        tc = req.tool_choice
        if isinstance(tc, str):
            if tc not in ("auto", "none", "required"):
                _reject(f"unknown tool_choice {tc!r}", "tool_choice")
            if tc == "required" and not req.tools:
                _reject("tool_choice=required needs at least one tool",
                        "tool_choice")
        elif isinstance(tc, dict):
            name = (tc.get("function") or {}).get("name")
            declared = {(t.get("function") or {}).get("name")
                        for t in (req.tools or [])}
            if name not in declared:
                _reject(f"tool_choice names undeclared tool {name!r}",
                        "tool_choice")
    if req.function_call is not None and isinstance(req.function_call, dict):
        name = req.function_call.get("name")
        declared = {f.get("name") for f in (req.functions or [])}
        if name not in declared:
            _reject(f"function_call names undeclared function {name!r}",
                    "function_call")
    if req.response_format is not None:
        rf = req.response_format
        if rf.type not in ("text", "json_object", "json_schema"):
            _reject(f"unknown response_format.type {rf.type!r}",
                    "response_format.type")
        if rf.type == "json_schema":
            if not rf.json_schema:
                _reject("json_schema missing", "response_format.json_schema")
    if req.chat_template_kwargs is not None:
        et = req.chat_template_kwargs.get("enable_thinking")
        if et is not None and not isinstance(et, bool):
            _reject("enable_thinking must be a boolean",
                    "chat_template_kwargs.enable_thinking")
    for i, m in enumerate(req.messages):
        if m.role not in ("system", "user", "assistant", "tool", "function"):
            _reject(f"unknown role {m.role!r}", f"messages[{i}].role")
        if isinstance(m.content, list):
            for part in m.content:
                if part.get("type") != "text":
                    _reject("multimodal content parts are not supported",
                            f"messages[{i}].content")


def validate_completion_request(req: CompletionRequest) -> None:
    if not isinstance(req.prompt, str):
        _reject("prompt must be a single string", "prompt")
    if req.n != 1:
        _reject("only n=1 is supported", "n")
    if req.logprobs and not req.echo:
        _reject("logprobs requires echo=true (prompt scoring); "
                "completion-token logprobs are not supported", "logprobs")
    if req.echo and not req.logprobs:
        _reject("echo without logprobs is not supported", "echo")
    if req.echo and (req.max_tokens or 0) != 0:
        _reject("echo+logprobs requires max_tokens=0 (prompt scoring)",
                "max_tokens")
    if req.echo and req.stream:
        _reject("echo+logprobs cannot stream", "stream")
    if req.stream_options is not None and not req.stream:
        _reject("stream_options requires stream=true", "stream_options")


def flatten_content(content) -> str:
    if content is None:
        return ""
    if isinstance(content, str):
        return content
    return "".join(p.get("text", "") for p in content
                   if p.get("type") == "text")


def sampling_from_chat(req: ChatCompletionRequest,
                       default_max: int = 512) -> SamplingParams:
    mt = req.max_completion_tokens or req.max_tokens or default_max
    stop = req.stop if isinstance(req.stop, list) else (
        [req.stop] if req.stop else [])
    return SamplingParams(
        temperature=req.temperature if req.temperature is not None else 1.0,
        top_p=req.top_p if req.top_p is not None else 1.0,
        top_k=req.top_k or 0,
        repetition_penalty=req.repetition_penalty or 1.0,
        max_tokens=mt,
        min_tokens=req.min_tokens or 0,
        stop=stop,
        seed=req.seed,
        ignore_eos=bool(req.ignore_eos))


def guided_from_completion(req: CompletionRequest) -> Optional[GuidedOptions]:
    """vLLM-style guided_regex / guided_json / guided_choice on
    /v1/completions (at most one; 400 otherwise)."""
    set_fields = [f for f in ("guided_regex", "guided_json",
                              "guided_choice") if getattr(req, f)]
    if not set_fields:
        return None
    if len(set_fields) > 1:
        _reject("at most one of guided_regex/guided_json/guided_choice",
                set_fields[1])
    if req.guided_regex is not None:
        return GuidedOptions(regex=req.guided_regex)
    if req.guided_json is not None:
        return GuidedOptions(json_schema=req.guided_json, strict=True)
    return GuidedOptions(regex="|".join(
        re.escape(c) for c in req.guided_choice))


def guided_from_chat(req: ChatCompletionRequest) -> Optional[GuidedOptions]:
    rf = req.response_format
    if rf is None or rf.type == "text":
        return None
    if rf.type == "json_object":
        return GuidedOptions(json_mode=True, strict=False)
    schema = rf.json_schema or {}
    strict = bool(schema.get("strict"))
    return GuidedOptions(json_schema=schema, strict=strict)


# ---------------------------------------------------------------------------
# Responses
# ---------------------------------------------------------------------------

def completion_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


def chat_response(model: str, text: str, finish_reason: str,
                  prompt_tokens: int, completion_tokens: int,
                  tool_calls: Optional[List[Dict[str, Any]]] = None,
                  function_call: Optional[Dict[str, Any]] = None,
                  rid: Optional[str] = None) -> Dict[str, Any]:
    msg: Dict[str, Any] = {"role": "assistant", "content": text}
    if tool_calls:
        msg["tool_calls"] = tool_calls
        msg["content"] = None if not text else text
        finish_reason = "tool_calls"
    if function_call:
        msg["function_call"] = function_call
        msg["content"] = None if not text else text
    return {
        "id": rid or completion_id(),
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": [{
            "index": 0,
            "message": msg,
            "finish_reason": finish_reason,
        }],
        "usage": {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens,
        },
    }


def chat_chunk(rid: str, model: str, delta: Dict[str, Any],
               finish_reason: Optional[str] = None,
               usage: Optional[Dict[str, int]] = None) -> Dict[str, Any]:
    out: Dict[str, Any] = {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [{"index": 0, "delta": delta,
                     "finish_reason": finish_reason}],
    }
    if usage is not None:
        out["choices"] = []
        out["usage"] = usage
    return out


def error_body(message: str, etype: str = "invalid_request_error",
               param: Optional[str] = None,
               code: Optional[str] = None) -> Dict[str, Any]:
    return {"error": {"message": message, "type": etype,
                      "param": param, "code": code}}
