"""JSON-Schema -> regex lowering (conservative subset, fail-fast).

Port of `ferrum_tpu/sampling/schema.py`, the same code: the same regex
string for the same schema, the same verdict from
`validate_json_against_subset`. The subset:

  - type: object with properties / required / additionalProperties:false
  - scalars: string, number, integer, boolean
  - enum of strings or numbers
  - arrays with homogeneous scalar/object items
  - nested objects of the same subset

Unsupported constructs raise NotSupportedError so the server can reject
with param=response_format.json_schema before generation starts.
"""

from __future__ import annotations

import re
from typing import Any, Dict

from ..types import NotSupportedError

_WS = r"\s*"
_STRING = r'"([^"\\]|\\["\\/bfnrt]|\\u[0-9a-fA-F]{4})*"'
_NUMBER = r"-?(0|[1-9]\d*)(\.\d+)?([eE][+-]?\d+)?"
_INTEGER = r"-?(0|[1-9]\d*)"
_BOOLEAN = r"(true|false)"
_NULL = r"null"


def _escape_literal(s: str) -> str:
    out = []
    for ch in s:
        if ch in r"\^$.|?*+()[]{}":
            out.append("\\" + ch)
        else:
            out.append(ch)
    return "".join(out)


def _value_regex(schema: Dict[str, Any], depth: int = 0) -> str:
    if depth > 8:
        raise NotSupportedError("schema nesting too deep (>8)")
    if not isinstance(schema, dict):
        raise NotSupportedError("schema must be an object")

    if "enum" in schema:
        opts = []
        for v in schema["enum"]:
            if isinstance(v, str):
                opts.append('"' + _escape_literal(v) + '"')
            elif isinstance(v, bool):
                opts.append("true" if v else "false")
            elif isinstance(v, (int, float)):
                opts.append(_escape_literal(repr(v)))
            else:
                raise NotSupportedError(f"enum value {v!r} unsupported")
        return "(" + "|".join(opts) + ")"

    ty = schema.get("type")
    if ty == "string":
        return _STRING
    if ty == "number":
        return _NUMBER
    if ty == "integer":
        return _INTEGER
    if ty == "boolean":
        return _BOOLEAN
    if ty == "null":
        return _NULL
    if ty == "array":
        items = schema.get("items")
        if items is None:
            raise NotSupportedError("array without homogeneous items")
        item_re = _value_regex(items, depth + 1)
        min_items = schema.get("minItems", 0)
        if schema.get("maxItems") is not None or min_items not in (0, 1):
            raise NotSupportedError("minItems>1 / maxItems unsupported")
        body = f"{_WS}{item_re}({_WS},{_WS}{item_re})*{_WS}"
        if min_items == 0:
            return r"\[(" + body + r"|\s*)\]"
        return r"\[" + body + r"\]"
    if ty == "object":
        return _object_regex(schema, depth)
    raise NotSupportedError(f"type {ty!r} unsupported")


def _object_regex(schema: Dict[str, Any], depth: int) -> str:
    props = schema.get("properties")
    if not props:
        raise NotSupportedError("object without properties")
    addl = schema.get("additionalProperties", None)
    if addl not in (False, None):
        raise NotSupportedError("additionalProperties must be false/omitted")
    required = schema.get("required", list(props.keys()))
    for r in required:
        if r not in props:
            raise NotSupportedError(f"required key {r!r} not in properties")
    # Fixed key order (declaration order), required keys only — the
    # conservative contract the reference ships: optional keys are only
    # supported when they form a suffix of the declaration order.
    names = list(props.keys())
    opt_started = False
    parts = []
    for i, name in enumerate(names):
        key_re = f'"{_escape_literal(name)}"{_WS}:{_WS}' \
            + _value_regex(props[name], depth + 1)
        is_req = name in required
        if not is_req:
            opt_started = True
        elif opt_started:
            raise NotSupportedError(
                "optional properties must come after all required ones")
        sep = f"{_WS},{_WS}" if i > 0 else _WS
        if is_req:
            parts.append(sep + key_re)
        else:
            parts.append(f"({sep}{key_re})?")
    return r"\{" + "".join(parts) + _WS + r"\}"


def schema_to_regex(schema: Dict[str, Any]) -> str:
    """Top-level entry. The schema may be the raw json_schema object or
    the OpenAI wrapper {"name":..., "schema": {...}, "strict": true}."""
    if "schema" in schema and isinstance(schema["schema"], dict):
        schema = schema["schema"]
    if schema.get("type") != "object":
        raise NotSupportedError("top-level schema must be type=object")
    return _WS + _object_regex(schema, 0) + _WS


def validate_json_against_subset(text: str, schema: Dict[str, Any]) -> bool:
    """Post-hoc validation used by the server's strict-schema buffered
    streaming (emit only after validation passes)."""
    from .regex_dfa import compile_regex

    try:
        dfa = compile_regex(schema_to_regex(schema))
    except NotSupportedError:
        return False
    return dfa.fullmatch(text)
