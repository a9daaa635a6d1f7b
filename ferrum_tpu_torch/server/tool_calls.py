"""Tool-call extraction from generated text.

Copy of `ferrum_tpu/server/tool_calls.py` (stdlib only): engine output
that carries tool-call JSON becomes OpenAI `tool_calls` (or the legacy
`function_call`); `tool_choice=none` leaves the content untouched;
`tool_choice=required` or a named tool restricts the parse to declared
tools.

Formats recognized (model-family conventions):
  - Hermes/Qwen: <tool_call>{"name": ..., "arguments": {...}}</tool_call>
  - bare JSON object(s) with "name" + "arguments" keys
"""

from __future__ import annotations

import json
import re
import uuid
from typing import Any, Dict, List, Optional, Tuple

_TOOL_TAG_RE = re.compile(r"<tool_call>\s*(\{.*?\})\s*</tool_call>",
                          re.DOTALL)


def _balanced_json_objects(text: str) -> List[str]:
    """Extract top-level {...} spans with balanced braces (string-aware)."""
    spans = []
    depth = 0
    start = None
    in_str = False
    esc = False
    for i, ch in enumerate(text):
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
            continue
        if ch == '"':
            in_str = True
        elif ch == "{":
            if depth == 0:
                start = i
            depth += 1
        elif ch == "}":
            if depth > 0:
                depth -= 1
                if depth == 0 and start is not None:
                    spans.append(text[start:i + 1])
                    start = None
    return spans


def _try_parse(obj_text: str, declared: Optional[set]) -> Optional[Dict]:
    try:
        obj = json.loads(obj_text)
    except json.JSONDecodeError:
        return None
    if not isinstance(obj, dict):
        return None
    name = obj.get("name")
    args = obj.get("arguments", obj.get("parameters"))
    if not isinstance(name, str) or args is None:
        return None
    if declared is not None and name not in declared:
        return None
    if not isinstance(args, (dict, list, str)):
        return None
    return {"name": name,
            "arguments": args if isinstance(args, str)
            else json.dumps(args, ensure_ascii=False)}


def parse_tool_calls(
    text: str, declared_tools: Optional[List[str]] = None,
    required_tool: Optional[str] = None,
) -> Tuple[str, List[Dict[str, Any]]]:
    """Returns (remaining_content, tool_calls in OpenAI shape).

    `declared_tools`: names allowed (None = accept any). `required_tool`
    restricts further to one specific tool.
    """
    declared = set(declared_tools) if declared_tools is not None else None
    if required_tool is not None:
        declared = {required_tool}

    calls: List[Dict[str, Any]] = []
    remaining = text

    tagged = list(_TOOL_TAG_RE.finditer(text))
    if tagged:
        for m in tagged:
            parsed = _try_parse(m.group(1), declared)
            if parsed is not None:
                calls.append(parsed)
        remaining = _TOOL_TAG_RE.sub("", text).strip()
    else:
        stripped = text.strip()
        if stripped.startswith("```"):
            stripped = re.sub(r"^```(?:json)?\s*|\s*```$", "", stripped,
                              flags=re.DOTALL).strip()
        for span in _balanced_json_objects(stripped):
            parsed = _try_parse(span, declared)
            if parsed is not None:
                calls.append(parsed)
        if calls:
            remaining = ""

    openai_calls = [{
        "id": f"call_{uuid.uuid4().hex[:24]}",
        "type": "function",
        "function": c,
    } for c in calls]
    return remaining, openai_calls
