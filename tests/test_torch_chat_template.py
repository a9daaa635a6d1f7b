"""Chat templates: the port's renderer (no jinja2) against the JAX
package's `ChatTemplateRenderer` (jinja2).

Both render the four default templates and the templates written out
below -- tool definitions and tool-call history through `tojson` (with
non-ASCII text), `namespace`, loop controls, the loop object, filters,
tests, string methods, `strftime_now` on a pinned clock,
`raise_exception` -- on messages drawn by hypothesis; the outputs must
be equal strings. A template the subset does not cover raises
InvalidRequestError when it loads, as jinja2's syntax errors do in the
JAX package; a render failure is an InvalidRequestError on both sides.
Also: `parse_tool_calls` against the JAX package's on hypothesis text.
"""

import datetime

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from ferrum_tpu.server import chat_template as jax_ct
from ferrum_tpu.server import tool_calls as jax_tc
from ferrum_tpu_torch.server import chat_template as ct
from ferrum_tpu_torch.server import tool_calls as tc
from ferrum_tpu_torch.types import InvalidRequestError

PINNED = datetime.datetime(2026, 3, 14, 9, 26, 53)

# A ChatML template with tools, tool-call history, thinking and a
# namespace walked backwards with loop controls.
TOOLS_TEMPLATE = """\
{%- if tools %}
    {{- '<|im_start|>system\\n' }}
    {%- if messages[0].role == 'system' %}
        {{- messages[0].content + '\\n\\n' }}
    {%- endif %}
    {{- "# Tools\\n\\n<tools>" }}
    {%- for tool in tools %}
        {{- "\\n" }}
        {{- tool | tojson }}
    {%- endfor %}
    {{- "\\n</tools><|im_end|>\\n" }}
{%- else %}
    {%- if messages[0].role == 'system' %}
        {{- '<|im_start|>system\\n' + messages[0].content + '<|im_end|>\\n' }}
    {%- endif %}
{%- endif %}
{%- set ns = namespace(multi_step_tool=true, last_query_index=messages|length - 1) %}
{%- for message in messages[::-1] %}
    {%- set index = (messages|length - 1) - loop.index0 %}
    {%- if ns.multi_step_tool and message.role == "user" and message.content is string and not(message.content.startswith('<tool_response>') and message.content.endswith('</tool_response>')) %}
        {%- set ns.multi_step_tool = false %}
        {%- set ns.last_query_index = index %}
        {%- break %}
    {%- endif %}
{%- endfor %}
{%- for message in messages %}
    {%- if message.content is string %}
        {%- set content = message.content %}
    {%- else %}
        {%- set content = '' %}
    {%- endif %}
    {%- if (message.role == "user") or (message.role == "system" and not loop.first) %}
        {{- '<|im_start|>' + message.role + '\\n' + content + '<|im_end|>' + '\\n' }}
    {%- elif message.role == "assistant" %}
        {%- set reasoning_content = '' %}
        {%- if '</think>' in content %}
            {%- set reasoning_content = content.split('</think>')[0].rstrip('\\n').split('<think>')[-1].lstrip('\\n') %}
            {%- set content = content.split('</think>')[-1].lstrip('\\n') %}
        {%- endif %}
        {%- if loop.index0 > ns.last_query_index %}
            {%- if loop.last or (not loop.last and reasoning_content) %}
                {{- '<|im_start|>' + message.role + '\\n<think>\\n' + reasoning_content.strip('\\n') + '\\n</think>\\n\\n' + content.lstrip('\\n') }}
            {%- else %}
                {{- '<|im_start|>' + message.role + '\\n' + content }}
            {%- endif %}
        {%- else %}
            {{- '<|im_start|>' + message.role + '\\n' + content }}
        {%- endif %}
        {%- if message.tool_calls %}
            {%- for tool_call in message.tool_calls %}
                {%- if (loop.first and content) or (not loop.first) %}
                    {{- '\\n' }}
                {%- endif %}
                {%- if tool_call.function %}
                    {%- set tool_call = tool_call.function %}
                {%- endif %}
                {{- '<tool_call>\\n{"name": "' }}
                {{- tool_call.name }}
                {{- '", "arguments": ' }}
                {%- if tool_call.arguments is string %}
                    {{- tool_call.arguments }}
                {%- else %}
                    {{- tool_call.arguments | tojson }}
                {%- endif %}
                {{- '}\\n</tool_call>' }}
            {%- endfor %}
        {%- endif %}
        {{- '<|im_end|>\\n' }}
    {%- elif message.role == "tool" %}
        {%- if loop.first or (messages[loop.index0 - 1].role != "tool") %}
            {{- '<|im_start|>user' }}
        {%- endif %}
        {{- '\\n<tool_response>\\n' }}
        {{- content }}
        {{- '\\n</tool_response>' }}
        {%- if loop.last or (messages[loop.index0 + 1].role != "tool") %}
            {{- '<|im_end|>\\n' }}
        {%- endif %}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|im_start|>assistant\\n' }}
    {%- if enable_thinking is defined and enable_thinking is false %}
        {{- '<think>\\n\\n</think>\\n\\n' }}
    {%- endif %}
{%- endif %}
"""

# A Llama-3.1-style template: the pinned date, a system message taken
# off the list, tools in the first user turn, items / reject / join /
# trim / default, and raise_exception.
LLAMA_TEMPLATE = """\
{{- bos_token }}
{%- if not date_string is defined %}
    {%- set date_string = strftime_now("%d %b %Y") %}
{%- endif %}
{%- if messages[0]['role'] == 'system' %}
    {%- set system_message = messages[0]['content']|trim %}
    {%- set messages = messages[1:] %}
{%- else %}
    {%- set system_message = "" %}
{%- endif %}
{{- "<|start_header_id|>system<|end_header_id|>\\n\\n" }}
{%- if builtin_tools is defined %}
    {{- "Tools: " + builtin_tools | reject('equalto', 'code_interpreter') | join(", ") + "\\n" }}
{%- endif %}
{{- "Today Date: " + date_string + "\\n\\n" }}
{{- system_message }}
{{- "<|eot_id|>" }}
{%- if tools is not none and tools | default([]) | length > 0 %}
    {%- if messages | length != 0 %}
        {%- set first_user_message = messages[0]['content']|trim %}
        {%- set messages = messages[1:] %}
    {%- else %}
        {{- raise_exception("Cannot put tools in the first user message when there's no first user message!") }}
    {%- endif %}
    {{- '<|start_header_id|>user<|end_header_id|>\\n\\n' -}}
    {%- for t in tools %}
        {{- t | tojson(indent=4) }}
        {{- "\\n\\n" }}
    {%- endfor %}
    {{- first_user_message + "<|eot_id|>"}}
{%- endif %}
{%- for message in messages %}
    {%- if not (message.role == 'tool' or message.role == 'function' or 'tool_calls' in message) %}
        {{- '<|start_header_id|>' + message['role'] + '<|end_header_id|>\\n\\n'+ message['content'] | trim + '<|eot_id|>' }}
    {%- elif 'tool_calls' in message %}
        {%- if not message.tool_calls|length == 1 %}
            {{- raise_exception("This model only supports single tool-calls at once!") }}
        {%- endif %}
        {%- set tool_call = message.tool_calls[0].function %}
        {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' -}}
        {{- '<|python_tag|>' + tool_call.name + '.call(' }}
        {%- for arg_name, arg_val in tool_call.arguments | items %}
            {{- arg_name + '="' + arg_val|string + '"' }}
            {%- if not loop.last %}
                {{- ", " }}
            {%- endif %}
        {%- endfor %}
        {{- ")<|eom_id|>" }}
    {%- elif message.role == "tool" or message.role == "function" %}
        {{- "<|start_header_id|>ipython<|end_header_id|>\\n\\n" }}
        {%- if message.content is mapping or message.content is iterable and message.content is not string %}
            {{- message.content | tojson }}
        {%- else %}
            {{- message.content }}
        {%- endif %}
        {{- "<|eot_id|>" }}
    {%- endif %}
{%- endfor %}
{%- if add_generation_prompt %}
    {{- '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}
{%- endif %}
"""

# Alternation checked with raise_exception, continue, the loop object,
# conditional expressions, ~, arithmetic, slices, dict literals and
# tests with arguments.
MISC_TEMPLATE = """\
{#- strict alternation after an optional system turn -#}
{%- set offset = 1 if messages and messages[0].role == 'system' else 0 -%}
{%- for message in messages -%}
  {%- if message.role == 'system' -%}{%- continue -%}{%- endif -%}
  {%- if (message.role == 'user') != ((loop.index0 - offset) % 2 == 0) -%}
    {{- raise_exception('roles must alternate user/assistant') -}}
  {%- endif -%}
  {%- set tag = {'user': 'INST', 'assistant': 'RESP'}[message.role] -%}
  [{{ tag ~ '#' ~ loop.index }}|{{ loop.revindex }}/{{ loop.length }}]
  {{- ' first' if loop.first }}{{ ' last' if loop.last else '' }}
  {%- if loop.index is divisibleby 2 %} even{% endif %}
  {{- ' ' ~ message.content[:12] | upper ~ '|' ~ message.content | length }}
  {%- if message.content is defined and message.content | trim == '' %} (blank){% endif %}
{% endfor -%}
{{- 'n=' ~ (messages | length) ~ ' ' ~ range(3) | list | join(',') ~ ' ' ~ (7 // 2) ~ (7 % 3) ~ (2 ** 3) -}}
{%- if add_generation_prompt %} >>{% endif -%}
"""

TEMPLATES = {"tools": TOOLS_TEMPLATE, "llama": LLAMA_TEMPLATE,
             "misc": MISC_TEMPLATE}

TEXT = st.text(alphabet=st.characters(
    codec="utf-8", exclude_categories=("Cs",)), max_size=40)
TOOL = st.fixed_dictionaries({
    "type": st.just("function"),
    "function": st.fixed_dictionaries({
        "name": st.sampled_from(["get_weather", "wetter_prüfen", "搜索"]),
        "description": TEXT,
        "parameters": st.just({"type": "object", "properties": {
            "city": {"type": "string", "description": "Straße / 城市"}}}),
    })})
TOOL_CALL = st.fixed_dictionaries({
    "type": st.just("function"),
    "function": st.fixed_dictionaries({
        "name": st.sampled_from(["get_weather", "搜索"]),
        "arguments": st.one_of(
            st.dictionaries(st.sampled_from(["city", "ort"]), TEXT,
                            max_size=2),
            TEXT)})})


@st.composite
def conversations(draw):
    """A system turn (or not), then alternating user / assistant turns,
    some assistant turns with thinking or tool calls, some followed by a
    tool turn."""
    msgs = []
    if draw(st.booleans()):
        msgs.append({"role": "system", "content": draw(TEXT)})
    for i in range(draw(st.integers(1, 4))):
        msgs.append({"role": "user", "content": draw(TEXT)})
        if draw(st.booleans()):
            content = draw(TEXT)
            if draw(st.booleans()):
                content = f"<think>\n{draw(TEXT)}\n</think>\n\n{content}"
            msg = {"role": "assistant", "content": content}
            if draw(st.booleans()):
                msg["tool_calls"] = [draw(TOOL_CALL)]
            msgs.append(msg)
    return msgs


def _pair(template=None, family="llama"):
    return (jax_ct.ChatTemplateRenderer(template, family,
                                        now_fn=lambda: PINNED),
            ct.ChatTemplateRenderer(template, family,
                                    now_fn=lambda: PINNED))


def _both(jr, pr, **kw):
    """Each renderer's output, or its exception's type and message kind."""
    out = []
    for r in (jr, pr):
        try:
            out.append(r.render(**kw))
        except Exception as e:  # noqa: BLE001 -- compared below
            kind = e.message.split(":")[0] \
                if isinstance(e, InvalidRequestError) or type(e).__name__ \
                == "InvalidRequestError" else type(e).__name__
            out.append(("error", kind))
    return out


@pytest.mark.parametrize("name", sorted(jax_ct.DEFAULT_TEMPLATES))
@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(msgs=conversations(), gen=st.booleans())
def test_default_templates_match_jinja2(name, msgs, gen):
    jr, pr = _pair(jax_ct.DEFAULT_TEMPLATES[name])
    j, p = _both(jr, pr, messages=msgs, add_generation_prompt=gen)
    assert p == j


@pytest.mark.parametrize("family", ["llama", "qwen3", "gemma3", "other"])
def test_family_default_matches(family):
    jr, pr = _pair(None, family)
    msgs = [{"role": "user", "content": "hé {{ x }}"},
            {"role": "assistant", "content": "ok"}]
    assert pr.render(msgs) == jr.render(msgs)


@pytest.mark.parametrize("name", sorted(TEMPLATES))
@settings(max_examples=60, deadline=None)
@given(msgs=conversations(), gen=st.booleans(),
       tools=st.one_of(st.none(), st.lists(TOOL, min_size=1, max_size=2)),
       thinking=st.sampled_from([None, True, False]),
       builtin=st.booleans())
def test_templates_match_jinja2(name, msgs, gen, tools, thinking, builtin):
    jr, pr = _pair(TEMPLATES[name])
    kwargs = {}
    if thinking is not None:
        kwargs["enable_thinking"] = thinking
    if builtin:
        kwargs["builtin_tools"] = ["brave_search", "code_interpreter"]
    j, p = _both(jr, pr, messages=msgs, add_generation_prompt=gen,
                 tools=tools, chat_template_kwargs=kwargs or None,
                 bos_token="<s>")
    assert p == j


# Constructs one at a time: (template, context).
SNIPPETS = [
    ("{% for i in [1, 2] %}{% if i == 2 %}[{{ x }}]{% endif %}"
     "{% set x = i %}{% endfor %}|{{ x }}", {}),
    ("{% set x = 0 %}{% for i in [1, 2] %}[{{ x }}]{% set x = i %}[{{ x }}]"
     "{% endfor %}|{{ x }}", {}),
    ("{% set x = 0 %}{% if true %}{% set x = 5 %}{% endif %}{{ x }}", {}),
    ("{% set ns = namespace(a=1) %}{% for i in [1, 2] %}"
     "{% set ns.a = ns.a + i %}{% endfor %}{{ ns.a }}{{ ns }}", {}),
    ("{% for i in [1, 2, 3] if i > 1 %}{{ loop.index }}{{ i }}"
     "{{ loop.previtem }}{{ loop.nextitem }}{% endfor %}", {}),
    ("{% for i in [] %}x{% else %}empty{% endfor %}", {}),
    ("{% for i in range(5) %}{% if i == 1 %}{% continue %}{% endif %}"
     "{% if i == 3 %}{% break %}{% endif %}{{ i }}{% endfor %}", {}),
    ("{% for k, v in d | items %}{{ k }}={{ v }};{% endfor %}",
     {"d": {"a": 1, "é": [1, "ü"]}}),
    ("{{ d | tojson }}|{{ d | tojson(indent=2) }}|"
     "{{ d | tojson(ensure_ascii=False) }}",
     {"d": {"k": "é😀", "n": None, "l": [1.5, True]}}),
    ("{{ y }}|{{ y is defined }}|{{ y is iterable }}|{{ y | length }}|"
     "{{ y | default('dflt') }}|{{ '' | default('b', true) }}", {}),
    ("{{ none }}|{{ [1, 'a'] }}|{{ {'a': 1} }}|{{ 1.0 }}|{{ true }}|"
     "{{ (1, 2) }}|{{ () }}", {}),
    ("{{ d.items }}", {"d": {"items": 3}}),
    ("{{ d['items'] }}|{{ d.get('items') }}|{{ d.missing }}|"
     "{{ d['missing'] }}", {"d": {"items": 3}}),
    ("{{ 'a' if false }}|{{ 'a' if false else 'b' }}|"
     "{{ 1 if x is none else 2 }}", {"x": None}),
    ("{{ 'a\\nb\\u00e9\\t' }}{{ \"q'\" }}{{ 'ab' 'cd' }}", {}),
    ("{{ 5 is number }}{{ true is number }}{{ 'a' is sequence }}"
     "{{ {} is sequence }}{{ 3 is odd }}{{ 4 is even }}{{ 1 is integer }}"
     "{{ true is boolean }}{{ 'aB' is lower }}{{ x is mapping }}",
     {"x": {"a": 1}}),
    ("{{ 3 // 2 }}{{ 3 / 2 }}{{ 2 ** 3 }}{{ -3 | abs }}{{ - 2 | abs }}"
     "{{ 7 % 4 }}{{ 1 + 2 * 3 }}{{ (1 + 2) * 3 }}", {}),
    ("{{ 1 == 1.0 }}{{ 'a' ~ 1 ~ none }}{{ x ~ 'q' }}{{ 1 < 2 < 3 }}"
     "{{ 'b' in 'abc' }}{{ 'z' not in ['a'] }}{{ not 1 in [1] }}", {}),
    ("{{ [1, 2, 3][1:] }}{{ 'abc'[::-1] }}{{ 'abc'[-1] }}{{ x.0 }}"
     "{{ 'abcdef'[1:5:2] }}", {"x": [5]}),
    ("{{ x is defined and x }}|{{ x or 'alt' }}|{{ 0 and 1 }}", {}),
    ("a  {%- if true -%}  b  {%- endif %}  c\n  {#- gone -#}  d\n", {}),
    ("{{ '  pad  ' | trim }}|{{ 'xxhixx' | trim('x') }}|{{ 'a-b' | "
     "replace('-', '+') }}|{{ 'up' | upper }}{{ 'LO' | lower }}"
     "|{{ [3, 4] | first }}{{ [3, 4] | last }}",
     {}),
    ("{{ [1, 2, 3] | select('odd') | list }}{{ ['a', '', 'b'] | select "
     "| join('+') }}{{ xs | selectattr('on') | map(attribute='n') | join }}"
     "{{ xs | rejectattr('n', 'equalto', 2) | map(attribute='n') | list }}"
     "{{ [1, 2] | map('string') | join('-') }}",
     {"xs": [{"n": 1, "on": True}, {"n": 2, "on": False}]}),
    ("{{ 'a,b'.split(',') }}{{ ' x '.strip() }}{{ 'ab'.startswith('a') }}"
     "{{ 'x{}'.format(1) }}{{ s.endswith('!') }}", {"s": "hi!"}),
    ("{% set a, b = 1, 2 %}{{ a }}{{ b }}{% for x, y in [[1, 2], [3, 4]] %}"
     "{{ x + y }}{% endfor %}", {}),
    ("{{ strftime_now('%Y-%m-%d %H:%M') }}|{{ dict(a=1) }}|"
     "{{ range(2, 8, 3) | list }}", {}),
    ("{% for m in ms %}{% for c in m %}{{ loop.index }}{{ c }}{% endfor %}"
     "{{ loop.index }};{% endfor %}", {"ms": ["ab", "c"]}),
    ("{{ loop }}{% for i in [1] %}{{ loop.cycle('a', 'b') }}{{ loop.depth }}"
     "{% endfor %}", {}),
    ("{{- 'x' -}}   \n  {{ 'y' }}\r\n{{ 'z' }}\n", {}),
]


@pytest.mark.parametrize("i", range(len(SNIPPETS)))
def test_constructs_match_jinja2(i):
    src, ctx = SNIPPETS[i]
    jr, pr = _pair(src)
    msgs = ctx.pop("messages", [])
    j, p = _both(jr, pr, messages=msgs, chat_template_kwargs=ctx or None)
    ctx["messages"] = msgs
    assert p == j, src


# Render failures: both raise InvalidRequestError ("chat template render
# failed"); python errors outside jinja2's TemplateError stay that type.
FAILURES = [
    ("{{ y.z }}", {}),
    ("{{ (x.y) + 'a' }}", {"x": {}}),
    ("{{ raise_exception('boom') }}", {}),
    ("{% set n = 1 %}{% set n.a = 2 %}", {}),
    ("{{ x | items | list }}", {"x": 3}),
    ("{{ 'a' + 1 }}", {}),
]


@pytest.mark.parametrize("i", range(len(FAILURES)))
def test_render_failures_match(i):
    src, ctx = FAILURES[i]
    jr, pr = _pair(src)
    j, p = _both(jr, pr, messages=[], chat_template_kwargs=ctx or None)
    assert isinstance(j, tuple) and p == j


# Outside the subset (or malformed): refused when the template loads.
REFUSED = [
    "{% macro m(x) %}{{ x }}{% endmacro %}{{ m(1) }}",
    "{% raw %}{{ x }}{% endraw %}",
    "{% filter upper %}x{% endfilter %}",
    "{% for m in ms recursive %}{{ loop(m) }}{% endfor %}",
    "{{ x | dictsort }}",
    "{{ x is escaped }}",
    "{{ lipsum() }}",
    "{% break %}",
    "{% if x %}no end",
    "{{ 'unclosed }}",
    "{% generation %}x{% endgeneration %}",
    "{% set x %}block set{% endset %}",
    "{% include 'other' %}",
]


@pytest.mark.parametrize("src", REFUSED)
def test_unsupported_constructs_refused_at_load(src):
    with pytest.raises(InvalidRequestError, match="bad chat template"):
        ct.ChatTemplateRenderer(src)


# Malformed for jinja2 too (a `break` outside a loop, refused here, is a
# Python SyntaxError in jinja2, outside its TemplateError).
@pytest.mark.parametrize("src", ["{% if x %}no end", "{{ 'unclosed }}",
                                 "{% generation %}x{% endgeneration %}"])
def test_malformed_templates_refused_by_jinja2_too(src):
    from ferrum_tpu.types import InvalidRequestError as JaxInvalid
    with pytest.raises(JaxInvalid, match="bad chat template"):
        jax_ct.ChatTemplateRenderer(src)


# --- tool calls ----------------------------------------------------------

CALL_TEXT = st.one_of(
    TEXT,
    st.builds(lambda n, a, pre, post: f'{pre}<tool_call>\n{{"name": "{n}", '
              f'"arguments": {a}}}\n</tool_call>{post}',
              st.sampled_from(["get_weather", "other", "搜索"]),
              st.sampled_from(['{"city": "Köln"}', '"raw"', '[1, 2]', '3',
                               '{"a": {"b": "}"}}']), TEXT, TEXT),
    st.builds(lambda n, a, pre: f'{pre}```json\n{{"name": "{n}", '
              f'"parameters": {a}}}\n```',
              st.sampled_from(["get_weather", "x"]),
              st.sampled_from(['{"q": "a\\"b"}', '{}', 'null']), TEXT),
    st.builds(lambda a, b: f'{{"name": "{a}", "arguments": {{}}}} and '
              f'{{"name": "{b}", "arguments": {{"k": 1}}}}',
              st.sampled_from(["get_weather", "搜索"]),
              st.sampled_from(["get_weather", "zz"])),
)


def _strip_ids(calls):
    for c in calls:
        assert c["id"].startswith("call_") and len(c["id"]) == 29
    return [{k: v for k, v in c.items() if k != "id"} for c in calls]


@settings(max_examples=200, deadline=None)
@given(text=CALL_TEXT,
       declared=st.one_of(st.none(), st.just(["get_weather", "搜索"])),
       required=st.one_of(st.none(), st.just("get_weather")))
def test_parse_tool_calls_matches_jax(text, declared, required):
    jc, jcalls = jax_tc.parse_tool_calls(text, declared, required)
    pc, pcalls = tc.parse_tool_calls(text, declared, required)
    assert pc == jc
    assert _strip_ids(pcalls) == _strip_ids(jcalls)
