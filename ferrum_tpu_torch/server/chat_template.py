"""Chat template rendering without jinja2.

Port of `ferrum_tpu/server/chat_template.py`. The card's machine has no
jinja2, so this module carries its own renderer for the Jinja subset
that HF chat templates use, rendering what the JAX package's
`jinja2.Environment` (keep_trailing_newline, no block trimming, the
loopcontrols extension, `tojson` as `json.dumps(value, **kwargs)`, a
pinned `strftime_now`) renders:

  * whitespace control `{%- -%}`, `{{- -}}`, `{#- -#}`;
  * `for` (tuple targets, a loop filter `if`, `else`, the `loop`
    object: index, index0, revindex, revindex0, first, last, length,
    previtem, nextitem, cycle), `if` / `elif` / `else`, `set` (names,
    name tuples, namespace attributes), `break`, `continue`;
  * expressions: literals (strings with Python escapes, ints, floats,
    true / false / none, lists, tuples, dicts), `~`, arithmetic,
    comparisons, `in` / `not in`, `not` / `and` / `or`, conditional
    expressions, subscripts and slices, attribute access that falls
    back to the key (`message.role`) and calls of Python methods
    (`content.startswith(...)`, `.strip()`, `.split()`, `.items()`);
  * globals `range`, `dict`, `namespace`, `strftime_now` and
    `raise_exception`;
  * the tests and filters in TESTS and FILTERS.

Scoping is Jinja's: each loop iteration has its own scope over the
enclosing one (a `set` inside a loop does not outlive its iteration;
`namespace` attributes do), and `if` opens none. Undefined names follow
jinja2's default `Undefined`: they print as "", are false, iterate
empty and have length 0; an attribute, item, call or arithmetic on one
fails the render.

A construct outside this subset (macros, call / filter / raw / with
blocks, include / import / extends, recursive loops, a filter or test
not listed, `lipsum` / `cycler` / `joiner`) raises
InvalidRequestError("bad chat template: ...") when the template loads,
where the JAX package raises on a jinja2 TemplateError; it is never
rendered as something else. A failure while rendering (an undefined
value used, `raise_exception`) raises InvalidRequestError("chat
template render failed: ..."). The JAX package defines no
`raise_exception`: calling it there fails as an undefined call, the
same error class and status.
"""

from __future__ import annotations

import datetime
import json
import numbers
import re
from collections import abc
from typing import Any, Callable, Dict, List, Optional

from ..types import InvalidRequestError


DEFAULT_TEMPLATES: Dict[str, str] = {
    # ChatML (qwen2/qwen3 family default). Newlines emitted via
    # expressions so block trimming can't eat them.
    "chatml": (
        "{%- for message in messages -%}"
        "{{ '<|im_start|>' + message.role + '\\n' + message.content"
        " + '<|im_end|>\\n' }}"
        "{%- endfor -%}"
        "{%- if add_generation_prompt -%}"
        "{{ '<|im_start|>assistant\\n' }}{%- endif -%}"
    ),
    # Llama-3 instruct
    "llama3": (
        "{{- '<|begin_of_text|>' -}}"
        "{%- for message in messages -%}"
        "{{ '<|start_header_id|>' + message.role + '<|end_header_id|>\\n\\n'"
        " + message.content + '<|eot_id|>' }}"
        "{%- endfor -%}"
        "{%- if add_generation_prompt -%}"
        "{{ '<|start_header_id|>assistant<|end_header_id|>\\n\\n' }}"
        "{%- endif -%}"
    ),
    # Gemma
    "gemma": (
        "{{- '<bos>' -}}"
        "{%- for message in messages -%}"
        "{%- set role = 'model' if message.role == 'assistant' "
        "else message.role -%}"
        "{{ '<start_of_turn>' + role + '\\n' + message.content"
        " + '<end_of_turn>\\n' }}"
        "{%- endfor -%}"
        "{%- if add_generation_prompt -%}"
        "{{ '<start_of_turn>model\\n' }}{%- endif -%}"
    ),
    # Plain fallback
    "plain": (
        "{%- for message in messages -%}"
        "{{ message.role + ': ' + message.content + '\\n' }}"
        "{%- endfor -%}"
        "{%- if add_generation_prompt -%}{{ 'assistant: ' }}{%- endif -%}"
    ),
}

_FAMILY_DEFAULT = {
    "qwen2": "chatml", "qwen3": "chatml", "qwen3_moe": "chatml",
    "llama": "llama3", "mistral": "llama3", "gemma3": "gemma",
}


class TemplateSyntaxError(Exception):
    """The template uses a construct outside the subset, or is malformed."""


class TemplateRenderError(Exception):
    """A render failed the way jinja2's TemplateError would."""


# ---------------------------------------------------------------------------
# Runtime values
# ---------------------------------------------------------------------------

class Undefined:
    """jinja2's default Undefined: "" when printed, false, empty; any
    attribute, item, call or arithmetic fails the render."""

    __slots__ = ("_name",)

    def __init__(self, name: str = "value"):
        self._name = name

    def _fail(self, *args, **kwargs):
        raise TemplateRenderError(f"{self._name!r} is undefined")

    def __getattr__(self, name):
        if name[:2] == "__":
            raise AttributeError(name)
        self._fail()

    __add__ = __radd__ = __sub__ = __rsub__ = __mul__ = __rmul__ = _fail
    __truediv__ = __rtruediv__ = __floordiv__ = __rfloordiv__ = _fail
    __mod__ = __rmod__ = __pos__ = __neg__ = __call__ = _fail
    __getitem__ = __lt__ = __le__ = __gt__ = __ge__ = __int__ = _fail
    __float__ = __pow__ = __rpow__ = _fail

    def __eq__(self, other):
        return type(self) is type(other)

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return id(type(self))

    def __str__(self):
        return ""

    def __len__(self):
        return 0

    def __iter__(self):
        return iter(())

    def __bool__(self):
        return False

    def __repr__(self):
        return "Undefined"


class Namespace:
    """`namespace(...)`: the one object whose attributes `set` assigns."""

    def __init__(self, *args, **kwargs):
        self.__dict__["_attrs"] = dict(*args, **kwargs)

    def __getattr__(self, name):
        try:
            return self.__dict__["_attrs"][name]
        except KeyError:
            raise AttributeError(name) from None

    def __repr__(self):
        return f"<Namespace {self.__dict__['_attrs']!r}>"


def _str(v: Any) -> str:
    return "" if isinstance(v, Undefined) else str(v)


def _getattr(obj: Any, name: str) -> Any:
    """Jinja's `obj.name`: the attribute, else the item, else Undefined."""
    if isinstance(obj, Undefined):
        obj._fail()
    try:
        return getattr(obj, name)
    except AttributeError:
        pass
    try:
        return obj[name]
    except (TypeError, LookupError, AttributeError):
        return Undefined(name)


def _getitem(obj: Any, key: Any) -> Any:
    """Jinja's `obj[key]`: the item, else (for a str key) the attribute,
    else Undefined."""
    if isinstance(obj, Undefined):
        obj._fail()
    try:
        return obj[key]
    except (AttributeError, TypeError, LookupError):
        if isinstance(key, str):
            try:
                return getattr(obj, key)
            except AttributeError:
                pass
        return Undefined(repr(key))


# --- tests ---------------------------------------------------------------

def _t_sequence(v):
    try:
        len(v)
        v.__getitem__
    except Exception:
        return False
    return True


def _t_iterable(v):
    try:
        iter(v)
    except TypeError:
        return False
    return True


TESTS: Dict[str, Callable[..., bool]] = {
    "defined": lambda v: not isinstance(v, Undefined),
    "undefined": lambda v: isinstance(v, Undefined),
    "none": lambda v: v is None,
    "string": lambda v: isinstance(v, str),
    "mapping": lambda v: isinstance(v, abc.Mapping),
    "iterable": _t_iterable,
    "sequence": _t_sequence,
    "number": lambda v: isinstance(v, numbers.Number),
    "integer": lambda v: isinstance(v, int) and v is not True
    and v is not False,
    "float": lambda v: isinstance(v, float),
    "boolean": lambda v: v is True or v is False,
    "true": lambda v: v is True,
    "false": lambda v: v is False,
    "callable": callable,
    "lower": lambda v: str(v).islower(),
    "upper": lambda v: str(v).isupper(),
    "odd": lambda v: v % 2 == 1,
    "even": lambda v: v % 2 == 0,
    "divisibleby": lambda v, n: v % n == 0,
    "sameas": lambda v, o: v is o,
    "in": lambda v, seq: v in seq,
    "eq": lambda a, b: a == b, "equalto": lambda a, b: a == b,
    "==": lambda a, b: a == b,
    "ne": lambda a, b: a != b, "!=": lambda a, b: a != b,
    "lt": lambda a, b: a < b, "lessthan": lambda a, b: a < b,
    "<": lambda a, b: a < b, "le": lambda a, b: a <= b,
    "<=": lambda a, b: a <= b,
    "gt": lambda a, b: a > b, "greaterthan": lambda a, b: a > b,
    ">": lambda a, b: a > b, "ge": lambda a, b: a >= b,
    ">=": lambda a, b: a >= b,
}


# --- filters -------------------------------------------------------------

def _f_items(v):
    """A generator, as jinja2's: a non-mapping fails when iterated."""
    if isinstance(v, Undefined):
        return
    if not isinstance(v, abc.Mapping):
        raise TypeError("Can only get item pairs from a mapping.")
    yield from v.items()


def _f_default(v, default_value="", boolean=False):
    if isinstance(v, Undefined) or (boolean and not v):
        return default_value
    return v


def _f_first(v):
    for x in v:
        return x
    return Undefined("first")


def _f_last(v):
    for x in reversed(v):
        return x
    return Undefined("last")


def _f_join(v, d="", attribute=None):
    if attribute is not None:
        v = [_getattr(x, attribute) for x in v]
    return _str(d).join(_str(x) for x in v)


def _f_replace(s, old, new, count=None):
    return _str(s).replace(_str(old), _str(new),
                           -1 if count is None else count)


def _select(v, args, want):
    if not args:
        return (x for x in v if bool(x) == want)
    name, rest = args[0], args[1:]
    test = TESTS[name]
    return (x for x in v if bool(test(x, *rest)) == want)


def _selectattr(v, args, want):
    attr, rest = args[0], args[1:]
    if not rest:
        return (x for x in v if bool(_getattr(x, attr)) == want)
    test = TESTS[rest[0]]
    return (x for x in v if bool(test(_getattr(x, attr), *rest[1:])) == want)


def _f_map(v, *args, attribute=None, default=None):
    if attribute is not None:
        def one(x):
            r = _getattr(x, attribute)
            return default if default is not None \
                and isinstance(r, Undefined) else r
        return (one(x) for x in v)
    func = FILTERS[args[0]]
    return (func(x, *args[1:]) for x in v)


FILTERS: Dict[str, Callable[..., Any]] = {
    "length": len, "count": len,
    "trim": lambda v, chars=None: _str(v).strip(chars),
    "items": _f_items,
    "default": _f_default, "d": _f_default,
    "tojson": lambda v, **kw: json.dumps(v, **kw),
    "upper": lambda v: _str(v).upper(),
    "lower": lambda v: _str(v).lower(),
    "string": _str,
    "list": list,
    "first": _f_first,
    "last": _f_last,
    "join": _f_join,
    "replace": _f_replace,
    "abs": abs,
    "select": lambda v, *a: _select(v, a, True),
    "reject": lambda v, *a: _select(v, a, False),
    "selectattr": lambda v, *a: _selectattr(v, a, True),
    "rejectattr": lambda v, *a: _selectattr(v, a, False),
    "map": _f_map,
}

# Jinja's default globals that the subset leaves out.
_UNSUPPORTED_GLOBALS = {"lipsum", "cycler", "joiner"}


class _Loop:
    """The `loop` object of a for loop over a list."""

    def __init__(self, items: list):
        self._items = items
        self.length = len(items)
        self.index0 = 0

    def _at(self, i):
        return self._items[i] if 0 <= i < self.length \
            else Undefined("loop item")

    index = property(lambda self: self.index0 + 1)
    revindex = property(lambda self: self.length - self.index0)
    revindex0 = property(lambda self: self.length - self.index0 - 1)
    first = property(lambda self: self.index0 == 0)
    last = property(lambda self: self.index0 == self.length - 1)
    previtem = property(lambda self: self._at(self.index0 - 1))
    nextitem = property(lambda self: self._at(self.index0 + 1))
    depth = 1
    depth0 = 0

    def cycle(self, *args):
        return args[self.index0 % len(args)]


class _Break(Exception):
    pass


class _Continue(Exception):
    pass


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_NAME = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
_STRING = re.compile(r"('([^'\\]*(?:\\.[^'\\]*)*)'|\"([^\"\\]*(?:\\.[^\"\\]*)*)\")",
                     re.S)
_FLOAT = re.compile(r"(?<!\.)(\d+_)*\d+((\.(\d+_)*\d+)?[eE][+\-]?(\d+_)*\d+"
                    r"|\.(\d+_)*\d+)")
_INTEGER = re.compile(r"(\d+_)*\d+")
_OPERATORS = ("//", "**", "==", "!=", ">=", "<=", "+", "-", "/", "*", "%",
              "~", "[", "]", "(", ")", "{", "}", ".", ",", ":", "|", "=",
              "<", ">")
_NEWLINES = re.compile(r"\r\n|\r|\n")


def _normalize_newlines(s: str) -> str:
    return _NEWLINES.sub("\n", s)


class _Tok:
    __slots__ = ("kind", "value")

    def __init__(self, kind: str, value: Any = None):
        self.kind = kind        # data | var | block | end | name | str |
        self.value = value      # num | op | eof

    def __repr__(self):
        return f"{self.kind}:{self.value!r}"


def _lex(src: str) -> List[_Tok]:
    """Tokens: `data` (text, whitespace control applied), `var` / `block`
    (a tag's start), the tag's expression tokens, `end` (its close)."""
    toks: List[_Tok] = []
    i, n = 0, len(src)
    strip_next = False
    while i < n:
        j = i
        while True:
            j = src.find("{", j)
            if j < 0 or j + 1 >= n or src[j + 1] in "{%#":
                break
            j += 1
        data = src[i:] if j < 0 or j + 1 >= n else src[i:j]
        start = n if j < 0 or j + 1 >= n else j
        lstrip = start < n and src[start + 2:start + 3] == "-"
        if strip_next:
            data = data.lstrip()
        if lstrip:
            data = data.rstrip()
        if data:
            toks.append(_Tok("data", _normalize_newlines(data)))
        if start >= n:
            break
        kind = src[start + 1]
        i = start + 2
        if src[i:i + 1] in ("-", "+"):
            i += 1
        if kind == "#":
            end = src.find("#}", i)
            if end < 0:
                raise TemplateSyntaxError("unclosed comment")
            strip_next = src[end - 1] == "-" and end - 1 >= i
            i = end + 2
            continue
        closer = "}}" if kind == "{" else "%}"
        toks.append(_Tok("var" if kind == "{" else "block"))
        while True:
            if i >= n:
                raise TemplateSyntaxError(f"unclosed tag, expected {closer!r}")
            if src.startswith("-" + closer, i):
                strip_next = True
                i += 3
                break
            if src.startswith(closer, i):
                strip_next = False
                i += 2
                break
            c = src[i]
            if c.isspace():
                i += 1
                continue
            m = _STRING.match(src, i)
            if m:
                body = _normalize_newlines(m.group(0)[1:-1])
                toks.append(_Tok("str", body.encode(
                    "ascii", "backslashreplace").decode("unicode-escape")))
                i = m.end()
                continue
            m = _FLOAT.match(src, i)
            if m:
                toks.append(_Tok("num", float(m.group(0).replace("_", ""))))
                i = m.end()
                continue
            m = _INTEGER.match(src, i)
            if m:
                toks.append(_Tok("num", int(m.group(0).replace("_", ""))))
                i = m.end()
                continue
            m = _NAME.match(src, i)
            if m:
                toks.append(_Tok("name", m.group(0)))
                i = m.end()
                continue
            op = next((o for o in _OPERATORS if src.startswith(o, i)), None)
            if op is None:
                raise TemplateSyntaxError(f"unexpected character {c!r}")
            toks.append(_Tok("op", op))
            i += len(op)
        toks.append(_Tok("end"))
    toks.append(_Tok("eof"))
    return toks


# ---------------------------------------------------------------------------
# Parser: statements as tuples, expressions as tuples (op, ...)
# ---------------------------------------------------------------------------

_CONSTS = {"true": True, "false": False, "none": None,
           "True": True, "False": False, "None": None}
_UNSUPPORTED_TAGS = {"macro", "call", "filter", "raw", "with", "include",
                     "import", "from", "extends", "block", "autoescape",
                     "do", "trans", "endraw"}
_COMPARE_OPS = {"==", "!=", ">", ">=", "<", "<="}


class _Parser:
    def __init__(self, toks: List[_Tok]):
        self.toks = toks
        self.pos = 0
        self.loop_depth = 0

    # --- token helpers ---
    @property
    def cur(self) -> _Tok:
        return self.toks[self.pos]

    def next(self) -> _Tok:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def is_op(self, *ops) -> bool:
        return self.cur.kind == "op" and self.cur.value in ops

    def is_name(self, *names) -> bool:
        return self.cur.kind == "name" and self.cur.value in names

    def expect_op(self, op: str) -> None:
        if not self.is_op(op):
            raise TemplateSyntaxError(f"expected {op!r}, got {self.cur!r}")
        self.pos += 1

    def expect_name(self, name: Optional[str] = None) -> str:
        if self.cur.kind != "name" or (name and self.cur.value != name):
            raise TemplateSyntaxError(
                f"expected {name or 'a name'}, got {self.cur!r}")
        return self.next().value

    def expect_end(self) -> None:
        if self.cur.kind != "end":
            raise TemplateSyntaxError(f"expected the end of the tag, got "
                                      f"{self.cur!r}")
        self.pos += 1

    # --- statements ---
    def parse_body(self, end_tags=()) -> tuple:
        """Nodes up to a block tag named in `end_tags` (left unread:
        the caller reads its name) or the end of the template."""
        body = []
        while True:
            t = self.cur
            if t.kind == "eof":
                if end_tags:
                    raise TemplateSyntaxError(
                        f"missing {' or '.join(end_tags)}")
                return body, None
            if t.kind == "data":
                self.next()
                body.append(("data", t.value))
            elif t.kind == "var":
                self.next()
                body.append(("out", self.parse_tuple()))
                self.expect_end()
            elif t.kind == "block":
                self.next()
                name = self.expect_name()
                if name in end_tags:
                    return body, name
                body.append(self.parse_statement(name))
            else:
                raise TemplateSyntaxError(f"unexpected {t!r}")

    def parse_statement(self, name: str):
        if name == "for":
            return self.parse_for()
        if name == "if":
            return self.parse_if()
        if name == "set":
            return self.parse_set()
        if name in ("break", "continue"):
            if not self.loop_depth:
                raise TemplateSyntaxError(f"{name!r} outside loop")
            self.expect_end()
            return (name,)
        if name in _UNSUPPORTED_TAGS:
            raise TemplateSyntaxError(f"the {name!r} tag is not supported")
        raise TemplateSyntaxError(f"unknown tag {name!r}")

    def parse_target(self):
        names = [self.expect_name()]
        while self.is_op(","):
            self.next()
            if self.cur.kind != "name" or self.is_name("in"):
                break
            names.append(self.expect_name())
        return names[0] if len(names) == 1 else tuple(names)

    def parse_for(self):
        target = self.parse_target()
        self.expect_name("in")
        it = self.parse_tuple(with_condexpr=False)
        cond = None
        if self.is_name("if"):
            self.next()
            cond = self.parse_expr()
        if self.is_name("recursive"):
            raise TemplateSyntaxError("recursive loops are not supported")
        self.expect_end()
        self.loop_depth += 1
        body, tag = self.parse_body(("endfor", "else"))
        self.loop_depth -= 1
        else_body = []
        if tag == "else":
            self.expect_end()
            else_body, _ = self.parse_body(("endfor",))
        self.expect_end()
        return ("for", target, it, cond, body, else_body)

    def parse_if(self):
        branches = []
        cond = self.parse_tuple(with_condexpr=False)
        self.expect_end()
        while True:
            body, tag = self.parse_body(("elif", "else", "endif"))
            branches.append((cond, body))
            if tag == "elif":
                cond = self.parse_tuple(with_condexpr=False)
                self.expect_end()
                continue
            self.expect_end()
            if tag == "else":
                else_body, _ = self.parse_body(("endif",))
                self.expect_end()
                return ("if", branches, else_body)
            return ("if", branches, [])

    def parse_set(self):
        name = self.expect_name()
        if self.is_op("."):
            self.next()
            target = ("attr", name, self.expect_name())
        else:
            target = ("name", name)
            if self.is_op(","):
                self.pos -= 1
                target = ("names", self.parse_target())
        if not self.is_op("="):
            raise TemplateSyntaxError("block set is not supported")
        self.next()
        value = self.parse_tuple()
        self.expect_end()
        return ("set", target, value)

    # --- expressions ---
    def parse_tuple(self, with_condexpr=True):
        parse = self.parse_expr if with_condexpr else self.parse_or
        items = [parse()]
        if not self.is_op(","):
            return items[0]
        while self.is_op(","):
            self.next()
            if self.cur.kind == "end" or self.is_op(")") \
                    or self.is_name("if", "recursive"):
                break
            items.append(parse())
        return ("tuple", items)

    def parse_expr(self):
        expr = self.parse_or()
        while self.is_name("if"):
            self.next()
            test = self.parse_or()
            other = None
            if self.is_name("else"):
                self.next()
                other = self.parse_expr()
            expr = ("cond", test, expr, other)
        return expr

    def parse_or(self):
        left = self.parse_and()
        while self.is_name("or"):
            self.next()
            left = ("or", left, self.parse_and())
        return left

    def parse_and(self):
        left = self.parse_not()
        while self.is_name("and"):
            self.next()
            left = ("and", left, self.parse_not())
        return left

    def parse_not(self):
        if self.is_name("not"):
            self.next()
            return ("not", self.parse_not())
        return self.parse_compare()

    def parse_compare(self):
        expr = self.parse_math1()
        ops = []
        while True:
            if self.cur.kind == "op" and self.cur.value in _COMPARE_OPS:
                op = self.next().value
            elif self.is_name("in"):
                self.next()
                op = "in"
            elif self.is_name("not") and self.toks[self.pos + 1].kind \
                    == "name" and self.toks[self.pos + 1].value == "in":
                self.pos += 2
                op = "notin"
            else:
                break
            ops.append((op, self.parse_math1()))
        return ("compare", expr, ops) if ops else expr

    def parse_math1(self):
        left = self.parse_concat()
        while self.is_op("+", "-"):
            op = self.next().value
            left = ("bin", op, left, self.parse_concat())
        return left

    def parse_concat(self):
        args = [self.parse_math2()]
        while self.is_op("~"):
            self.next()
            args.append(self.parse_math2())
        return ("concat", args) if len(args) > 1 else args[0]

    def parse_math2(self):
        left = self.parse_pow()
        while self.is_op("*", "/", "//", "%"):
            op = self.next().value
            left = ("bin", op, left, self.parse_pow())
        return left

    def parse_pow(self):
        left = self.parse_unary()
        while self.is_op("**"):
            self.next()
            left = ("bin", "**", left, self.parse_unary())
        return left

    def parse_unary(self, with_filter=True):
        if self.is_op("-"):
            self.next()
            node = ("neg", self.parse_unary(False))
        elif self.is_op("+"):
            self.next()
            node = ("pos", self.parse_unary(False))
        else:
            node = self.parse_primary()
        node = self.parse_postfix(node)
        if with_filter:
            node = self.parse_filter_expr(node)
        return node

    def parse_primary(self):
        t = self.cur
        if t.kind == "name":
            self.next()
            if t.value in _CONSTS:
                return ("const", _CONSTS[t.value])
            if t.value in _UNSUPPORTED_GLOBALS:
                raise TemplateSyntaxError(f"{t.value!r} is not supported")
            return ("name", t.value)
        if t.kind == "str":
            parts = [self.next().value]
            while self.cur.kind == "str":
                parts.append(self.next().value)
            return ("const", "".join(parts))
        if t.kind == "num":
            self.next()
            return ("const", t.value)
        if self.is_op("("):
            self.next()
            if self.is_op(")"):
                self.next()
                return ("tuple", [])
            node = self.parse_tuple()
            self.expect_op(")")
            return node
        if self.is_op("["):
            self.next()
            items = []
            while not self.is_op("]"):
                if items:
                    self.expect_op(",")
                    if self.is_op("]"):
                        break
                items.append(self.parse_expr())
            self.next()
            return ("list", items)
        if self.is_op("{"):
            self.next()
            items = []
            while not self.is_op("}"):
                if items:
                    self.expect_op(",")
                    if self.is_op("}"):
                        break
                key = self.parse_expr()
                self.expect_op(":")
                items.append((key, self.parse_expr()))
            self.next()
            return ("dict", items)
        raise TemplateSyntaxError(f"unexpected {t!r}")

    def parse_postfix(self, node):
        while True:
            if self.is_op("."):
                self.next()
                t = self.next()
                if t.kind == "name":
                    node = ("getattr", node, t.value)
                elif t.kind == "num" and isinstance(t.value, int):
                    node = ("getitem", node, ("const", t.value))
                else:
                    raise TemplateSyntaxError("expected an attribute name")
            elif self.is_op("["):
                self.next()
                node = ("getitem", node, self.parse_subscript())
                self.expect_op("]")
            elif self.is_op("("):
                node = ("call", node) + self.parse_call_args()
            else:
                return node

    def parse_subscript(self):
        parts: List[Any] = [None]
        if not self.is_op(":"):
            parts[0] = self.parse_expr()
            if not self.is_op(":"):
                return parts[0]
        while self.is_op(":") and len(parts) < 3:
            self.next()
            parts.append(None if self.is_op(":", "]") else self.parse_expr())
        while len(parts) < 3:
            parts.append(None)
        return ("slice", parts)

    def parse_call_args(self):
        self.expect_op("(")
        args, kwargs = [], []
        while not self.is_op(")"):
            if args or kwargs:
                self.expect_op(",")
                if self.is_op(")"):
                    break
            if self.is_op("*", "**"):
                raise TemplateSyntaxError("*args / **kwargs are not supported")
            if self.cur.kind == "name" and self.toks[self.pos + 1].kind \
                    == "op" and self.toks[self.pos + 1].value == "=":
                key = self.next().value
                self.next()
                kwargs.append((key, self.parse_expr()))
            else:
                if kwargs:
                    raise TemplateSyntaxError(
                        "positional argument after keyword argument")
                args.append(self.parse_expr())
        self.next()
        return (args, kwargs)

    def parse_filter_expr(self, node):
        while True:
            if self.is_op("|"):
                self.next()
                name = self.expect_name()
                while self.is_op("."):
                    self.next()
                    name += "." + self.expect_name()
                if name not in FILTERS:
                    raise TemplateSyntaxError(
                        f"the {name!r} filter is not supported")
                args = self.parse_call_args() if self.is_op("(") \
                    else ([], [])
                node = ("filter", name, node) + args
            elif self.is_name("is"):
                self.next()
                negate = False
                if self.is_name("not"):
                    self.next()
                    negate = True
                name = self.expect_name()
                if name not in TESTS:
                    raise TemplateSyntaxError(
                        f"the {name!r} test is not supported")
                args: tuple = ([], [])
                if self.is_op("("):
                    args = self.parse_call_args()
                elif (self.cur.kind in ("name", "str", "num")
                      or self.is_op("[", "{")) \
                        and not self.is_name("else", "or", "and"):
                    if self.is_name("is"):
                        raise TemplateSyntaxError(
                            "You cannot chain multiple tests with is")
                    args = ([self.parse_postfix(self.parse_primary())], [])
                node = ("test", name, node) + args
                if negate:
                    node = ("not", node)
            elif self.is_op("("):
                node = ("call", node) + self.parse_call_args()
            else:
                return node


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------

class _Scope:
    __slots__ = ("vars", "parent")

    def __init__(self, parent: Optional["_Scope"] = None):
        self.vars: Dict[str, Any] = {}
        self.parent = parent

    def lookup(self, name: str) -> Any:
        s = self
        while s is not None:
            if name in s.vars:
                return s.vars[name]
            s = s.parent
        return Undefined(name)


_BINOPS = {
    "+": lambda a, b: a + b, "-": lambda a, b: a - b,
    "*": lambda a, b: a * b, "/": lambda a, b: a / b,
    "//": lambda a, b: a // b, "%": lambda a, b: a % b,
    "**": lambda a, b: a ** b,
}
_CMPOPS = {
    "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
    ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
    "<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
    "in": lambda a, b: a in b, "notin": lambda a, b: a not in b,
}


def _eval(node, scope: _Scope) -> Any:
    op = node[0]
    if op == "const":
        return node[1]
    if op == "name":
        return scope.lookup(node[1])
    if op == "getattr":
        return _getattr(_eval(node[1], scope), node[2])
    if op == "getitem":
        obj = _eval(node[1], scope)
        key = node[2]
        if key[0] == "slice":
            lo, hi, step = (None if p is None else _eval(p, scope)
                            for p in key[1])
            return _getitem(obj, slice(lo, hi, step))
        return _getitem(obj, _eval(key, scope))
    if op == "call":
        func = _eval(node[1], scope)
        args = [_eval(a, scope) for a in node[2]]
        kwargs = {k: _eval(v, scope) for k, v in node[3]}
        return func(*args, **kwargs)
    if op == "filter":
        args = [_eval(a, scope) for a in node[3]]
        kwargs = {k: _eval(v, scope) for k, v in node[4]}
        return FILTERS[node[1]](_eval(node[2], scope), *args, **kwargs)
    if op == "test":
        args = [_eval(a, scope) for a in node[3]]
        kwargs = {k: _eval(v, scope) for k, v in node[4]}
        return TESTS[node[1]](_eval(node[2], scope), *args, **kwargs)
    if op == "not":
        return not _eval(node[1], scope)
    if op == "and":
        left = _eval(node[1], scope)
        return _eval(node[2], scope) if left else left
    if op == "or":
        left = _eval(node[1], scope)
        return left if left else _eval(node[2], scope)
    if op == "cond":
        if _eval(node[1], scope):
            return _eval(node[2], scope)
        return Undefined("else") if node[3] is None \
            else _eval(node[3], scope)
    if op == "compare":
        left = _eval(node[1], scope)
        for cop, rnode in node[2]:
            right = _eval(rnode, scope)
            if not _CMPOPS[cop](left, right):
                return False
            left = right
        return True
    if op == "bin":
        return _BINOPS[node[1]](_eval(node[2], scope), _eval(node[3], scope))
    if op == "concat":
        return "".join(_str(_eval(a, scope)) for a in node[1])
    if op == "neg":
        return -_eval(node[1], scope)
    if op == "pos":
        return +_eval(node[1], scope)
    if op == "list":
        return [_eval(a, scope) for a in node[1]]
    if op == "tuple":
        return tuple(_eval(a, scope) for a in node[1])
    if op == "dict":
        return {_eval(k, scope): _eval(v, scope) for k, v in node[1]}
    raise TemplateRenderError(f"cannot evaluate {op!r}")


def _assign(scope: _Scope, target, value) -> None:
    if isinstance(target, tuple):
        values = list(value)
        if len(values) != len(target):
            raise TemplateRenderError(
                f"cannot unpack {len(values)} values into {len(target)}")
        for name, v in zip(target, values):
            scope.vars[name] = v
    else:
        scope.vars[target] = value


def _run(body, scope: _Scope, out: List[str]) -> None:
    for node in body:
        kind = node[0]
        if kind == "data":
            out.append(node[1])
        elif kind == "out":
            out.append(_str(_eval(node[1], scope)))
        elif kind == "if":
            for cond, branch in node[1]:
                if _eval(cond, scope):
                    _run(branch, scope, out)
                    break
            else:
                _run(node[2], scope, out)
        elif kind == "for":
            _, target, it, cond, loop_body, else_body = node
            items = _eval(it, scope)
            if cond is not None:
                kept = []
                for x in items:
                    inner = _Scope(scope)
                    _assign(inner, target, x)
                    if _eval(cond, inner):
                        kept.append(x)
                items = kept
            else:
                items = list(items)
            loop = _Loop(items)
            for i, x in enumerate(items):
                inner = _Scope(scope)
                _assign(inner, target, x)
                loop.index0 = i
                inner.vars["loop"] = loop
                try:
                    _run(loop_body, inner, out)
                except _Continue:
                    continue
                except _Break:
                    break
            if not items:
                _run(else_body, scope, out)
        elif kind == "set":
            target, value = node[1], _eval(node[2], scope)
            if target[0] == "name":
                scope.vars[target[1]] = value
            elif target[0] == "names":
                _assign(scope, target[1], value)
            else:
                ns = scope.lookup(target[1])
                if not isinstance(ns, Namespace):
                    raise TemplateRenderError(
                        "cannot assign attribute on non-namespace object")
                ns.__dict__["_attrs"][target[2]] = value
        elif kind == "break":
            raise _Break()
        elif kind == "continue":
            raise _Continue()


def _raise_exception(message: Any) -> None:
    raise TemplateRenderError(_str(message))


class ChatTemplateRenderer:
    def __init__(self, template: Optional[str] = None,
                 family: str = "llama",
                 now_fn: Optional[Callable[[], datetime.datetime]] = None):
        now_fn = now_fn or datetime.datetime.now
        # Pinned clock for golden tests.
        self._globals: Dict[str, Any] = {
            "range": range, "dict": dict, "namespace": Namespace,
            "strftime_now": lambda fmt: now_fn().strftime(fmt),
            "raise_exception": _raise_exception,
        }
        src = template or DEFAULT_TEMPLATES[
            _FAMILY_DEFAULT.get(family, "plain")]
        try:
            body, _ = _Parser(_lex(src)).parse_body()
        except TemplateSyntaxError as e:
            raise InvalidRequestError(f"bad chat template: {e}")
        self._body = body

    def render(self, messages: List[Dict[str, Any]],
               add_generation_prompt: bool = True,
               tools: Optional[List[Dict[str, Any]]] = None,
               chat_template_kwargs: Optional[Dict[str, Any]] = None,
               bos_token: str = "", eos_token: str = "") -> str:
        """Render normalized messages; `content` must already be a string
        (the server layer flattens content parts and validates roles)."""
        ctx: Dict[str, Any] = {
            "messages": messages,
            "add_generation_prompt": add_generation_prompt,
            "bos_token": bos_token,
            "eos_token": eos_token,
        }
        if tools:
            ctx["tools"] = tools
        if chat_template_kwargs:
            for k, v in chat_template_kwargs.items():
                ctx.setdefault(k, v)
        top = _Scope()
        top.vars.update(self._globals)
        scope = _Scope(top)
        scope.vars.update(ctx)
        out: List[str] = []
        try:
            _run(self._body, scope, out)
        except TemplateRenderError as e:
            raise InvalidRequestError(f"chat template render failed: {e}")
        return "".join(out)
