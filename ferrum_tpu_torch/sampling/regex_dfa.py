"""A self-contained regex -> NFA -> lazy-DFA compiler for guided decoding.

Port of `ferrum_tpu/sampling/regex_dfa.py`, the same code (the port
imports nothing of the JAX package, so it keeps its own copy). Supports
the subset schema_to_regex produces plus common patterns: literals,
escapes (\\d \\w \\s \\D \\W \\S, punctuation escapes), char classes
[a-z^-], '.', anchor-free concatenation, quantifiers * + ? {m} {m,}
{m,n}, alternation '|', groups (...) / (?:...). Other constructs raise
NotSupportedError with the JAX package's messages (fail fast).

DFA states are built lazily by subset construction with memoized
transitions, so a pathological state blowup never happens eagerly.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

from ..types import NotSupportedError

MAX_CP = 0x10FFFF
Ranges = Tuple[Tuple[int, int], ...]   # sorted inclusive codepoint ranges


# ---------------------------------------------------------------------------
# Parser → AST
# ---------------------------------------------------------------------------

class _Node:
    pass


class _Lit(_Node):
    def __init__(self, ranges: Ranges):
        self.ranges = ranges


class _Cat(_Node):
    def __init__(self, parts: List[_Node]):
        self.parts = parts


class _Alt(_Node):
    def __init__(self, opts: List[_Node]):
        self.opts = opts


class _Rep(_Node):
    def __init__(self, node: _Node, lo: int, hi: Optional[int]):
        self.node = node
        self.lo = lo
        self.hi = hi  # None = unbounded


_D = ((48, 57),)
_W = ((48, 57), (65, 90), (95, 95), (97, 122))
_S = ((9, 10), (11, 13), (32, 32))
_DOT = ((0, 9), (11, MAX_CP))  # any but newline


def _negate(ranges: Ranges) -> Ranges:
    out = []
    prev = 0
    for lo, hi in sorted(ranges):
        if lo > prev:
            out.append((prev, lo - 1))
        prev = max(prev, hi + 1)
    if prev <= MAX_CP:
        out.append((prev, MAX_CP))
    return tuple(out)


_ESCAPES = {
    "d": _D, "D": _negate(_D), "w": _W, "W": _negate(_W),
    "s": _S, "S": _negate(_S),
    "n": ((10, 10),), "t": ((9, 9),), "r": ((13, 13),),
}


class _Parser:
    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0

    def error(self, msg: str):
        raise NotSupportedError(
            f"regex not supported at {self.i}: {msg} (pattern={self.p!r})")

    def peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def next(self) -> str:
        c = self.p[self.i]
        self.i += 1
        return c

    def parse(self) -> _Node:
        node = self.parse_alt()
        if self.i != len(self.p):
            self.error("dangling input")
        return node

    def parse_alt(self) -> _Node:
        opts = [self.parse_cat()]
        while self.peek() == "|":
            self.next()
            opts.append(self.parse_cat())
        return opts[0] if len(opts) == 1 else _Alt(opts)

    def parse_cat(self) -> _Node:
        parts: List[_Node] = []
        while self.peek() not in (None, "|", ")"):
            parts.append(self.parse_rep())
        if not parts:
            return _Cat([])
        return parts[0] if len(parts) == 1 else _Cat(parts)

    def parse_rep(self) -> _Node:
        atom = self.parse_atom()
        while True:
            c = self.peek()
            if c == "*":
                self.next()
                atom = _Rep(atom, 0, None)
            elif c == "+":
                self.next()
                atom = _Rep(atom, 1, None)
            elif c == "?":
                self.next()
                atom = _Rep(atom, 0, 1)
            elif c == "{":
                save = self.i
                self.next()
                digits = ""
                while self.peek() and self.peek().isdigit():
                    digits += self.next()
                if not digits:
                    self.i = save
                    break
                lo = int(digits)
                hi: Optional[int] = lo
                if self.peek() == ",":
                    self.next()
                    digits2 = ""
                    while self.peek() and self.peek().isdigit():
                        digits2 += self.next()
                    hi = int(digits2) if digits2 else None
                if self.peek() != "}":
                    self.error("bad {} quantifier")
                self.next()
                if hi is not None and hi < lo:
                    self.error("{m,n} with n < m")
                atom = _Rep(atom, lo, hi)
            else:
                break
        return atom

    def parse_atom(self) -> _Node:
        c = self.peek()
        if c == "(":
            self.next()
            if self.peek() == "?":
                self.next()
                k = self.peek()
                if k == ":":
                    self.next()
                else:
                    self.error("only (?:...) groups supported")
            node = self.parse_alt()
            if self.peek() != ")":
                self.error("unclosed group")
            self.next()
            return node
        if c == "[":
            return self.parse_class()
        if c == ".":
            self.next()
            return _Lit(_DOT)
        if c == "\\":
            self.next()
            e = self.next()
            if e in _ESCAPES:
                return _Lit(_ESCAPES[e])
            if not e.isalnum():
                return _Lit(((ord(e), ord(e)),))
            self.error(f"escape \\{e}")
        if c in "*+?{":
            self.error(f"dangling quantifier {c}")
        if c in ("^", "$"):
            # Patterns are implicitly fully anchored for guided decoding.
            self.next()
            return _Cat([])
        self.next()
        return _Lit(((ord(c), ord(c)),))

    def parse_class(self) -> _Node:
        self.next()  # [
        negate = False
        if self.peek() == "^":
            negate = True
            self.next()
        ranges: List[Tuple[int, int]] = []
        first = True
        while True:
            c = self.peek()
            if c is None:
                self.error("unclosed class")
            if c == "]" and not first:
                self.next()
                break
            first = False
            if c == "\\":
                self.next()
                e = self.next()
                if e in _ESCAPES:
                    ranges.extend(_ESCAPES[e])
                    continue
                lo = ord(e)
            else:
                lo = ord(self.next())
            if self.peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self.next()
                hic = self.next()
                if hic == "\\":
                    hic = self.next()
                hi = ord(hic)
            else:
                hi = lo
            ranges.append((lo, hi))
        merged = _merge(tuple(ranges))
        return _Lit(_negate(merged) if negate else merged)


def _merge(ranges: Ranges) -> Ranges:
    out: List[Tuple[int, int]] = []
    for lo, hi in sorted(ranges):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return tuple(out)


# ---------------------------------------------------------------------------
# NFA (Thompson) with epsilon transitions
# ---------------------------------------------------------------------------

class _NFA:
    def __init__(self):
        self.eps: List[List[int]] = []
        self.trans: List[List[Tuple[Ranges, int]]] = []

    def new_state(self) -> int:
        self.eps.append([])
        self.trans.append([])
        return len(self.eps) - 1

    def add_eps(self, a: int, b: int):
        self.eps[a].append(b)

    def add_trans(self, a: int, ranges: Ranges, b: int):
        self.trans[a].append((ranges, b))


_REP_UNROLL_CAP = 256


def _build(nfa: _NFA, node: _Node) -> Tuple[int, int]:
    """Returns (start, end) NFA fragment."""
    if isinstance(node, _Lit):
        s, e = nfa.new_state(), nfa.new_state()
        nfa.add_trans(s, node.ranges, e)
        return s, e
    if isinstance(node, _Cat):
        s = e = nfa.new_state()
        for part in node.parts:
            ps, pe = _build(nfa, part)
            nfa.add_eps(e, ps)
            e = pe
        return s, e
    if isinstance(node, _Alt):
        s, e = nfa.new_state(), nfa.new_state()
        for opt in node.opts:
            os_, oe = _build(nfa, opt)
            nfa.add_eps(s, os_)
            nfa.add_eps(oe, e)
        return s, e
    if isinstance(node, _Rep):
        lo, hi = node.lo, node.hi
        if hi is not None and hi > _REP_UNROLL_CAP:
            raise NotSupportedError(f"{{m,n}} with n > {_REP_UNROLL_CAP}")
        if lo > _REP_UNROLL_CAP:
            raise NotSupportedError(f"{{m,}} with m > {_REP_UNROLL_CAP}")
        s = e = nfa.new_state()
        for _ in range(lo):
            ps, pe = _build(nfa, node.node)
            nfa.add_eps(e, ps)
            e = pe
        if hi is None:  # Kleene tail
            ps, pe = _build(nfa, node.node)
            nfa.add_eps(e, ps)
            nfa.add_eps(pe, e)
        else:
            tail_end = nfa.new_state()
            nfa.add_eps(e, tail_end)
            cur = e
            for _ in range(hi - lo):
                ps, pe = _build(nfa, node.node)
                nfa.add_eps(cur, ps)
                nfa.add_eps(pe, tail_end)
                cur = pe
            e = tail_end
        return s, e
    raise NotSupportedError(f"unknown node {node!r}")


# ---------------------------------------------------------------------------
# Lazy DFA via subset construction
# ---------------------------------------------------------------------------

class DFA:
    def __init__(self, nfa: _NFA, start_nfa: int, accept_nfa: int):
        self._nfa = nfa
        self._accept = accept_nfa
        self._ids: Dict[FrozenSet[int], int] = {}
        self._sets: List[FrozenSet[int]] = []
        self._memo: Dict[Tuple[int, int], Optional[int]] = {}
        self.start = self._intern(self._closure(frozenset([start_nfa])))

    def _closure(self, states: FrozenSet[int]) -> FrozenSet[int]:
        stack = list(states)
        seen = set(states)
        while stack:
            s = stack.pop()
            for t in self._nfa.eps[s]:
                if t not in seen:
                    seen.add(t)
                    stack.append(t)
        return frozenset(seen)

    def _intern(self, states: FrozenSet[int]) -> int:
        sid = self._ids.get(states)
        if sid is None:
            sid = len(self._sets)
            self._ids[states] = sid
            self._sets.append(states)
        return sid

    def step(self, state_id: int, cp: int) -> Optional[int]:
        key = (state_id, cp)
        hit = self._memo.get(key, -2)
        if hit != -2:
            return hit
        nxt = set()
        for s in self._sets[state_id]:
            for ranges, t in self._nfa.trans[s]:
                for lo, hi in ranges:
                    if lo <= cp <= hi:
                        nxt.add(t)
                        break
        out = self._intern(self._closure(frozenset(nxt))) if nxt else None
        self._memo[key] = out
        return out

    def walk(self, state_id: int, text: str) -> Optional[int]:
        st: Optional[int] = state_id
        for ch in text:
            st = self.step(st, ord(ch))
            if st is None:
                return None
        return st

    def is_accepting(self, state_id: int) -> bool:
        return self._accept in self._sets[state_id]

    def has_live_out(self, state_id: int) -> bool:
        return any(self._nfa.trans[s] for s in self._sets[state_id])

    def fullmatch(self, text: str) -> bool:
        st = self.walk(self.start, text)
        return st is not None and self.is_accepting(st)


def compile_regex(pattern: str) -> DFA:
    ast = _Parser(pattern).parse()
    nfa = _NFA()
    s, e = _build(nfa, ast)
    return DFA(nfa, s, e)
