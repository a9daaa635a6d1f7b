"""Tokenizers: a checkpoint's `tokenizer.json` and the byte-level test one.

`FerrumTokenizer` is the port of `ferrum_tpu/tokenizer.py`'s, without
the HuggingFace `tokenizers` package (the card's machine has none): it
reads `tokenizer.json` itself and implements what Llama-3.x and
Qwen2/Qwen3 tokenizers use (byte-level BPE) and what Gemma 3's and
Mistral 7B v0.1's use (SentencePiece-style BPE: no pre-tokenizer, "▁"
for spaces, byte fallback) --

  added tokens  split out of the raw text first (leftmost-longest),
                `lstrip` / `rstrip` honoured; those marked `normalized`
                split out after normalization (their content normalized)
  normalizer    none, NFC (`unicodedata`), Replace (a String pattern),
                Prepend, or a Sequence of them
  pre-tokenizer Split(Regex, Isolated) steps, then ByteLevel (with or
                without its own GPT-2 regex, `add_prefix_space`); or
                none (each normalized piece is one word)
  model         BPE with `merges` in rank order (the lowest-rank pair
                merged first, the leftmost among equals, as the
                `tokenizers` heap does), `ignore_merges` (a pre-token
                found whole in the vocab is not merged), `byte_fallback`
                (a character outside the vocab as its <0xNN> byte
                tokens) and `unk_token` / `fuse_unk`
  post-process  TemplateProcessing (Llama-3's and Gemma's BOS),
                ByteLevel, or a Sequence of them
  decoder       ByteLevel: a token's symbols back to bytes (a token with
                a symbol outside the byte alphabet as its UTF-8 bytes),
                the bytes decoded as UTF-8 with U+FFFD for what is not;
                or a Sequence of Replace (a String pattern), ByteFallback
                (runs of <0xNN> tokens as UTF-8, U+FFFD a byte where
                invalid), Fuse and Strip

-- with the metadata of `tokenizer_config.json` (chat template, eos and
bos, `added_tokens_decoder` specials) and `generation_config.json`'s eos
list. Any other component (Metaspace, WordPiece, Unigram, byte fallback
under a ByteLevel pre-tokenizer, ...) raises ModelLoadError naming it.

The Split regexes use `\\p{L}`, `\\p{N}` and `\\s`, which stdlib `re`
lacks or reads otherwise: they are expanded into explicit character
classes, built once (lazily) from `unicodedata` plus the letters and
numbers Unicode 16.0 added (Python 3.12's `unicodedata` is 15.0; the
Oniguruma engine of `tokenizers` has 16.0), and `\\s` as the Unicode
White_Space set (stdlib `\\s` also matches U+001C..U+001F). NFC follows
`unicodedata`: the few compositions Unicode 16.0 added are not applied.

`ByteTokenizer` (`make_byte_tokenizer`) is the port of the JAX package's
byte-level test tokenizer: ids 0-255 are the 256 byte symbols of the
GPT-2 byte-level alphabet in sorted order, 256 = <bos>, 257 = <eos>,
then `vocab_extra` unused slots, so the same text gives the same ids in
both packages.
"""

from __future__ import annotations

import heapq
import json
import os
import re
import unicodedata
from functools import lru_cache
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple, Union

from .types import ModelLoadError

BOS, EOS = "<bos>", "<eos>"


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte → printable unicode symbol map."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


BYTE_SYMBOL = _bytes_to_unicode()
SYMBOL_BYTE = {c: b for b, c in BYTE_SYMBOL.items()}


# ---------------------------------------------------------------------------
# Regex translation: \p{L}, \p{N}, \s -> explicit classes for stdlib re
# ---------------------------------------------------------------------------

# Unicode White_Space (Oniguruma's \s, Rust's char::is_whitespace).
WHITE_SPACE = ((0x9, 0xD), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
               (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
               (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))
# Letters and numbers new in Unicode 16.0 (absent from unicodedata 15.0).
_UNICODE16 = {
    "L": ((0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC),
          (0x105C0, 0x105F3), (0x10D4A, 0x10D65), (0x10D6F, 0x10D85),
          (0x10EC2, 0x10EC4), (0x11380, 0x11389), (0x1138B, 0x1138B),
          (0x1138E, 0x1138E), (0x11390, 0x113B5), (0x113B7, 0x113B7),
          (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0),
          (0x13460, 0x143FA), (0x16100, 0x1611D), (0x16D40, 0x16D6C),
          (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED), (0x1E5F0, 0x1E5F0),
          (0x2EBF0, 0x2EE5D)),
    "N": ((0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9),
          (0x16130, 0x16139), (0x16D70, 0x16D79), (0x1CCF0, 0x1CCF9),
          (0x1E5F1, 0x1E5FA)),
}


def _merge_ranges(points) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for c in sorted(points):
        if out and out[-1][1] >= c - 1:
            out[-1][1] = max(out[-1][1], c)
        else:
            out.append([c, c])
    return [(a, b) for a, b in out]


@lru_cache(maxsize=None)
def category_ranges(cat: str) -> Tuple[Tuple[int, int], ...]:
    """Code point ranges of a general category class (L or N)."""
    pts = {c for c in range(0x110000)
           if unicodedata.category(chr(c)).startswith(cat)}
    for a, b in _UNICODE16[cat]:
        pts.update(range(a, b + 1))
    return tuple(_merge_ranges(pts))


def _class_body(ranges) -> str:
    return "".join(f"\\U{a:08X}" if a == b else f"\\U{a:08X}-\\U{b:08X}"
                   for a, b in ranges)


def translate_regex(pattern: str) -> str:
    """An Oniguruma pattern of a tokenizer.json Split (or ByteLevel's
    GPT-2 regex) -> the same pattern for stdlib `re`: \\p{L} / \\p{N} /
    \\P{..} and \\s / \\S as explicit classes. Escapes whose meaning
    differs between the two engines (\\d, \\w, \\b, other categories)
    raise ModelLoadError."""
    out: List[str] = []
    in_class = False
    i = 0
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            e = pattern[i + 1]
            if e in "pP":
                m = re.match(r"\{(\^?)([A-Za-z]+)\}", pattern[i + 2:])
                if not m or m.group(2) not in _UNICODE16:
                    raise ModelLoadError(
                        f"tokenizer regex class {pattern[i:i + 8]!r} is not "
                        f"supported (\\p{{L}} and \\p{{N}} are)",
                        param="pre_tokenizer")
                neg = (e == "P") != bool(m.group(1))
                body = _class_body(category_ranges(m.group(2)))
                i += 2 + m.end()
            elif e in "sS":
                neg = e == "S"
                body = _class_body(WHITE_SPACE)
                i += 2
            elif e in "dDwWbBhHRXkgGAzZ":
                raise ModelLoadError(
                    f"tokenizer regex escape \\{e} is not supported",
                    param="pre_tokenizer")
            else:
                out.append(pattern[i:i + 2])
                i += 2
                continue
            if in_class and neg:
                raise ModelLoadError(
                    "a negated class inside [...] is not supported in a "
                    "tokenizer regex", param="pre_tokenizer")
            out.append(body if in_class
                       else f"[{'^' if neg else ''}{body}]")
            continue
        if c == "[":
            if in_class:
                raise ModelLoadError("nested [...] in a tokenizer regex is "
                                     "not supported", param="pre_tokenizer")
            in_class = True
            out.append(c)
            i += 1
            if pattern[i:i + 1] == "^":
                out.append("^")
                i += 1
            if pattern[i:i + 1] == "]":
                out.append("\\]")
                i += 1
            continue
        if c == "]" and in_class:
            in_class = False
        out.append(c)
        i += 1
    return "".join(out)


@lru_cache(maxsize=None)
def _compiled(pattern: str) -> "re.Pattern":
    return re.compile(translate_regex(pattern))


# ByteLevel's own pre-tokenization regex (use_regex=true).
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")
_WS_CHARS = frozenset(chr(c) for a, b in WHITE_SPACE
                      for c in range(a, b + 1))


def _split_isolated(text: str, rx: "re.Pattern") -> List[str]:
    """Every match and every stretch between matches, in order."""
    out, at = [], 0
    for m in rx.finditer(text):
        if m.start() > at:
            out.append(text[at:m.start()])
        if m.end() > m.start():
            out.append(m.group())
        at = m.end()
    if at < len(text):
        out.append(text[at:])
    return out


# ---------------------------------------------------------------------------
# tokenizer.json
# ---------------------------------------------------------------------------

def _unsupported(part: str, what: Any) -> ModelLoadError:
    return ModelLoadError(f"tokenizer.json {part} {what!r} is not supported "
                          f"by the port's tokenizer", param=part)


class _AddedTokens:
    """Added tokens matched in text: leftmost-longest (longer alternatives
    first in one regex), then widened over White_Space by lstrip/rstrip
    as the `tokenizers` library widens them. `norm` maps a token's
    content to the form it is matched in (normalized tokens)."""

    def __init__(self, tokens: List[dict], norm=None):
        self._tok = {(norm(t["content"]) if norm else t["content"]): t
                     for t in tokens}
        alts = sorted(self._tok, key=len, reverse=True)
        self._rx = re.compile("|".join(map(re.escape, alts))) \
            if alts else None

    def split(self, text: str) -> List[Tuple[Optional[str], str]]:
        """[(token content or None, text)] covering `text`."""
        if self._rx is None or not text:
            return [(None, text)]
        out: List[Tuple[Optional[str], str]] = []
        at = 0
        for m in self._rx.finditer(text):
            t = self._tok[m.group()]
            start, stop = m.start(), m.end()
            if t.get("lstrip"):
                ws = start
                while ws > 0 and text[ws - 1] in _WS_CHARS:
                    ws -= 1
                start = max(ws, at)
            if t.get("rstrip"):
                while stop < len(text) and text[stop] in _WS_CHARS:
                    stop += 1
            if at < start:
                out.append((None, text[at:start]))
            out.append((t["content"], text[start:stop]))
            at = stop
        if at != len(text):
            out.append((None, text[at:]))
        return out


class FerrumTokenizer:
    """A `tokenizer.json` BPE tokenizer (components: module docstring),
    the JAX package's FerrumTokenizer interface."""

    def __init__(self, spec: Dict[str, Any],
                 eos_token_ids: Sequence[int] = (),
                 bos_token_id: Optional[int] = None,
                 chat_template: Optional[str] = None,
                 special_ids: Optional[Set[int]] = None):
        self.eos_token_ids = tuple(eos_token_ids)
        self.bos_token_id = bos_token_id
        self.chat_template = chat_template
        self._special_ids = special_ids or set()
        self._load_model(spec.get("model") or {})
        self._normalize = self._load_normalizer(spec.get("normalizer"))
        self._load_added(spec.get("added_tokens") or [])
        self._splits, self._byte_level = self._load_pre_tokenizer(
            spec.get("pre_tokenizer"))
        if self._byte_fallback and self._byte_level is not None:
            raise _unsupported("model.byte_fallback",
                               "with a ByteLevel pre-tokenizer")
        self._prefix, self._suffix = self._load_post_processor(
            spec.get("post_processor"))
        self._decoders = self._load_decoder(spec.get("decoder"))
        self._cache: Dict[str, List[int]] = {}

    # -- construction ------------------------------------------------------
    def _load_model(self, m: Dict[str, Any]) -> None:
        if m.get("type") != "BPE":
            raise _unsupported("model", m.get("type"))
        for key in ("continuing_subword_prefix", "end_of_word_suffix",
                    "dropout"):
            if m.get(key):
                raise _unsupported(f"model.{key}", m[key])
        self._byte_fallback = bool(m.get("byte_fallback", False))
        self._unk = m.get("unk_token")
        self._fuse_unk = bool(m.get("fuse_unk", False))
        self._vocab: Dict[str, int] = dict(m["vocab"])
        if self._unk is not None and self._unk not in self._vocab:
            raise _unsupported("model.unk_token", self._unk)
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        self._ranks: Dict[Tuple[str, str], int] = {}
        for r, mg in enumerate(m.get("merges") or []):
            a, b = mg.split(" ", 1) if isinstance(mg, str) else mg
            self._ranks.setdefault((a, b), r)
        self._ignore_merges = bool(m.get("ignore_merges", False))

    def _load_added(self, added: List[dict]) -> None:
        for t in added:
            if t.get("single_word"):
                raise _unsupported("added_tokens.single_word",
                                   t["content"])
        self._added = {t["content"]: t["id"] for t in added}
        self._added_by_id = {t["id"]: t["content"] for t in added}
        self._special = {t["content"] for t in added if t.get("special")}
        self._raw_split = _AddedTokens(
            [t for t in added if not t.get("normalized")])
        self._norm_split = _AddedTokens(
            [t for t in added if t.get("normalized")], self._normalize)

    @staticmethod
    def _load_normalizer(n: Optional[Dict[str, Any]]):
        """The normalizer as one str -> str function (None: none)."""
        if n is None:
            return None
        steps = n.get("normalizers", []) if n.get("type") == "Sequence" \
            else [n]
        fns = []
        for st in steps:
            kind = st.get("type")
            if kind == "NFC":
                fns.append(lambda x: unicodedata.normalize("NFC", x))
            elif kind == "Prepend":
                fns.append(lambda x, pre=st["prepend"]: pre + x if x else x)
            elif kind == "Replace" and "String" in st.get("pattern", {}):
                fns.append(lambda x, a=st["pattern"]["String"],
                           b=st["content"]: x.replace(a, b))
            else:
                raise _unsupported("normalizer", kind if kind != "Replace"
                                   else st.get("pattern"))
        if not fns:
            return None

        def normalize(x: str) -> str:
            for fn in fns:
                x = fn(x)
            return x
        return normalize

    @staticmethod
    def _load_decoder(d: Optional[Dict[str, Any]]):
        """"ByteLevel", or the SentencePiece-style chain as a list of
        (kind, args) steps."""
        if d and d.get("type") == "ByteLevel":
            return "ByteLevel"
        steps = d.get("decoders", []) if d and d.get("type") == "Sequence" \
            else [d]
        chain = []
        for st in steps:
            kind = st and st.get("type")
            if kind == "Replace" and "String" in st.get("pattern", {}):
                chain.append((kind, (st["pattern"]["String"],
                                     st["content"])))
            elif kind in ("ByteFallback", "Fuse"):
                chain.append((kind, ()))
            elif kind == "Strip":
                chain.append((kind, (st["content"], int(st["start"]),
                                     int(st["stop"]))))
            else:
                raise _unsupported("decoder", kind)
        return chain

    @staticmethod
    def _load_pre_tokenizer(p: Optional[Dict[str, Any]]):
        """(Split patterns, ByteLevel's (add_prefix_space, use_regex)), or
        ([], None) without a pre-tokenizer."""
        if p is None:
            return [], None
        steps = (p.get("pretokenizers", []) if p and
                 p.get("type") == "Sequence" else [p])
        if not steps or not steps[-1] or steps[-1].get("type") != "ByteLevel":
            raise _unsupported("pre_tokenizer",
                               [s and s.get("type") for s in steps])
        splits = []
        for s in steps[:-1]:
            if s.get("type") != "Split":
                raise _unsupported("pre_tokenizer", s.get("type"))
            if s.get("behavior") != "Isolated" or s.get("invert"):
                raise _unsupported("pre_tokenizer.Split.behavior",
                                   (s.get("behavior"), s.get("invert")))
            pat = s["pattern"]
            splits.append(pat["Regex"] if "Regex" in pat
                          else re.escape(pat["String"]))
        bl = steps[-1]
        return splits, (bool(bl.get("add_prefix_space", False)),
                        bool(bl.get("use_regex", True)))

    @staticmethod
    def _load_post_processor(p: Optional[Dict[str, Any]]):
        prefix: List[int] = []
        suffix: List[int] = []
        procs = (p.get("processors", []) if p and p.get("type") == "Sequence"
                 else [p] if p else [])
        for q in procs:
            if q.get("type") == "ByteLevel":
                continue        # offsets only
            if q.get("type") != "TemplateProcessing":
                raise _unsupported("post_processor", q.get("type"))
            seen_a = False
            for item in q["single"]:
                if "Sequence" in item:
                    seen_a = True
                    continue
                ids = q["special_tokens"][item["SpecialToken"]["id"]]["ids"]
                (suffix if seen_a else prefix).extend(ids)
        return prefix, suffix

    # -- loading -------------------------------------------------------------
    @classmethod
    def from_pretrained(cls, model_dir: str) -> "FerrumTokenizer":
        """tokenizer.json (+ tokenizer_config.json, generation_config.json
        metadata) of a local checkpoint directory."""
        tj = os.path.join(model_dir, "tokenizer.json")
        if not os.path.exists(tj):
            raise ModelLoadError(f"no tokenizer.json under {model_dir}")
        with open(tj, encoding="utf-8") as f:
            tok = cls(json.load(f))

        eos_ids: List[int] = []
        cfg_path = os.path.join(model_dir, "tokenizer_config.json")
        if os.path.exists(cfg_path):
            with open(cfg_path, encoding="utf-8") as f:
                cfg = json.load(f)
            chat_template = cfg.get("chat_template")
            if isinstance(chat_template, list):  # HF multi-template form
                chat_template = {t["name"]: t["template"]
                                 for t in chat_template}.get("default")
            tok.chat_template = chat_template
            for key in ("eos_token", "bos_token"):
                val = cfg.get(key)
                if isinstance(val, dict):
                    val = val.get("content")
                tid = None if val is None else tok.token_to_id(val)
                if tid is not None:
                    if key == "eos_token":
                        eos_ids.append(tid)
                    else:
                        tok.bos_token_id = tid
            for tid_str, meta in (cfg.get("added_tokens_decoder")
                                  or {}).items():
                if meta.get("special"):
                    tok._special_ids.add(int(tid_str))
        gen_cfg = os.path.join(model_dir, "generation_config.json")
        if os.path.exists(gen_cfg):
            with open(gen_cfg, encoding="utf-8") as f:
                e = json.load(f).get("eos_token_id")
            if isinstance(e, list):
                eos_ids.extend(int(x) for x in e)
            elif e is not None:
                eos_ids.append(int(e))
        tok.eos_token_ids = tuple(dict.fromkeys(eos_ids))
        return tok

    # -- encode --------------------------------------------------------------
    def _pre_tokens(self, text: str) -> List[str]:
        if self._byte_level is None:
            return [text]
        pieces = [text]
        for pat in self._splits:
            rx = _compiled(pat)
            pieces = [s for p in pieces for s in _split_isolated(p, rx)]
        prefix_space, use_regex = self._byte_level
        out = []
        for p in pieces:
            if prefix_space and not p.startswith(" "):
                p = " " + p
            for s in (_split_isolated(p, _compiled(GPT2_PATTERN))
                      if use_regex else [p]):
                out.append("".join(BYTE_SYMBOL[b] for b in s.encode()))
        return out

    def _symbols(self, word: str) -> List[str]:
        """A word's initial symbols, as `tokenizers`' BPE makes them: each
        character in the vocab; else its <0xNN> byte tokens (byte
        fallback, when all are in the vocab); else the unk token (runs
        of them fused under fuse_unk; a pending unk lands before the
        next character found in the vocab, or at the end); else
        dropped."""
        syms: List[str] = []
        unk = 0                                   # pending unk symbols
        for ch in word:
            if ch in self._vocab:
                syms.extend([self._unk] * unk)
                unk = 0
                syms.append(ch)
                continue
            if self._byte_fallback:
                bs = [f"<0x{b:02X}>" for b in ch.encode()]
                if all(b in self._vocab for b in bs):
                    syms.extend(bs)
                    continue
            if self._unk is not None:
                if unk and not self._fuse_unk:
                    syms.append(self._unk)
                unk = 1
        return syms + [self._unk] * unk

    def _merge(self, syms: List[str]) -> List[str]:
        """Apply the merges: the lowest rank first, the leftmost among
        equal ranks, each merge re-queueing its new neighbour pairs
        (`tokenizers`' Word::merge_all)."""
        n = len(syms)
        prev = list(range(-1, n - 1))
        nxt = list(range(1, n + 1))
        heap = []
        for i in range(n - 1):
            r = self._ranks.get((syms[i], syms[i + 1]))
            if r is not None:
                heap.append((r, i, syms[i] + syms[i + 1]))
        heapq.heapify(heap)
        while heap:
            _, i, new = heapq.heappop(heap)
            j = nxt[i]
            if not syms[i] or j >= n or syms[i] + syms[j] != new \
                    or (syms[i], syms[j]) not in self._ranks:
                continue
            syms[i], syms[j] = new, ""
            nxt[i] = nxt[j]
            if nxt[i] < n:
                prev[nxt[i]] = i
            if prev[i] >= 0:
                r = self._ranks.get((syms[prev[i]], new))
                if r is not None:
                    heapq.heappush(heap, (r, prev[i], syms[prev[i]] + new))
            if nxt[i] < n:
                r = self._ranks.get((new, syms[nxt[i]]))
                if r is not None:
                    heapq.heappush(heap, (r, i, new + syms[nxt[i]]))
        return [x for x in syms if x]

    def _bpe(self, word: str) -> List[int]:
        hit = self._cache.get(word)
        if hit is not None:
            return hit
        if self._ignore_merges and word in self._vocab:
            ids = [self._vocab[word]]
        else:
            ids = [self._vocab[x] for x in self._merge(self._symbols(word))]
        if len(self._cache) < 100_000:
            self._cache[word] = ids
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = []
        for tok, piece in self._raw_split.split(text):
            if tok is not None:
                ids.append(self._added[tok])
                continue
            if self._normalize is not None:
                piece = self._normalize(piece)
            for tok2, sub in self._norm_split.split(piece):
                if tok2 is not None:
                    ids.append(self._added[tok2])
                    continue
                if not sub:         # `tokenizers` drops empty pieces
                    continue
                for w in self._pre_tokens(sub):
                    ids.extend(self._bpe(w))
        if add_special_tokens:
            ids = self._prefix + ids + self._suffix
        return ids

    # -- decode --------------------------------------------------------------
    def _token(self, i: int) -> Optional[str]:
        t = self._added_by_id.get(i)
        return t if t is not None else self._id_to_token.get(i)

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True
               ) -> str:
        tokens = []
        for i in ids:
            t = self._token(int(i))
            if t is None or (skip_special_tokens and t in self._special):
                continue
            tokens.append(t)
        if self._decoders != "ByteLevel":
            return "".join(_decode_chain(self._decoders, tokens))
        out = bytearray()
        for t in tokens:
            bs = [SYMBOL_BYTE.get(c) for c in t]
            out.extend(t.encode() if None in bs else bs)
        return out.decode("utf-8", errors="replace")

    @property
    def vocab_size(self) -> int:
        return len(set(self._vocab) | set(self._added))

    def token_to_id(self, token: str) -> Optional[int]:
        i = self._added.get(token)
        return i if i is not None else self._vocab.get(token)

    def decode_incremental(self, all_ids: Sequence[int], prefix_offset: int,
                           read_offset: int) -> Tuple[str, int, int]:
        """Stable streaming detokenization: text is emitted only once its
        bytes are final (no dangling U+FFFD). Returns (new_text,
        new_prefix_offset, new_read_offset)."""
        ids = list(all_ids)
        prefix_text = self.decode(ids[prefix_offset:read_offset])
        full_text = self.decode(ids[prefix_offset:])
        if len(full_text) > len(prefix_text) and not full_text.endswith("�"):
            return full_text[len(prefix_text):], read_offset, len(ids)
        return "", prefix_offset, read_offset


def _byte_token(t: str) -> Optional[int]:
    """The byte of a <0xNN> token, else None."""
    if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
        try:
            return int(t[3:5], 16)
        except ValueError:
            return None
    return None


def _decode_chain(chain, tokens: List[str]) -> List[str]:
    """The SentencePiece-style decoder steps over the token strings, as
    `tokenizers` applies them (each step maps the list to a new one)."""
    for kind, args in chain:
        if kind == "Replace":
            tokens = [t.replace(args[0], args[1]) for t in tokens]
        elif kind == "Fuse":
            tokens = ["".join(tokens)]
        elif kind == "Strip":
            content, start, stop = args
            out = []
            for t in tokens:
                a = 0
                while a < min(start, len(t)) and t[a] == content:
                    a += 1
                b = 0
                while b < min(stop, len(t) - a) and t[-1 - b] == content:
                    b += 1
                out.append(t[a:len(t) - b])
            tokens = out
        else:                                       # ByteFallback
            out, run = [], []
            for t in tokens + [None]:
                b = None if t is None else _byte_token(t)
                if b is not None:
                    run.append(b)
                    continue
                if run:
                    try:
                        out.append(bytes(run).decode("utf-8"))
                    except UnicodeDecodeError:
                        out.extend("\ufffd" * len(run))
                    run = []
                if t is not None:
                    out.append(t)
            tokens = out
    return tokens


# ---------------------------------------------------------------------------
# Test tokenizer (hardware- and network-free): byte-level vocabulary
# ---------------------------------------------------------------------------

class ByteTokenizer:
    def __init__(self, vocab_extra: int = 0):
        rank = {ch: i for i, ch in enumerate(sorted(BYTE_SYMBOL.values()))}
        self._byte_to_id = [rank[BYTE_SYMBOL[b]] for b in range(256)]
        self._id_to_byte = {i: b for b, i in enumerate(self._byte_to_id)}
        self._specials = {BOS: 256, EOS: 257}
        self._special_ids = {256, 257}
        self._extra = vocab_extra
        self.eos_token_ids: Tuple[int, ...] = (257,)

    @property
    def vocab_size(self) -> int:
        return 258 + self._extra

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for part in re.split(f"({re.escape(BOS)}|{re.escape(EOS)})", text):
            if part in self._specials:
                ids.append(self._specials[part])
            elif part:
                ids.extend(self._byte_to_id[b] for b in part.encode("utf-8"))
        return ids

    def decode(self, ids: Sequence[int],
               skip_special_tokens: bool = True) -> str:
        out = bytearray()
        for i in ids:
            if i in self._id_to_byte:
                out.append(self._id_to_byte[i])
            elif i in self._special_ids:
                if not skip_special_tokens:
                    out.extend((BOS if i == 256 else EOS).encode())
            elif 258 <= i < 258 + self._extra:
                out.extend(f"<extra_{i - 258}>".encode())
        return out.decode("utf-8", errors="replace")

    def decode_incremental(self, all_ids: Sequence[int], prefix_offset: int,
                           read_offset: int) -> Tuple[str, int, int]:
        """Emit text only once its bytes are final (no dangling partial
        UTF-8 sequence): returns (new_text, prefix_offset, read_offset)."""
        ids = list(all_ids)
        prefix_text = self.decode(ids[prefix_offset:read_offset])
        full_text = self.decode(ids[prefix_offset:])
        if len(full_text) > len(prefix_text) and not full_text.endswith("�"):
            return full_text[len(prefix_text):], read_offset, len(ids)
        return "", prefix_offset, read_offset


def make_byte_tokenizer(vocab_extra: int = 0) -> ByteTokenizer:
    return ByteTokenizer(vocab_extra)


# What the engine takes: encode, decode, decode_incremental, eos_token_ids.
Tokenizer = Union[FerrumTokenizer, ByteTokenizer]
