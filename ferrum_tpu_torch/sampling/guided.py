"""Guided decoding's host processors: regex-DFA token masks, JSON mode.

Port of `ferrum_tpu/sampling/guided.py`, the same code: a DFA compiled
from a regex hard-masks the vocabulary each step (EOS allowed only in
accepting states); `schema_to_regex` lowers a conservative JSON-Schema
subset, failing fast on unsupported constructs.

The DFA lives on the host; per-state vocab masks are computed lazily and
cached (O(vocab * token length) once per distinct state). The engine
uses a processor as the host shadow of a device-FSM request (its state
and `is_complete`) and as the mask of the host-masked path.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..types import GuidedOptions, NotSupportedError
from .regex_dfa import DFA, compile_regex
from .schema import schema_to_regex


class RegexGuidedProcessor:
    """Per-request DFA state machine + lazy per-state vocab masks.

    ref: RegexGuidedProcessor ferrum-sampler/src/guided.rs:1-34.
    """

    def __init__(self, dfa: DFA, tokenizer):
        self.dfa = dfa
        self.tokenizer = tokenizer
        self._vocab_strings: Optional[list] = None
        self._mask_cache: Dict[int, np.ndarray] = {}
        self.state = dfa.start
        self._complete = False

    # -- vocabulary preparation (lazy, once) --
    def _vocab(self):
        if self._vocab_strings is None:
            tok = self.tokenizer
            n = tok.vocab_size
            strings = []
            for tid in range(n):
                strings.append(tok.decode([tid], skip_special_tokens=True))
            self._vocab_strings = strings
        return self._vocab_strings

    def allowed_mask(self, seq=None) -> np.ndarray:
        """Bool mask [vocab]: tokens whose text keeps the DFA alive.
        EOS tokens allowed iff the current state accepts (EOS-when-
        accepting, ref guided.rs)."""
        cached = self._mask_cache.get(self.state)
        if cached is not None:
            return cached
        strings = self._vocab()
        dfa = self.dfa
        mask = np.zeros(len(strings), dtype=bool)
        for tid, s in enumerate(strings):
            if not s:
                continue
            st = dfa.walk(self.state, s)
            if st is not None:
                mask[tid] = True
        if dfa.is_accepting(self.state):
            for eid in self.tokenizer.eos_token_ids:
                if eid < len(mask):
                    mask[eid] = True
        self._mask_cache[self.state] = mask
        return mask

    def advance(self, seq, token_id: int) -> None:
        if token_id in self.tokenizer.eos_token_ids:
            self._complete = True
            return
        s = self.tokenizer.decode([token_id], skip_special_tokens=True)
        nxt = self.dfa.walk(self.state, s)
        if nxt is None:
            # Token violated the DFA (shouldn't happen under masking);
            # freeze in a dead state that only allows EOS.
            self._complete = True
            return
        self.state = nxt
        if self.dfa.is_accepting(self.state) and not self.dfa.has_live_out(
                self.state):
            self._complete = True

    def is_complete(self, seq=None) -> bool:
        return self._complete


class JsonModeProcessor(RegexGuidedProcessor):
    """Best-effort json_object mode: constrain to a generic JSON value
    grammar approximation (ref: json_mode.rs lightweight state machine)."""

    JSON_REGEX = (
        r'\s*\{\s*(("([^"\\]|\\.)*"\s*:\s*'
        r'("([^"\\]|\\.)*"|-?\d+(\.\d+)?([eE][+-]?\d+)?|true|false|null|'
        r'\{[^{}]*\}|\[[^\[\]]*\])\s*)'
        r'(,\s*"([^"\\]|\\.)*"\s*:\s*'
        r'("([^"\\]|\\.)*"|-?\d+(\.\d+)?([eE][+-]?\d+)?|true|false|null|'
        r'\{[^{}]*\}|\[[^\[\]]*\])\s*)*)?\}\s*')

    def __init__(self, tokenizer):
        super().__init__(compile_regex(self.JSON_REGEX), tokenizer)


def build_guided_processor(opts: GuidedOptions, tokenizer):
    if opts.regex is not None:
        return RegexGuidedProcessor(compile_regex(opts.regex), tokenizer)
    if opts.json_schema is not None:
        regex = schema_to_regex(opts.json_schema)
        return RegexGuidedProcessor(compile_regex(regex), tokenizer)
    if opts.json_mode:
        return JsonModeProcessor(tokenizer)
    raise NotSupportedError("guided options empty")
