"""Token-level FSM tables for guided decoding on the device.

Port of `ferrum_tpu/sampling/token_fsm.py`, the same numpy code: the
tables are bit for bit the JAX package's for the same DFA and
tokenizer. The DFA is compiled ONCE into dense tables, so guided
sequences ride the normal decode windows instead of a host round trip
a token:

  - `trans`  int32 [S+1, 258]: dense char-level transition table.
    Columns 0..255 are codepoints < 256; column 256 is the shared
    "high" transition (all codepoints >= 256, verified uniform per
    state at build time); column 257 is PAD (stay). Row S is the
    absorbing dead state.
  - `mask`   uint32 [S+1, ceil(V/32)]: per-state packed vocab bitmask;
    bit v set iff walking token v's text keeps the DFA alive (EOS bits
    set iff the state accepts; the dead state allows EOS alone).
  - a per-TOKENIZER `token_cps` int32 [V, Lmax] matrix (codepoints,
    256 = high, 257 = pad) lets the device ADVANCE the state after
    sampling: state' = fold(trans, token_cps[tok]), Lmax gathers.

The runner (engine/runner.py) stacks every registered FSM's tables and
applies them with `sampling/device.py::guided_mask_rows` and
`guided_advance` inside its decode windows and batched prefills.
Build cost is vectorized numpy (all states x all tokens advance one
codepoint per iteration), cached per (pattern, tokenizer) by the engine.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..types import NotSupportedError
from .regex_dfa import DFA

PAD_CP = 257      # column: stay in place
HIGH_CP = 256     # column: any codepoint >= 256
MAX_STATES = 4096


# ---------------------------------------------------------------------------
# Per-tokenizer vocab tables (shared by every FSM)
# ---------------------------------------------------------------------------

@dataclass
class VocabTable:
    token_cps: np.ndarray    # int32 [V, Lmax] codepoint columns (PAD_CP pad)
    valid: np.ndarray        # bool [V] non-empty, decodable tokens
    eos_ids: Tuple[int, ...]


_VOCAB_CACHE: Dict[int, VocabTable] = {}


def vocab_table(tokenizer, vocab_size: int) -> VocabTable:
    """Token id -> codepoint matrix. Cached per tokenizer instance."""
    key = id(tokenizer)
    hit = _VOCAB_CACHE.get(key)
    if hit is not None and hit.token_cps.shape[0] == vocab_size:
        return hit
    n = min(tokenizer.vocab_size, vocab_size)
    strings: List[str] = [
        tokenizer.decode([tid], skip_special_tokens=True)
        for tid in range(n)]
    lmax = max((len(s) for s in strings), default=1) or 1
    cps = np.full((vocab_size, lmax), PAD_CP, np.int32)
    valid = np.zeros(vocab_size, bool)
    for tid, s in enumerate(strings):
        if not s:
            continue
        valid[tid] = True
        row = [min(ord(c), HIGH_CP) for c in s]
        cps[tid, :len(row)] = row
    tab = VocabTable(token_cps=cps, valid=valid,
                     eos_ids=tuple(tokenizer.eos_token_ids))
    _VOCAB_CACHE[key] = tab
    return tab


# ---------------------------------------------------------------------------
# FSM compilation
# ---------------------------------------------------------------------------

@dataclass
class TokenFsm:
    """Dense guided-decoding tables for one compiled regex."""

    trans: np.ndarray        # int32 [S+1, 258]; row `dead` is absorbing
    mask_words: np.ndarray   # uint32 [S+1, W] packed allowed-token bits
    accepting: np.ndarray    # bool [S+1]
    start: int               # local start state id
    dead: int                # local dead state id (== S)
    dfa_to_local: Dict[int, int] = None  # DFA state id -> local row

    @property
    def num_states(self) -> int:
        return self.trans.shape[0]


def _high_representatives(dfa: DFA) -> List[int]:
    """Codepoints >= 256 that could behave differently (range edges)."""
    reps = {256, 0x10FFFF}
    for trs in dfa._nfa.trans:
        for ranges, _t in trs:
            for lo, hi in ranges:
                for cp in (lo, hi, lo - 1, hi + 1):
                    if 256 <= cp <= 0x10FFFF:
                        reps.add(cp)
    return sorted(reps)


def build_token_fsm(dfa: DFA, vocab: VocabTable,
                    vocab_size: int) -> TokenFsm:
    """Explore the DFA breadth-first over the dense char alphabet and
    compile transition + packed-mask tables.

    Raises NotSupportedError when the FSM exceeds MAX_STATES or a state
    distinguishes codepoints >= 256 (then the engine falls back to the
    host-masking path)."""
    high_reps = _high_representatives(dfa)

    local: Dict[int, int] = {dfa.start: 0}
    order: List[int] = [dfa.start]
    rows: List[np.ndarray] = []
    i = 0
    while i < len(order):
        sid = order[i]
        i += 1
        row = np.empty(258, np.int64)  # filled with local ids below
        targets: List[Optional[int]] = [
            dfa.step(sid, cp) for cp in range(256)]
        # High-plane uniformity check.
        high = dfa.step(sid, high_reps[0])
        for cp in high_reps[1:]:
            if dfa.step(sid, cp) != high:
                raise NotSupportedError(
                    "guided FSM distinguishes codepoints >= 256; "
                    "using host masking for this request")
        targets.append(high)                       # HIGH_CP column
        for col, tgt in enumerate(targets):
            if tgt is None:
                row[col] = -1                      # dead (patched later)
            else:
                nid = local.get(tgt)
                if nid is None:
                    nid = len(order)
                    if nid >= MAX_STATES:
                        raise NotSupportedError(
                            f"guided FSM exceeds {MAX_STATES} states; "
                            "using host masking for this request")
                    local[tgt] = nid
                    order.append(tgt)
                row[col] = nid
        row[PAD_CP] = local[sid]                   # pad: stay
        rows.append(row)

    s = len(order)
    dead = s
    trans = np.full((s + 1, 258), dead, np.int32)
    for li, row in enumerate(rows):
        r = row.copy()
        r[r < 0] = dead
        trans[li] = r
    trans[dead] = dead
    trans[dead, PAD_CP] = dead

    accepting = np.zeros(s + 1, bool)
    for sid, li in local.items():
        accepting[li] = dfa.is_accepting(sid)

    # Vectorized per-state token mask: advance ALL (state, token) pairs
    # one codepoint per iteration; dead state absorbs.
    cps = vocab.token_cps
    v, lmax = cps.shape
    cur = np.broadcast_to(
        np.arange(s + 1, dtype=np.int32)[:, None], (s + 1, v)).copy()
    for l in range(lmax):
        cur = trans[cur, cps[None, :, l]]
    allowed = (cur != dead) & vocab.valid[None, :]
    for eid in vocab.eos_ids:
        if eid < v:
            allowed[:, eid] = accepting
    allowed[dead, :] = False
    for eid in vocab.eos_ids:                      # dead: EOS-only escape
        if eid < v:
            allowed[dead, eid] = True

    w = (vocab_size + 31) // 32
    padded = np.zeros((s + 1, w * 32), bool)
    padded[:, :v] = allowed[:, :vocab_size]
    bits = padded.reshape(s + 1, w, 32).astype(np.uint32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))
    mask_words = (bits * weights[None, None, :]).sum(
        axis=2, dtype=np.uint32)

    return TokenFsm(trans=trans, mask_words=mask_words,
                    accepting=accepting, start=0, dead=dead,
                    dfa_to_local=dict(local))
