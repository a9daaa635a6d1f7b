"""Speculative decoding: accept/reject verification on the host, and the
engine's counters.

Copy of `ferrum_tpu/engine/speculative.py` (numpy, no device code): the
Leviathan rejection-sampling scheme -- accept draft token t_i with
probability min(1, p_target(t_i) / p_draft(t_i)); on the first
rejection resample from the residual max(0, p - q), normalized; if all
K are accepted, sample one bonus token from the target's K+1-th
distribution. The output distribution equals sampling from the target
alone. The engine's rounds (engine/spec_decode.py) run the same scheme
on the device; `verify_speculation` is the host oracle tests hold them
to.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class SpeculationResult:
    accepted_tokens: List[int]     # accepted draft prefix + corrected/bonus
    num_draft_accepted: int        # how many of the K draft tokens survived
    used_bonus: bool


def _normalize(p: np.ndarray) -> np.ndarray:
    s = p.sum()
    if s <= 0:
        out = np.zeros_like(p)
        out[int(np.argmax(p))] = 1.0
        return out
    return p / s


def verify_speculation(
    draft_tokens: np.ndarray,      # int [K]
    draft_probs: np.ndarray,       # f32 [K, V] — draft distribution per step
    target_probs: np.ndarray,      # f32 [K+1, V] — target distribution per
                                   # position (incl. the bonus position)
    rng: np.random.Generator,
    greedy: bool = False,
) -> SpeculationResult:
    """Accept/reject the draft tokens against the target distributions."""
    k = len(draft_tokens)
    assert draft_probs.shape[0] == k and target_probs.shape[0] == k + 1
    out: List[int] = []
    for i in range(k):
        t = int(draft_tokens[i])
        p = float(target_probs[i, t])
        q = float(draft_probs[i, t])
        if greedy:
            accept = int(np.argmax(target_probs[i])) == t
        else:
            ratio = 1.0 if q <= 0 else min(1.0, p / q)
            accept = rng.random() < ratio
        if accept:
            out.append(t)
            continue
        # Rejected: resample from the residual max(0, p - q), normalized.
        if greedy:
            corrected = int(np.argmax(target_probs[i]))
        else:
            residual = np.maximum(target_probs[i] - draft_probs[i], 0.0)
            residual = _normalize(residual)
            corrected = int(rng.choice(len(residual), p=residual))
        out.append(corrected)
        return SpeculationResult(out, num_draft_accepted=i, used_bonus=False)
    # All K accepted → bonus token from the target's next distribution.
    if greedy:
        bonus = int(np.argmax(target_probs[k]))
    else:
        bonus = int(rng.choice(target_probs.shape[1],
                               p=_normalize(target_probs[k])))
    out.append(bonus)
    return SpeculationResult(out, num_draft_accepted=k, used_bonus=True)


@dataclass
class SpeculativeStats:
    proposals: int = 0
    drafted_tokens: int = 0
    accepted_tokens: int = 0

    @property
    def acceptance_rate(self) -> float:
        return self.accepted_tokens / max(self.drafted_tokens, 1)
