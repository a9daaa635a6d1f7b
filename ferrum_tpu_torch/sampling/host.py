"""Host-side logits-processor chain and `sample_host`.

Port of `ferrum_tpu/sampling/host.py`, the same numpy code, so that the
host-masked guided path draws what the JAX engine draws from equal
logits and an equal `np.random.Generator`: repetition penalty,
temperature, top-k, top-p, then the guided mask, then argmax or a
multinomial draw.
"""

from __future__ import annotations

from typing import List, Optional, Protocol, Sequence

import numpy as np

from ..types import SamplingParams


class LogitsProcessor(Protocol):
    def __call__(self, logits: np.ndarray, token_history: Sequence[int]
                 ) -> np.ndarray: ...


class TemperatureProcessor:
    def __init__(self, temperature: float):
        self.temperature = max(temperature, 1e-5)

    def __call__(self, logits, token_history):
        return logits / self.temperature


class RepetitionPenaltyProcessor:
    def __init__(self, penalty: float):
        self.penalty = penalty

    def __call__(self, logits, token_history):
        if self.penalty == 1.0 or not len(token_history):
            return logits
        logits = logits.copy()
        seen = np.unique(np.asarray(token_history))
        seen = seen[(seen >= 0) & (seen < logits.shape[-1])]
        vals = logits[seen]
        logits[seen] = np.where(vals > 0, vals / self.penalty,
                                vals * self.penalty)
        return logits


class TopKProcessor:
    def __init__(self, k: int):
        self.k = k

    def __call__(self, logits, token_history):
        if self.k <= 0 or self.k >= logits.shape[-1]:
            return logits
        kth = np.partition(logits, -self.k)[-self.k]
        out = logits.copy()
        out[out < kth] = -np.inf
        return out


class TopPProcessor:
    def __init__(self, p: float):
        self.p = p

    def __call__(self, logits, token_history):
        if self.p >= 1.0:
            return logits
        order = np.argsort(-logits)
        probs = _softmax(logits[order])
        cum_before = np.cumsum(probs) - probs
        keep = cum_before < self.p
        keep[0] = True
        out = np.full_like(logits, -np.inf)
        out[order[keep]] = logits[order[keep]]
        return out


def _softmax(x: np.ndarray) -> np.ndarray:
    m = np.max(x[np.isfinite(x)]) if np.isfinite(x).any() else 0.0
    e = np.exp(np.clip(x - m, -80, 80), where=np.isfinite(x),
               out=np.zeros_like(x))
    return e / e.sum()


class LogitsProcessorChain:
    def __init__(self, processors: List[LogitsProcessor]):
        self.processors = processors

    def __call__(self, logits: np.ndarray,
                 token_history: Sequence[int]) -> np.ndarray:
        out = np.asarray(logits, dtype=np.float32)
        for p in self.processors:
            out = p(out, token_history)
        return out

    @classmethod
    def from_params(cls, sp: SamplingParams) -> "LogitsProcessorChain":
        ps: List[LogitsProcessor] = []
        if sp.repetition_penalty != 1.0:
            ps.append(RepetitionPenaltyProcessor(sp.repetition_penalty))
        if sp.temperature > 0:
            ps.append(TemperatureProcessor(sp.temperature))
            if sp.top_k:
                ps.append(TopKProcessor(sp.top_k))
            if sp.top_p < 1.0:
                ps.append(TopPProcessor(sp.top_p))
        return cls(ps)


def sample_host(logits: np.ndarray, sp: SamplingParams,
                token_history: Sequence[int],
                rng: np.random.Generator,
                mask: Optional[np.ndarray] = None) -> int:
    """Full host path: chain → optional guided mask → greedy/multinomial."""
    processed = LogitsProcessorChain.from_params(sp)(logits, token_history)
    if mask is not None:
        processed = np.where(mask, processed, -np.inf)
    if sp.temperature <= 0.0:
        return int(np.argmax(processed))
    probs = _softmax(processed)
    return int(rng.choice(len(probs), p=probs))
