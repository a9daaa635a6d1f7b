"""Requests, responses and errors of the engine boundary.

Port of `ferrum_tpu/types.py` without LoRA: sampling parameters with
stop strings, per-request seeds and prompt scoring (`logprobs` with
`InferenceRequest.echo`), `GuidedOptions` (guided decoding), and the
engine's metrics snapshot. Plain dataclasses.
"""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class FerrumError(Exception):
    code = "internal_error"

    def __init__(self, message: str, *, param: Optional[str] = None):
        super().__init__(message)
        self.message = message
        self.param = param


class InvalidRequestError(FerrumError):
    code = "invalid_request_error"


class ModelLoadError(FerrumError):
    code = "model_load_error"


class CapacityError(FerrumError):
    code = "capacity_error"


class NotSupportedError(FerrumError):
    code = "not_supported"


class EngineStoppedError(FerrumError):
    code = "engine_stopped"


class FinishReason(str, enum.Enum):
    STOP = "stop"            # EOS or stop string
    LENGTH = "length"        # max_tokens reached
    TOOL_CALLS = "tool_calls"
    ABORT = "abort"
    ERROR = "error"


@dataclass
class SamplingParams:
    """temperature == 0 means greedy; top_k == 0 and top_p == 1 are off.
    `seed`: the request's own sampling stream (runner.py); `logprobs`
    with `InferenceRequest.echo` and max_tokens == 0 scores the prompt."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    max_tokens: int = 512
    min_tokens: int = 0
    stop: List[str] = field(default_factory=list)
    stop_token_ids: List[int] = field(default_factory=list)
    seed: Optional[int] = None
    ignore_eos: bool = False
    logprobs: Optional[int] = None

    def validate(self) -> None:
        if self.temperature < 0.0:
            raise InvalidRequestError("temperature must be >= 0",
                                      param="temperature")
        if not (0.0 < self.top_p <= 1.0):
            raise InvalidRequestError("top_p must be in (0, 1]",
                                      param="top_p")
        if self.top_k < 0:
            raise InvalidRequestError("top_k must be >= 0", param="top_k")
        if self.max_tokens < 0:
            # 0 = prompt-only scoring (echo + logprobs, no generation).
            raise InvalidRequestError("max_tokens must be >= 0",
                                      param="max_tokens")
        if self.repetition_penalty <= 0.0:
            raise InvalidRequestError("repetition_penalty must be > 0",
                                      param="repetition_penalty")


@dataclass
class GuidedOptions:
    """Structured-output constraints (the JAX package's type): a regex,
    a JSON schema (its subset: sampling/schema.py) or JSON mode. `strict`
    is the server's: a strict schema fails fast outside the subset and
    its output is validated after generation."""

    regex: Optional[str] = None
    json_schema: Optional[Dict[str, Any]] = None
    json_mode: bool = False
    strict: bool = True


@dataclass
class InferenceRequest:
    """`prompt_token_ids` may be given pre-tokenized; else `prompt` is
    tokenized by the engine. `echo` with `sampling.logprobs` and
    max_tokens == 0: the engine returns per-prompt-position logprobs."""

    prompt: Optional[str] = None
    prompt_token_ids: Optional[List[int]] = None
    sampling: SamplingParams = field(default_factory=SamplingParams)
    guided: Optional[GuidedOptions] = None
    echo: bool = False
    request_id: str = field(
        default_factory=lambda: f"req-{uuid.uuid4().hex[:16]}")
    priority: int = 0
    arrival_time: float = field(default_factory=time.monotonic)


@dataclass
class StreamChunk:
    request_id: str
    text: str
    token_ids: List[int]
    finished: bool = False
    finish_reason: Optional[FinishReason] = None
    prompt_tokens: int = 0
    completion_tokens: int = 0
    logprobs: Optional[List[Dict[str, Any]]] = None


@dataclass
class InferenceResponse:
    request_id: str
    text: str
    token_ids: List[int]
    finish_reason: FinishReason
    prompt_tokens: int
    completion_tokens: int
    ttft: Optional[float] = None          # seconds, host clock
    e2e_latency: Optional[float] = None
    logprobs: Optional[List[Dict[str, Any]]] = None


@dataclass
class EngineMetricsSnapshot:
    """The engine's counters (the JAX package's fields and defaults).
    `kv_blocks_free`: the paged pool's free blocks, or on the linear
    layout the pool less the blocks running sequences hold; the
    prefix-cache fields are the cache's hits, misses and reused
    tokens."""

    iterations_total: int = 0
    requests_submitted: int = 0
    requests_completed: int = 0
    requests_preempted: int = 0
    tokens_prefilled: int = 0
    tokens_decoded: int = 0
    kv_blocks_total: int = 0
    kv_blocks_free: int = 0
    waiting_requests: int = 0
    running_requests: int = 0
    prefix_cache_hits: int = 0
    prefix_cache_misses: int = 0
    prefix_cache_saved_tokens: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.__dict__)
