"""Requests, responses and errors of the engine boundary.

Port of `ferrum_tpu/types.py`, trimmed to the served path (no guided
decoding, echo scoring, LoRA or stop strings yet). Plain dataclasses.
"""

from __future__ import annotations

import enum
import uuid
from dataclasses import dataclass, field
from typing import List, Optional


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


class EngineStoppedError(FerrumError):
    code = "engine_stopped"


class FinishReason(str, enum.Enum):
    STOP = "stop"            # EOS
    LENGTH = "length"        # max_tokens reached
    ABORT = "abort"
    ERROR = "error"


@dataclass
class SamplingParams:
    """temperature == 0 means greedy; top_k == 0 and top_p == 1 are off."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    repetition_penalty: float = 1.0
    max_tokens: int = 512
    min_tokens: int = 0
    stop_token_ids: List[int] = field(default_factory=list)
    ignore_eos: bool = False

    def validate(self) -> None:
        if self.temperature < 0.0:
            raise InvalidRequestError("temperature must be >= 0",
                                      param="temperature")
        if not (0.0 < self.top_p <= 1.0):
            raise InvalidRequestError("top_p must be in (0, 1]",
                                      param="top_p")
        if self.top_k < 0:
            raise InvalidRequestError("top_k must be >= 0", param="top_k")
        if self.max_tokens < 1:
            raise InvalidRequestError("max_tokens must be >= 1",
                                      param="max_tokens")
        if self.repetition_penalty <= 0.0:
            raise InvalidRequestError("repetition_penalty must be > 0",
                                      param="repetition_penalty")


@dataclass
class InferenceRequest:
    """`prompt_token_ids` may be given pre-tokenized; else `prompt` is
    tokenized by the engine."""

    prompt: Optional[str] = None
    prompt_token_ids: Optional[List[int]] = None
    sampling: SamplingParams = field(default_factory=SamplingParams)
    request_id: str = field(
        default_factory=lambda: f"req-{uuid.uuid4().hex[:16]}")


@dataclass
class StreamChunk:
    request_id: str
    text: str
    token_ids: List[int]
    finished: bool = False
    finish_reason: Optional[FinishReason] = None
    prompt_tokens: int = 0
    completion_tokens: int = 0


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
