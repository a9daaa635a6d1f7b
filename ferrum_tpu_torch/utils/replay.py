"""Request replay bundles: capture a request for an offline repro.

Port of `ferrum_tpu/utils/replay.py`, with the same `BUNDLE_SCHEMA`: a
bundle is a JSON file holding the engine-boundary request (token ids,
sampling params, guided options), the effective runtime config and the
observed output, enough to re-run the request on any machine. A bundle
the JAX package wrote loads here, its sampling fields (stop strings,
per-request seeds and logprobs too) into the port's `SamplingParams`,
its guided options into `GuidedOptions`; a sampling field the port does
not know raises InvalidRequestError naming it.
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, Optional

from ..config import EngineConfig
from ..types import (GuidedOptions, InferenceRequest, InvalidRequestError,
                     SamplingParams)

BUNDLE_SCHEMA = 1


def capture_bundle(request: InferenceRequest, cfg: EngineConfig,
                   model_label: str,
                   response_token_ids: Optional[list] = None,
                   error: Optional[str] = None) -> Dict[str, Any]:
    return {
        "schema": BUNDLE_SCHEMA,
        "captured_at": time.time(),
        "model": model_label,
        "request": {
            "request_id": request.request_id,
            "prompt_token_ids": request.prompt_token_ids,
            "prompt": request.prompt,
            "sampling": dataclasses.asdict(request.sampling),
            "guided": dataclasses.asdict(request.guided)
            if request.guided else None,
        },
        "effective_config": {
            k: v for k, v in dataclasses.asdict(cfg).items()
            if not callable(v)
        },
        "observed": {
            "response_token_ids": response_token_ids,
            "error": error,
        },
    }


def save_bundle(bundle: Dict[str, Any], path: str) -> None:
    with open(path, "w") as f:
        json.dump(bundle, f, indent=2)


def load_bundle(path: str) -> Dict[str, Any]:
    with open(path) as f:
        bundle = json.load(f)
    if bundle.get("schema") != BUNDLE_SCHEMA:
        raise ValueError(f"unknown bundle schema {bundle.get('schema')}")
    return bundle


def request_from_bundle(bundle: Dict[str, Any]) -> InferenceRequest:
    r = bundle["request"]
    ported = {f.name for f in dataclasses.fields(SamplingParams)}
    kw = {}
    for name, value in r["sampling"].items():
        if name not in ported:
            raise InvalidRequestError(
                f"sampling.{name}={value!r} is not yet ported",
                param=name)
        kw[name] = value
    return InferenceRequest(
        prompt=r.get("prompt"),
        prompt_token_ids=r.get("prompt_token_ids"),
        sampling=SamplingParams(**kw),
        guided=GuidedOptions(**r["guided"]) if r.get("guided") else None,
        request_id=r["request_id"] + "-replay")


def replay_bundle(path: str, engine) -> Dict[str, Any]:
    """Re-run a bundle through an engine; returns the comparison record."""
    bundle = load_bundle(path)
    req = request_from_bundle(bundle)
    res = engine.infer(req)
    want = bundle["observed"].get("response_token_ids")
    return {
        "request_id": req.request_id,
        "token_ids": res.token_ids,
        "matches_observed": want is None or want == res.token_ids,
        "finish_reason": res.finish_reason.value,
    }
