"""Locked structured profile events (JSONL) and the global sink.

Port of `ferrum_tpu/utils/profile.py`. The schema is locked: field
names, `SCHEMA_VERSION` and the kind / status / detail vocabularies are
the JAX package's, so `tools/analyze_profile.py` reads either package's
files. Bump SCHEMA_VERSION in both for any change.

Detail levels gate emission by event kind:
  off    -- nothing (a sink may still be configured; emit() no-ops)
  basic  -- iteration / compile / memory / error events (timed spans
            obey sample_rate)
  debug  -- adds the window / prefill dispatch spans and scheduler
            decisions
  full   -- adds per-request spans; sample_rate forced to 1.0

Memory events snapshot the CUDA card through `torch.cuda` (the JAX
package's key names), with host RSS beside it, and host RSS alone when
no card is in use.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Dict, Optional

SCHEMA_VERSION = 2

KINDS = ("instant", "timed_span", "resource", "memory", "error")
STATUSES = ("ok", "failure", "diagnostic_only")
DETAILS = ("off", "basic", "debug", "full")

# Events allowed at `basic`; everything else needs debug / full.
_BASIC_EVENTS = frozenset({
    "engine.iteration", "engine.compile", "engine.preempt",
    "engine.memory", "engine.start", "engine.stop", "error",
})
# Events added at `debug` (dispatch-level spans and decisions).
_DEBUG_PREFIXES = ("window.", "prefill.", "sched.")


@dataclass
class ProfileEvent:
    event: str                      # e.g. "engine.iteration", "window.fetch"
    entrypoint: str                 # run | serve | bench_serve | synthetic
    kind: str                       # one of KINDS
    status: str                     # one of STATUSES
    t_start: float
    duration_s: float
    attrs: Dict[str, Any] = field(default_factory=dict)
    schema: int = SCHEMA_VERSION


def parse_entrypoint(value: str) -> Optional[str]:
    v = value.strip().lower().replace("-", "_")
    if v == "benchserve":
        v = "bench_serve"
    return v if v in ("run", "serve", "bench_serve", "synthetic") else None


def parse_detail(value: str) -> Optional[str]:
    v = value.strip().lower()
    return v if v in DETAILS else None


class ProfileSink:
    """Writes admitted events as JSON lines. Emitters on several threads
    (the engine loop, bench workers) share one lock around each write."""

    def __init__(self, path: Optional[str], entrypoint: str = "synthetic",
                 sample_rate: float = 0.01, seed: int = 0,
                 detail: str = "basic",
                 memory_path: Optional[str] = None):
        assert detail in DETAILS, detail
        self.path = path
        self.entrypoint = entrypoint
        self.detail = detail
        self.sample_rate = 1.0 if detail == "full" else sample_rate
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._fh = open(path, "a") if path else None
        self._mem_fh = (open(memory_path, "a")
                        if memory_path and memory_path != path else None)
        self.events_emitted = 0
        self.events_sampled_out = 0
        self.events_detail_gated = 0

    # -- gating --------------------------------------------------------
    def _admit(self, event: str, kind: str) -> bool:
        if self.detail == "off":
            return False
        if self.detail == "full":
            return True
        if event in _BASIC_EVENTS or kind in ("memory", "error", "resource"):
            return True
        if self.detail == "debug":
            return event.startswith(_DEBUG_PREFIXES)
        return False                                     # basic: gated

    # -- emission ------------------------------------------------------
    def emit(self, event: str, duration_s: float,
             attrs: Optional[Dict[str, Any]] = None,
             force: bool = False, kind: str = "timed_span",
             status: str = "ok") -> None:
        fh = self._mem_fh if (kind == "memory" and self._mem_fh) else self._fh
        if fh is None:
            return
        if not self._admit(event, kind):
            self.events_detail_gated += 1
            return
        if (not force and kind == "timed_span"
                and self._rng.random() > self.sample_rate):
            self.events_sampled_out += 1
            return
        ev = ProfileEvent(event=event, entrypoint=self.entrypoint,
                          kind=kind, status=status,
                          t_start=time.time() - duration_s,
                          duration_s=duration_s, attrs=attrs or {})
        with self._lock:
            fh.write(json.dumps(asdict(ev)) + "\n")
            fh.flush()
            self.events_emitted += 1

    def emit_instant(self, event: str,
                     attrs: Optional[Dict[str, Any]] = None,
                     status: str = "ok") -> None:
        self.emit(event, 0.0, attrs, force=True, kind="instant",
                  status=status)

    def emit_error(self, event: str, message: str,
                   attrs: Optional[Dict[str, Any]] = None) -> None:
        a = dict(attrs or {})
        a["message"] = message
        self.emit(event, 0.0, a, force=True, kind="error",
                  status="failure")

    def emit_memory(self, attrs: Optional[Dict[str, Any]] = None) -> None:
        a = snapshot_memory()
        a.update(attrs or {})
        self.emit("engine.memory", 0.0, a, force=True, kind="memory")

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None
        if self._mem_fh:
            self._mem_fh.close()
            self._mem_fh = None


def snapshot_memory() -> Dict[str, Any]:
    """The CUDA card's allocator readings when a card is initialized in
    this process (device_bytes_in_use = memory_allocated,
    device_peak_bytes_in_use = max_memory_allocated, device_bytes_limit
    = the card's total memory), and host RSS -- one dict, stable keys,
    missing values omitted (torch reports no largest allocation, so
    device_largest_alloc_size never appears)."""
    out: Dict[str, Any] = {}
    try:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            out["device_bytes_in_use"] = int(torch.cuda.memory_allocated())
            out["device_peak_bytes_in_use"] = int(
                torch.cuda.max_memory_allocated())
            out["device_bytes_limit"] = int(torch.cuda.mem_get_info()[1])
    except Exception:
        pass
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        out["host_rss_bytes"] = pages * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        pass
    return out


_global_lock = threading.Lock()
_global_sink: Optional[ProfileSink] = None


def configure_global_profile(path: Optional[str],
                             entrypoint: str = "synthetic",
                             sample_rate: float = 0.01,
                             detail: str = "basic",
                             memory_path: Optional[str] = None
                             ) -> ProfileSink:
    global _global_sink
    with _global_lock:
        if _global_sink is not None:
            _global_sink.close()
        _global_sink = ProfileSink(path, entrypoint, sample_rate,
                                   detail=detail, memory_path=memory_path)
        return _global_sink


def global_profile() -> Optional[ProfileSink]:
    return _global_sink


def emit(event: str, duration_s: float,
         attrs: Optional[Dict[str, Any]] = None, force: bool = False,
         kind: str = "timed_span", status: str = "ok") -> None:
    sink = _global_sink
    if sink is not None:
        sink.emit(event, duration_s, attrs, force, kind=kind, status=status)


def emit_instant(event: str, attrs: Optional[Dict[str, Any]] = None,
                 status: str = "ok") -> None:
    sink = _global_sink
    if sink is not None:
        sink.emit_instant(event, attrs, status=status)


def emit_memory(attrs: Optional[Dict[str, Any]] = None) -> None:
    sink = _global_sink
    if sink is not None:
        sink.emit_memory(attrs)
