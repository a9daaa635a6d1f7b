"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each `csrc/*.cu` source compiles with nvcc into its own shared library
(`-gencode arch=compute_90a,code=sm_90a`), all sources in parallel, at
first use. Libraries land in `build/ferrum_tpu_torch/<hash>/` at the
repository root, keyed by a hash of the sources and flags, so a changed
source rebuilds and an unchanged one loads from disk. No PyTorch header
is compiled: pointers and the stream cross as `c_void_p`, and every C
entry point returns `cudaGetLastError()` for its wrapper to check.

Nothing here runs at import time; `library(name)` builds on first call.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
BUILD_ROOT = os.path.join(REPO_ROOT, "build", "ferrum_tpu_torch")
SOURCES = ("w4a8tl_gemm", "kv_append", "moe_gemm", "w4a16_gemm",
           "w4a8_gemm", "w4a8tl_gd", "w4a8tl_mcache")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
# C signatures of every entry point (argtypes; restype is int).
SIGNATURES = {
    "w4a8tl_gemm": {
        "ferrum_w4a8tl_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _P],
        "ferrum_w4a8tl_prefill": [_P, _P, _P, _P, _P, _P, _P,
                                  _I, _I, _I, _I, _P],
        "ferrum_w4a8tl_decode_plan": [_I, _I, _I, _I, _P],
    },
    "w4a8tl_gd": {
        "ferrum_w4a8tl_gd_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _P],
        "ferrum_w4a8tl_gd_decode_plan": [_I, _I, _I, _I, _P],
    },
    "w4a8tl_mcache": {
        "ferrum_w4a8tl_prefill_mcache": [_P, _P, _P, _P, _P, _P, _P,
                                         _I, _I, _I, _I, _P],
    },
    "moe_gemm": {
        "ferrum_moe_bmm": [_P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, _I, _I, _I, _P],
        "ferrum_moe_bmm_plan": [_I, _I, _I, _I, _P],
        "ferrum_moe_grouped": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _P],
        "ferrum_moe_grouped_decode": [_P, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _I, _I, _I, _I, _P],
        "ferrum_moe_grouped_plan": [_I, _I, _I, _I, _P],
    },
    "w4a16_gemm": {
        "ferrum_w4a16_gemm": [_P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P],
        "ferrum_w4a16_decode_plan": [_I, _I, _I, _I, _P],
        "ferrum_moe_grouped_w4a16": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _I, _I, _I, _I, _I, _P],
        "ferrum_moe_grouped_w4a16_plan": [_I, _I, _I, _P],
    },
    "w4a8_gemm": {
        "ferrum_w4a8_decode": [_P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _I, _I, _I, _P],
        "ferrum_w4a8_decode_plan": [_I, _I, _I, _I, _P],
    },
    "kv_append": {
        "ferrum_kv_append_rows": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _P],
        "ferrum_kv_append_pages": [_P, _P, _P, _I, _P, _I, _I, _P],
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# Libraries `library` brought into this process, in order: built here or
# loaded from an earlier build (a library's first use, the eager
# counterpart of a program's first trace). The engine runner's compile
# audit reads it (engine/runner.py `_note_kernel_builds`).
LOADED: List[str] = []


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels build on a machine with the toolkit")


def _digest(name: str) -> str:
    """Hash of `name`.cu, every header in csrc/ (a source may include any
    of them) and the flags."""
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_ROOT, _digest(name), f"lib{name}.so")


def build_all() -> float:
    """Compile every source that is not built yet, one nvcc process per
    source, all started together. Returns the wall seconds spent."""
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        os.makedirs(os.path.dirname(out), exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exit {proc.returncode}\n"
                          f"{log.decode(errors='replace')}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of one source (built at first use)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not os.path.exists(path):
                build_all()
            lib = ctypes.CDLL(path)
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            _libs[name] = lib
            LOADED.append(name)
    return lib


def check(err: int, what: str) -> None:
    """Raise on a nonzero cudaError_t returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
