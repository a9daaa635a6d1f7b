"""The safetensors file format, read and written without `safetensors`.

The card's machine has no `safetensors` package, so the port keeps its
own reader (checkpoint loading, models/loader.py) and writer (local test
checkpoints). A file is:

  8 bytes     little-endian u64: the header's length n
  n bytes     JSON: {name: {"dtype", "shape", "data_offsets": [b, e]}, ...}
              and an optional "__metadata__" of strings (skipped)
  the rest    the tensors' bytes, little-endian, row-major; a tensor's
              bytes are [8 + n + b, 8 + n + e)

The reader copies one tensor at a time out of the file (`readinto` a
buffer of the tensor's size; no mapping, whose pages would count in the
process's RSS), so host memory holds one tensor, not the file. BF16 has no numpy
dtype: its bytes are read as int16 and viewed as `torch.bfloat16`.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..types import ModelLoadError

# safetensors dtype -> (numpy dtype of the bytes, torch dtype).
DTYPES: Dict[str, Tuple[np.dtype, torch.dtype]] = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<i2"), torch.bfloat16),
    "I64": (np.dtype("<i8"), torch.int64),
    "I32": (np.dtype("<i4"), torch.int32),
    "I16": (np.dtype("<i2"), torch.int16),
    "I8": (np.dtype("i1"), torch.int8),
    "U8": (np.dtype("u1"), torch.uint8),
    "BOOL": (np.dtype("?"), torch.bool),
}
_TORCH_NAMES = {t: name for name, (_, t) in DTYPES.items()}
MAX_HEADER = 100 << 20


class SafetensorsFile:
    """One safetensors file: its header read at once; `get(name)` copies
    one tensor out as a CPU tensor."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size < 8:
                raise ModelLoadError(
                    f"{path}: too short for a safetensors file")
            (n,) = struct.unpack("<Q", f.read(8))
            if n > MAX_HEADER or 8 + n > size:
                raise ModelLoadError(
                    f"{path}: bad safetensors header length {n}")
            try:
                header = json.loads(f.read(n))
            except ValueError as e:
                raise ModelLoadError(f"{path}: bad safetensors header: {e}")
        self._base = 8 + n
        self._entries = {k: v for k, v in header.items()
                         if k != "__metadata__"}
        for name, e in self._entries.items():
            self._check(name, e, size)

    def _check(self, name: str, e: dict, size: int) -> None:
        if e.get("dtype") not in DTYPES:
            raise ModelLoadError(
                f"{self.path}: tensor {name!r} has dtype {e.get('dtype')!r}; "
                f"the port reads {sorted(DTYPES)}", param=name)
        begin, end = e["data_offsets"]
        count = int(np.prod(e["shape"], dtype=np.int64))
        if (end - begin != count * DTYPES[e["dtype"]][0].itemsize
                or begin < 0 or self._base + end > size):
            raise ModelLoadError(
                f"{self.path}: tensor {name!r}: data_offsets {begin}..{end} "
                f"do not hold {e['dtype']} {e['shape']}", param=name)

    def keys(self):
        return self._entries.keys()

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def get(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        np_dtype, dtype = DTYPES[e["dtype"]]
        begin, end = (self._base + x for x in e["data_offsets"])
        out = np.empty(e["shape"], dtype=np_dtype)
        with open(self.path, "rb") as f:
            f.seek(begin)
            if f.readinto(out.reshape(-1).view(np.uint8)) != end - begin:
                raise ModelLoadError(
                    f"{self.path}: tensor {name!r} ends early", param=name)
        t = torch.from_numpy(out)
        return t.view(torch.bfloat16) if dtype == torch.bfloat16 else t


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor],
                      metadata: Optional[Dict[str, str]] = None) -> None:
    """Write `tensors` (any device; one is copied to the host at a time)
    back to back in the order given, the header padded with spaces to a
    multiple of 8 bytes as the reference writer pads it."""
    header: Dict[str, object] = {}
    if metadata:
        header["__metadata__"] = dict(metadata)
    offset = 0
    for name, t in tensors.items():
        if t.dtype not in _TORCH_NAMES:
            raise ModelLoadError(f"tensor {name!r}: dtype {t.dtype} has no "
                                 f"safetensors name here", param=name)
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _TORCH_NAMES[t.dtype],
                        "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            host = t.detach().contiguous().cpu()
            if host.dtype == torch.bfloat16:
                host = host.view(torch.int16)
            f.write(host.numpy().data)
