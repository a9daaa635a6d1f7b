"""Device selection for the port's entry points.

Counterpart of `ferrum_tpu/ops/pallas/__init__.py:on_tpu()`, with one
difference of policy: the JAX package falls back to its jnp references
off the TPU, the port does not. An entry point runs on the CUDA card by
default and raises when there is none; the CPU is used only when the
caller asks for it (`device="cpu"`, as the CPU parity tests do). Inside
the package a kernel wrapper picks its route from the tensor it is
given (`is_cuda`): CUDA tensors launch the kernel, CPU tensors take the
plain PyTorch version.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` → the first CUDA card (raises without one); an explicit
    device passes through after the same availability check."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ferrum_tpu_torch needs a CUDA device; pass device='cpu' to "
            "run the plain PyTorch versions on the host")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
