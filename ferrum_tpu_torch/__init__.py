"""ferrum_tpu_torch — the PyTorch / CUDA (Hopper) port of ferrum_tpu.

The module layout mirrors `ferrum_tpu/` so each port module sits at the
same relative path as its JAX counterpart. The package imports torch and
numpy only: never jax, never anything of `ferrum_tpu` (it keeps its own
copies of the host-only modules it needs).

Entry points run on the CUDA card unless the caller passes
`device="cpu"`; without a card they raise (`device.resolve_device`).
Every Pallas kernel of the served path has a hand-written CUDA C++
counterpart under `ops/kernels/csrc/`, built at first use.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
