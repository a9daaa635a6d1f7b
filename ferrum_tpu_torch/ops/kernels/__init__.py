"""Hand-written Hopper kernels of the port (CUDA C++ in `csrc/`).

Counterpart of `ferrum_tpu/ops/pallas/`. Every kernel has a plain
PyTorch version beside it in the same module; the wrapper takes the
plain version only for tensors on the CPU, and launches the kernel (or
raises) for tensors on a CUDA card -- never a silent fallback.

Each kernel's `Kernel` record below counts its launches (one per
wrapper call that launches it), so a run can show that its path went
through the kernel.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Kernel:
    name: str
    source: str        # CUDA source, relative to the repository root
    replaces: str      # the Pallas TPU kernel it replaces (file:line)
    launches: int = 0
    # Those of the launches made at decode sizes, where a kernel runs
    # another loop there (moe_grouped at <= 256 rows).
    decode_launches: int = 0


_CSRC = "ferrum_tpu_torch/ops/kernels/csrc"
_QMM = "ferrum_tpu/ops/pallas/quant_matmul.py"
_KVA = "ferrum_tpu/ops/pallas/kv_append.py"

W4A8TL_DECODE = Kernel("w4a8tl_decode", f"{_CSRC}/w4a8tl_gemm.cu",
                       f"{_QMM}:601 _qmm_w4a8tl_mxu_kernel")
W4A8TL_PREFILL = Kernel("w4a8tl_prefill", f"{_CSRC}/w4a8tl_gemm.cu",
                        f"{_QMM}:289 _qmm_w4a8tl_kernel")
KV_APPEND_ROWS = Kernel("kv_append_rows", f"{_CSRC}/kv_append.cu",
                        f"{_KVA}:46 kv_append_rows")
KV_APPEND_PAGES = Kernel("kv_append_pages", f"{_CSRC}/kv_append.cu",
                         f"{_KVA}:80 kv_append_pages")

MOE_BMM = Kernel("moe_bmm", f"{_CSRC}/moe_gemm.cu",
                 f"{_QMM}:1290 _qbmm_w4a8tl_mxu_kernel (and :1243 "
                 f"_qbmm_w4a8tl_kernel)")
MOE_GROUPED = Kernel("moe_grouped", f"{_CSRC}/moe_gemm.cu",
                     f"{_QMM}:1098 _qgmm_w4a8tl_kernel")

W4A16_GEMM = Kernel("w4a16_gemm", f"{_CSRC}/w4a16_gemm.cu",
                    f"{_QMM}:60 _qmm_kernel")
W4A8_DECODE = Kernel("w4a8_decode", f"{_CSRC}/w4a8_gemm.cu",
                     f"{_QMM}:172 _qmm_w4a8_kernel")
MOE_GROUPED_W4A16 = Kernel("moe_grouped_w4a16", f"{_CSRC}/w4a16_gemm.cu",
                           f"{_QMM}:970 _qgmm_kernel")

W4A8TL_GD_DECODE = Kernel("w4a8tl_gd_decode", f"{_CSRC}/w4a8tl_gd.cu",
                          f"{_QMM}:543 _qmm_w4a8tl_gd_kernel")
# Unwired, as in the JAX package: reached only through its wrapper.
W4A8TL_PREFILL_MCACHE = Kernel("w4a8tl_prefill_mcache",
                               f"{_CSRC}/w4a8tl_mcache.cu",
                               f"{_QMM}:339 _qmm_w4a8tl_mcache_kernel")

KERNELS = (W4A8TL_DECODE, W4A8TL_PREFILL, KV_APPEND_ROWS, KV_APPEND_PAGES,
           MOE_BMM, MOE_GROUPED, W4A16_GEMM, W4A8_DECODE, MOE_GROUPED_W4A16,
           W4A8TL_GD_DECODE, W4A8TL_PREFILL_MCACHE)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = k.decode_launches = 0


def launch_counts() -> dict:
    return {k.name: k.launches for k in KERNELS}
