"""Matrix product, the paper pool's ``matmul`` (the kernel of its 95%
utilisation and multi-core claims).

``(M, K) @ (K, N)`` with an fp32 accumulator, cast to ``out_dtype``
(default x's).  Two implementations, as in the reference
(``repro/kernels/matmul.py``):

* ``matmul_cuda`` - the hand-written Hopper kernel in ``csrc/matmul.cu``
  (fp32 on CUDA cores, bf16 on tensor cores), replacing ``matmul_pallas``.
  It takes any M, N, K (the TPU's 128^3 tile asserts are not the
  function's) and picks its own tiling.  It adds one to
  ``LAUNCHES["matmul"]`` per launch.
* ``matmul_plain`` - the oracle's fp32 product (``ref.matmul_ref``), the
  counterpart of ``matmul_xla``.  The CPU runs it, and ``chip_smoke.py``
  holds the kernel against it.

``repro_torch.kernels.ops.matmul`` picks between them by the tensor's
device.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

SOURCE = "matmul.cu"
LAUNCHES = {"matmul": 0}
KERNELS_PER_CALL = 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernels_per_call(*_shapes, **_kw) -> int:
    """Kernels one call launches, whatever the shapes."""
    return KERNELS_PER_CALL


matmul_plain = ref.matmul_ref       # the plain version is the oracle


def matmul_cuda(x, w, *, out_dtype=None):
    """The kernel: x (M, K) and w (K, N), both fp32 or both bf16; the
    output fp32 or bf16.  Raises on anything else."""
    what = "matmul"
    build.check_operands(what, _DTYPE_CODE, x=x, w=w)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: out_dtype {out_dtype}; the kernel writes "
                        "float32 or bfloat16")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"{what}: x {tuple(x.shape)} and w {tuple(w.shape)}"
                         " must be (M, K) and (K, N)")
    (m, k), n = x.shape, w.shape[1]
    if max(m, n, k) > _INT_MAX:
        raise ValueError(f"{what}: dimensions {(m, n, k)} exceed 2^31 - 1")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out              # nothing to launch
    lib = build.library(SOURCE)
    with torch.cuda.device(x.device):
        err = lib.repro_matmul(
            _DTYPE_CODE[x.dtype], _DTYPE_CODE[out_dtype], x.data_ptr(),
            w.data_ptr(), out.data_ptr(), m, n, k,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, what)
    LAUNCHES["matmul"] += KERNELS_PER_CALL
    return out
