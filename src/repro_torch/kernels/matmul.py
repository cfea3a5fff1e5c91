"""Matrix product, the paper pool's ``matmul`` (the kernel of its 95%
utilisation and multi-core claims).

``(M, K) @ (K, N)`` with an fp32 accumulator, cast to ``out_dtype``
(default x's).  Two implementations, as in the reference
(``repro/kernels/matmul.py``):

* ``matmul_cuda`` - the hand-written Hopper kernels in ``csrc/matmul.cu``,
  replacing ``matmul_pallas``, on one of three routes (:func:`route`):
  ``sgemm`` (fp32, CUDA cores), ``wgmma`` (bf16 on tensor cores, fed by
  TMA, wherever a TMA tensor map can describe both operands) and ``wmma``
  (the other bf16 shapes).  It takes any M, N, K (the TPU's 128^3 tile
  asserts are not the function's) and picks its own tiling.  It adds one
  to ``LAUNCHES["matmul"]`` and one to its route's count in ``ROUTES``
  per launch.
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
ROUTES = {"sgemm": 0, "wgmma": 0, "wmma": 0}    # the same launches by route
KERNELS_PER_CALL = 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0


def route(dtype, k: int, n: int, aligned: bool = True) -> str:
    """The kernel that takes an (M, K) @ (K, N) product of ``dtype``:
    ``"sgemm"`` for fp32; for bf16 ``"wgmma"`` where a TMA tensor map can
    describe both operands (K > 0, rows of A and B whole multiples of 16
    bytes, i.e. K % 8 == 0 and N % 8 == 0, and both bases 16-byte aligned:
    ``aligned``), else ``"wmma"``.  Raises on any other dtype."""
    if dtype == torch.float32:
        return "sgemm"
    if dtype != torch.bfloat16:
        raise TypeError(f"matmul: dtype {dtype}; the kernels take float32 "
                        "or bfloat16")
    return ("wgmma" if aligned and k > 0 and k % 8 == 0 and n % 8 == 0
            else "wmma")


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
    kind = route(x.dtype, k, n, aligned=_aligned(x, w))
    _launch(kind, x, w, out)
    LAUNCHES["matmul"] += KERNELS_PER_CALL
    ROUTES[kind] += 1
    return out


def _aligned(*ts) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def _launch(kind, x, w, out, trans_b=True) -> None:
    """One launch of route ``kind``'s kernel into ``out``.  ``trans_b``
    False (wgmma only) flips wgmma's transpose bit for B: a wrong product
    that the parity checks must reject (``matmul_transpose_bit_flipped``)."""
    (m, k), n = x.shape, w.shape[1]
    lib = build.library(SOURCE)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        if kind == "wgmma":
            err = lib.repro_matmul_wgmma(
                _DTYPE_CODE[out.dtype], int(trans_b), x.data_ptr(),
                w.data_ptr(), out.data_ptr(), m, n, k, stream)
        else:
            err = lib.repro_matmul(
                _DTYPE_CODE[x.dtype], _DTYPE_CODE[out.dtype], x.data_ptr(),
                w.data_ptr(), out.data_ptr(), m, n, k, stream)
    build.check(lib, err, "matmul")


def matmul_transpose_bit_flipped(x, w):
    """A planted fault: the wgmma route's product with B's transpose bit
    flipped (B read as if it were (N, K) row-major), fp32 out.  Counts no
    launch; it exists only for the checks that must reject it."""
    build.check_operands("matmul", (torch.bfloat16,), x=x, w=w)
    (m, k), n = x.shape, w.shape[1]
    if route(x.dtype, k, n, aligned=_aligned(x, w)) != "wgmma":
        raise ValueError("matmul: the plant needs a wgmma-route product")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _launch("wgmma", x, w, out, trans_b=False)
    return out
