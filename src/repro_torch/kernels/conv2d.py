"""2-D convolution, the paper pool's ``conv2d`` (its 3x7x7 fconv2d; with
matmul, the pool's most compute-intensive kernel).

A valid convolution of a ``(C, H, W)`` input with one ``(C, k, k)`` filter,
giving ``(H-k+1, W-k+1)``, accumulated in fp32 over the taps ``ci, ki, kj``.
Two implementations, as in the reference (``repro/kernels/conv2d.py``):

* ``conv2d_cuda`` - the hand-written Hopper kernels in ``csrc/conv2d.cu``,
  replacing ``conv2d_pallas``; the dtype picks the route (:func:`route`).
  bf16 runs ``mma``: the convolution as a banded (Toeplitz) product on
  ``mma.sync`` tensor cores with fp32 sums, ceil((k + 7) / 16) K-steps of
  16 a filter row.  fp32 runs ``simt``: a register-blocked direct convolution
  on CUDA cores (8 x 4 outputs a thread), each output's ``fmaf`` chain in
  the order ci, ki, kj.  Both stage a 64 x 128 output tile's input with
  its halo in shared memory one channel at a time.  Any C >= 1, H, W >= k
  and k up to :data:`MAX_K` (the Pallas kernel asserts that its 8-row
  blocks divide H-k+1).  Each call adds one to ``LAUNCHES["conv2d"]`` and
  to its route's count in ``ROUTES``.
* ``conv2d_plain`` - the oracle's tap loop (``ref.conv2d_ref``), cast to
  x's dtype.

Both return x's dtype, as ``conv2d_pallas`` does; the reference's
``conv2d_xla`` returns its oracle's fp32 for any input (ROADMAP §3).
``repro_torch.kernels.ops.conv2d`` picks between them by the tensor's
device.
"""
from __future__ import annotations

import torch

from . import build, ref

SOURCE = "conv2d.cu"
LAUNCHES = {"conv2d": 0}
# the same launches by route: "mma" (bf16, tensor cores), "simt" (fp32)
ROUTES = {"mma": 0, "simt": 0}
KERNELS_PER_CALL = 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ROUTE = {torch.bfloat16: "mma", torch.float32: "simt"}
# the largest filter: the first kernel's line, a 32 x 32 output tile with
# its halo and the filter in 48 KB of fp32 ((31 + k)^2 + k^2 <= 12288)
MAX_K = 61


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0


def kernels_per_call(*_shapes, **_kw) -> int:
    """Kernels one call launches, whatever the shapes."""
    return KERNELS_PER_CALL


def route(dtype, k: int) -> str:
    """The kernel that takes a ``k x k`` filter of ``dtype``: ``"mma"``
    (bf16, the banded product on tensor cores) or ``"simt"`` (fp32, CUDA
    cores).  Raises on any other dtype, or k outside 1 .. MAX_K."""
    if dtype not in _ROUTE:
        raise TypeError(f"conv2d: dtype {dtype}; the kernels take float32 "
                        "or bfloat16")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"conv2d: a {k} x {k} filter; the kernels take k "
                         f"from 1 to the largest, {MAX_K}")
    return _ROUTE[dtype]


def conv2d_plain(x, w):
    return ref.conv2d_ref(x, w).to(x.dtype)


def conv2d_cuda(x, w):
    """The kernel: x (C, H, W) and w (C, k, k), both fp32 or both bf16;
    returns (H-k+1, W-k+1) in x's dtype.  Raises on anything else."""
    what = "conv2d"
    build.check_operands(what, _DTYPE_CODE, x=x, w=w)
    if (x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0]
            or w.shape[1] != w.shape[2]):
        raise ValueError(f"{what}: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} must be (C, H, W) and (C, k, k)")
    c, h, wd = x.shape
    k = w.shape[1]
    if c < 1 or k < 1 or h < k or wd < k:
        raise ValueError(f"{what}: need C >= 1 and H, W >= k >= 1, got x "
                         f"{tuple(x.shape)}, k {k}")
    kind = route(x.dtype, k)
    out = torch.empty((h - k + 1, wd - k + 1), dtype=x.dtype,
                      device=x.device)
    lib = build.library(SOURCE)
    with torch.cuda.device(x.device):
        err = lib.repro_conv2d(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
            c, h, wd, k, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, what)
    LAUNCHES["conv2d"] += KERNELS_PER_CALL
    ROUTES[kind] += KERNELS_PER_CALL
    return out
