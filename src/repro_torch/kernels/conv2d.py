"""2-D convolution, the paper pool's ``conv2d`` (its 3x7x7 fconv2d; with
matmul, the pool's most compute-intensive kernel).

A valid convolution of a ``(C, H, W)`` input with one ``(C, k, k)`` filter,
giving ``(H-k+1, W-k+1)``, accumulated in fp32 over the taps ``ci, ki, kj``.
Two implementations, as in the reference (``repro/kernels/conv2d.py``):

* ``conv2d_cuda`` - the hand-written Hopper kernel in ``csrc/conv2d.cu``,
  replacing ``conv2d_pallas``: a thread block per 32 x 32 output tile, the
  input tile with its halo and the filter staged in shared memory one
  channel at a time.  Any H, W >= k (the Pallas kernel asserts that its
  8-row blocks divide H-k+1).  It adds one to ``LAUNCHES["conv2d"]`` per
  launch.
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
KERNELS_PER_CALL = 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TILE, _MAX_SMEM_FLOATS = 32, 12288     # csrc/conv2d.cu


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernels_per_call(*_shapes, **_kw) -> int:
    """Kernels one call launches, whatever the shapes."""
    return KERNELS_PER_CALL


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
    if (_TILE + k - 1) ** 2 + k * k > _MAX_SMEM_FLOATS:
        raise ValueError(f"{what}: a {k} x {k} filter's tile exceeds the "
                         "kernel's 48 KB of shared memory")
    out = torch.empty((h - k + 1, wd - k + 1), dtype=x.dtype,
                      device=x.device)
    lib = build.library(SOURCE)
    with torch.cuda.device(x.device):
        err = lib.repro_conv2d(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
            c, h, wd, k, torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, what)
    LAUNCHES["conv2d"] += KERNELS_PER_CALL
    return out
