"""Jacobi 2-D, the paper pool's ``jacobi2d`` (a 5-point stencil, whose
halo is the slide by one of contribution C2).

``steps`` sweeps of ``0.2 * ((((centre + up) + down) + left) + right)`` over
the interior of an ``(H, W)`` array, the boundary kept, in x's dtype (bf16
rounds each add and the product, 0.2 itself rounded to bf16).  Two
implementations, as in the reference (``repro/kernels/jacobi2d.py``):

* ``jacobi2d_cuda`` - the hand-written Hopper kernel in
  ``csrc/jacobi2d.cu``, replacing ``jacobi2d_pallas``: one launch a sweep,
  ping-ponging two buffers, a thread a point.  Any H and W (the Pallas
  kernel asserts that 8 divides H - 2; below 3 the sweep is a copy).  The
  wrapper adds one to ``LAUNCHES["jacobi2d"]`` per launch:
  :func:`kernels_per_call` of them a call, one a sweep.
* ``jacobi2d_plain`` - the oracle's sweeps (``ref.jacobi2d_ref``), the
  counterpart of ``jacobi2d_xla``, which takes ``steps`` too.

The kernel equals the plain version bit for bit, in fp32 and bf16.
``repro_torch.kernels.ops.jacobi2d`` picks between them by the tensor's
device.
"""
from __future__ import annotations

import torch

from . import build, ref

SOURCE = "jacobi2d.cu"
LAUNCHES = {"jacobi2d": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernels_per_call(*_shapes, steps=1, **_kw) -> int:
    """Kernels one call launches: one a sweep."""
    return steps


def jacobi2d_plain(x, steps=1):
    return ref.jacobi2d_ref(x, steps)


def jacobi2d_cuda(x, steps=1):
    """The kernel: x (H, W), fp32 or bf16, H, W >= 1, ``steps`` >= 0
    sweeps.  Returns a new (H, W) array in x's dtype.  Raises on anything
    else."""
    what = "jacobi2d"
    build.check_operands(what, _DTYPE_CODE, x=x)
    if x.dim() != 2 or x.shape[0] < 1 or x.shape[1] < 1:
        raise ValueError(f"{what}: x {tuple(x.shape)} must be (H, W) with "
                         "H, W >= 1")
    if x.shape[0] > _INT_MAX or x.shape[1] > _INT_MAX:
        raise ValueError(f"{what}: {tuple(x.shape)} exceeds 2^31 - 1")
    if not isinstance(steps, int) or steps < 0:
        raise ValueError(f"{what}: steps={steps!r} must be an int >= 0")
    out = torch.empty_like(x)
    if steps == 0:
        return out.copy_(x)
    # the sweeps ping-pong between out and scratch, the last writing out
    scratch = torch.empty_like(x) if steps > 1 else None
    lib = build.library(SOURCE)
    h, w = x.shape
    src = x
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        for i in range(steps):
            dst = out if (steps - 1 - i) % 2 == 0 else scratch
            err = lib.repro_jacobi2d(_DTYPE_CODE[x.dtype], src.data_ptr(),
                                     dst.data_ptr(), h, w, stream)
            build.check(lib, err, what)
            LAUNCHES["jacobi2d"] += 1
            src = dst
    return out
