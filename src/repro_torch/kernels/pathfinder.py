"""Pathfinder, the paper pool's ``pathfinder`` (the RiVec row DP, whose
neighbour access is a slide by one).

Over a ``(rows, cols)`` cost grid, ``dst[j] = w[i][j] + min(src[j],
min(src[j-1], src[j+1]))`` row by row from ``src = w[0]``, the edge
columns' missing neighbours read as 3.0e38; returns the last row, fp32.
Two implementations, as in the reference (``repro/kernels/pathfinder.py``):

* ``pathfinder_cuda`` - the hand-written Hopper kernel in
  ``csrc/pathfinder.cu``, replacing ``pathfinder_pallas``: ghost-zone
  tiling, each launch advancing ``HEIGHT`` rows over 1024-column windows
  that need no exchange between blocks, a thread owning 4 contiguous
  columns (16 bytes of an fp32 cost row, 8 of a bf16 one), the next rows
  streaming into a ring in shared memory by ``cp.async``.  One C call launches every
  launch of a call; the wrapper adds them to ``LAUNCHES["pathfinder"]``:
  :func:`kernels_per_call` of them (``ceil((rows - 1) / HEIGHT)``, one for
  a single row).
* ``pathfinder_plain`` - the oracle's row loop (``ref.pathfinder_ref``).

Both fill the edge with the Pallas kernel's 3.0e38 (``_BIG``), where the
reference's oracle and ``pathfinder_xla`` use fp32's max (ROADMAP §3):
they differ only once a path cost passes 3e38.  The kernel equals the
plain version bit for bit.  ``repro_torch.kernels.ops.pathfinder`` picks
between them by the tensor's device.
"""
from __future__ import annotations

import torch

from . import build, ref

SOURCE = "pathfinder.cu"
LAUNCHES = {"pathfinder": 0}
# rows a launch advances: a multiple of 8 below 512 (csrc/pathfinder.cu's
# 1024-column window)
HEIGHT = 64
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernels_per_call(shape, *_shapes, **_kw) -> int:
    """Kernels one call launches on a (rows, cols) grid."""
    return max(1, -(-(shape[0] - 1) // HEIGHT))


pathfinder_plain = ref.pathfinder_ref     # the plain version is the oracle


def pathfinder_cuda(w):
    """The kernel: w (rows, cols), fp32 or bf16, rows and cols >= 1.
    Returns the (cols,) fp32 row.  Raises on anything else."""
    what = "pathfinder"
    build.check_operands(what, _DTYPE_CODE, w=w)
    if w.dim() != 2 or w.shape[0] < 1 or w.shape[1] < 1:
        raise ValueError(f"{what}: w {tuple(w.shape)} must be (rows, cols) "
                         "with rows, cols >= 1")
    rows, cols = w.shape
    if rows > _INT_MAX or cols > _INT_MAX:
        raise ValueError(f"{what}: {rows} x {cols} exceeds 2^31 - 1")
    launches = kernels_per_call(w.shape)
    # one C call launches them all, the rows ping-ponging between out and
    # scratch, the last launch writing out
    out = torch.empty(cols, dtype=torch.float32, device=w.device)
    scratch = torch.empty_like(out) if launches > 1 else None
    lib = build.library(SOURCE)
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = lib.repro_pathfinder(
            _DTYPE_CODE[w.dtype], w.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), rows, cols,
            HEIGHT, stream)
    build.check(lib, err, what)
    build.count(LAUNCHES, "pathfinder", launches)
    return out
