"""Row softmax, the paper pool's ``softmax`` (the ML "final attention
score" kernel; with dotproduct, the pool's reduction kernels).

Softmax over the last axis in fp32 math, the max subtracted first, out in
x's dtype.  Two implementations, as in the reference
(``repro/kernels/softmax.py``):

* ``softmax_cuda`` - the hand-written Hopper kernel in ``csrc/softmax.cu``,
  replacing ``softmax_pallas``: one thread block per row, the row cached in
  shared memory up to 12280 columns (re-read beyond).  Any shape; leading
  axes are rows.  It adds one to ``LAUNCHES["softmax"]`` per launch.
* ``softmax_plain`` - the oracle (``ref.softmax_ref``), the counterpart of
  ``softmax_xla``.

``repro_torch.kernels.ops.softmax`` picks between them by the tensor's
device.
"""
from __future__ import annotations

import torch

from . import build, ref

SOURCE = "softmax.cu"
LAUNCHES = {"softmax": 0}
KERNELS_PER_CALL = 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernels_per_call(*_shapes, **_kw) -> int:
    """Kernels one call launches, whatever the shapes."""
    return KERNELS_PER_CALL


softmax_plain = ref.softmax_ref     # the plain version is the oracle


def softmax_cuda(x):
    """The kernel: x of any shape (at least 1-D), fp32 or bf16; softmax
    over its last axis.  Raises on anything else."""
    what = "softmax"
    build.check_operands(what, _DTYPE_CODE, x=x)
    if x.dim() < 1:
        raise ValueError(f"{what}: x must have at least one axis")
    cols = x.shape[-1]
    rows = x.numel() // cols if cols else 0
    if cols > _INT_MAX or rows > _INT_MAX:
        raise ValueError(f"{what}: {rows} rows of {cols} exceed 2^31 - 1")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y                # nothing to launch
    lib = build.library(SOURCE)
    with torch.cuda.device(x.device):
        err = lib.repro_softmax(
            _DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(), rows, cols,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, what)
    build.count(LAUNCHES, "softmax", KERNELS_PER_CALL)
    return y
