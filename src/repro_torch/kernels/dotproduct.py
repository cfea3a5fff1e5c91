"""Dot product, the paper pool's ``dotproduct``: the kernel of its 3-step
hierarchical reduction (contribution C3).

``sum(x * y)`` over two length-n vectors in fp32, a 0-d fp32 tensor.  Two
implementations, as in the reference (``repro/kernels/dotproduct.py``):

* ``dotproduct_cuda`` - the hand-written Hopper kernel in
  ``csrc/dotproduct.cu``, replacing ``dotproduct_pallas``: per-thread
  accumulation, a warp shuffle tree and a block tree, then a second pass
  over the per-block partials (no atomics: a repeated call returns the same
  bits).  Any n (the Pallas kernel asserts a multiple of 1024).  A call
  launches two kernels, the partial pass and the final one, and adds two
  to ``LAUNCHES["dotproduct"]``, so the count is of kernels, as for the
  other pool kernels.
* ``dotproduct_plain`` - the oracle's fp32 sum (``ref.dotproduct_ref``), the
  counterpart of ``dotproduct_xla``.

``repro_torch.kernels.ops.dotproduct`` picks between them by the tensor's
device.
"""
from __future__ import annotations

import torch

from . import build, ref

SOURCE = "dotproduct.cu"
LAUNCHES = {"dotproduct": 0}
KERNELS_PER_CALL = 2        # dot_partial_kernel, then dot_final_kernel
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the first pass's grid, a function of n alone (csrc/dotproduct.cu): one
# block of 256 threads per 4096 elements, at most 1024 blocks
_PER_BLOCK, _MAX_BLOCKS = 4096, 1024


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernels_per_call(*_shapes, **_kw) -> int:
    """Kernels one call launches, whatever the shapes."""
    return KERNELS_PER_CALL


def n_blocks(n: int) -> int:
    """Blocks of the first pass for n elements."""
    return max(1, min(_MAX_BLOCKS, -(-n // _PER_BLOCK)))


dotproduct_plain = ref.dotproduct_ref     # the plain version is the oracle


def dotproduct_cuda(x, y):
    """The kernel: x and y (n,), both fp32 or both bf16.  Returns a 0-d
    fp32 tensor.  Raises on anything else."""
    what = "dotproduct"
    build.check_operands(what, _DTYPE_CODE, x=x, y=y)
    if x.dim() != 1 or x.shape != y.shape:
        raise ValueError(f"{what}: x {tuple(x.shape)} and y "
                         f"{tuple(y.shape)} must be vectors of one length")
    n = x.shape[0]
    blocks = n_blocks(n)
    partial = torch.empty(blocks, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    lib = build.library(SOURCE)
    with torch.cuda.device(x.device):
        err = lib.repro_dotproduct(
            _DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
            partial.data_ptr(), out.data_ptr(), n, blocks,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, what)
    LAUNCHES["dotproduct"] += KERNELS_PER_CALL
    return out
