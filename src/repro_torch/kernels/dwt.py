"""1-D Haar DWT, the paper pool's ``dwt`` (its misaligned strided memory
access workload).

Each level halves the running approximation: lo, hi = (even +- odd) *
fl32(1/sqrt 2); the output is [lo_L, hi_L, ..., hi_1] in x's dtype.  Two
implementations, as in the reference (``repro/kernels/dwt.py``):

* ``dwt_haar_cuda`` - the hand-written Hopper kernel in ``csrc/dwt.cu``,
  replacing ``dwt_haar_pallas`` (one Pallas launch a level, then a
  concatenation): one launch computes up to ``LEVELS_PER_LAUNCH`` levels
  from one read of x and writes each in its place; deeper transforms go
  on from the last lo with another launch.  Any n divisible by 2^levels
  (the Pallas kernel also asks its 512-pair blocks to divide each level).
  The wrapper adds one to ``LAUNCHES["dwt"]`` per launch:
  :func:`kernels_per_call` of them a call.
* ``dwt_haar_plain`` - the per-level schedule (``ref.dwt_haar_ref``):
  in fp32 the bits of the reference's oracle ``dwt_haar_xla``, in bf16
  the Pallas kernel's bits and dtype (ROADMAP §3).

The kernel equals the plain version bit for bit, in fp32 and bf16.
``repro_torch.kernels.ops.dwt_haar`` picks between them by the tensor's
device.
"""
from __future__ import annotations

import torch

from . import build, ref

SOURCE = "dwt.cu"
LAUNCHES = {"dwt": 0}
LEVELS_PER_LAUNCH = 10          # a block's 1024 inputs (csrc/dwt.cu)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernels_per_call(*_shapes, levels=1, **_kw) -> int:
    """Kernels one call launches: one for every ``LEVELS_PER_LAUNCH``
    levels or part of them."""
    return -(-levels // LEVELS_PER_LAUNCH)


def dwt_haar_plain(x, *, levels=1):
    return ref.dwt_haar_ref(x, levels)


def dwt_haar_cuda(x, *, levels=1):
    """The kernel: x (n,), fp32 or bf16, on a CUDA device, ``levels`` >= 1
    with 2^levels dividing n (ValueError otherwise).  Returns (n,) in x's
    dtype."""
    what = "dwt_haar"
    build.check_operands(what, _DTYPE_CODE, x=x)
    if x.dim() != 1:
        raise ValueError(f"{what}: x {tuple(x.shape)} must be a vector")
    n = x.shape[0]
    ref.dwt_check(n, levels)
    out = torch.empty_like(x)
    lib = build.library(SOURCE)
    src, m, left = x, n, levels
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        while left:
            here = min(left, LEVELS_PER_LAUNCH)
            # the last launch writes lo_L into the output's head; an earlier
            # one into scratch, which the next launch reads
            lo = out if here == left else torch.empty(
                m >> here, dtype=x.dtype, device=x.device)
            err = lib.repro_dwt_haar(_DTYPE_CODE[x.dtype], src.data_ptr(), m,
                                     here, out.data_ptr(), lo.data_ptr(),
                                     stream)
            build.check(lib, err, what)
            LAUNCHES["dwt"] += 1
            src, m, left = lo, m >> here, left - here
    return out
