"""Dropout, the paper pool's ``dropout`` (its mask-unit workload, MASKU in
Table 2).

With precomputed random bits, as the Ara2 kernel streams its mask from
memory: keep ``x[i]`` where ``float32(bits[i]) / 2^32 >= rate``, scaled by
a division by ``(1 - rate)`` rounded to x's dtype; 0 elsewhere; x's dtype.
``bits`` are ``torch.uint32`` values (a signed view would be wrong for
bits >= 2^31).  Two implementations, as in the reference
(``repro/kernels/dropout.py``):

* ``dropout_cuda`` - the hand-written Hopper kernel in ``csrc/dropout.cu``,
  replacing ``dropout_pallas``: a grid-stride loop, any n (the Pallas
  kernel asserts that its 1024-element blocks divide n).  It adds one to
  ``LAUNCHES["dropout"]`` per launch.
* ``dropout_plain`` - the oracle (``ref.dropout_ref``), the counterpart of
  ``dropout_xla``.

The kernel equals the plain version bit for bit, in fp32 and bf16.
``repro_torch.kernels.ops.dropout`` picks between them by the tensor's
device.
"""
from __future__ import annotations

import torch

from . import build, ref

SOURCE = "dropout.cu"
LAUNCHES = {"dropout": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernels_per_call(*_shapes, **_kw) -> int:
    return 1


def dropout_plain(x, bits, *, rate):
    return ref.dropout_ref(x, bits, rate)


def dropout_cuda(x, bits, *, rate):
    """The kernel: x (n,), fp32 or bf16, n >= 1, and bits (n,)
    ``torch.uint32`` on x's device.  Returns (n,) in x's dtype.  Raises on
    anything else."""
    what = "dropout"
    build.check_operands(what, _DTYPE_CODE, x=x)
    build.check_operands(what, (torch.uint32,), bits=bits)
    if bits.device != x.device:
        raise ValueError(f"{what}: bits on {bits.device}, x on {x.device}")
    if x.dim() != 1 or x.shape != bits.shape or x.shape[0] < 1:
        raise ValueError(f"{what}: x {tuple(x.shape)} and bits "
                         f"{tuple(bits.shape)} must be non-empty vectors of "
                         "one length")
    # (1 - rate) rounded to x's dtype, as the reference's weakly typed
    # scalar; exact in fp32
    divisor = float(torch.tensor(1.0 - rate, dtype=torch.float64).to(x.dtype))
    y = torch.empty_like(x)
    lib = build.library(SOURCE)
    with torch.cuda.device(x.device):
        err = lib.repro_dropout(
            _DTYPE_CODE[x.dtype], x.data_ptr(), bits.data_ptr(), y.data_ptr(),
            x.shape[0], rate, divisor,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, what)
    build.count(LAUNCHES, "dropout")
    return y
