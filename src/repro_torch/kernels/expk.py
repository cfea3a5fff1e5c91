"""Software exp, the paper pool's ``exp`` (Ara2 emulates exponentiation
with preloaded polynomial coefficients, §4).

Range reduction x = n ln2 + r, a degree-6 Taylor polynomial in r by
Horner, and 2^n built from exponent bits with n clipped to [-126, 127]; fp32
math, out in x's dtype.  Two implementations, as in the reference
(``repro/kernels/expk.py``):

* ``exp_cuda`` - the hand-written Hopper kernel in ``csrc/expk.cu``,
  replacing ``exp_pallas``: a grid-stride loop of 16-byte loads, any n (the
  Pallas kernel asserts that its 1024-element blocks divide n).  It adds
  one to ``LAUNCHES["exp"]`` per launch.
* ``exp_plain`` - the oracle (``ref.exp_ref``), the Pallas body as ``jit``
  and the interpret path compile it: fused multiply-adds, half-to-even
  rounding of n, subnormal results flushed to +0 (ROADMAP §3).  The
  reference's ``exp_xla`` is ``jnp.exp``, within 3.4e-7 of it.

The kernel equals the plain version bit for bit, in fp32 and bf16 (NaN
where the plain version gives NaN).  ``repro_torch.kernels.ops.exp`` picks
between them by the tensor's device.
"""
from __future__ import annotations

import torch

from . import build, ref

SOURCE = "expk.cu"
LAUNCHES = {"exp": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def kernels_per_call(*_shapes, **_kw) -> int:
    return 1


def exp_plain(x):
    return ref.exp_ref(x)


def exp_cuda(x):
    """The kernel: x (n,), fp32 or bf16, n >= 1, on a CUDA device.
    Returns (n,) in x's dtype.  Raises on anything else."""
    what = "exp"
    build.check_operands(what, _DTYPE_CODE, x=x)
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError(f"{what}: x {tuple(x.shape)} must be a non-empty "
                         "vector")
    y = torch.empty_like(x)
    lib = build.library(SOURCE)
    with torch.cuda.device(x.device):
        err = lib.repro_exp(_DTYPE_CODE[x.dtype], x.data_ptr(), y.data_ptr(),
                            x.shape[0],
                            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, what)
    LAUNCHES["exp"] += 1
    return y
