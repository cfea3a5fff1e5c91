"""Complex FFT, the paper pool's ``fft`` (its whole-signal-in-registers
kernel, and the power-of-two data movement of contribution C2).

The DFT of a complex signal given as two planes ``(x_re, x_im)`` of length
n = 2^t >= 2, in the reference's radix-2 Stockham schedule (``y[k] =
sum_j x[j] exp(-2 pi i j k / n)``), fp32 out for fp32 or bf16 in.  Two
implementations, as in the reference (``repro/kernels/fft.py``):

* ``fft_cuda`` - the hand-written Hopper kernels in ``csrc/fft.cu``,
  replacing ``fft_pallas``: for n <= 4096 one block runs every stage in
  shared memory; beyond, :func:`plan` splits the stages into global passes
  of up to 5 stages (radix 32 in registers) and one local pass over 512-long
  columns, 16 a block.  The wrapper launches each pass and adds one to
  ``LAUNCHES["fft"]`` per launch: :func:`kernels_per_call` of them a call
  (1 up to n = 4096, 4 at n = 2^24).
* ``fft_plain`` - the same Stockham schedule in PyTorch fp32
  (``ref.fft_ref``), the counterpart of ``fft_xla``.

Both raise ``ValueError`` on an n that is not a power of two >= 2, where
the reference asserts.  ``repro_torch.kernels.ops.fft`` picks between them
by the tensor's device.
"""
from __future__ import annotations

import torch

from . import build, ref

SOURCE = "fft.cu"
LAUNCHES = {"fft": 0}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/fft.cu: one block holds 2^12 elements; beyond, the local pass takes
# columns of 2^9 elements, 2^4 columns a block, after global passes of at
# most 5 stages each
_LOCAL_MAX_LOG, _LOCAL_LEN_LOG, _LOCAL_COLS_LOG, _MAX_Q = 12, 9, 4, 5


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def plan(n: int) -> list[tuple]:
    """The kernel launches of one length-n transform, in order:
    ``("pass", q, s)`` runs stages s .. s+q-1 through device memory,
    ``("local", log_len, log_cols)`` the last ``log_len`` stages in shared
    memory, 2^log_cols columns a block."""
    t = ref.fft_log2(n)
    if t <= _LOCAL_MAX_LOG:
        return [("local", t, 0)]
    steps, s, g = [], 0, t - _LOCAL_LEN_LOG
    while s < g:
        q = min(_MAX_Q, g - s)
        steps.append(("pass", q, s))
        s += q
    return steps + [("local", _LOCAL_LEN_LOG, _LOCAL_COLS_LOG)]


def kernels_per_call(shape, *_shapes, **_kw) -> int:
    """Kernels one call launches on a length-``shape[0]`` signal."""
    return len(plan(shape[0]))


def fft_plain(x_re, x_im):
    return ref.fft_ref(x_re, x_im)


def fft_cuda(x_re, x_im):
    """The kernels: x_re and x_im (n,), both fp32 or both bf16, n = 2^t >=
    2.  Returns (y_re, y_im), fp32.  Raises on anything else."""
    what = "fft"
    build.check_operands(what, _DTYPE_CODE, x_re=x_re, x_im=x_im)
    if x_re.dim() != 1 or x_re.shape != x_im.shape:
        raise ValueError(f"{what}: x_re {tuple(x_re.shape)} and x_im "
                         f"{tuple(x_im.shape)} must be vectors of one length")
    n = x_re.shape[0]
    steps = plan(n)
    dev = x_re.device
    out = [torch.empty(n, dtype=torch.float32, device=dev) for _ in range(2)]
    # the passes ping-pong between out and a scratch pair, the last one
    # writing out
    scratch = ([torch.empty(n, dtype=torch.float32, device=dev)
                for _ in range(2)] if len(steps) > 1 else None)
    lib = build.library(SOURCE)
    src, code = (x_re, x_im), _DTYPE_CODE[x_re.dtype]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for i, step in enumerate(steps):
            dst = out if (len(steps) - 1 - i) % 2 == 0 else scratch
            ptrs = (src[0].data_ptr(), src[1].data_ptr(), dst[0].data_ptr(),
                    dst[1].data_ptr())
            if step[0] == "pass":
                _, q, s = step
                err = lib.repro_fft_pass(code, q, *ptrs, n, s, stream)
            else:
                _, log_len, log_cols = step
                err = lib.repro_fft_local(code, *ptrs, log_len, log_cols,
                                          n >> log_len, stream)
            build.check(lib, err, what)
            LAUNCHES["fft"] += 1
            src, code = dst, _DTYPE_CODE[torch.float32]
    return out[0], out[1]
