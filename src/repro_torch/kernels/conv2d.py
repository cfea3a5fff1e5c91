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
  its halo in shared memory one channel at a time; a filter too large for
  one stage is walked in bands of filter rows (or, where one row is too
  wide, single rows in bands of columns) that fit, :func:`bands`.  Any
  C >= 1, H, W >= k >= 1 (the Pallas kernel asserts that its 8-row blocks
  divide H-k+1).  Each call adds one to ``LAUNCHES["conv2d"]`` and to its
  route's count in ``ROUTES``.
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
# csrc/conv2d.cu's layout: 64 x 128 output tiles, a ring of 2 (fp32) or 3
# (bf16) staged input tiles, a TMA box at most 256 elements a side, and the
# card's 227 KB of shared memory a block
_TILE_H, _TILE_W, _STAGES = 64, 128, {"simt": 2, "mma": 3}
_MAX_BOX, _MAX_SMEM = 256, 227 * 1024
# the bf16 route's table of B fragments: a uint2 a lane for every (ci, ki,
# K-step), when there are at most 96 of them
_TABLE_STEPS = 96


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
    cores).  Raises on any other dtype, or k < 1."""
    if dtype not in _ROUTE:
        raise TypeError(f"conv2d: dtype {dtype}; the kernels take float32 "
                        "or bfloat16")
    if k < 1:
        raise ValueError(f"conv2d: a {k} x {k} filter; k must be >= 1")
    return _ROUTE[dtype]


def k_steps(k: int) -> int:
    """K-steps of 16 the banded product takes a filter row: a 16 x 8 output
    tile's band B[kk, n] = w[16 s + kk - n] spans k + 7 columns."""
    return -(-(k + 7) // 16)


def _pitch(kind: str, kw: int) -> int:
    """Columns of a staged input tile for a band of ``kw`` taps (simt) or
    ``kw`` K-steps (mma)."""
    return _TILE_W + (8 * -(-kw // 8) if kind == "simt" else 16 * kw - 8)


def smem_bytes(kind: str, channels: int, k: int, kb: int, kw: int) -> int:
    """Shared memory of a block of route ``kind`` for bands of ``kb``
    filter rows by ``kw`` column units (csrc's ``simt_smem`` /
    ``mma_smem``)."""
    esize = 4 if kind == "simt" else 2
    stage = -(-(_TILE_H + kb - 1) * _pitch(kind, kw) * esize // 128) * 128
    table = 0
    if kind == "mma" and channels <= _TABLE_STEPS \
            and channels * k * k_steps(k) <= _TABLE_STEPS:
        table = channels * k * k_steps(k) * 32 * 8
    return 128 + 128 + table + _STAGES[kind] * stage


def _fits(kind, channels, k, kb, kw) -> bool:
    return (_TILE_H + kb - 1 <= _MAX_BOX and _pitch(kind, kw) <= _MAX_BOX
            and smem_bytes(kind, channels, k, kb, kw) <= _MAX_SMEM)


def bands(dtype, k: int, channels: int = 1) -> tuple[int, int]:
    """``(kb, kw)``: the filter rows and the column units (simt: taps, mma:
    K-steps) of one band of the kernel's walk over a ``k x k`` filter of
    ``channels`` channels.  A filter whose staged tile fits takes one band
    (kb = k, kw all its units); else bands of the most filter rows that fit
    at full width; else, one filter row a band, in bands of the most
    columns that fit.  Several column bands come only with one row a band,
    so the fp32 route keeps each output's fmaf order ci, ki, kj."""
    kind = route(dtype, k)
    units = k if kind == "simt" else k_steps(k)
    if _fits(kind, channels, k, 1, units):
        return max(b for b in range(1, min(k, _MAX_BOX - _TILE_H + 1) + 1)
                   if _fits(kind, channels, k, b, units)), units
    return 1, max(w for w in range(1, units + 1)
                  if _fits(kind, channels, k, 1, w))


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
    kb, kw = bands(x.dtype, k, c)
    out = torch.empty((h - k + 1, wd - k + 1), dtype=x.dtype,
                      device=x.device)
    lib = build.library(SOURCE)
    with torch.cuda.device(x.device):
        err = lib.repro_conv2d(
            _DTYPE_CODE[x.dtype], x.data_ptr(), w.data_ptr(), out.data_ptr(),
            c, h, wd, k, kb, kw,
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check(lib, err, what)
    build.count(LAUNCHES, "conv2d", KERNELS_PER_CALL, ROUTES, kind)
    return out
