"""Kernel dispatch, the port's counterpart of ``repro/kernels/ops.py``.

The implementation follows the tensor's device, and nothing else:

* a CPU tensor takes the plain PyTorch version;
* a CUDA tensor launches the hand-written kernel, or raises;
* any other device raises.

There is no environment override and no fallback: a CUDA tensor never
reaches a plain version through this module.  ``decode_attention``,
``ssd_step`` and ``roi_align`` have no kernel (the reference leaves them
to XLA) and are plain PyTorch everywhere.  So is a *windowed* paged call:
the reference routes ``window is not None`` to its XLA gather functions
on every device (``repro/kernels/ops.py:112-140``), and so does this
module (``paged_*_attention_plain(window=...)``); with ``window=None`` a
CUDA tensor launches the paged kernel or raises, as before.
"""
from __future__ import annotations

import math

import torch

from ..tree import tree_leaves
from .conv2d import conv2d_cuda, conv2d_plain
from .dotproduct import dotproduct_cuda, dotproduct_plain
from .dropout import dropout_cuda, dropout_plain
from .dwt import dwt_haar_cuda, dwt_haar_plain
from .expk import exp_cuda, exp_plain
from .fft import fft_cuda, fft_plain
from .flash_attention import (NEG_INF, FlashAttention, flash_attention_cuda,
                              flash_attention_plain)
from .jacobi2d import jacobi2d_cuda, jacobi2d_plain
from .matmul import matmul_cuda, matmul_plain
from .paged_attention import (paged_decode_attention_cuda,
                              paged_decode_attention_plain,
                              paged_prefill_attention_cuda,
                              paged_prefill_attention_plain)
from .pathfinder import pathfinder_cuda, pathfinder_plain
from .softmax import softmax_cuda, softmax_plain
from .ssd_scan import SSDScan, ssd_cuda, ssd_plain, ssd_step_plain


def _pick(x, plain, cuda, what: str):
    kind = x.device.type
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return cuda
    raise ValueError(f"{what}: no implementation for device {x.device}")


def records_grad(*args) -> bool:
    """Whether autograd records a call on ``args``: grad mode on and a
    tensor among them (or nested in their lists, tuples and dicts) that
    requires grad.  A training call; serving's calls are not."""
    return torch.is_grad_enabled() and any(
        isinstance(t, torch.Tensor) and t.requires_grad
        for t in tree_leaves(args))


def attention(q, k, v, *, causal=True, window=None, scale=None):
    """Dense full-sequence GQA attention (the flash forward).  q:
    (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D), queries right-aligned to the
    keys; ``window`` None or >= 1.  Returns (B, Hq, Sq, D).  With grad mode
    on and an input that requires grad, the call goes through
    ``FlashAttention`` (the same forward by device, keeping the rows'
    log-sum-exp, and the plain backward)."""
    if records_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, window, scale)
    fn = _pick(q, flash_attention_plain, flash_attention_cuda, "attention")
    return fn(q, k, v, causal=causal, window=window, scale=scale)


# the fewest rows a decode step's fp32 products run at.  On the card cuBLAS
# takes a one-row fp32 product (and a batched product by its batch count)
# to another kernel than a wider batch's, whose sums round apart: padded
# to this many rows, a request's row computes the same bits at any batch
# up to it, so a narrow cluster replica (width 1 or 4) decodes as the wide
# engine (width 8) does
INVARIANT_ROWS = 8


def pad_rows(t, rows: int = INVARIANT_ROWS):
    """``t`` with zero rows appended along axis 0 up to ``rows`` (``t``
    itself when it has as many already)."""
    if t.shape[0] >= rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + t.shape[1:])])


def decode_attention(q, k_cache, v_cache, kv_len, *, scale=None,
                     window=None):
    """Single-token GQA attention against a dense (B, Hkv, Smax, D) cache;
    ``kv_len``: (B,) valid lengths (the new token sits at kv_len - 1).
    Plain PyTorch on every device, as the reference leaves it to XLA
    (``decode_attention_xla``): masked logits at -1e30, softmax in fp32.
    A batch narrower than ``INVARIANT_ROWS`` runs padded to it (zero rows,
    sliced off)."""
    b = q.shape[0]
    if b < INVARIANT_ROWS:
        return decode_attention(
            pad_rows(q), pad_rows(k_cache), pad_rows(v_cache),
            pad_rows(kv_len), scale=scale, window=window)[:b]
    b, hq, _, d = q.shape
    _, hkv, smax, _ = k_cache.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, hkv, g, d) * scale
    logits = torch.einsum("bhgd,bhsd->bhgs", qf, k_cache.float())
    kpos = torch.arange(smax, device=q.device)[None, :]
    kv = kv_len.long()[:, None]
    mask = kpos < kv
    if window is not None:
        mask &= kpos > kv - 1 - window
    logits = torch.where(mask[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v_cache.float())
    return out.reshape(b, hq, 1, d).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, block_table, kv_len, *,
                           scale=None, window=None):
    """Single-token GQA attention against a paged KV pool via a block
    table.  q: (B, Hq, 1, D); pools: (N, Hkv, bs, D); block_table: (B, M)
    int32; kv_len: (B,) int32.  Returns (B, Hq, 1, D).  A ``window``
    takes the plain gather path on every device, as in the reference."""
    if window is not None:
        return paged_decode_attention_plain(q, k_pool, v_pool, block_table,
                                            kv_len, scale=scale,
                                            window=window)
    fn = _pick(q, paged_decode_attention_plain, paged_decode_attention_cuda,
               "paged_decode_attention")
    return fn(q, k_pool, v_pool, block_table, kv_len, scale=scale)


def paged_prefill_attention(q, k_pool, v_pool, block_table, q_start, *,
                            scale=None, window=None):
    """One prompt chunk's causal attention against a paged KV pool (the
    chunk's K/V must already sit in its block).  q: (B, Hq, Sq, D) at
    absolute positions ``q_start[b] + [0, Sq)``.  Returns (B, Hq, Sq, D).
    A ``window`` takes the plain gather path on every device, as in the
    reference."""
    if window is not None:
        return paged_prefill_attention_plain(q, k_pool, v_pool, block_table,
                                             q_start, scale=scale,
                                             window=window)
    fn = _pick(q, paged_prefill_attention_plain,
               paged_prefill_attention_cuda, "paged_prefill_attention")
    return fn(q, k_pool, v_pool, block_table, q_start, scale=scale)


def ssd_scan(x, dt, a_log, b_mat, c_mat, *, d_skip=None, h0=None):
    """Mamba2 SSD chunked scan (chunk ``min(64, S)``).  x: (B, S, H, P),
    dt: (B, S, H) fp32, a_log: (H,), b_mat/c_mat: (B, S, G, N); optional
    d_skip (H,) and initial state h0 (B, H, P, N).  Returns (y, h_final
    (B, H, P, N) fp32).  A CUDA tensor always launches the kernel, with or
    without ``h0`` (the reference sends ``h0`` to XLA).  With grad mode on
    and an input that requires grad, the call goes through ``SSDScan``
    (the same forward by device, the plain backward; a gradient through
    ``h0`` raises ``NotImplementedError``)."""
    if records_grad(x, dt, a_log, b_mat, c_mat, d_skip, h0):
        return SSDScan.apply(x, dt, a_log, b_mat, c_mat, d_skip, h0)
    fn = _pick(x, ssd_plain, ssd_cuda, "ssd_scan")
    return fn(x, dt, a_log, b_mat, c_mat, d_skip=d_skip, h0=h0)


def ssd_step(h_state, xt, dtt, a_log, bt, ct, *, d_skip=None):
    """One-token SSD recurrence (decode).  Plain PyTorch on every device,
    as the reference leaves it to XLA (``ssd_step_xla``)."""
    return ssd_step_plain(h_state, xt, dtt, a_log, bt, ct, d_skip=d_skip)


# ---------------------------------------------------------------------------
# The paper's kernel pool.  Each kernel picks its own tiling (the reference's
# TPU tile knobs, bm / bn / bk and block_rows, are not carried over) and
# takes every shape the reference's ``xla`` impl takes.
# ---------------------------------------------------------------------------

def matmul(x, w, *, out_dtype=None):
    """(M, K) @ (K, N), fp32 accumulation, out in ``out_dtype`` (default
    x's)."""
    fn = _pick(x, matmul_plain, matmul_cuda, "matmul")
    return fn(x, w, out_dtype=out_dtype)


def dotproduct(x, y):
    """fp32 sum of x * y over two length-n vectors: a 0-d fp32 tensor."""
    return _pick(x, dotproduct_plain, dotproduct_cuda, "dotproduct")(x, y)


def softmax(x):
    """Softmax over the last axis, fp32 math, out in x's dtype."""
    return _pick(x, softmax_plain, softmax_cuda, "softmax")(x)


def conv2d(x, w):
    """Valid conv of x (C, H, W) with one filter w (C, k, k): (H-k+1,
    W-k+1) in x's dtype (as ``conv2d_pallas``)."""
    return _pick(x, conv2d_plain, conv2d_cuda, "conv2d")(x, w)


def fft(x_re, x_im):
    """The complex DFT of ``x_re + i x_im`` (two (n,) planes, n a power of
    two >= 2; ValueError otherwise) in the reference's Stockham schedule:
    (y_re, y_im), fp32."""
    return _pick(x_re, fft_plain, fft_cuda, "fft")(x_re, x_im)


def pathfinder(w):
    """The row DP over a (rows, cols) cost grid: the last row's min-path
    costs, (cols,) fp32, the edge filled with 3.0e38 (as
    ``pathfinder_pallas``)."""
    return _pick(w, pathfinder_plain, pathfinder_cuda, "pathfinder")(w)


def jacobi2d(x, steps=1):
    """``steps`` 5-point Jacobi sweeps of x (H, W)'s interior, the boundary
    kept, in x's dtype."""
    return _pick(x, jacobi2d_plain, jacobi2d_cuda, "jacobi2d")(x, steps=steps)


def dropout(x, bits, *, rate):
    """x (n,) kept where float32(bits) / 2^32 >= rate (``bits``
    ``torch.uint32``) and divided by (1 - rate) in x's dtype; 0 elsewhere."""
    return _pick(x, dropout_plain, dropout_cuda, "dropout")(x, bits,
                                                            rate=rate)


def exp(x):
    """Software exp of x (n,) (``exp_pallas``'s polynomial scheme), fp32
    math, out in x's dtype."""
    return _pick(x, exp_plain, exp_cuda, "exp")(x)


def roi_align(feat, rois, *, out_size=7, sampling=2):
    """ROI-align: feat (C, H, W), rois (R, 4) [y0, x0, y1, x1] in pixel
    coordinates -> (R, C, out_size, out_size) in feat's dtype (fp32 math
    for fp32 input), each bin the mean of ``sampling``^2 bilinear samples,
    coordinates clipped into the image.  The reference's ``roi_align_xla``
    (``repro/kernels/roi_align.py:15``): plain PyTorch on every device, as
    the reference leaves it to XLA (gather-bound; no Pallas kernel)."""
    c, h, w = feat.shape
    dev = feat.device
    rois = rois.to(feat.dtype)
    y0, x0, y1, x1 = (rois[:, i, None, None, None, None] for i in range(4))
    bin_h, bin_w = (y1 - y0) / out_size, (x1 - x0) / out_size
    o = torch.arange(out_size, device=dev)
    s = torch.arange(sampling, device=dev)
    oy, ox = o[:, None, None, None], o[None, :, None, None]
    sy, sx = s[None, None, :, None], s[None, None, None, :]
    # sample coordinates: (R, out, out, s, s)
    y = y0 + (oy + (sy + 0.5) / sampling) * bin_h
    x = x0 + (ox + (sx + 0.5) / sampling) * bin_w
    y = torch.clamp(y, 0.0, h - 1.0)
    x = torch.clamp(x, 0.0, w - 1.0)
    yi = torch.clamp(torch.floor(y).long(), 0, h - 2)
    xi = torch.clamp(torch.floor(x).long(), 0, w - 2)
    dy, dx = y - yi, x - xi
    v00 = feat[:, yi, xi]                       # (C, R, out, out, s, s)
    v01 = feat[:, yi, xi + 1]
    v10 = feat[:, yi + 1, xi]
    v11 = feat[:, yi + 1, xi + 1]
    val = (v00 * (1 - dy) * (1 - dx) + v01 * (1 - dy) * dx
           + v10 * dy * (1 - dx) + v11 * dy * dx)
    return val.mean(dim=(-2, -1)).transpose(0, 1)   # (R, C, out, out)


def dwt_haar(x, *, levels=1):
    """The 1-D Haar DWT of x (n,), ``levels`` >= 1 with 2^levels dividing
    n (ValueError otherwise): [lo_L, hi_L, ..., hi_1] in x's dtype, each
    level rounded to it."""
    return _pick(x, dwt_haar_plain, dwt_haar_cuda, "dwt_haar")(
        x, levels=levels)
