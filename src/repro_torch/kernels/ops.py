"""Kernel dispatch, the port's counterpart of ``repro/kernels/ops.py``.

The implementation follows the tensor's device, and nothing else:

* a CPU tensor takes the plain PyTorch version;
* a CUDA tensor launches the hand-written kernel, or raises;
* any other device raises.

There is no environment override and no fallback: a CUDA tensor never
reaches a plain version through this module.  ``decode_attention`` and
``ssd_step`` have no kernel (the reference leaves them to XLA) and are
plain PyTorch everywhere.
"""
from __future__ import annotations

import math

import torch

from .conv2d import conv2d_cuda, conv2d_plain
from .dotproduct import dotproduct_cuda, dotproduct_plain
from .dropout import dropout_cuda, dropout_plain
from .dwt import dwt_haar_cuda, dwt_haar_plain
from .expk import exp_cuda, exp_plain
from .fft import fft_cuda, fft_plain
from .flash_attention import (NEG_INF, flash_attention_cuda,
                              flash_attention_plain)
from .jacobi2d import jacobi2d_cuda, jacobi2d_plain
from .matmul import matmul_cuda, matmul_plain
from .paged_attention import (paged_decode_attention_cuda,
                              paged_decode_attention_plain,
                              paged_prefill_attention_cuda,
                              paged_prefill_attention_plain)
from .pathfinder import pathfinder_cuda, pathfinder_plain
from .softmax import softmax_cuda, softmax_plain
from .ssd_scan import ssd_cuda, ssd_plain, ssd_step_plain


def _pick(x, plain, cuda, what: str):
    kind = x.device.type
    if kind == "cpu":
        return plain
    if kind == "cuda":
        return cuda
    raise ValueError(f"{what}: no implementation for device {x.device}")


def _no_paged_window(what: str, window) -> None:
    if window is not None:
        raise NotImplementedError(
            f"{what}(window={window}): sliding-window paged attention "
            "(gemma3's local layers) is not ported yet")


def attention(q, k, v, *, causal=True, window=None, scale=None):
    """Dense full-sequence GQA attention (the flash forward).  q:
    (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D), queries right-aligned to the
    keys; ``window`` None or >= 1.  Returns (B, Hq, Sq, D)."""
    fn = _pick(q, flash_attention_plain, flash_attention_cuda, "attention")
    return fn(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(q, k_cache, v_cache, kv_len, *, scale=None,
                     window=None):
    """Single-token GQA attention against a dense (B, Hkv, Smax, D) cache;
    ``kv_len``: (B,) valid lengths (the new token sits at kv_len - 1).
    Plain PyTorch on every device, as the reference leaves it to XLA
    (``decode_attention_xla``): masked logits at -1e30, softmax in fp32."""
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
    int32; kv_len: (B,) int32.  Returns (B, Hq, 1, D)."""
    _no_paged_window("paged_decode_attention", window)
    fn = _pick(q, paged_decode_attention_plain, paged_decode_attention_cuda,
               "paged_decode_attention")
    return fn(q, k_pool, v_pool, block_table, kv_len, scale=scale)


def paged_prefill_attention(q, k_pool, v_pool, block_table, q_start, *,
                            scale=None, window=None):
    """One prompt chunk's causal attention against a paged KV pool (the
    chunk's K/V must already sit in its block).  q: (B, Hq, Sq, D) at
    absolute positions ``q_start[b] + [0, Sq)``.  Returns (B, Hq, Sq, D)."""
    _no_paged_window("paged_prefill_attention", window)
    fn = _pick(q, paged_prefill_attention_plain,
               paged_prefill_attention_cuda, "paged_prefill_attention")
    return fn(q, k_pool, v_pool, block_table, q_start, scale=scale)


def ssd_scan(x, dt, a_log, b_mat, c_mat, *, d_skip=None, h0=None):
    """Mamba2 SSD chunked scan (chunk ``min(64, S)``).  x: (B, S, H, P),
    dt: (B, S, H) fp32, a_log: (H,), b_mat/c_mat: (B, S, G, N); optional
    d_skip (H,) and initial state h0 (B, H, P, N).  Returns (y, h_final
    (B, H, P, N) fp32).  A CUDA tensor always launches the kernel, with or
    without ``h0`` (the reference sends ``h0`` to XLA)."""
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


def dwt_haar(x, *, levels=1):
    """The 1-D Haar DWT of x (n,), ``levels`` >= 1 with 2^levels dividing
    n (ValueError otherwise): [lo_L, hi_L, ..., hi_1] in x's dtype, each
    level rounded to it."""
    return _pick(x, dwt_haar_plain, dwt_haar_cuda, "dwt_haar")(
        x, levels=levels)
