"""Paged GQA attention over a blocked KV pool: decode and chunked prefill.

KV lives in a global pool of fixed-size blocks — k_pool/v_pool:
``(n_blocks, n_kv_heads, block_size, head_dim)`` — and each request owns an
ordered block-table row ``(max_blocks,)`` of int32 pool ids mapping its
logical positions ``[i * block_size, (i+1) * block_size)`` to blocks (vLLM's
PagedAttention, Kwon et al. SOSP 2023).

Two implementations of each function, as in the reference
(``repro/kernels/paged_attention.py``):

* ``*_cuda`` — the hand-written Hopper kernel in ``csrc/paged_attention.cu``
  (one templated kernel for both), launched on PyTorch's current stream.
  It replaces ``paged_decode_attention_pallas`` and
  ``paged_prefill_attention_pallas``; what bounds it and how it is built is
  in the source's header note.  Each wrapper checks its inputs, allocates
  the output with ``torch.empty`` and adds one to ``LAUNCHES[name]`` per
  launch, so a run can show that its path went through the kernel.
* ``*_plain`` — plain PyTorch with the math of the reference's ``xla``
  functions: a gather of the table's blocks and a masked fp32 softmax.  The
  CPU runs it, and ``chip_smoke.py`` holds the kernel against it.

``repro_torch.kernels.ops`` picks between them by the tensor's device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build
from .ref import gather_pool

NEG_INF = -1e30
SOURCE = "paged_attention.cu"

# launches of each hand-written kernel since the last reset (a plain dict
# of ints: chip_smoke zeroes it before the main path and reads it after)
LAUNCHES = {"paged_decode_attention": 0, "paged_prefill_attention": 0}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _scale(scale, d: int) -> float:
    return float(scale if scale is not None else 1.0 / math.sqrt(d))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the kernels' comparators on the card).
# ---------------------------------------------------------------------------

def paged_decode_attention_plain(q, k_pool, v_pool, block_table, kv_len, *,
                                 scale=None):
    """q: (B, Hq, 1, D); k_pool/v_pool: (N, Hkv, bs, D); block_table: (B, M)
    int32; kv_len: (B,) int32.  Returns (B, Hq, 1, D) in q's dtype.

    Positions at or past ``kv_len`` get p = 0 and their V is zeroed before
    the product, so stale pool bytes (even NaN) never reach the sum; a row
    with ``kv_len == 0`` returns 0, as the reference's Pallas kernel does."""
    b, hq, _, d = q.shape
    hkv = k_pool.shape[1]
    g = hq // hkv
    k = gather_pool(k_pool, block_table).float()     # (B, Hkv, M*bs, D)
    v = gather_pool(v_pool, block_table).float()
    kpos = torch.arange(k.shape[2], device=q.device)
    valid = kpos[None, :] < kv_len[:, None].long()   # (B, M*bs)
    qf = q.float().reshape(b, hkv, g, d) * _scale(scale, d)
    logits = torch.einsum("bhgd,bhsd->bhgs", qf, k)
    vmask = valid[:, None, None, :]
    logits = torch.where(vmask, logits, NEG_INF)
    p = torch.where(vmask, torch.softmax(logits, dim=-1), 0.0)
    v = torch.where(valid[:, None, :, None], v, 0.0)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v)
    return out.reshape(b, hq, 1, d).to(q.dtype)


def paged_prefill_attention_plain(q, k_pool, v_pool, block_table, q_start, *,
                                  scale=None):
    """q: (B, Hq, Sq, D) chunk queries at absolute positions
    ``q_start[b] + [0, Sq)``; causal (``kpos <= qpos``) over the table.
    Returns (B, Hq, Sq, D) in q's dtype.  V past the chunk's causal
    frontier is zeroed before the product (stale bytes never reach it)."""
    b, hq, sq, d = q.shape
    hkv = k_pool.shape[1]
    g = hq // hkv
    k = gather_pool(k_pool, block_table).float()
    v = gather_pool(v_pool, block_table).float()
    kpos = torch.arange(k.shape[2], device=q.device)
    qpos = q_start[:, None].long() + torch.arange(sq, device=q.device)[None]
    mask = (kpos[None, None, :] <= qpos[:, :, None])[:, None, None]
    qf = q.float().reshape(b, hkv, g, sq, d) * _scale(scale, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.where(mask, torch.softmax(logits, dim=-1), 0.0)
    frontier = kpos[None, :] <= qpos[:, -1:]        # (B, M*bs)
    v = torch.where(frontier[:, None, :, None], v, 0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v)
    return out.reshape(b, hq, sq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Hand-written CUDA kernels (csrc/paged_attention.cu).
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# limits of csrc/paged_attention.cu: 64-key tiles, one PV column a thread
# (128 threads), at most 64 query rows (g * Sq) a thread block
_TILE_KEYS, _MAX_HEAD_DIM, _MAX_ROWS = 64, 128, 64
_MAX_SMEM = 227 * 1024


def _check(q, k_pool, v_pool, block_table, lens, what: str) -> None:
    """Raise on anything the kernel does not take."""
    tensors = {"q": q, "k_pool": k_pool, "v_pool": v_pool,
               "block_table": block_table, "lens": lens}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, expected the "
                             f"CUDA device of q ({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: q dtype {q.dtype}; the kernel takes "
                        "bfloat16 or float32")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"{what}: pools ({k_pool.dtype}, {v_pool.dtype}) "
                        f"must match q ({q.dtype})")
    if block_table.dtype != torch.int32 or lens.dtype != torch.int32:
        raise TypeError(f"{what}: block_table and lengths must be int32")
    if q.dim() != 4 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} must be (B, Hq, Sq, D)"
                         f" and both pools (N, Hkv, bs, D), got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, bs, dk = k_pool.shape
    if dk != d or hkv == 0 or hq % hkv:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs pools "
                         f"{tuple(k_pool.shape)} (need equal D and "
                         "Hq % Hkv == 0)")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or tuple(lens.shape) != (b,):
        raise ValueError(f"{what}: block_table {tuple(block_table.shape)} "
                         f"must be (B, M) and lengths {tuple(lens.shape)} "
                         f"(B,) with B = {b}")
    if d % 8 or d > _MAX_HEAD_DIM or k_pool.data_ptr() % 16 \
            or v_pool.data_ptr() % 16:
        raise ValueError(f"{what}: head_dim {d} must be a multiple of 8 up "
                         f"to {_MAX_HEAD_DIM}, with 16-byte aligned pools")
    rows = (hq // hkv) * sq
    if _TILE_KEYS % bs or rows > _MAX_ROWS:
        raise ValueError(f"{what}: block_size {bs} must divide "
                         f"{_TILE_KEYS}, and g * Sq = {rows} be at most "
                         f"{_MAX_ROWS}")
    ld = d + 16 // q.element_size()
    smem = (4 * _TILE_KEYS * ld * q.element_size()
            + (rows * d + rows * _TILE_KEYS + 3 * rows) * 4)
    if smem > _MAX_SMEM:
        raise ValueError(f"{what}: needs {smem} bytes of shared memory, "
                         f"the card offers {_MAX_SMEM}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def paged_decode_attention_cuda(q, k_pool, v_pool, block_table, kv_len, *,
                                scale=None):
    """The decode kernel, replacing ``paged_decode_attention_pallas``
    (``repro/kernels/paged_attention.py:103``).  Bound by bytes on the
    H100; the header note of ``csrc/paged_attention.cu`` says what its
    design does about that."""
    what = "paged_decode_attention"
    _check(q, k_pool, v_pool, block_table, kv_len, what)
    b, hq, sq, d = q.shape
    if sq != 1:
        raise ValueError(f"{what}: q must carry one token per row, got "
                         f"Sq = {sq}")
    _, hkv, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    lib = build.library(SOURCE)
    with torch.cuda.device(q.device):
        err = lib.repro_paged_decode_attention(
            _DTYPE_CODE[q.dtype], _ptr(q), _ptr(k_pool), _ptr(v_pool),
            _ptr(block_table), _ptr(kv_len), _ptr(out), b, hkv, hq // hkv,
            d, bs, block_table.shape[1], _scale(scale, d), _stream(q))
    build.check(lib, err, what)
    LAUNCHES[what] += 1
    return out


def paged_prefill_attention_cuda(q, k_pool, v_pool, block_table, q_start, *,
                                 scale=None):
    """The chunked-prefill kernel, replacing
    ``paged_prefill_attention_pallas``
    (``repro/kernels/paged_attention.py:224``).  Bound by bytes on the H100,
    as the decode kernel (same source).  The chunk's own K/V must already
    sit in its block, written on the same stream before this call."""
    what = "paged_prefill_attention"
    _check(q, k_pool, v_pool, block_table, q_start, what)
    b, hq, sq, d = q.shape
    _, hkv, bs, _ = k_pool.shape
    out = torch.empty_like(q)
    lib = build.library(SOURCE)
    with torch.cuda.device(q.device):
        err = lib.repro_paged_prefill_attention(
            _DTYPE_CODE[q.dtype], _ptr(q), _ptr(k_pool), _ptr(v_pool),
            _ptr(block_table), _ptr(q_start), _ptr(out), b, hkv, hq // hkv,
            sq, d, bs, block_table.shape[1], _scale(scale, d), _stream(q))
    build.check(lib, err, what)
    LAUNCHES[what] += 1
    return out
