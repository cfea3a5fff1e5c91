"""Paged GQA attention over a blocked KV pool: decode and chunked prefill.

KV lives in a global pool of fixed-size blocks — k_pool/v_pool:
``(n_blocks, n_kv_heads, block_size, head_dim)`` — and each request owns an
ordered block-table row ``(max_blocks,)`` of int32 pool ids mapping its
logical positions ``[i * block_size, (i+1) * block_size)`` to blocks (vLLM's
PagedAttention, Kwon et al. SOSP 2023).

Two implementations of each function, as in the reference
(``repro/kernels/paged_attention.py``):

* ``*_cuda`` — the hand-written Hopper kernels in
  ``csrc/paged_attention.cu``, launched on PyTorch's current stream.  They
  replace ``paged_decode_attention_pallas`` and
  ``paged_prefill_attention_pallas``; what bounds them and how they are
  built is in the source's header note.  Both take any block size and any
  group, on two routes picked by dtype (:func:`route`): bf16 on the tensor
  cores (``mma``, split over the keys by :func:`decode_plan` /
  :func:`prefill_plan`), fp32 on CUDA cores (``simt``).  Each wrapper checks
  its inputs, allocates the output with ``torch.empty`` and adds one to
  ``LAUNCHES[name]`` per launch and one to its route's count
  (``ROUTE_COUNTS[name]``), so a run can show that its path went through
  the kernel.
* ``*_plain`` — plain PyTorch with the math of the reference's ``xla``
  functions: a gather of the table's blocks and a masked fp32 softmax.  The
  CPU runs it, and ``chip_smoke.py`` holds the kernel against it.

``repro_torch.kernels.ops`` picks between them by the tensor's device.
A windowed call (gemma3's local layers) takes ``*_plain(window=...)`` on
every device, as the reference sends it to its XLA functions (the kernels
keep the unwindowed mask).
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading

import torch

from . import build
from .ref import gather_pool

NEG_INF = -1e30
SOURCE = "paged_attention.cu"

# launches of each hand-written kernel since the last reset (a plain dict
# of ints: chip_smoke zeroes it before the main path and reads it after)
LAUNCHES = {"paged_decode_attention": 0, "paged_prefill_attention": 0}
# each kernel's launches by route: "mma" (bf16, tensor cores), "simt" (fp32)
ROUTES = {"mma": 0, "simt": 0}           # the prefill's
DECODE_ROUTES = {"mma": 0, "simt": 0}    # decode's
ROUTE_COUNTS = {"paged_decode_attention": DECODE_ROUTES,
                "paged_prefill_attention": ROUTES}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES, DECODE_ROUTES):
        for name in counts:
            counts[name] = 0


def _scale(scale, d: int) -> float:
    return float(scale if scale is not None else 1.0 / math.sqrt(d))


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path; the kernels' comparators on the card).
# ---------------------------------------------------------------------------

def paged_decode_attention_plain(q, k_pool, v_pool, block_table, kv_len, *,
                                 scale=None, window=None):
    """q: (B, Hq, 1, D); k_pool/v_pool: (N, Hkv, bs, D); block_table: (B, M)
    int32; kv_len: (B,) int32.  Returns (B, Hq, 1, D) in q's dtype.  With
    ``window`` only keys past kv_len - 1 - window are seen.

    Positions outside the window or at or past ``kv_len`` get p = 0 and
    their V is zeroed before the product, so stale pool bytes (even NaN)
    never reach the sum; a row with ``kv_len == 0`` returns 0, as the
    reference's Pallas kernel does."""
    b, hq, _, d = q.shape
    hkv = k_pool.shape[1]
    g = hq // hkv
    k = gather_pool(k_pool, block_table).float()     # (B, Hkv, M*bs, D)
    v = gather_pool(v_pool, block_table).float()
    kpos = torch.arange(k.shape[2], device=q.device)[None, :]
    kv = kv_len[:, None].long()
    valid = kpos < kv                                # (B, M*bs)
    if window is not None:
        valid &= kpos > kv - 1 - window
    qf = q.float().reshape(b, hkv, g, d) * _scale(scale, d)
    logits = torch.einsum("bhgd,bhsd->bhgs", qf, k)
    vmask = valid[:, None, None, :]
    logits = torch.where(vmask, logits, NEG_INF)
    p = torch.where(vmask, torch.softmax(logits, dim=-1), 0.0)
    v = torch.where(valid[:, None, :, None], v, 0.0)
    out = torch.einsum("bhgs,bhsd->bhgd", p, v)
    return out.reshape(b, hq, 1, d).to(q.dtype)


def paged_prefill_attention_plain(q, k_pool, v_pool, block_table, q_start, *,
                                  scale=None, window=None):
    """q: (B, Hq, Sq, D) chunk queries at absolute positions
    ``q_start[b] + [0, Sq)``; causal (``kpos <= qpos``) over the table and,
    with ``window``, only past ``qpos - window``.  Returns (B, Hq, Sq, D) in
    q's dtype.  V that no query of the chunk may see is zeroed before the
    product (stale bytes never reach it)."""
    b, hq, sq, d = q.shape
    hkv = k_pool.shape[1]
    g = hq // hkv
    k = gather_pool(k_pool, block_table).float()
    v = gather_pool(v_pool, block_table).float()
    kpos = torch.arange(k.shape[2], device=q.device)
    qpos = q_start[:, None].long() + torch.arange(sq, device=q.device)[None]
    vis = kpos[None, None, :] <= qpos[:, :, None]            # (B, Sq, K)
    if window is not None:
        vis &= kpos[None, None, :] > qpos[:, :, None] - window
    mask = vis[:, None, None]
    qf = q.float().reshape(b, hkv, g, sq, d) * _scale(scale, d)
    logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, k)
    logits = torch.where(mask, logits, NEG_INF)
    p = torch.where(mask, torch.softmax(logits, dim=-1), 0.0)
    v = torch.where(vis.any(dim=1)[:, None, :, None], v, 0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v)
    return out.reshape(b, hq, sq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Hand-written CUDA kernels (csrc/paged_attention.cu).
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# limits of csrc/paged_attention.cu: 64-key tiles and 64-row tiles (any
# block size, any g * Sq), one PV column a thread on the CUDA cores
_TILE_KEYS, _MAX_HEAD_DIM, _MAX_ROWS = 64, 128, 64
_MAX_SMEM = 227 * 1024
# head dims the tensor-core kernel is built for; a head dim between two is
# zero-padded in shared memory up to the next
HEAD_DIM_TEMPLATES = (16, 32, 64, 128)
# the most key splits of one row tile (the combining block reads them all)
MAX_SPLITS = 64


def route(dtype, d: int) -> tuple[str, int]:
    """The kernel that takes ``dtype`` at head dim ``d`` (decode and
    prefill alike) and the head dim it runs at: ``("mma", d rounded up to
    16, 32, 64 or 128)`` for bf16, ``("simt", d)`` for fp32."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"paged attention: q dtype {dtype}; the kernels "
                        "take bfloat16 or float32")
    if dtype == torch.float32:
        return "simt", d
    return "mma", next(t for t in HEAD_DIM_TEMPLATES if t >= d)


prefill_route = route       # the name the prefill's callers know


def prefill_plan(hkv: int, rows: int, bs: int, max_blocks: int,
                 n_sm: int) -> tuple[int, int]:
    """(row tiles, key splits) of the tensor-core kernel for ``rows`` =
    g * Sq query rows a kv head.  The splits follow the table's width
    (at most one per 64-key tile of its ``max_blocks * bs`` keys) and the
    card's SM count (enough blocks to fill it at B = 1), never the batch or
    ``q_start``: the host reads no device tensor, and a row's output does
    not depend on the rows batched with it."""
    row_tiles = -(-rows // _MAX_ROWS)
    tiles = -(-max_blocks * bs // _TILE_KEYS)
    want = -(-n_sm // (row_tiles * hkv))
    return row_tiles, max(1, min(tiles, want, MAX_SPLITS))


def decode_plan(hkv: int, g: int, bs: int, max_blocks: int,
                n_sm: int) -> tuple[int, int]:
    """(row tiles, key splits) of the tensor-core decode: its g query rows a
    kv head cut as the prefill's (:func:`prefill_plan` with Sq = 1), from
    the table's width, the block size and the SM count, never ``kv_len``
    (a device tensor: reading it would sync the host every step) or B."""
    return prefill_plan(hkv, g, bs, max_blocks, n_sm)


def split_tiles(n_tiles: int, splits: int) -> list[range]:
    """The key tiles each split walks when a row's frontier covers
    ``n_tiles`` tiles (the kernel's ``first_tile``): contiguous, in order,
    every tile exactly once; a split with none writes an empty partial."""
    return [range(s * n_tiles // splits, (s + 1) * n_tiles // splits)
            for s in range(splits)]


def smem_bytes(kind: str, dp: int, rows: int, splits: int = 1) -> int:
    """Shared memory of a block of route ``kind`` (csrc's layouts): ``mma``
    Q, two K and two V tiles of 64 rows of ``dp`` + 8 bf16 (or the
    combine's weights, if larger); ``simt`` two K/V stages of 64 keys of
    ``dp`` + 4 floats, then q, p and the softmax state of its ``rows``
    (at most 64)."""
    if kind == "mma":
        return max(5 * _MAX_ROWS * (dp + 8) * 2, _MAX_ROWS * (splits + 1) * 4)
    rows = min(rows, _MAX_ROWS)
    return (4 * _TILE_KEYS * (dp + 4) + rows * dp + rows * _TILE_KEYS
            + 3 * rows) * 4


def _check(q, k_pool, v_pool, block_table, lens, what: str) -> None:
    """Raise on anything the kernels do not take."""
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
    if block_table.shape[1] * bs >= 2 ** 31:
        raise ValueError(f"{what}: a table of {block_table.shape[1]} blocks "
                         f"of {bs} positions exceeds 2^31 - 1 keys")
    kind, dp = route(q.dtype, d)
    if kind == "mma" and q.data_ptr() % 16:
        raise ValueError(f"{what}: q must be 16-byte aligned")
    smem = smem_bytes(kind, dp, (hq // hkv) * sq, MAX_SPLITS)
    if smem > _MAX_SMEM:
        raise ValueError(f"{what}: needs {smem} bytes of shared memory, "
                         f"the card offers {_MAX_SMEM}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# The arrival counters of the split kernels' combine, one buffer per
# (device, stream): zeroed once, and every launch leaves its words zero.
# Launches on one stream run in order, so they may share a buffer; two
# streams never share one, so split launches on concurrent streams (the
# serving cluster's threaded driver) never read each other's arrivals.  A
# buffer is allocated while its stream is current: when it grows, the old
# one returns to that stream's pool in PyTorch's caching allocator, which
# hands it out again only to later work on the same stream.
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}
_COUNTERS_LOCK = threading.Lock()


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    key = (dev.index, torch.cuda.current_stream(dev).cuda_stream)
    with _COUNTERS_LOCK:
        have = _COUNTERS.get(key)
        if have is None or have.numel() < n:
            have = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
            _COUNTERS[key] = have
        return have


def _launch(what, q, k_pool, v_pool, block_table, lens, scale, decode):
    """One launch of the kernel of q's route into a new output; counts it."""
    _check(q, k_pool, v_pool, block_table, lens, what)
    b, hq, sq, d = q.shape
    _, hkv, bs, _ = k_pool.shape
    g, m = hq // hkv, block_table.shape[1]
    kind, dp = route(q.dtype, d)
    out = torch.empty_like(q)
    lib = build.library(SOURCE)
    with torch.cuda.device(q.device):
        if kind == "mma":
            plan = decode_plan(hkv, g, bs, m, _sm_count(q.device.index)) \
                if decode else \
                prefill_plan(hkv, g * sq, bs, m, _sm_count(q.device.index))
            row_tiles, splits = plan
            units = b * hkv * row_tiles
            part = (torch.empty(units * splits * _MAX_ROWS * (dp + 2),
                                dtype=torch.float32, device=q.device)
                    if splits > 1 else None)
            counters = _counters(q.device, units) if splits > 1 else None
            err = lib.repro_paged_attention_mma(
                _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(block_table),
                _ptr(lens), _ptr(out),
                None if part is None else _ptr(part),
                None if counters is None else _ptr(counters), b, hkv, g, sq,
                d, dp, bs, m, splits, int(decode), _scale(scale, d),
                _stream(q))
        else:
            err = lib.repro_paged_attention_simt(
                _ptr(q), _ptr(k_pool), _ptr(v_pool), _ptr(block_table),
                _ptr(lens), _ptr(out), b, hkv, g, sq, d, bs, m, int(decode),
                _scale(scale, d), _stream(q))
    build.check(lib, err, what)
    build.count(LAUNCHES, what, 1, ROUTE_COUNTS[what], kind)
    return out


def paged_decode_attention_cuda(q, k_pool, v_pool, block_table, kv_len, *,
                                scale=None):
    """The decode kernel of ``q``'s dtype (:func:`route`), replacing
    ``paged_decode_attention_pallas``
    (``repro/kernels/paged_attention.py:103``); any block size, any g.  bf16
    runs on the tensor cores, split over the keys (:func:`decode_plan`) and
    combined in the same launch; fp32 on CUDA cores, one block a 64-row
    tile.  Bound by bytes on the H100: the header note of
    ``csrc/paged_attention.cu`` says what the design does about that."""
    what = "paged_decode_attention"
    if q.dim() == 4 and q.shape[2] != 1:
        raise ValueError(f"{what}: q must carry one token per row, got "
                         f"Sq = {q.shape[2]}")
    return _launch(what, q, k_pool, v_pool, block_table, kv_len, scale, True)


def paged_prefill_attention_cuda(q, k_pool, v_pool, block_table, q_start, *,
                                 scale=None):
    """The chunked-prefill kernel of ``q``'s dtype (:func:`route`),
    replacing ``paged_prefill_attention_pallas``
    (``repro/kernels/paged_attention.py:224``); any block size, any g * Sq.
    bf16 runs on the tensor cores, split over the keys
    (:func:`prefill_plan`) and combined in the same launch; fp32 on CUDA
    cores, one block a 64-row tile.  The chunk's own K/V must already sit
    in its block, written on the same stream before this call."""
    return _launch("paged_prefill_attention", q, k_pool, v_pool, block_table,
                   q_start, scale, False)
