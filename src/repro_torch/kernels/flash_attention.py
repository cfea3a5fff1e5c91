"""Dense flash-attention forward: GQA, causal and/or sliding window.

q ``(B, Hq, Sq, D)`` against k/v ``(B, Hkv, Sk, D)``, q-head ``h`` reading kv
head ``h // (Hq / Hkv)``, queries right-aligned to the keys
(``qpos = i + Sk - Sq``).  Two implementations, as in the reference
(``repro/kernels/attention.py``):

* ``flash_attention_cuda`` — the hand-written Hopper kernels in
  ``csrc/flash_attention.cu``, launched on PyTorch's current stream.  They
  replace ``flash_attention_pallas``; what bounds them and how they are
  built is in the source's header note.  The dtype picks the route
  (:func:`route`): bf16 runs on the tensor cores (``mma.sync``), fp32 on
  CUDA cores.  The wrapper checks its inputs, allocates the output with
  ``torch.empty`` and adds one to ``LAUNCHES["flash_attention"]`` and one
  to its route's count in ``ROUTES`` per launch.
* ``flash_attention_plain`` — plain PyTorch with the math of the reference's
  ``attention_xla`` forward: q chunks, an fp32 online softmax over kv chunks,
  masked logits at the finite ``-1e30``.  The CPU runs it, and
  ``chip_smoke.py`` holds the kernel against it.

Both keep the reference's edge semantics: a row whose keys are all masked
(causal with Sq > Sk) ends as the mean of V over every key, not 0.
``repro_torch.kernels.ops`` picks between them by the tensor's device.

Training differentiates through :class:`FlashAttention`, the counterpart of
the reference's ``jax.custom_vjp`` around ``attention_xla``
(``repro/kernels/attention.py:139-260``).  Its forward is the kernel on a
CUDA tensor and the plain version on a CPU tensor, each asked for the rows'
log-sum-exp (``return_lse=True``); its backward is
:func:`flash_attention_backward_plain` on either device, the port of the
reference's ``_flash_bwd``, which is XLA code there, not a Pallas kernel.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

NEG_INF = -1e30
SOURCE = "flash_attention.cu"

# launches of the hand-written kernel since the last reset (a plain dict of
# ints: chip_smoke zeroes it before the main path and reads it after)
LAUNCHES = {"flash_attention": 0}
# the same launches by route: "mma" (bf16, tensor cores), "simt" (fp32)
ROUTES = {"mma": 0, "simt": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0


def _scale(scale, d: int) -> float:
    return float(scale if scale is not None else 1.0 / math.sqrt(d))


def _mask(qpos, kpos, causal: bool, window):
    """(Sq', Sk') bool: key ``kpos`` is visible to query ``qpos``."""
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def _kv_hi(q0: int, q1: int, sq: int, sk: int, causal: bool,
           kv_chunk: int) -> int:
    """The keys q rows ``[q0, q1)`` walk: under the causal mask up to the
    kv chunk holding the last row's position, unless a row sees no key."""
    if causal and q0 + sk - sq >= 0:
        return min(sk, -(-(q1 + sk - sq) // kv_chunk) * kv_chunk)
    return sk


def flash_attention_plain(q, k, v, *, causal=True, window=None, scale=None,
                          q_chunk=1024, kv_chunk=1024, return_lse=False):
    """The reference's ``attention_xla`` forward (no ``kv_len``), for any
    Sq and Sk: a loop over q chunks, each an fp32 online softmax over kv
    chunks (the last chunk of either may be short).  Returns (B, Hq, Sq, D)
    in q's dtype; with ``return_lse`` also each row's log-sum-exp
    ``m + log(max(l, 1e-30))``, (B, Hq, Sq) fp32, as ``_flash_fwd_impl``
    keeps it for the backward.

    Under the causal mask a q chunk stops at the last kv chunk its last row
    can see, as the reference does — except when the chunk holds a row with
    no visible key (qpos < 0): such a row is the mean of V over every key,
    so its chunk walks all of them (the reference's chunk bound would drop
    keys there, where its Pallas kernel and the CUDA kernel keep them)."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    qf_all = q.float() * _scale(scale, d)
    kf, vf = k.float(), v.float()
    outs, lses = [], []
    for q0 in range(0, sq, q_chunk):
        q1 = min(q0 + q_chunk, sq)
        qpos = torch.arange(q0, q1, device=q.device) + (sk - sq)
        kv_hi = _kv_hi(q0, q1, sq, sk, causal, kv_chunk)
        qf = qf_all[:, :, q0:q1].reshape(b, hkv, g, q1 - q0, d)
        m = torch.full((b, hkv, g, q1 - q0, 1), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(qf)
        for k0 in range(0, kv_hi, kv_chunk):
            k1 = min(k0 + kv_chunk, kv_hi)
            kpos = torch.arange(k0, k1, device=q.device)
            logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kf[:, :, k0:k1])
            logits = torch.where(_mask(qpos, kpos, causal, window), logits,
                                 NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p,
                                             vf[:, :, k0:k1])
            m = m_new
        out = acc / torch.where(l == 0.0, 1.0, l)
        outs.append(out.reshape(b, hq, q1 - q0, d).to(q.dtype))
        lses.append((m + torch.log(torch.clamp(l, min=1e-30)))
                    .reshape(b, hq, q1 - q0))
    out = torch.cat(outs, dim=2)
    return (out, torch.cat(lses, dim=2)) if return_lse else out


def flash_attention_backward_plain(q, k, v, out, lse, dout, *, causal=True,
                                   window=None, scale=None, q_chunk=1024,
                                   kv_chunk=1024):
    """Gradients (dq, dk, dv) of the flash forward, in the inputs' dtypes:
    the reference's ``_flash_bwd`` over the q chunks of ``attention_xla``.

    Everything runs in fp32 from the saved q, k, v, out and lse (B, Hq,
    Sq): per q chunk ``delta = sum(dout * out)``, and per kv chunk
    ``p = exp(logits - lse)`` recomputed under the forward's mask, ``dv +=
    p^T dout``, ``ds = p (dout v^T - delta)``, ``dq += ds k scale`` and
    ``dk += ds^T q scale``; dk and dv sum over the g q-heads of a kv head.
    The chunks and the causal key bound are the forward's
    (:func:`flash_attention_plain`)."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    sc = _scale(scale, d)
    kf, vf = k.float(), v.float()
    dq = torch.empty((b, hq, sq, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, hkv, sk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for q0 in range(0, sq, q_chunk):
        q1 = min(q0 + q_chunk, sq)
        n = q1 - q0
        qpos = torch.arange(q0, q1, device=q.device) + (sk - sq)
        kv_hi = _kv_hi(q0, q1, sq, sk, causal, kv_chunk)
        qf = (q[:, :, q0:q1].float() * sc).reshape(b, hkv, g, n, d)
        do = dout[:, :, q0:q1].float().reshape(b, hkv, g, n, d)
        o = out[:, :, q0:q1].float().reshape(b, hkv, g, n, d)
        lq = lse[:, :, q0:q1].reshape(b, hkv, g, n, 1)
        delta = (do * o).sum(dim=-1, keepdim=True)
        dqc = torch.zeros_like(qf)
        for k0 in range(0, kv_hi, kv_chunk):
            k1 = min(k0 + kv_chunk, kv_hi)
            kb, vb = kf[:, :, k0:k1], vf[:, :, k0:k1]
            kpos = torch.arange(k0, k1, device=q.device)
            logits = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb)
            logits = torch.where(_mask(qpos, kpos, causal, window), logits,
                                 NEG_INF)
            p = torch.exp(logits - lq)
            dv[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", p, do)
            ds = p * (torch.einsum("bhgqd,bhkd->bhgqk", do, vb) - delta)
            dqc += torch.einsum("bhgqk,bhkd->bhgqd", ds, kb) * sc
            dk[:, :, k0:k1] += torch.einsum("bhgqk,bhgqd->bhkd", ds, qf)
        dq[:, :, q0:q1] = dqc.reshape(b, hq, n, d)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttention(torch.autograd.Function):
    """Flash attention under autograd: the forward by the tensor's device
    (the kernel on a CUDA tensor, the plain version on a CPU tensor, each
    keeping the rows' log-sum-exp), the backward
    :func:`flash_attention_backward_plain` on either.  It saves (q, k, v,
    out, lse).  ``kv_len`` has no gradient path, as in the reference."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if q.device.type == "cpu":
            fn = flash_attention_plain
        elif q.device.type == "cuda":
            fn = flash_attention_cuda
        else:
            raise ValueError(f"attention: no implementation for device "
                             f"{q.device}")
        out, lse = fn(q, k, v, causal=causal, window=window, scale=scale,
                      return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        dq, dk, dv = flash_attention_backward_plain(*ctx.saved_tensors, dout,
                                                    **ctx.opts)
        return dq, dk, dv, None, None, None


# ---------------------------------------------------------------------------
# Hand-written CUDA kernel (csrc/flash_attention.cu).
# ---------------------------------------------------------------------------

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# limits of csrc/flash_attention.cu's fp32 kernel: one PV column a thread
# (128 threads), at most 64 query rows (g * bq) a thread block, a larger
# group cut into blocks of 64 q-heads (:func:`group_blocks`), 64-key tiles
# (the head dim limit holds for both routes)
_MAX_HEAD_DIM, _MAX_ROWS, _TILE_KEYS = 128, 64, 64
_MAX_SMEM = 227 * 1024
# head dims the tensor-core kernel is built for; a head dim between two is
# zero-padded in shared memory up to the next
HEAD_DIM_TEMPLATES = (16, 32, 64, 128)


def route(dtype, d: int) -> tuple[str, int]:
    """The kernel that takes ``dtype`` at head dim ``d``, and the head dim
    it runs at: ``("mma", d rounded up to 16, 32, 64 or 128)`` for bf16,
    ``("simt", d)`` for fp32.  Raises on any other dtype, and on a head dim
    that is not a multiple of 8 up to 128."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"flash_attention: q dtype {dtype}; the kernel takes "
                        "bfloat16 or float32")
    if d <= 0 or d % 8 or d > _MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} must be a multiple "
                         f"of 8 up to {_MAX_HEAD_DIM}")
    if dtype == torch.float32:
        return "simt", d
    return "mma", next(t for t in HEAD_DIM_TEMPLATES if t >= d)


def group_blocks(g: int) -> int:
    """Blocks the fp32 route cuts a kv head's group of ``g`` q-heads into:
    at most 64 q-heads a block (64 query rows), so ceil(g / 64).  The bf16
    route runs a block per q-head and 64 queries whatever g is."""
    return -(-g // _MAX_ROWS)


def _check(q, k, v, window) -> None:
    """Raise on anything the kernel does not take."""
    what = "flash_attention"
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{what}: {name} on {t.device}, expected the "
                             f"CUDA device of q ({q.device})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{what}: q dtype {q.dtype}; the kernel takes "
                        "bfloat16 or float32")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{what}: k / v ({k.dtype}, {v.dtype}) must match "
                        f"q ({q.dtype})")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: q {tuple(q.shape)} must be (B, Hq, Sq, D)"
                         f" and k / v (B, Hkv, Sk, D), got {tuple(k.shape)} "
                         f"/ {tuple(v.shape)}")
    b, hq, _, d = q.shape
    bk, hkv, sk, dk = k.shape
    if bk != b or dk != d or hkv == 0 or hq % hkv or sk == 0:
        raise ValueError(f"{what}: q {tuple(q.shape)} vs k / v "
                         f"{tuple(k.shape)} (need equal B and D, Sk >= 1 and "
                         "Hq % Hkv == 0)")
    kind, _ = route(q.dtype, d)
    if window is not None and window < 1:
        raise ValueError(f"{what}: window {window} must be >= 1 (or None)")
    if kind == "mma":
        return                  # 5 tiles of 64 x (128 + 8) bf16 at most
    if b * hkv * group_blocks(hq // hkv) > 65535:
        raise ValueError(f"{what}: B * Hkv * ceil(g / {_MAX_ROWS}) must be at "
                         "most 65535 (the grid's y dimension)")
    gh = min(hq // hkv, _MAX_ROWS)
    rows = gh * (_MAX_ROWS // gh)
    ld = d + 16 // q.element_size()
    smem = (4 * _TILE_KEYS * ld * q.element_size()
            + (rows * d + rows * _TILE_KEYS + 3 * rows) * 4)
    if smem > _MAX_SMEM:
        raise ValueError(f"{what}: needs {smem} bytes of shared memory, "
                         f"the card offers {_MAX_SMEM}")


def flash_attention_cuda(q, k, v, *, causal=True, window=None, scale=None,
                         return_lse=False):
    """The kernel of ``q``'s dtype (:func:`route`), replacing
    ``flash_attention_pallas`` (``repro/kernels/attention.py:73``).
    ``causal``, ``window`` (None or >= 1) and ``scale`` (``1/sqrt(D)`` by
    default) are runtime arguments of one compiled kernel.  With
    ``return_lse`` the same launch also stores each row's log-sum-exp,
    (B, Hq, Sq) fp32, and returns (out, lse); without it the kernel is
    given a null pointer and stores none (``out`` is the same bits)."""
    _check(q, k, v, window)
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    kind, dp = route(q.dtype, d)
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    lib = build.library(SOURCE)
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)]
    ptrs.append(ctypes.c_void_p(None if lse is None else lse.data_ptr()))
    tail = (_scale(scale, d), int(bool(causal)),
            -1 if window is None else int(window),
            ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    with torch.cuda.device(q.device):
        if kind == "mma":
            err = lib.repro_flash_attention_mma(
                *ptrs, b, hkv, hq // hkv, sq, sk, d, dp, *tail)
        else:
            err = lib.repro_flash_attention(
                _DTYPE_CODE[q.dtype], *ptrs, b, hkv, hq // hkv, sq, sk, d,
                *tail)
    build.check(lib, err, "flash_attention")
    build.count(LAUNCHES, "flash_attention", 1, ROUTES, kind)
    return (out, lse) if return_lse else out
