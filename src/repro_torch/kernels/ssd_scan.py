"""Mamba2 SSD (state-space dual) chunked scan.

Per head h with A = -exp(a_log[h]), over time t:

  h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t outer B_t ;   y_t = C_t . h_t
                                                       (+ d_skip[h] * x_t)

x ``(B, S, H, P)``, dt ``(B, S, H)`` (already softplus'd), B/C
``(B, S, G, N)`` with head h reading group ``h // (H / G)``.  The sequence
is cut into chunks of ``Q = min(chunk, S)`` positions (S must be a multiple
of Q, as the reference asserts): inside a chunk the masked
``(C B^T) * exp(segsum)`` product, across chunks the carried fp32 state.
Three implementations, as in the reference (``repro/kernels/ssd_scan.py``):

* ``ssd_cuda`` - the hand-written Hopper kernels in ``csrc/ssd_scan.cu``,
  launched on PyTorch's current stream.  They replace ``ssd_pallas`` (and
  the wrapper's separate ``d_skip`` / ``h0`` handling: the kernels load
  ``h0`` in place of zeros and add ``d_skip * x`` in fp32 before the one
  rounding of y).  The dtype picks the route (:func:`route`): bf16 runs
  chunk-parallel on the tensor cores (``mma``: chunk states, a state pass
  over the chunks, chunk outputs; one fused launch for one chunk), fp32
  the first port's kernel on CUDA cores (``simt``, one launch).  Each call
  adds :func:`kernels_per_call` to ``LAUNCHES["ssd_scan"]`` and to its
  route's count in ``ROUTES``.
* ``ssd_plain`` - plain PyTorch with the arithmetic of ``ssd_xla``, a Python
  loop over chunks.  The CPU runs it, and ``chip_smoke.py`` holds the kernel
  against it.
* ``ssd_step_plain`` - the one-token decode recurrence (``ssd_step_xla``),
  plain PyTorch on every device, as the reference leaves it to XLA.

``repro_torch.kernels.ops`` picks between the first two by the tensor's
device; under autograd it goes through :class:`SSDScan` (the same forward
by device, the backward differentiating ``ssd_plain``).  The sequential
oracle is ``ref.ssd_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

SOURCE = "ssd_scan.cu"
CHUNK = 64

# launches of the hand-written kernels since the last reset (a plain dict of
# ints: chip_smoke zeroes it before the main path and reads it after)
LAUNCHES = {"ssd_scan": 0}
# the same launches by route: "mma" (bf16, tensor cores), "simt" (fp32)
ROUTES = {"mma": 0, "simt": 0}


def reset_launches() -> None:
    for counts in (LAUNCHES, ROUTES):
        for name in counts:
            counts[name] = 0


def chunk_len(s: int, chunk: int = CHUNK) -> int:
    """The chunk of an S-position scan: ``min(chunk, S)``; raises unless it
    divides S (``ssd_xla`` and ``ssd_pallas`` assert the same)."""
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"ssd_scan: sequence length {s} must be at most "
                         f"{chunk} or a multiple of it")
    return q


def _chunk_body(h_in, xc, dtc, a, bc, cc):
    """One chunk, batch and heads written out, as the reference's
    ``_chunk_body`` under ``vmap``.  xc: (B, Q, H, P), dtc: (B, Q, H),
    a: (H,), bc/cc: (B, Q, H, N), h_in: (B, H, P, N).
    Returns (y (B, Q, H, P), h_out)."""
    s = torch.cumsum(dtc * a, dim=1)                       # (B, Q, H)
    st = s.transpose(1, 2)                                 # (B, H, Q)
    # intra-chunk: scores[b, h, i, j] = (C_i . B_j) exp(s_i - s_j), j <= i
    cb = torch.einsum("bihn,bjhn->bhij", cc, bc)
    q = s.shape[1]
    causal = torch.ones((q, q), dtype=torch.bool, device=xc.device).tril()
    # the exponent is masked before the exp, which makes the decay 0 above
    # the diagonal: there s_i - s_j is positive and overflows past 88 (the
    # reference's ``ssd_xla`` takes exp there and masks after, so its
    # gradient is 0 * inf = NaN)
    decay = torch.exp(torch.where(causal, st[..., :, None] - st[..., None, :],
                                  -torch.inf))
    scores = cb * decay
    dtx = dtc[..., None] * xc                              # (B, Q, H, P)
    y = torch.einsum("bhij,bjhp->bihp", scores, dtx)
    # inter-chunk: the carried state's contribution
    y = y + torch.exp(st).transpose(1, 2)[..., None] * torch.einsum(
        "bihn,bhpn->bihp", cc, h_in)
    # state update
    decay_out = torch.exp(st[..., -1:] - st)               # (B, H, Q)
    dh = torch.einsum("bjhp,bjhn->bhpn",
                      decay_out.transpose(1, 2)[..., None] * dtx, bc)
    h_out = torch.exp(st[..., -1])[..., None, None] * h_in + dh
    return y, h_out


def ssd_plain(x, dt, a_log, b_mat, c_mat, *, d_skip=None, h0=None,
              chunk=CHUNK):
    """The chunked scan of ``ssd_xla``: fp32 math, y in x's dtype, the
    final state ``(B, H, P, N)`` in fp32."""
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2:]
    rep = h // g
    q = chunk_len(s, chunk)
    a = -torch.exp(a_log.float())
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device) if h0 is None else h0.float())
    ys = []
    for c0 in range(0, s, q):
        t = slice(c0, c0 + q)
        y, state = _chunk_body(
            state, x[:, t].float(), dt[:, t].float(), a,
            b_mat[:, t].float().repeat_interleave(rep, dim=2),
            c_mat[:, t].float().repeat_interleave(rep, dim=2))
        ys.append(y)
    y = torch.cat(ys, dim=1)
    if d_skip is not None:
        y = y + d_skip.float()[None, None, :, None] * x.float()
    return y.to(x.dtype), state


def ssd_step_plain(h_state, xt, dtt, a_log, bt, ct, *, d_skip=None):
    """One-token recurrent step (decode, O(1) per token).  h_state:
    (B, H, P, N) fp32, xt: (B, H, P), dtt: (B, H), bt/ct: (B, G, N).
    Returns (y (B, H, P) in xt's dtype, new state)."""
    rep = xt.shape[1] // bt.shape[1]
    a = -torch.exp(a_log.float())
    bt = bt.float().repeat_interleave(rep, dim=1)
    ct = ct.float().repeat_interleave(rep, dim=1)
    decay = torch.exp(dtt.float() * a)
    dx = dtt.float()[..., None] * xt.float()
    h_state = decay[..., None, None] * h_state + dx[..., None] * bt[:, :, None]
    y = torch.einsum("bhpn,bhn->bhp", h_state, ct)
    if d_skip is not None:
        y = y + d_skip.float()[None, :, None] * xt.float()
    return y.to(xt.dtype), h_state


class SSDScan(torch.autograd.Function):
    """The scan under autograd: the forward by the tensor's device
    (:func:`ssd_cuda` on a CUDA tensor, :func:`ssd_plain` on a CPU tensor),
    the backward ``torch.autograd.grad`` of :func:`ssd_plain` recomputed
    from the saved inputs, on either device.  The reference's Pallas
    kernel has no VJP and its training differentiates ``ssd_xla`` through
    jnp; the plain backward is that, not the port of a kernel.  y's
    gradient reaches x, dt, a_log, b_mat, c_mat and ``d_skip``; an ``h0``
    that requires grad raises (training passes none) and ``h_final`` is not
    differentiable."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b_mat, c_mat, d_skip, h0):
        if ctx.needs_input_grad[6]:
            raise NotImplementedError(
                "ssd_scan: no gradient through h0 (training passes none)")
        if x.device.type == "cpu":
            fn = ssd_plain
        elif x.device.type == "cuda":
            fn = ssd_cuda
        else:
            raise ValueError(f"ssd_scan: no implementation for device "
                             f"{x.device}")
        y, h_final = fn(x, dt, a_log, b_mat, c_mat, d_skip=d_skip, h0=h0)
        ctx.save_for_backward(x, dt, a_log, b_mat, c_mat, d_skip, h0)
        ctx.mark_non_differentiable(h_final)
        return y, h_final

    @staticmethod
    def backward(ctx, dy, _dh):
        *inputs, h0 = ctx.saved_tensors
        need = ctx.needs_input_grad[:6]
        args = [None if t is None else t.detach().requires_grad_(n)
                for t, n in zip(inputs, need)]
        with torch.enable_grad():
            y, _ = ssd_plain(*args[:5], d_skip=args[5], h0=h0)
        grads = iter(torch.autograd.grad(
            y, [t for t, n in zip(args, need) if n], dy))
        return (*(next(grads) if n else None for n in need), None)


# ---------------------------------------------------------------------------
# Hand-written CUDA kernel (csrc/ssd_scan.cu).
# ---------------------------------------------------------------------------

_ROUTE = {torch.bfloat16: "mma", torch.float32: "simt"}
# limits of csrc/ssd_scan.cu: a chunk of at most 64 positions, a state of
# at most 256; the simt kernel takes 16 state rows (of P) a thread block
# and holds the fp32 tiles below in shared memory
_SLICE_P, _MAX_STATE = 16, 256
_MAX_SMEM = 227 * 1024


def route(dtype) -> str:
    """The kernel that takes ``dtype``: ``"mma"`` (bf16, chunk-parallel on
    the tensor cores) or ``"simt"`` (fp32, CUDA cores).  Raises on any
    other dtype."""
    if dtype not in _ROUTE:
        raise TypeError(f"ssd_scan: x dtype {dtype}; the kernel takes "
                        "bfloat16 or float32")
    return _ROUTE[dtype]


def n_chunks(s: int) -> int:
    return s // chunk_len(s)


def kernels_per_call(s: int, dtype=torch.bfloat16) -> int:
    """Launches of one call at sequence length ``s``: the mma route runs
    chunk states, the state pass and chunk outputs (3), or one fused
    launch where S is one chunk; simt one."""
    if route(dtype) == "simt" or n_chunks(s) == 1:
        return 1
    return 3


def workspace_numel(b: int, s: int, h: int, p: int, n: int) -> int:
    """fp32 elements of the mma route's workspace: each chunk's state
    (B, chunks, H, P, N) and its exp(s_last) (B, chunks, H); none where S
    is one chunk."""
    nc = n_chunks(s)
    return 0 if nc == 1 else b * nc * h * (p * n + 1)


def smem_bytes(q: int, n: int) -> int:
    """Dynamic shared memory of one simt thread block (csrc/ssd_scan.cu)."""
    ld = n + 1
    return 4 * (2 * q * ld + q * (q + 1) + 2 * q * _SLICE_P
                + _SLICE_P * ld + 3 * q)


def _check(x, dt, a_log, b_mat, c_mat, d_skip, h0) -> int:
    """Raise on anything the kernel does not take; returns the chunk."""
    what = "ssd_scan"
    named = [("x", x), ("dt", dt), ("a_log", a_log), ("b_mat", b_mat),
             ("c_mat", c_mat), ("d_skip", d_skip), ("h0", h0)]
    for name, t in named:
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{what}: {name} on {t.device}, expected the "
                             f"CUDA device of x ({x.device})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    route(x.dtype)
    if b_mat.dtype != x.dtype or c_mat.dtype != x.dtype:
        raise TypeError(f"{what}: b_mat / c_mat ({b_mat.dtype}, "
                        f"{c_mat.dtype}) must match x ({x.dtype})")
    for name, t in named[1:3] + named[5:]:
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
    if x.dim() != 4 or b_mat.dim() != 4 or b_mat.shape != c_mat.shape:
        raise ValueError(f"{what}: x {tuple(x.shape)} must be (B, S, H, P) "
                         f"and b_mat / c_mat (B, S, G, N), got "
                         f"{tuple(b_mat.shape)} / {tuple(c_mat.shape)}")
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2:]
    if (b_mat.shape[:2] != (bsz, s) or g == 0 or h % g
            or tuple(dt.shape) != (bsz, s, h) or tuple(a_log.shape) != (h,)
            or (d_skip is not None and tuple(d_skip.shape) != (h,))
            or (h0 is not None and tuple(h0.shape) != (bsz, h, p, n))):
        raise ValueError(
            f"{what}: shapes x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
            f"a_log {tuple(a_log.shape)}, b/c {tuple(b_mat.shape)}, d_skip "
            f"{None if d_skip is None else tuple(d_skip.shape)}, h0 "
            f"{None if h0 is None else tuple(h0.shape)}: need dt (B, S, H), "
            "a_log / d_skip (H,), h0 (B, H, P, N) and H % G == 0")
    q = chunk_len(s)
    if n < 1 or n > _MAX_STATE or p < 1:
        raise ValueError(f"{what}: d_state {n} must be in [1, {_MAX_STATE}]"
                         f" and head_dim {p} >= 1")
    if x.dtype == torch.float32 and smem_bytes(q, n) > _MAX_SMEM:
        raise ValueError(f"{what}: needs {smem_bytes(q, n)} bytes of shared "
                         f"memory, the card offers {_MAX_SMEM}")
    return q


def ssd_cuda(x, dt, a_log, b_mat, c_mat, *, d_skip=None, h0=None):
    """The kernels, replacing ``ssd_pallas``
    (``repro/kernels/ssd_scan.py:153``) and its wrapper's ``d_skip`` / ``h0``
    handling.  Returns (y in x's dtype, h_final (B, H, P, N) fp32)."""
    q = _check(x, dt, a_log, b_mat, c_mat, d_skip, h0)
    bsz, s, h, p = x.shape
    g, n = b_mat.shape[2:]
    y = torch.empty_like(x)
    h_out = torch.empty((bsz, h, p, n), dtype=torch.float32, device=x.device)
    rt = route(x.dtype)

    def ptr(t):
        return ctypes.c_void_p(None if t is None else t.data_ptr())
    lib = build.library(SOURCE)
    with torch.cuda.device(x.device):
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(x.device).cuda_stream)
        args = (ptr(x), ptr(dt), ptr(a_log), ptr(b_mat), ptr(c_mat), ptr(h0),
                ptr(d_skip), ptr(y), ptr(h_out))
        if rt == "simt":
            err = lib.repro_ssd_scan_simt(*args, bsz, s, h, p, g, n, q,
                                          stream)
        else:
            ws = torch.empty(workspace_numel(bsz, s, h, p, n),
                             dtype=torch.float32, device=x.device)
            err = lib.repro_ssd_scan_mma(*args, ptr(ws), bsz, s, h, p, g, n,
                                         q, stream)
    build.check(lib, err, "ssd_scan")
    k = kernels_per_call(s, x.dtype)
    build.count(LAUNCHES, "ssd_scan", k, ROUTES, rt)
    return y, h_out
