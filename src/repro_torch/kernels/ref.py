"""Plain PyTorch oracles for the port's kernels, mirroring the pool kernels'
oracles, the dense and paged attention oracles and the SSD recurrence of
``repro/kernels/ref.py``: deliberately naive, fully materialized or
sequential, fp32 math (jacobi2d and dropout round as the reference does in
x's dtype).  Tests hold them against the reference's oracles; the plain
paged paths share the table gather.  fft's is the reference's Stockham
schedule (``fft_xla``), not a library transform; pathfinder's edge fill is
the Pallas kernel's 3.0e38, not the reference oracle's fp32 max; exp's is
the Pallas body's polynomial with its fused multiply-adds (the reference's
oracle is ``jnp.exp``); dwt's rounds each level to x's dtype.  roi_align's
walks the samples one by one (the reference has no kernel for it)."""
from __future__ import annotations

import functools
import math

import torch


def matmul_ref(x, w, out_dtype=None):
    """(M, K) @ (K, N) in fp32, cast to ``out_dtype`` (default x's)."""
    return (x.float() @ w.float()).to(out_dtype or x.dtype)


def dotproduct_ref(x, y):
    """Sum of x * y in fp32, a 0-d tensor."""
    return (x.float() * y.float()).sum()


def softmax_ref(x, axis=-1):
    """Softmax along ``axis`` in fp32, max subtracted first; x's dtype."""
    x32 = x.float()
    e = torch.exp(x32 - x32.amax(dim=axis, keepdim=True))
    return (e / e.sum(dim=axis, keepdim=True)).to(x.dtype)


def conv2d_ref(x, w):
    """x: (C, H, W), w: (C, K, K) -> (H-K+1, W-K+1) in fp32 for fp32 and
    bf16 inputs alike, as the reference's oracle: the paper's 3x7x7
    single-output-channel convolution, tap by tap."""
    c, h, ww = x.shape
    k = w.shape[1]
    xf, wf = x.float(), w.float()
    out = torch.zeros((h - k + 1, ww - k + 1), device=x.device)
    for ci in range(c):
        for ki in range(k):
            for kj in range(k):
                out = out + wf[ci, ki, kj] * xf[ci, ki:h - k + 1 + ki,
                                                kj:ww - k + 1 + kj]
    return out


def fft_log2(n: int) -> int:
    """log2 n for a power of two n >= 2, which the FFT needs (the
    reference asserts it); raises ValueError on any other n."""
    if n < 2 or n & (n - 1):
        raise ValueError(f"fft: n={n} must be a power of two >= 2")
    return n.bit_length() - 1


def fft_twiddles(stage: int, l: int, device):
    """Stage ``stage``'s twiddles exp(-2 pi i j / 2l), j < l, as fp32
    (re, im) planes, each computed in fp64 and rounded once (the
    reference's table row ``stage``, without its zero padding)."""
    ang = torch.arange(l, dtype=torch.float64, device=device) * (-math.pi / l)
    return torch.cos(ang).float(), torch.sin(ang).float()


def fft_stages(x_re, x_im, twiddles=fft_twiddles):
    """The radix-2 Stockham FFT of ``fft.py:35-49`` in fp32: stage s views
    the signal as (2, l, m), top = a + b, bot = w_l (a - b), and stacks
    them as (l, 2, m).  ``twiddles(stage, l, device)`` gives w_l."""
    n = x_re.shape[0]
    xr, xi = x_re.float(), x_im.float()
    for s in range(fft_log2(n)):
        l, m = n >> (s + 1), 1 << s
        ar, br = xr.reshape(2, l, m)
        ai, bi = xi.reshape(2, l, m)
        wr, wi = (w.reshape(l, 1) for w in twiddles(s, l, xr.device))
        dr, di = ar - br, ai - bi
        xr = torch.stack([ar + br, wr * dr - wi * di], dim=1).reshape(n)
        xi = torch.stack([ai + bi, wr * di + wi * dr], dim=1).reshape(n)
    return xr, xi


def fft_ref(x_re, x_im):
    """(re, im) of the DFT of x_re + i x_im, fp32, by ``fft_stages``."""
    if x_re.dim() != 1 or x_re.shape != x_im.shape:
        raise ValueError(f"fft: x_re {tuple(x_re.shape)} and x_im "
                         f"{tuple(x_im.shape)} must be vectors of one length")
    return fft_stages(x_re, x_im)


PATHFINDER_FILL = 3.0e38     # the Pallas kernel's edge (pathfinder.py:18)


def pathfinder_ref(w):
    """w: (rows, cols) costs -> (cols,) fp32 min-path cost per column, row
    by row: dst[j] = w[i, j] + min(src[j], min(src[j-1], src[j+1])), the
    missing neighbours of the edge columns read as ``PATHFINDER_FILL``."""
    src = w[0].float()
    fill = torch.full((1,), PATHFINDER_FILL, dtype=torch.float32,
                      device=w.device)
    for i in range(1, w.shape[0]):
        left = torch.cat([fill, src[:-1]])
        right = torch.cat([src[1:], fill])
        src = w[i].float() + torch.minimum(src, torch.minimum(left, right))
    return src


def jacobi2d_ref(x, steps=1):
    """``steps`` 5-point Jacobi sweeps of the interior, boundary kept, in
    x's dtype: 0.2 * ((((centre + up) + down) + left) + right), each add
    and the product rounded to x's dtype, 0.2 itself rounded to it (as the
    reference's weakly typed scalar)."""
    fifth = torch.tensor(0.2, dtype=torch.float32).to(x.dtype)
    for _ in range(steps):
        inner = fifth * (x[1:-1, 1:-1] + x[:-2, 1:-1] + x[2:, 1:-1]
                         + x[1:-1, :-2] + x[1:-1, 2:])
        x = x.clone()
        x[1:-1, 1:-1] = inner
    return x.clone() if steps == 0 else x


def dropout_ref(x, bits, rate):
    """Keep x where float32(bits) / 2^32 >= float32(rate) (``bits``
    uint32, converted to nearest), scaled by 1 / (1 - rate) as a division
    by (1 - rate) rounded to x's dtype; 0 elsewhere; x's dtype."""
    u = bits.to(torch.float32) / 2.0 ** 32
    keep = u >= torch.tensor(rate, dtype=torch.float32)
    # on x's device: PyTorch's CUDA division by a CPU scalar multiplies by
    # its reciprocal, which is not the reference's division
    divisor = torch.tensor(1.0 - rate, dtype=torch.float64).to(x.dtype).to(
        x.device)
    return torch.where(keep, x / divisor, 0.0)


# exp_pallas's constants (expk.py:16-19) as the Pallas body sees them,
# rounded once to fp32: log2 e, ln 2 and the Taylor coefficients 1/k!,
# k = 6 down to 0, in the order of its Horner steps
EXP_LOG2E = 1.4426950408889634
EXP_LN2 = 0.6931471805599453
EXP_COEFFS = (1.0 / 720, 1.0 / 120, 1.0 / 24, 1.0 / 6, 0.5, 1.0, 1.0)
FLT_MIN = 2.0 ** -126        # the least normal fp32


def fma32(a, b, c):
    """fp32 ``a * b + c`` rounded once, as a fused multiply-add: the
    product of two fp32 values is exact in fp64 (48 bits), the fp64 sum is
    made round-to-odd (its rounding error, exact by TwoSum, decides the last
    bit) and then rounded to fp32.  Round-to-odd at 53 bits and then to
    nearest at 24 is the correctly rounded sum (53 >= 24 + 2), where a plain
    fp64 sum rounded again can land on an fp32 tie that the exact sum is
    not on."""
    a, b, c = (torch.as_tensor(t, dtype=torch.float32, device=a.device)
               for t in (a, b, c))
    prod = a.double() * b.double()
    c64 = c.double()
    s = prod + c64
    bb = s - prod
    err = (prod - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    sticky = torch.isfinite(err) & (err != 0) & even
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(sticky, torch.nextafter(s, toward), s)
    return s.float()


def exp_parts(x, fma=fma32):
    """The Pallas body ``_exp_poly`` (expk.py:22-32) up to its last step,
    in fp32: n = rint(x log2e) (half to even), r = fma(-n, ln2, x), six
    Horner steps p = fma(p, r, c), n clipped to [-126, 127] (a NaN n to
    -126, as fmaxf).  Returns (p, the clipped n as int32, 2^n built from
    exponent bits).  ``fma`` is the multiply-add (a test plants a schedule
    that rounds the product and the sum apart)."""
    xf = x.float()
    dev = xf.device
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    n = torch.round(xf * f32(EXP_LOG2E))
    r = fma(-n, f32(EXP_LN2), xf)
    p = torch.full_like(r, EXP_COEFFS[0])
    for c in EXP_COEFFS[1:]:
        p = fma(p, r, f32(c))
    ni = torch.fmin(torch.fmax(n, f32(-126.0)), f32(127.0)).to(torch.int32)
    return p, ni, ((ni + 127) << 23).view(torch.float32)


def exp_poly(x, fma=fma32):
    """The Pallas body ``_exp_poly`` (expk.py:22-32) in fp32, as ``jit``
    and the interpret path compile it (:func:`exp_parts`), then p 2^n,
    whose exact value is a product by a power of two, flushed to +0 where
    it is below the least normal fp32 (XLA:CPU flushes subnormals; PyTorch
    does not).  Outside about [-87.3, 88.7] the result follows the clip
    (89 -> 2.2e38, -200 -> 1.6e-38); +-inf give NaN."""
    p, _, two_n = exp_parts(x, fma)
    y = p.double() * two_n.double()          # exact
    return torch.where(y.abs() < FLT_MIN, 0.0, y).float()


def exp_ref(x):
    """Software exp of x (any shape, fp32 or bf16) by :func:`exp_poly`,
    rounded to x's dtype."""
    return exp_poly(x).to(x.dtype)


DWT_SCALE = 0.70710677      # fl32(1 / sqrt 2), dwt.py:17


def dwt_check(n: int, levels: int) -> None:
    """Raise ValueError unless ``levels`` >= 1 halvings of n are even."""
    if not isinstance(levels, int) or levels < 1:
        raise ValueError(f"dwt_haar: levels={levels!r} must be an int >= 1")
    if n < 1 or n % (1 << levels):
        raise ValueError(f"dwt_haar: n={n} is not divisible by "
                         f"2^levels = {1 << levels}")


def dwt_haar_ref(x, levels=1):
    """The 1-D Haar DWT of x (n,), fp32 or bf16, level by level: lo, hi =
    (even +- odd) * fl32(1/sqrt 2), each add and product rounded in fp32,
    then lo and hi rounded to x's dtype before the next level (bf16 as
    the Pallas kernel, which writes each level in x's dtype; fp32 as the
    reference's oracle ``dwt_haar_xla``).  Returns [lo_L, hi_L, ..., hi_1]
    in x's dtype."""
    if x.dim() != 1:
        raise ValueError(f"dwt_haar: x {tuple(x.shape)} must be a vector")
    dwt_check(x.shape[0], levels)
    s = torch.tensor(DWT_SCALE, dtype=torch.float32, device=x.device)
    lo, parts = x, []
    for _ in range(levels):
        even, odd = lo[0::2].float(), lo[1::2].float()
        parts.insert(0, ((even - odd) * s).to(x.dtype))
        lo = ((even + odd) * s).to(x.dtype)
    return torch.cat([lo, *parts])


def roi_align_ref(feat, rois, out_size=7, sampling=2):
    """feat: (C, H, W); rois: (R, 4) [y0, x0, y1, x1] in pixel coords.
    Returns (R, C, out_size, out_size) fp32: each bin the mean of its
    ``sampling``^2 bilinear samples, taken one at a time."""
    c, h, w = feat.shape
    f = feat.float()

    def bilinear(y, x):
        y = min(max(y, 0.0), h - 1.0)
        x = min(max(x, 0.0), w - 1.0)
        y0 = min(max(math.floor(y), 0), h - 2)
        x0 = min(max(math.floor(x), 0), w - 2)
        dy, dx = y - y0, x - x0
        return (f[:, y0, x0] * (1 - dy) * (1 - dx)
                + f[:, y0, x0 + 1] * (1 - dy) * dx
                + f[:, y0 + 1, x0] * dy * (1 - dx)
                + f[:, y0 + 1, x0 + 1] * dy * dx)

    out = torch.zeros((rois.shape[0], c, out_size, out_size),
                      dtype=torch.float32, device=feat.device)
    for r, (y0, x0, y1, x1) in enumerate(rois.double().tolist()):
        bin_h, bin_w = (y1 - y0) / out_size, (x1 - x0) / out_size
        for oy in range(out_size):
            for ox in range(out_size):
                acc = torch.zeros(c, dtype=torch.float32, device=feat.device)
                for sy in range(sampling):
                    for sx in range(sampling):
                        acc = acc + bilinear(
                            y0 + (oy + (sy + 0.5) / sampling) * bin_h,
                            x0 + (ox + (sx + 0.5) / sampling) * bin_w)
                out[r, :, oy, ox] = acc / (sampling * sampling)
    return out


def _softmax_rows(logits: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis with -inf masks; fully-masked rows -> 0."""
    p = torch.softmax(logits, dim=-1)
    return torch.where(torch.isnan(p), torch.zeros_like(p), p)


def attention_ref(q, k, v, *, causal=True, window=None, scale=None):
    """q: (B, Hq, Sq, D), k/v: (B, Hkv, Sk, D); GQA by head broadcast,
    queries right-aligned to the keys.  Masks with -inf, so a fully masked
    row is 0 here (the kernels' finite -1e30 makes it the mean of V)."""
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k = k.repeat_interleave(g, dim=1).float()
    v = v.repeat_interleave(g, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    qpos = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    logits = logits.masked_fill(~mask, float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", _softmax_rows(logits),
                        v).to(q.dtype)


def gather_pool(pool: torch.Tensor, block_table: torch.Tensor) -> torch.Tensor:
    """(N, Hkv, bs, D) pool through a (B, M) table -> (B, Hkv, M*bs, D)."""
    b, m = block_table.shape
    _, hkv, bs, d = pool.shape
    x = pool[block_table.long()]                     # (B, M, Hkv, bs, D)
    return x.permute(0, 2, 1, 3, 4).reshape(b, hkv, m * bs, d)


def paged_prefill_attention_ref(q, k_pool, v_pool, block_table, q_start, *,
                                scale=None, window=None):
    """Causal chunk attention against a paged KV pool, fully materialized.

    q: (B, Hq, Sq, D) — one prompt chunk per batch row, whose first query
    sits at absolute position ``q_start[b]``; query ``q_start + i`` attends
    every pool position ``<= q_start + i`` through the (B, M) table."""
    b, hq, sq, d = q.shape
    g = hq // k_pool.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    k = gather_pool(k_pool, block_table).repeat_interleave(g, dim=1).float()
    v = gather_pool(v_pool, block_table).repeat_interleave(g, dim=1).float()
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k) * scale
    qpos = q_start[:, None].long() + torch.arange(sq, device=q.device)[None]
    kpos = torch.arange(k.shape[2], device=q.device)[None, None, :]
    mask = kpos <= qpos[:, :, None]                  # (B, Sq, M*bs)
    if window is not None:
        mask &= kpos > qpos[:, :, None] - window
    logits = logits.masked_fill(~mask[:, None], float("-inf"))
    p = _softmax_rows(logits)
    return torch.einsum("bhqk,bhkd->bhqd", p, v).to(q.dtype)


def ssd_ref(x, dt, a_log, b_mat, c_mat, *, d_skip=None, h0=None):
    """Mamba2 SSD, the exact sequential recurrence (the oracle).

    x: (B, S, H, P), dt: (B, S, H), a_log: (H,) (A = -exp(a_log) < 0),
    b_mat/c_mat: (B, S, G, N) with H % G == 0, optional d_skip: (H,),
    h0: (B, H, P, N) initial state.  Returns (y in x's dtype, h_final fp32)."""
    bsz, s, h, p = x.shape
    rep = h // b_mat.shape[2]
    a = -torch.exp(a_log.float())
    bh = b_mat.float().repeat_interleave(rep, dim=2)           # (B, S, H, N)
    ch = c_mat.float().repeat_interleave(rep, dim=2)
    xf, dtf = x.float(), dt.float()
    state = (torch.zeros((bsz, h, p, b_mat.shape[3]), device=x.device)
             if h0 is None else h0.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * a)                        # (B, H)
        dx = dtf[:, t, :, None] * xf[:, t]                      # (B, H, P)
        state = (decay[..., None, None] * state
                 + dx[..., None] * bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, ch[:, t]))
    y = torch.stack(ys, dim=1)
    if d_skip is not None:
        y = y + d_skip.float()[None, None, :, None] * xf
    return y.to(x.dtype), state
