"""xLSTM blocks: chunkwise-parallel mLSTM (matrix memory) and recurrent
sLSTM (scalar memory), per arXiv:2405.04517.  The port's counterpart of
``repro/models/xlstm.py``, for training and serving.

The reference has no Pallas kernel here: its path is einsums, a scan over
chunks and a scan over tokens, all left to XLA.  The port's is the same
arithmetic in plain PyTorch on every device: a Python loop over the mLSTM
chunks and a per-token loop for the sLSTM recurrence, in the reference's
op order.  Under autograd both cells checkpoint as the reference's do
(``torch.utils.checkpoint``): each mLSTM chunk body, and the sLSTM loop in
segments of up to ``SEGMENT`` tokens, so the backward makes a chunk's
(Q, Q) matrices or a segment's per-token carries again instead of holding
every one.  Neither changes a value.  Every cell runs in fp32; a block's
projections run in the weights' dtype, and its fp32 leaves (``w_i``,
``w_f``, ``b_i``, ``b_f``, ``r_w``) stay fp32 at any weight dtype, as in
the reference.

States: mLSTM ``(C (B, H, dk, dv), n (B, H, dk), m (B, H))``, stored scaled
by exp(-m), with ``m`` starting at -1e30; sLSTM ``(c, n, h, m)`` each
(B, H, dh).  Decode is O(1) per token.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import records_grad
from .layers import PT, rmsnorm, silu
from .mamba2 import _causal_conv

CHUNK = 256       # the reference's mlstm_parallel chunk
SEGMENT = 64      # the reference's slstm_scan checkpoint segment
M_INIT = -1e30    # the running max of an empty state


def _under_grad(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` where autograd
    records it (grad mode on and an input that requires grad: a training
    call), so the backward runs ``fn`` again for what it needs; serving's
    calls run it as it is."""
    if records_grad(*args):
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# mLSTM cell - chunkwise parallel (prefill).
# ---------------------------------------------------------------------------

def _mlstm_chunk(carry, qc, kc, vc, lf, li):
    """One chunk.  carry: (C (B,H,dk,dv), n (B,H,dk), m (B,H));
    qc/kc: (B,H,Q,dk), vc: (B,H,Q,dv); lf/li: (B,H,Q) log f / log i, all
    fp32.  Returns (carry out, y (B,H,Q,dv))."""
    c_in, n_in, m_in = carry
    f_cum = torch.cumsum(lf, dim=-1)                   # F_i, inclusive
    g = li - f_cum                                     # g_j
    m_tilde = torch.maximum(m_in[..., None], torch.cummax(g, dim=2).values)
    m_total = f_cum + m_tilde                          # recurrent m_t
    # intra-chunk decay matrix D_ij = exp(g_j - m_tilde_i), j <= i, 0 above
    # the diagonal.  The exponent is masked before the exp: above the
    # diagonal it may pass 88 and overflow (the reference takes exp there,
    # so its gradient is 0 * inf = NaN); D is the same bits
    q_idx = torch.arange(lf.shape[-1], device=lf.device)
    causal = (q_idx[:, None] >= q_idx[None, :])[None, None]
    d_mat = torch.exp(torch.where(
        causal, g[:, :, None, :] - m_tilde[:, :, :, None], -torch.inf))
    s = torch.einsum("bhid,bhjd->bhij", qc, kc) * d_mat   # masked scores
    inter_w = torch.exp(m_in[..., None] - m_tilde)     # (B,H,Q)
    num = torch.einsum("bhij,bhjv->bhiv", s, vc) \
        + inter_w[..., None] * torch.einsum("bhid,bhdv->bhiv", qc, c_in)
    den = s.sum(dim=-1) + inter_w * torch.einsum("bhid,bhd->bhi", qc, n_in)
    y = num / torch.maximum(den.abs(), torch.exp(-m_total))[..., None]
    # chunk-out state (stabilized at m_out = m_total[..., -1])
    m_last = m_tilde[..., -1]
    w_out = torch.exp(g - m_last[..., None])           # (B,H,Q)
    c_out = torch.einsum("bhjd,bhjv->bhdv", kc * w_out[..., None], vc) \
        + torch.exp(m_in - m_last)[..., None, None] * c_in
    n_out = torch.einsum("bhjd,bhj->bhd", kc, w_out) \
        + torch.exp(m_in - m_last)[..., None] * n_in
    return (c_out, n_out, f_cum[..., -1] + m_last), y


def chunk_len(s: int, chunk: int = CHUNK) -> int:
    """The chunk of an S-token mLSTM prefill: ``min(chunk, S)``; raises
    unless it divides S (the reference asserts the same)."""
    q = min(chunk, s)
    if q < 1 or s % q:
        raise ValueError(f"mlstm_parallel: sequence length {s} must be at "
                         f"most {chunk} or a multiple of it")
    return q


def mlstm_init_state(b: int, h: int, dk: int, dv: int, device):
    return (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=device),
            torch.zeros((b, h, dk), dtype=torch.float32, device=device),
            torch.full((b, h), M_INIT, dtype=torch.float32, device=device))


def mlstm_parallel(q, k, v, i_gate, f_gate, *, chunk=CHUNK, state=None):
    """q/k: (B, H, S, dk), v: (B, H, S, dv), i_gate/f_gate: (B, H, S) raw
    pre-activations.  Returns (y (B, H, S, dv) in v's dtype, state).  Under
    autograd each chunk body is checkpointed, as the reference's."""
    b, h, s, dk = q.shape
    dv = v.shape[-1]
    chunk = chunk_len(s, chunk)
    k = k / math.sqrt(dk)
    lf = F.logsigmoid(f_gate.float())
    li = i_gate.float()
    qf, kf, vf = q.float(), k.float(), v.float()
    if state is None:
        state = mlstm_init_state(b, h, dk, dv, q.device)
    ys = []
    for lo in range(0, s, chunk):
        sl = slice(lo, lo + chunk)
        state, y = _under_grad(_mlstm_chunk, state, qf[:, :, sl],
                               kf[:, :, sl], vf[:, :, sl], lf[..., sl],
                               li[..., sl])
        ys.append(y)
    return torch.cat(ys, dim=2).to(v.dtype), state


def mlstm_step(state, q, k, v, i_gate, f_gate):
    """One-token recurrent step.  q/k: (B,H,dk), v: (B,H,dv), gates (B,H).
    Returns (state, y (B,H,dv) in v's dtype)."""
    c, n, m = state
    dk = q.shape[-1]
    k = k.float() / math.sqrt(dk)
    q = q.float()
    lf = F.logsigmoid(f_gate.float())
    li = i_gate.float()
    m_new = torch.maximum(lf + m, li)
    fp = torch.exp(lf + m - m_new)
    ip = torch.exp(li - m_new)
    c = fp[..., None, None] * c + ip[..., None, None] * \
        torch.einsum("bhd,bhv->bhdv", k, v.float())
    n = fp[..., None] * n + ip[..., None] * k
    num = torch.einsum("bhd,bhdv->bhv", q, c)
    den = torch.einsum("bhd,bhd->bh", q, n)
    y = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return (c, n, m_new), y.to(v.dtype)


# ---------------------------------------------------------------------------
# sLSTM cell - strictly recurrent scalar memory.
# ---------------------------------------------------------------------------

def _slstm_step(carry, xt, r_w):
    c, n, h, m = carry
    rec = torch.einsum("ghde,bhe->bghd", r_w, h)      # (B, 4, H, dh)
    it = xt[..., 0] + rec[:, 0]
    ft = xt[..., 1] + rec[:, 1]
    zt = xt[..., 2] + rec[:, 2]
    ot = xt[..., 3] + rec[:, 3]
    lf = F.logsigmoid(ft)
    m_new = torch.maximum(lf + m, it)
    ip = torch.exp(it - m_new)
    fp = torch.exp(lf + m - m_new)
    c = fp * c + ip * torch.tanh(zt)
    n = fp * n + ip
    h = torch.sigmoid(ot) * c / torch.clamp(n, min=1.0)
    return c, n, h, m_new


def _slstm_run(state, xs, r_w):
    """The recurrence over xs (B, T, H, dh, 4) fp32, one step a token:
    (hs (B, T, H, dh), state)."""
    hs = []
    for t in range(xs.shape[1]):
        state = _slstm_step(state, xs[:, t], r_w)
        hs.append(state[2])
    return torch.stack(hs, dim=1), state


def segment_len(s: int, segment: int = SEGMENT) -> int:
    """The checkpoint segment of an S-token sLSTM scan, as the reference
    picks it: the largest divisor of S up to ``segment``; S itself (one
    segment, no checkpoint) where that is 1 or S is at most ``segment``."""
    seg = segment
    while s % seg:
        seg -= 1
    return s if seg <= 1 or s <= seg else seg


def slstm_scan(x_gates, r_w, state):
    """x_gates: (B, S, H, dh, 4) pre-activations [i, f, z, o] from the input
    path; r_w: (4, H, dh, dh) per-head recurrent weights; state (c, n, h,
    m) each (B, H, dh).  One step a token, in the reference's op order;
    under autograd each segment of :func:`segment_len` tokens is
    checkpointed, as the reference's two-level scan.  Returns (hs (B, S,
    H, dh) fp32, state)."""
    xs = x_gates.float()
    s = xs.shape[1]
    seg = segment_len(s)
    if seg == s:
        return _slstm_run(state, xs, r_w)
    hs = []
    for lo in range(0, s, seg):
        h, state = _under_grad(_slstm_run, state, xs[:, lo:lo + seg], r_w)
        hs.append(h)
    return torch.cat(hs, dim=1), state


def slstm_init_state(b: int, h: int, dh: int, device):
    def z():
        return torch.zeros((b, h, dh), dtype=torch.float32, device=device)
    return (z(), z(), z(), torch.full((b, h, dh), M_INIT,
                                      dtype=torch.float32, device=device))


# ---------------------------------------------------------------------------
# Blocks.
# ---------------------------------------------------------------------------

def mlstm_block_templates(d_model: int, n_heads: int, pf: int = 2,
                          d_conv: int = 4) -> dict:
    di = pf * d_model
    dh = di // n_heads
    return {
        "norm": PT((d_model,), "zeros"),
        "up": PT((d_model, 2 * di), "scaled"),
        "conv_w": PT((d_conv, di), "scaled"),
        "conv_b": PT((di,), "zeros"),
        # block-diagonal per-head projections (xLSTM paper): di^2/H params
        "wq": PT((n_heads, dh, dh), "scaled"),
        "wk": PT((n_heads, dh, dh), "scaled"),
        "wv": PT((n_heads, dh, dh), "scaled"),
        "w_i": PT((di, n_heads), "scaled", dtype=torch.float32),
        "w_f": PT((di, n_heads), "scaled", dtype=torch.float32),
        "b_i": PT((n_heads,), "zeros", dtype=torch.float32),
        "b_f": PT((n_heads,), "ones", dtype=torch.float32),
        "hnorm": PT((di,), "zeros"),
        "down": PT((di, d_model), "scaled"),
    }


def _mlstm_block_inner(p, x, n_heads, *, conv_state=None, mstate=None,
                       chunk=CHUNK, norm_eps=1e-6):
    b, s, _ = x.shape
    h = rmsnorm(p["norm"], x, norm_eps)
    up = torch.matmul(h, p["up"])
    di = up.shape[-1] // 2
    xm, z = up[..., :di], up[..., di:]
    xc, new_conv = _causal_conv(xm, p["conv_w"], p["conv_b"],
                                conv_state=conv_state)
    dh = di // n_heads
    xch = xc.reshape(b, s, n_heads, dh)
    xmh = xm.reshape(b, s, n_heads, dh)
    q = torch.einsum("bshd,hde->bhse", xch, p["wq"])
    k = torch.einsum("bshd,hde->bhse", xch, p["wk"])
    v = torch.einsum("bshd,hde->bhse", xmh, p["wv"])
    ig = torch.matmul(xc.float(), p["w_i"]) + p["b_i"]          # (B, S, H)
    fg = torch.matmul(xc.float(), p["w_f"]) + p["b_f"]
    y, mstate = mlstm_parallel(q, k, v, ig.transpose(1, 2),
                               fg.transpose(1, 2), chunk=chunk, state=mstate)
    y = y.transpose(1, 2).reshape(b, s, di)
    y = rmsnorm(p["hnorm"], y, norm_eps) * silu(z)
    return x + torch.matmul(y, p["down"]), (new_conv, mstate)


def mlstm_block(p, x, n_heads, **kw):
    out, _ = _mlstm_block_inner(p, x, n_heads, **kw)
    return out


def mlstm_block_with_state(p, x, n_heads, conv_state, mstate, **kw):
    """The block over a prompt, from ``conv_state`` (B, K-1, di) and the
    mLSTM state ``mstate`` (None: empty).  Returns (out, (conv, mstate))."""
    return _mlstm_block_inner(p, x, n_heads, conv_state=conv_state,
                              mstate=mstate, **kw)


def mlstm_block_decode(p, x, n_heads, conv_state, mstate, *, norm_eps=1e-6):
    """One-token mLSTM block step.  x: (B, 1, d); conv_state: (B, K-1, di);
    mstate: (C, n, m).  The conv taps are one contraction here, as the
    reference writes it.  Returns (out, conv_state, mstate), new
    tensors."""
    b = x.shape[0]
    h = rmsnorm(p["norm"], x, norm_eps)
    up = torch.matmul(h, p["up"])
    di = up.shape[-1] // 2
    xm, z = up[..., :di], up[..., di:]
    xp = torch.cat([conv_state.to(xm.dtype), xm], dim=1)
    xc = silu(torch.einsum("bkc,kc->bc", xp, p["conv_w"]) + p["conv_b"])
    new_conv = xp[:, 1:, :]
    dh = di // n_heads
    xch = xc.reshape(b, n_heads, dh)
    xmh = xm[:, 0].reshape(b, n_heads, dh)
    q = torch.einsum("bhd,hde->bhe", xch, p["wq"])
    k = torch.einsum("bhd,hde->bhe", xch, p["wk"])
    v = torch.einsum("bhd,hde->bhe", xmh, p["wv"])
    ig = torch.matmul(xc.float(), p["w_i"]) + p["b_i"]
    fg = torch.matmul(xc.float(), p["w_f"]) + p["b_f"]
    mstate, y = mlstm_step(mstate, q, k, v, ig, fg)
    y = y.reshape(b, 1, di)
    y = rmsnorm(p["hnorm"], y, norm_eps) * silu(z)
    return x + torch.matmul(y, p["down"]), new_conv, mstate


def slstm_block_templates(d_model: int, n_heads: int,
                          d_conv: int = 4) -> dict:
    dh = d_model // n_heads
    return {
        "norm": PT((d_model,), "zeros"),
        "conv_w": PT((d_conv, d_model), "scaled"),
        "conv_b": PT((d_model,), "zeros"),
        "w_gates": PT((d_model, d_model * 4), "scaled"),
        "r_w": PT((4, n_heads, dh, dh), "scaled", dtype=torch.float32),
        "gnorm": PT((d_model,), "zeros"),
        "out": PT((d_model, d_model), "scaled"),
    }


def _slstm_out(p, x, hs, norm_eps):
    b, s, d = x.shape
    y = hs.reshape(b, s, d).to(x.dtype)
    y = rmsnorm(p["gnorm"], y, norm_eps)
    return x + torch.matmul(y, p["out"])


def slstm_block(p, x, n_heads, *, conv_state=None, state=None,
                norm_eps=1e-6, return_state=False):
    """The sLSTM block over a prompt x (B, S, d), from ``conv_state`` and
    ``state`` (None: empty).  Returns out, or (out, (conv, state))."""
    b, s, d = x.shape
    dh = d // n_heads
    h = rmsnorm(p["norm"], x, norm_eps)
    xc, new_conv = _causal_conv(h, p["conv_w"], p["conv_b"],
                                conv_state=conv_state)
    gates = torch.matmul(xc, p["w_gates"]).float()
    gates = gates.reshape(b, s, n_heads, dh, 4)
    if state is None:
        state = slstm_init_state(b, n_heads, dh, x.device)
    hs, state = slstm_scan(gates, p["r_w"], state)
    out = _slstm_out(p, x, hs, norm_eps)
    if return_state:
        return out, (new_conv, state)
    return out


def slstm_block_decode(p, x, n_heads, conv_state, state, *, norm_eps=1e-6):
    """One-token sLSTM block step.  x: (B, 1, d); conv_state: (B, K-1, d).
    Returns (out, conv_state, state), new tensors."""
    b, _, d = x.shape
    dh = d // n_heads
    h = rmsnorm(p["norm"], x, norm_eps)
    xp = torch.cat([conv_state.to(h.dtype), h], dim=1)
    xc = silu(torch.einsum("bkc,kc->bc", xp, p["conv_w"]) + p["conv_b"])
    new_conv = xp[:, 1:, :]
    gates = torch.matmul(xc, p["w_gates"]).float()
    gates = gates.reshape(b, 1, n_heads, dh, 4)
    hs, state = slstm_scan(gates, p["r_w"], state)
    return _slstm_out(p, x, hs, norm_eps), new_conv, state
