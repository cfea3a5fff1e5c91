"""Plain PyTorch oracles for the port's kernels, mirroring the pool kernels'
oracles, the dense and paged attention oracles and the SSD recurrence of
``repro/kernels/ref.py``: deliberately naive, fully materialized or
sequential, fp32 math.  Tests hold them against the reference's oracles;
the plain paged paths share the table gather."""
from __future__ import annotations

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
