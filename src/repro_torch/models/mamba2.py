"""Mamba2 (SSD) block: fused in-projection, causal depthwise conv, SSD scan,
gated RMSNorm, out-projection.  The port's counterpart of
``repro/models/mamba2.py``.

The prefill scan goes through ``ops.ssd_scan`` (the hand-written kernel on
the card); decode keeps O(1) state per token, ``(conv_state (B, K-1,
conv_dim), ssm_state (B, H, P, N) fp32)``, stepped by ``ops.ssd_step``.
Both lead with the batch axis and couple no rows, so one row is one
sequence's whole state: the serving slot hooks (``slot_state``) admit,
evict or zero a row without touching its neighbours.
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels import ops
from .layers import PT, rmsnorm, silu, softplus


@dataclasses.dataclass(frozen=True)
class MambaDims:
    d_model: int
    d_inner: int
    head_dim: int
    n_heads: int
    n_groups: int
    d_state: int
    d_conv: int = 4

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def proj_dim(self) -> int:
        # [z (d_inner), x (d_inner), B (G*N), C (G*N), dt (H)]
        return 2 * self.d_inner + 2 * self.n_groups * self.d_state + self.n_heads


def mamba_dims(cfg) -> MambaDims:
    d_inner = cfg.ssm_expand * cfg.d_model
    head_dim = cfg.ssm_head_dim
    return MambaDims(cfg.d_model, d_inner, head_dim, d_inner // head_dim,
                     cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv)


def mamba_templates(dims: MambaDims) -> dict:
    f32 = torch.float32
    return {
        "in_proj": PT((dims.d_model, dims.proj_dim), "scaled"),
        "conv_w": PT((dims.d_conv, dims.conv_dim), "scaled"),
        "conv_b": PT((dims.conv_dim,), "zeros"),
        "a_log": PT((dims.n_heads,), "ssm_a", dtype=f32),
        "dt_bias": PT((dims.n_heads,), "ssm_dt", dtype=f32),
        "d_skip": PT((dims.n_heads,), "ones", dtype=f32),
        "norm_w": PT((dims.d_inner,), "zeros"),
        "out_proj": PT((dims.d_inner, dims.d_model), "scaled"),
    }


def _split_proj(zxbcdt, dims: MambaDims):
    di, gn, h = dims.d_inner, dims.n_groups * dims.d_state, dims.n_heads
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + di + 2 * gn]
    dt = zxbcdt[..., di + di + 2 * gn:]
    assert dt.shape[-1] == h
    return z, xbc, dt


def _split_xbc(xbc, dims: MambaDims):
    """(..., conv_dim) -> x (..., d_inner), B and C (..., G * N)."""
    di, gn = dims.d_inner, dims.n_groups * dims.d_state
    return xbc[..., :di], xbc[..., di:di + gn], xbc[..., di + gn:]


def _causal_conv(xbc, w, b, *, conv_state=None):
    """Depthwise causal conv along time.  xbc: (B, S, C); w: (K, C).  With
    ``conv_state`` (B, K-1, C) it is prepended (chunked prefill).  The taps
    are summed one by one in xbc's dtype, as the reference writes it.
    Returns (silu(out), new_conv_state)."""
    k = w.shape[0]
    if conv_state is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = conv_state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i][None, None, :] for i in range(k))
    out = out + b
    new_state = xp[:, -(k - 1):, :] if k > 1 else pad[:, :0]
    return silu(out), new_state


def mamba_forward(p, x, dims: MambaDims, *, ssm_state=None, conv_state=None,
                  return_state=False, norm_eps=1e-6):
    """Full-sequence forward.  x: (B, S, d_model)."""
    b, s, _ = x.shape
    zxbcdt = torch.matmul(x, p["in_proj"])
    z, xbc, dt = _split_proj(zxbcdt, dims)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"],
                                 conv_state=conv_state)
    xi, bmat, cmat = _split_xbc(xbc, dims)
    xh = xi.reshape(b, s, dims.n_heads, dims.head_dim).contiguous()
    bm = bmat.reshape(b, s, dims.n_groups, dims.d_state).contiguous()
    cm = cmat.reshape(b, s, dims.n_groups, dims.d_state).contiguous()
    dt_act = softplus(dt.float() + p["dt_bias"])
    y, h_final = ops.ssd_scan(xh, dt_act, p["a_log"], bm, cm,
                              d_skip=p["d_skip"], h0=ssm_state)
    y = y.reshape(b, s, dims.d_inner)
    y = rmsnorm(p["norm_w"], y * silu(z), norm_eps)
    out = torch.matmul(y, p["out_proj"])
    if return_state:
        return out, (new_conv, h_final)
    return out


def mamba_decode(p, x, conv_state, ssm_state, dims: MambaDims,
                 norm_eps=1e-6):
    """One-token step.  x: (B, 1, d_model); conv_state: (B, K-1, conv_dim);
    ssm_state: (B, H, P, N).  The taps are one contraction here, as the
    reference writes it.  Returns (out, conv_state, ssm_state), new
    tensors."""
    b = x.shape[0]
    zxbcdt = torch.matmul(x, p["in_proj"])
    z, xbc, dt = _split_proj(zxbcdt, dims)
    xp = torch.cat([conv_state.to(xbc.dtype), xbc], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", xp, p["conv_w"]) + p["conv_b"]
    conv_out = silu(conv_out)[:, None, :]
    new_conv = xp[:, 1:, :]
    xi, bmat, cmat = _split_xbc(conv_out, dims)
    xh = xi.reshape(b, dims.n_heads, dims.head_dim)
    bm = bmat.reshape(b, dims.n_groups, dims.d_state)
    cm = cmat.reshape(b, dims.n_groups, dims.d_state)
    dt_act = softplus(dt[:, 0].float() + p["dt_bias"])
    y, ssm_state = ops.ssd_step(ssm_state, xh, dt_act, p["a_log"], bm, cm,
                                d_skip=p["d_skip"])
    y = y.reshape(b, 1, dims.d_inner)
    y = rmsnorm(p["norm_w"], y * silu(z), norm_eps)
    out = torch.matmul(y, p["out_proj"])
    return out, new_conv, ssm_state
