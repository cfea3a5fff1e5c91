"""GQA attention layer (qk-norm, qkv-bias) over the paged KV pool.

The port's counterpart of the paged paths of ``repro/models/attention.py``.
Pools are updated in place (the reference returns updated copies that XLA
aliases through donation); every write lands on the pool's own stream
before the attention kernel that reads it.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .layers import PT, apply_rope_cs, rmsnorm


def attn_templates(cfg) -> dict:
    d = cfg.d_model
    hd = cfg.head_dim_resolved
    t = {
        "wq": PT((d, cfg.n_heads * hd), "scaled"),
        "wk": PT((d, cfg.n_kv_heads * hd), "scaled"),
        "wv": PT((d, cfg.n_kv_heads * hd), "scaled"),
        "wo": PT((cfg.n_heads * hd, d), "scaled"),
    }
    if cfg.qkv_bias:
        t["bq"] = PT((cfg.n_heads * hd,), "zeros")
        t["bk"] = PT((cfg.n_kv_heads * hd,), "zeros")
        t["bv"] = PT((cfg.n_kv_heads * hd,), "zeros")
    if cfg.qk_norm:
        t["q_norm"] = PT((hd,), "zeros")
        t["k_norm"] = PT((hd,), "zeros")
    return t


def _project_qkv(p, x, cfg):
    """x: (B, S, D) -> q (B, Hq, S, hd), k/v (B, Hkv, S, hd); qk-norm after
    the head reshape and before RoPE (the caller applies RoPE)."""
    b, s, _ = x.shape
    hd = cfg.head_dim_resolved
    q = torch.matmul(x, p["wq"])
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    k = k.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def _out_proj(p, out):
    b, _, s, _ = out.shape
    return torch.matmul(out.transpose(1, 2).reshape(b, s, -1), p["wo"])


def attn_decode_paged(p, x, k_pool, v_pool, block_table, kv_len, rope, cfg,
                      *, write_rows=None):
    """One-token decode against one layer's paged pool, in place.

    x: (B, 1, D); k_pool/v_pool: (N, Hkv, bs, hd); block_table: (B, M)
    int32; kv_len: (B,) int32 current lengths (the new token's position);
    rope: (cos, sin) at those positions.  The new K/V lands in pool block
    ``block_table[b, kv_len // bs]`` at offset ``kv_len % bs``.
    ``write_rows`` (a (R,) index tensor, or None for every row) restricts
    the write to rows whose block column is inside the table: an idle slot
    whose position ran past ``M * bs`` writes nothing, as the reference's
    out-of-range scatter drops it (``attention.py:198-204``).
    Returns the attention output (B, 1, D)."""
    bs = k_pool.shape[2]
    q, k, v = _project_qkv(p, x, cfg)
    if rope is not None:
        q, k = apply_rope_cs(q, *rope), apply_rope_cs(k, *rope)
    col = (kv_len // bs).long()
    off = (kv_len % bs).long()
    bt = block_table
    k_new, v_new = k[:, :, 0], v[:, :, 0]                 # (B, Hkv, hd)
    if write_rows is not None:
        col, off, bt = col[write_rows], off[write_rows], bt[write_rows]
        k_new, v_new = k_new[write_rows], v_new[write_rows]
    blk = bt.gather(1, col[:, None])[:, 0].long()
    # rows own distinct blocks, so writes never collide (idle rows all hit
    # the null block: last write wins, and nothing reads it)
    k_pool[blk, :, off] = k_new
    v_pool[blk, :, off] = v_new
    out = ops.paged_decode_attention(q.contiguous(), k_pool, v_pool,
                                     block_table, kv_len + 1)
    return _out_proj(p, out)


def attn_prefill_paged(p, x, cfg, k_pool, v_pool, bt_row, chunk, q_start,
                       rope):
    """One ``block_size`` chunk of a paged prefill, in place.

    x: (1, bs, D), the chunk's hidden states at absolute positions
    ``[chunk * bs, (chunk + 1) * bs)``; k_pool/v_pool: (N, Hkv, bs, hd);
    bt_row: (M,) int32 table of the request; ``q_start``: (1,) int32
    tensor holding ``chunk * bs``; rope: (cos, sin) at the chunk's
    positions.  The chunk's K/V (pad rows past the prompt included) are
    written into pool block ``bt_row[chunk]`` first, then the chunk's
    queries attend causally over blocks ``0..chunk`` through the table —
    on the same stream, so the kernel reads what was just written.
    Returns the attention output (1, bs, D)."""
    b, s, _ = x.shape
    bs = k_pool.shape[2]
    if b != 1 or s != bs:
        raise ValueError(f"paged prefill runs one request in block_size "
                         f"chunks: got batch {b}, chunk {s} vs block_size "
                         f"{bs}")
    q, k, v = _project_qkv(p, x, cfg)
    if rope is not None:
        q, k = apply_rope_cs(q, *rope), apply_rope_cs(k, *rope)
    blk = bt_row[chunk:chunk + 1].long()
    k_pool.index_copy_(0, blk, k)
    v_pool.index_copy_(0, blk, v)
    out = ops.paged_prefill_attention(q.contiguous(), k_pool, v_pool,
                                      bt_row[None], q_start)
    return _out_proj(p, out)
