"""GQA attention layer (qk-norm, qkv-bias): full-sequence, dense-cache and
paged-pool modes, and the encoder-decoder's cross-attention.

The port's counterpart of ``repro/models/attention.py``.  Caches and pools
are updated in place (the reference returns updated copies that XLA aliases
through donation); every write lands on the cache's own stream before the
attention that reads it.  RoPE arrives as ``rope = (cos, sin)`` tables at
the call's positions (``layers.rope_cos_sin``; None when the config has no
RoPE), computed once per step and shared by every layer.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .layers import PT, apply_rope, apply_rope_cs, rmsnorm


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


def _rope(q, k, rope):
    if rope is None:
        return q, k
    return apply_rope_cs(q, *rope), apply_rope_cs(k, *rope)


def _out_proj(p, out):
    b, _, s, _ = out.shape
    return torch.matmul(out.transpose(1, 2).reshape(b, s, -1), p["wo"])


def project_kv(p, x, cfg, *, positions=None, rope=True):
    """K/V projection only (prefill caches): x (B, S, D) -> k/v
    (B, Hkv, S, hd), k-norm'd and, with ``rope``, rotated at ``positions``
    (``arange(S)`` by default)."""
    b, s, _ = x.shape
    hd = cfg.head_dim_resolved
    k = torch.matmul(x, p["wk"])
    v = torch.matmul(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    v = v.reshape(b, s, cfg.n_kv_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    if rope and cfg.rope_theta:
        pos = positions if positions is not None else torch.arange(
            s, device=x.device)
        k = apply_rope(k, pos, cfg.rope_theta)
    return k, v


def _project_q_only(p, x, cfg):
    """Query projection only (cross-attention): x (B, S, D) -> q
    (B, Hq, S, hd), q-norm'd."""
    b, s, _ = x.shape
    hd = cfg.head_dim_resolved
    q = torch.matmul(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(b, s, cfg.n_heads, hd).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
    return q


def attn_forward(p, x, cfg, *, positions=None, window=None, causal=True,
                 cross_kv=None):
    """Full-sequence attention (training / encoder): x (B, S, D) at
    ``positions`` (``arange(S)`` by default) through the flash kernel.
    ``cross_kv``: an encoder's (k, v), (B, Hkv, S_enc, hd) each; the
    queries attend over all of them, with neither RoPE nor a causal mask
    (cross-attention)."""
    s = x.shape[1]
    if cross_kv is None:
        q, k, v = _project_qkv(p, x, cfg)
    else:
        q, (k, v) = _project_q_only(p, x, cfg), cross_kv
    if cross_kv is None and cfg.rope_theta:
        pos = positions if positions is not None else torch.arange(
            s, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    out = ops.attention(q.contiguous(), k.contiguous(), v.contiguous(),
                        causal=causal and cross_kv is None, window=window)
    return _out_proj(p, out)


def attn_prefill(p, x, cfg, rope, *, cache_len: int, window=None):
    """Prefill: causal attention over the prompt through the flash kernel,
    and the layer's K/V cache laid out for ``cache_len`` positions.

    x: (B, S, D); rope at positions ``arange(S)``.  The cache is zero-padded
    to ``cache_len`` when the prompt is shorter; when it is longer (a ring
    buffer of ``cache_len`` slots) the last ``cache_len`` keys sit at their
    ring slots, token t at slot t % cache_len.  Returns (out (B, S, D),
    (k_cache, v_cache))."""
    s = x.shape[1]
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rope(q, k, rope)
    k, v = k.contiguous(), v.contiguous()
    out = _out_proj(p, ops.attention(q.contiguous(), k, v, causal=True,
                                     window=window))
    pad = cache_len - s
    if pad > 0:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    elif pad < 0:
        shift = s % cache_len
        k = torch.roll(k[:, :, -cache_len:], shift, dims=2)
        v = torch.roll(v[:, :, -cache_len:], shift, dims=2)
    return out, (k, v)


def _project_decode_qkv(p, x, rope, cfg):
    """Single-token q/k/v projection with RoPE at each row's position
    (``rope`` tables of shape (B, 1, 1, hd/2)).  Shared by the dense and
    paged decode paths, so both layouts see identical projections."""
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rope(q, k, rope)
    return q, k, v


def attn_decode(p, x, k_cache, v_cache, kv_len, rope, cfg, *, window=None,
                ring: bool = False):
    """One-token decode against one layer's dense cache, in place.

    x: (B, 1, D); k_cache/v_cache: (B, Hkv, W, hd); ``kv_len`` is the new
    token's position, a 0-d tensor (one position for every row: lockstep)
    or (B,) (per-slot positions: the continuous slot pool).  The new K/V
    goes to slot ``kv_len`` and the row attends over ``kv_len + 1`` keys.
    ``ring=True``: the cache is a ring buffer of its W slots; the new K/V
    goes to slot ``kv_len % W`` and the row attends over
    ``min(kv_len + 1, W)`` keys.

    Writes follow the reference's semantics exactly: a 0-d position past
    the cache is clamped to its last slot (``dynamic_update_slice``); a
    (B,) row whose position is at or past W writes nothing (the one-hot
    blend has no hot entry there) — an idle slot's position keeps
    advancing, and indexing past W would raise.  Returns (out (B, 1, D),
    k_cache, v_cache)."""
    b = x.shape[0]
    w = k_cache.shape[2]
    q, k, v = _project_decode_qkv(p, x, rope, cfg)
    if kv_len.dim() == 0:
        slot = kv_len % w if ring else kv_len.clamp(max=w - 1)
        attend = (kv_len + 1).clamp(max=w) if ring else kv_len + 1
        pos_b = attend.expand(b)
        k_cache.index_copy_(2, slot.reshape(1).long(), k)
        v_cache.index_copy_(2, slot.reshape(1).long(), v)
    else:
        slot = kv_len % w if ring else kv_len
        pos_b = (kv_len + 1).clamp(max=w) if ring else kv_len + 1
        inside = (slot < w)[:, None, None]
        rows = torch.arange(b, device=x.device)
        idx = slot.clamp(max=w - 1).long()
        for cache, new in ((k_cache, k), (v_cache, v)):
            # a row past the cache rewrites its own last slot unchanged
            cache[rows, :, idx] = torch.where(inside, new[:, :, 0],
                                              cache[rows, :, idx])
    out = ops.decode_attention(q, k_cache, v_cache, pos_b,
                               window=None if ring else window)
    return _out_proj(p, out), k_cache, v_cache


def attn_decode_paged(p, x, k_pool, v_pool, block_table, kv_len, rope, cfg,
                      *, window=None, write_rows=None):
    """One-token decode against one layer's paged pool, in place.

    x: (B, 1, D); k_pool/v_pool: (N, Hkv, bs, hd); block_table: (B, M)
    int32; kv_len: (B,) int32 current lengths (the new token's position);
    rope: (cos, sin) at those positions.  The new K/V lands in pool block
    ``block_table[b, kv_len // bs]`` at offset ``kv_len % bs``.
    ``write_rows`` (a (R,) index tensor, or None for every row) restricts
    the write to rows whose block column is inside the table: an idle slot
    whose position ran past ``M * bs`` writes nothing, as the reference's
    out-of-range scatter drops it (``attention.py:198-204``).  ``window``
    (a local layer's sliding window) sends the read to the gather path
    (``ops.paged_decode_attention``).  Returns the attention output
    (B, 1, D)."""
    bs = k_pool.shape[2]
    q, k, v = _project_decode_qkv(p, x, rope, cfg)
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
                                     block_table, kv_len + 1, window=window)
    return _out_proj(p, out)


def attn_prefill_paged(p, x, cfg, k_pool, v_pool, bt_row, chunk, q_start,
                       rope, *, window=None):
    """One ``block_size`` chunk of a paged prefill, in place.

    x: (1, bs, D), the chunk's hidden states at absolute positions
    ``[chunk * bs, (chunk + 1) * bs)``; k_pool/v_pool: (N, Hkv, bs, hd);
    bt_row: (M,) int32 table of the request; ``q_start``: (1,) int32
    tensor holding ``chunk * bs``; rope: (cos, sin) at the chunk's
    positions.  The chunk's K/V (pad rows past the prompt included) are
    written into pool block ``bt_row[chunk]`` first, then the chunk's
    queries attend causally over blocks ``0..chunk`` through the table —
    on the same stream, so the kernel reads what was just written.
    ``window``: a local layer's sliding window (the gather path).
    Returns the attention output (1, bs, D)."""
    b, s, _ = x.shape
    bs = k_pool.shape[2]
    if b != 1 or s != bs:
        raise ValueError(f"paged prefill runs one request in block_size "
                         f"chunks: got batch {b}, chunk {s} vs block_size "
                         f"{bs}")
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rope(q, k, rope)
    blk = bt_row[chunk:chunk + 1].long()
    k_pool.index_copy_(0, blk, k)
    v_pool.index_copy_(0, blk, v)
    out = ops.paged_prefill_attention(q.contiguous(), k_pool, v_pool,
                                      bt_row[None], q_start, window=window)
    return _out_proj(p, out)


def attn_cross_decode(p, x, k_cross, v_cross, cfg):
    """Decode-time cross-attention: x (B, 1, D) against one layer's fixed
    encoder strips k_cross / v_cross (B, Hkv, S_enc, hd), every key of the
    strip valid (``ops.decode_attention`` at ``kv_len = S_enc``).  Returns
    (B, 1, D)."""
    b = x.shape[0]
    q = _project_q_only(p, x, cfg)
    kv_len = torch.full((b,), k_cross.shape[2], dtype=torch.int32,
                        device=x.device)
    return _out_proj(p, ops.decode_attention(q, k_cross, v_cross, kv_len))
