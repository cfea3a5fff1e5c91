"""Decoder-only transformer, dense family: templates and the dense and
paged serving paths.  The port's counterpart of
``repro/models/transformer.py``.

A Python loop over the layers takes the place of ``lax.scan``.  The dense
cache is a dict ``{"k"/"v": (L, B, Hkv, W, hd), "pos": 0-d or (B,) int32}``
and the paged cache ``{"kp"/"vp": (L, N, Hkv, bs, hd), "bt": (B, M) int32,
"pos": (B,) int32}``; their tensors are updated in place, and the functions
return the dict anyway, as the reference returns its (donated) successor.
"""
from __future__ import annotations

import torch

from .attention import (attn_decode, attn_decode_paged, attn_prefill,
                        attn_prefill_paged, attn_templates)
from .layers import (PT, embed_lookup, embed_templates, rmsnorm,
                     rope_cos_sin, stack_layers, swiglu_apply,
                     swiglu_templates, tree_index)

# ---------------------------------------------------------------------------
# Templates.
# ---------------------------------------------------------------------------


def layer_templates(cfg) -> dict:
    return {
        "ln1": PT((cfg.d_model,), "zeros"),
        "attn": attn_templates(cfg),
        "ln2": PT((cfg.d_model,), "zeros"),
        "mlp": swiglu_templates(cfg.d_model, cfg.d_ff),
    }


def decoder_templates(cfg) -> dict:
    t = {
        "embed": embed_templates(cfg.padded_vocab, cfg.d_model),
        "layers": stack_layers(layer_templates(cfg), cfg.n_layers),
        "final_norm": PT((cfg.d_model,), "zeros"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = PT((cfg.d_model, cfg.padded_vocab), "scaled")
    return t


def layer_params(params, i: int) -> dict:
    """Layer ``i``'s slice of the stacked layer tree (views, no copies)."""
    return tree_index(params["layers"], i)


def lm_head_weight(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"]["embedding"].T
    return params["lm_head"]


def _lm_logits(params, x_last, cfg):
    """(B, D) final-norm'd last-token hiddens -> (B, V) fp32 serving logits.
    Both operands go to fp32 as in the reference; at full width the tied
    embedding's cast is a (V, D) fp32 transient on every call."""
    logits = torch.matmul(x_last.float(),
                          lm_head_weight(params, cfg).float())
    logits = logits[:, :cfg.vocab_size]
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _rope(positions, cfg):
    """RoPE tables at ``positions`` for every layer of one call (None when
    the config has no RoPE)."""
    if not cfg.rope_theta:
        return None
    return rope_cos_sin(positions, cfg.head_dim_resolved, cfg.rope_theta)


def _block(lp, x, cfg, attn):
    """One layer: pre-norm attention (``attn(lp_attn, h)``) and SwiGLU."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + attn(lp["attn"], h)
    h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + swiglu_apply(lp["mlp"], h)


# ---------------------------------------------------------------------------
# Dense KV cache (one (Hkv, W, hd) strip per slot and layer).
# ---------------------------------------------------------------------------

def decoder_prefill(params, batch, cfg, *, cache_len=None):
    """Prefill a batch of prompts.  Returns (last-token logits (B, V),
    cache {"k"/"v": (L, B, Hkv, cache_len, hd), "pos"}).

    ``batch["tokens"]``: (B, S).  ``batch["prefill_len"]`` (optional, (B,)
    int32): each row's true token count when ``tokens`` is right-padded to a
    bucket length.  Causality hides the pads from real tokens and their KV
    lands at positions >= the true length (masked in decode, overwritten as
    decode proceeds), so only the last-token gather and the position depend
    on it: ``pos`` becomes that (B,) vector.  Without it ``pos`` is the
    0-d S (every row at one position: lockstep's left-padded batch)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache_len = cache_len or s
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s}")
    dev = tokens.device
    x = embed_lookup(params["embed"], tokens)                  # (B, S, D)
    shape = (cfg.n_layers, b, cfg.n_kv_heads, cache_len,
             cfg.head_dim_resolved)
    k_all = torch.empty(shape, dtype=x.dtype, device=dev)
    v_all = torch.empty(shape, dtype=x.dtype, device=dev)
    rope = _rope(torch.arange(s, device=dev), cfg)

    def attn(i):
        def run(p, h):
            out, (kc, vc) = attn_prefill(p, h, cfg, rope, cache_len=cache_len)
            k_all[i], v_all[i] = kc, vc
            return out
        return run

    for i in range(cfg.n_layers):
        x = _block(layer_params(params, i), x, cfg, attn(i))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if "prefill_len" in batch:
        pos = batch["prefill_len"].to(device=dev, dtype=torch.int32)
        x_last = x[torch.arange(b, device=dev), pos.long() - 1]
    else:
        pos = torch.tensor(s, dtype=torch.int32, device=dev)
        x_last = x[:, -1]
    return _lm_logits(params, x_last, cfg), {"k": k_all, "v": v_all,
                                             "pos": pos}


def decoder_decode_step(params, cache, tokens, cfg):
    """tokens: (B, 1) against the dense cache.  Returns (logits (B, V),
    cache), the cache updated in place.

    ``cache["pos"]`` is 0-d (every row decodes at one position: lockstep)
    or (B,) (each slot at its own position: the continuous slot pool).
    Every row decodes and every row's position advances, idle slots
    included, as in the reference (``transformer.py:264-276``); an idle
    row whose position has passed the cache writes nothing
    (``attention.attn_decode``)."""
    pos = cache["pos"]
    b = tokens.shape[0]
    x = embed_lookup(params["embed"], tokens)                  # (B, 1, D)
    rope = _rope((pos.expand(b) if pos.dim() == 0 else pos)[:, None], cfg)
    for i in range(cfg.n_layers):
        kc, vc = cache["k"][i], cache["v"][i]
        x = _block(layer_params(params, i), x, cfg,
                   lambda p, h: attn_decode(p, h, kc, vc, pos, rope,
                                            cfg)[0])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_logits(params, x[:, -1], cfg)
    cache["pos"] = pos + 1
    return logits, cache


def decoder_cache_expand(sub, batch: int):
    """An empty ``batch``-slot decode cache shaped like the batch-1 prefill
    cache ``sub``: zero strips, per-slot positions at 0, to be filled by
    :func:`decoder_cache_slot_write` on admission."""
    def grow(x):
        return torch.zeros(x.shape[:1] + (batch,) + x.shape[2:],
                           dtype=x.dtype, device=x.device)
    return {"k": grow(sub["k"]), "v": grow(sub["v"]),
            "pos": torch.zeros((batch,), dtype=torch.int32,
                               device=sub["k"].device)}


def decoder_cache_slot_write(cache, sub, slot: int):
    """Write the batch-1 prefill cache ``sub`` into slot ``slot`` of a
    slot-pool decode cache, in place (prefill-on-admit)."""
    cache["k"][:, slot] = sub["k"][:, 0]
    cache["v"][:, slot] = sub["v"][:, 0]
    cache["pos"][slot] = sub["pos"].reshape(())
    return cache


# ---------------------------------------------------------------------------
# Paged KV cache (block-pool serving layout; see repro_torch.serving.kvcache).
# ---------------------------------------------------------------------------

def decoder_paged_cache_init(cfg, *, batch: int, n_blocks: int,
                             block_size: int, max_blocks: int,
                             dtype=torch.bfloat16, device):
    """Empty paged cache: one KV block pool shared by all ``batch`` slots,
    per-slot block tables on the null block, positions at 0.  The pools
    start as zeros, never ``torch.empty``: the kernels never read a
    position past a row's limit, but the plain path multiplies masked
    positions by zero, and stale garbage there could be NaN."""
    hd = cfg.head_dim_resolved
    pool = (cfg.n_layers, n_blocks, cfg.n_kv_heads, block_size, hd)
    return {"kp": torch.zeros(pool, dtype=dtype, device=device),
            "vp": torch.zeros(pool, dtype=dtype, device=device),
            "bt": torch.zeros((batch, max_blocks), dtype=torch.int32,
                              device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def decoder_cache_dtype(params):
    """KV dtype a prefill produces (the embedding's dtype)."""
    return params["embed"]["embedding"].dtype


def decoder_prefill_paged(params, pcache, batch, slot: int, chunk: int,
                          prefill_len: int, cfg):
    """One ``block_size`` chunk of a paged prefill for a single request.

    ``batch["tokens"]``: (1, bs) token ids of combined positions
    ``[chunk * bs, (chunk + 1) * bs)`` (0 past the prompt).  Each layer
    writes the chunk's K/V into pool block ``pcache["bt"][slot, chunk]``
    (installed by the engine before the call) and attends causally over
    blocks ``0..chunk``.  Returns (logits (1, V) of the last *true* row of
    the chunk — the next-token distribution on the final chunk only —,
    pcache), with ``pcache["pos"][slot]`` advanced to
    ``min((chunk + 1) * bs, prefill_len)``."""
    bs = pcache["kp"].shape[3]
    q_start = chunk * bs
    dev = pcache["kp"].device
    x = embed_lookup(params["embed"], batch["tokens"])         # (1, bs, D)
    bt_row = pcache["bt"][slot]                                # (M,)
    qs = torch.full((1,), q_start, dtype=torch.int32, device=dev)
    rope = _rope(torch.arange(q_start, q_start + bs, device=dev), cfg)
    for i in range(cfg.n_layers):
        kp, vp = pcache["kp"][i], pcache["vp"][i]
        x = _block(layer_params(params, i), x, cfg,
                   lambda p, h: attn_prefill_paged(p, h, cfg, kp, vp, bt_row,
                                                   chunk, qs, rope))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    last = min(max(prefill_len - 1 - q_start, 0), bs - 1)
    pcache["pos"][slot] = min(q_start + bs, prefill_len)
    return _lm_logits(params, x[0, last:last + 1], cfg), pcache


def decoder_decode_step_paged(params, pcache, tokens, cfg):
    """tokens: (B, 1) against the paged cache.  Every row decodes, idle
    rows included (their tables point at the null block), and every row's
    ``pos`` advances, as in the reference (``transformer.py:434``); only
    ``slot_release`` resets it.  A row whose position has run past the
    table (``pos // bs >= M``, an idle slot left for ``M * bs`` steps)
    writes nothing and attends over its whole table, as the reference's
    dropped scatter and capped walk do.  Returns (logits (B, V), pcache)."""
    pos, bt = pcache["pos"], pcache["bt"]
    bs, m = pcache["kp"].shape[3], bt.shape[1]
    inside = pos // bs < m
    # one host read per step; the common case (no overrun) writes all rows
    write_rows = None if bool(inside.all()) else inside.nonzero()[:, 0]
    x = embed_lookup(params["embed"], tokens)                  # (B, 1, D)
    rope = _rope(pos[:, None], cfg)
    for i in range(cfg.n_layers):
        kp, vp = pcache["kp"][i], pcache["vp"][i]
        x = _block(layer_params(params, i), x, cfg,
                   lambda p, h: attn_decode_paged(p, h, kp, vp, bt, pos,
                                                  rope, cfg,
                                                  write_rows=write_rows))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_logits(params, x[:, -1], cfg)
    pcache["pos"] += 1
    return logits, pcache
