"""Decoder-only transformer families (dense, moe, vlm): templates, the
training loss, and the dense and paged serving paths.  The port's
counterpart of ``repro/models/transformer.py``.

moe swaps each layer's SwiGLU for the expert layer (``models.moe``),
routed dropless (``exact=True``) on every serving path as in the
reference, so a token's output does not depend on the batch or chunk it
shares; the training loss routes with the capacity factor
(``exact=False``), as the reference trains.  vlm puts ``n_patches``
projected patch rows (``batch["patches"]``, (B, n_patches,
patch_embed_dim)) ahead of the tokens: the dense prefill and the loss
concatenate them (``embed_input``) and a paged chunk takes a patch row at
every position below ``n_patches`` (``_embed_chunk``); positions, the
cache and ``pos`` count them.

gemma3's 5:1 local:global pattern is a per-layer window
(``layer_window``): a local layer attends over its last ``local_window``
positions, a global layer gets ``window=None`` (the reference's
``_BIG_WINDOW``, a window past any context: the same mask, and the hand
kernels keep their unwindowed fast path).  Every serving body passes the
layer's window to its attention: the dense prefill to the flash kernel,
dense decode to ``ops.decode_attention``, and the paged chunk and decode to
``ops.paged_*_attention``, where a window takes the reference's gather
path.

A Python loop over the layers takes the place of ``lax.scan``.  The dense
cache is a dict ``{"k"/"v": (L, B, Hkv, W, hd), "pos": 0-d or (B,) int32}``
and the paged cache ``{"kp"/"vp": (L, N, Hkv, bs, hd), "bt": (B, M) int32,
"pos": (B,) int32}``; their tensors are updated in place, and the functions
return the dict anyway, as the reference returns its (donated) successor.
"""
from __future__ import annotations

import torch

from torch.utils.checkpoint import checkpoint

from ..kernels import ops
from .attention import (attn_decode, attn_decode_paged, attn_forward,
                        attn_prefill, attn_prefill_paged, attn_templates)
from .layers import (PT, embed_lookup, embed_templates, rmsnorm,
                     rope_cos_sin, softmax_xent_chunked, stack_layers,
                     swiglu_apply, swiglu_templates, tree_index, tree_unbind)
from .moe import moe_apply, moe_templates

# ---------------------------------------------------------------------------
# Templates.
# ---------------------------------------------------------------------------


def layer_templates(cfg) -> dict:
    t = {
        "ln1": PT((cfg.d_model,), "zeros"),
        "attn": attn_templates(cfg),
        "ln2": PT((cfg.d_model,), "zeros"),
    }
    if cfg.family == "moe":
        t["moe"] = moe_templates(cfg.d_model, cfg.d_ff, cfg.n_experts)
    else:
        t["mlp"] = swiglu_templates(cfg.d_model, cfg.d_ff)
    return t


def decoder_templates(cfg) -> dict:
    t = {
        "embed": embed_templates(cfg.padded_vocab, cfg.d_model),
        "layers": stack_layers(layer_templates(cfg), cfg.n_layers),
        "final_norm": PT((cfg.d_model,), "zeros"),
    }
    if not cfg.tie_embeddings:
        t["lm_head"] = PT((cfg.d_model, cfg.padded_vocab), "scaled")
    if cfg.family == "vlm":
        t["patch_proj"] = PT((cfg.patch_embed_dim, cfg.d_model), "scaled")
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
    embedding's cast is a (V, D) fp32 transient on every call.  Fewer rows
    than ``ops.INVARIANT_ROWS`` run padded to it, so a row's logits are
    the same bits at any batch up to it."""
    b = x_last.shape[0]
    logits = torch.matmul(ops.pad_rows(x_last.float()),
                          lm_head_weight(params, cfg).float())[:b]
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


def _ffn(lp, h, cfg, exact: bool):
    """The layer's feed-forward: SwiGLU, or for moe the expert layer,
    routed dropless with ``exact`` (every serving path) or with the
    capacity factor (training)."""
    if cfg.family == "moe":
        return moe_apply(lp["moe"], h, top_k=cfg.top_k,
                         capacity_factor=cfg.capacity_factor, exact=exact)
    return swiglu_apply(lp["mlp"], h)


def _block(lp, x, cfg, attn, exact: bool = True):
    """One layer: pre-norm attention (``attn(lp_attn, h)``) and the
    feed-forward (moe dropless unless ``exact=False``)."""
    h = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    x = x + attn(lp["attn"], h)
    h = rmsnorm(lp["ln2"], x, cfg.norm_eps)
    return x + _ffn(lp, h, cfg, exact)


def n_prefix(cfg) -> int:
    """Model-side positions ahead of a prompt's tokens (the vlm's
    patches)."""
    return cfg.n_patches if cfg.family == "vlm" else 0


def _project_patches(params, patches, dtype):
    """(B, n_patches, patch_embed_dim) -> (B, n_patches, D) in ``dtype``,
    the product in the two operands' promoted dtype as in the reference's
    einsum."""
    proj = params["patch_proj"]
    dt = torch.promote_types(patches.dtype, proj.dtype)
    return torch.matmul(patches.to(dt), proj.to(dt)).to(dtype)


def embed_input(params, batch, cfg):
    """(B, n_prefix + S, D): the token rows, for vlm behind the projected
    patches."""
    tok = embed_lookup(params["embed"], batch["tokens"])
    if not n_prefix(cfg):
        return tok
    patches = _project_patches(params, batch["patches"], tok.dtype)
    return torch.cat([patches, tok], dim=1)


# ---------------------------------------------------------------------------
# Training forward + loss.
# ---------------------------------------------------------------------------

def _train_layer(lp, x, positions, window, cfg):
    """One layer of the training forward: full-sequence causal attention
    (the flash kernel, under autograd) at the layer's window, and the
    feed-forward with moe's capacity routing."""
    def attn(p, h):
        return attn_forward(p, h, cfg, positions=positions, window=window)
    return _block(lp, x, cfg, attn, exact=False)


def decoder_loss(params, batch, cfg, *, remat=True, xent_chunk=512):
    """(mean loss, {"loss", "accuracy"}) of next-token prediction over
    ``batch["labels"]`` (B, S) (and ``batch["label_mask"]``, optional);
    the counterpart of the reference's ``decoder_loss``
    (``repro/models/transformer.py:141-154``).

    The stacked layer leaves are taken apart once a call (one
    ``torch.unbind`` a leaf, so each layer's backward adds its own slice
    of the stack's gradient, not a zero gradient of the whole stack); each
    layer runs at ``cfg.layer_window(i)`` (gemma3's local layers) and,
    with ``remat``, under ``torch.utils.checkpoint``, its activations made
    again in the backward (the reference's ``jax.checkpoint``).  vlm drops
    its ``n_patches`` prefix rows before the loss."""
    x = embed_input(params, batch, cfg)
    s_total = x.shape[1]
    positions = torch.arange(s_total, device=x.device)
    for i, lp in enumerate(tree_unbind(params["layers"], cfg.n_layers)):
        w = cfg.layer_window(i)
        if remat:
            x = checkpoint(_train_layer, lp, x, positions, w, cfg,
                           use_reentrant=False)
        else:
            x = _train_layer(lp, x, positions, w, cfg)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    x = x[:, n_prefix(cfg):]
    loss, acc = softmax_xent_chunked(
        x, lm_head_weight(params, cfg), batch["labels"], chunk=xent_chunk,
        label_mask=batch.get("label_mask"), logit_softcap=cfg.logit_softcap,
        valid_vocab=cfg.vocab_size)
    return loss, {"loss": loss, "accuracy": acc}


# ---------------------------------------------------------------------------
# Dense KV cache (one (Hkv, W, hd) strip per slot and layer).
# ---------------------------------------------------------------------------

def decoder_prefill(params, batch, cfg, *, cache_len=None):
    """Prefill a batch of prompts.  Returns (last-token logits (B, V),
    cache {"k"/"v": (L, B, Hkv, cache_len, hd), "pos"}).

    ``batch["tokens"]``: (B, S); for vlm ``batch["patches"]`` too, whose
    ``n_patches`` rows go ahead of the tokens (S counts them below).
    ``batch["prefill_len"]`` (optional, (B,) int32): each row's true token
    count when ``tokens`` is right-padded to a bucket length.  Causality
    hides the pads from real tokens and their KV lands at positions >= the
    true length (masked in decode, overwritten as decode proceeds), so only
    the last-token gather and the position depend on it: ``pos`` becomes
    the (B,) vector ``n_prefix + prefill_len``.  Without it ``pos`` is the
    0-d S (every row at one position: lockstep's left-padded batch)."""
    tokens = batch["tokens"]
    dev = tokens.device
    x = embed_input(params, batch, cfg)                        # (B, S, D)
    b, s = x.shape[:2]
    cache_len = cache_len or s
    if cache_len < s:
        raise ValueError(f"cache_len {cache_len} < prompt length {s} (vlm "
                         "prompts include the n_patches prefix positions)")
    shape = (cfg.n_layers, b, cfg.n_kv_heads, cache_len,
             cfg.head_dim_resolved)
    k_all = torch.empty(shape, dtype=x.dtype, device=dev)
    v_all = torch.empty(shape, dtype=x.dtype, device=dev)
    rope = _rope(torch.arange(s, device=dev), cfg)

    def attn(i):
        def run(p, h):
            out, (kc, vc) = attn_prefill(p, h, cfg, rope, cache_len=cache_len,
                                         window=cfg.layer_window(i))
            k_all[i], v_all[i] = kc, vc
            return out
        return run

    for i in range(cfg.n_layers):
        x = _block(layer_params(params, i), x, cfg, attn(i))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if "prefill_len" in batch:
        pos = n_prefix(cfg) + batch["prefill_len"].to(device=dev,
                                                      dtype=torch.int32)
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
        w = cfg.layer_window(i)
        x = _block(layer_params(params, i), x, cfg,
                   lambda p, h: attn_decode(p, h, kc, vc, pos, rope, cfg,
                                            window=w)[0])
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


def _embed_chunk(params, batch, q_start: int, bs: int, cfg):
    """Embed combined positions ``[q_start, q_start + bs)`` of a prompt: the
    token rows, and for vlm the projected patch row at every position
    below ``n_patches``.  The whole patch set is projected, as the dense
    prefill projects it, so a patch row has the same bits on both paths;
    a chunk past the prefix skips the projection."""
    tok = embed_lookup(params["embed"], batch["tokens"])       # (1, bs, D)
    if q_start >= n_prefix(cfg):
        return tok
    patches = _project_patches(params, batch["patches"], tok.dtype)
    n = min(bs, n_prefix(cfg) - q_start)
    return torch.cat([patches[:, q_start:q_start + n], tok[:, n:]], dim=1)


def decoder_prefill_paged(params, pcache, batch, slot: int, chunk: int,
                          prefill_len: int, cfg):
    """One ``block_size`` chunk of a paged prefill for a single request.

    ``batch["tokens"]``: (1, bs) token ids of combined positions
    ``[chunk * bs, (chunk + 1) * bs)`` (0 past the prompt, and for vlm at
    the patch positions, which take ``batch["patches"]``'s rows:
    ``_embed_chunk``).  ``prefill_len`` counts the prefix.  Each layer
    writes the chunk's K/V into pool block ``pcache["bt"][slot, chunk]``
    (installed by the engine before the call) and attends causally over
    blocks ``0..chunk``.  Returns (logits (1, V) of the last *true* row of
    the chunk — the next-token distribution on the final chunk only —,
    pcache), with ``pcache["pos"][slot]`` advanced to
    ``min((chunk + 1) * bs, prefill_len)``."""
    bs = pcache["kp"].shape[3]
    q_start = chunk * bs
    dev = pcache["kp"].device
    x = _embed_chunk(params, batch, q_start, bs, cfg)          # (1, bs, D)
    bt_row = pcache["bt"][slot]                                # (M,)
    qs = torch.full((1,), q_start, dtype=torch.int32, device=dev)
    rope = _rope(torch.arange(q_start, q_start + bs, device=dev), cfg)
    for i in range(cfg.n_layers):
        kp, vp = pcache["kp"][i], pcache["vp"][i]
        w = cfg.layer_window(i)
        x = _block(layer_params(params, i), x, cfg,
                   lambda p, h: attn_prefill_paged(p, h, cfg, kp, vp, bt_row,
                                                   chunk, qs, rope,
                                                   window=w))
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
        w = cfg.layer_window(i)
        x = _block(layer_params(params, i), x, cfg,
                   lambda p, h: attn_decode_paged(p, h, kp, vp, bt, pos,
                                                  rope, cfg, window=w,
                                                  write_rows=write_rows))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_logits(params, x[:, -1], cfg)
    pcache["pos"] += 1
    return logits, pcache
