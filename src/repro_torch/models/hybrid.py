"""zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block
(a single parameter set) applied after every ``shared_attn_every`` Mamba2
layers.  The port's counterpart of ``repro/models/hybrid.py``: the training
loss and the serving paths.

Python loops over the layer indices take the place of the reference's
nested ``lax.scan`` over groups: layer ``i`` is followed by the shared block
when ``(i + 1) % k == 0``, so the ``n_layers % k`` tail layers run without
one.  The shared block's full-sequence attention (the loss and the
prefill) goes through the flash kernel at ``window=cfg.local_window``; its
decode cache is a ring of ``W = min(cache_len, local_window)`` slots,
written at ``pos % W``, so the state per request stays bounded.  Every
Mamba2 layer's scan goes through ``ops.ssd_scan``: the SSD kernel, under
autograd ``SSDScan``.

Every cache leaf keeps its batch (serving slot) axis at 1: the Mamba2 conv
tails and SSD states ``(n_layers, B, ...)``, the shared block's ring KV
``(n_groups, B, Hkv, W, hd)``, plus ``pos`` (0-d after a prefill, (B,) in
the slot pool).  Decode updates them in place.
"""
from __future__ import annotations

import torch

from torch.utils.checkpoint import checkpoint

from .attention import attn_decode, attn_forward, attn_prefill, attn_templates
from .layers import (PT, embed_lookup, embed_templates, rmsnorm,
                     softmax_xent_chunked, stack_layers, swiglu_templates,
                     tree_index, tree_unbind)
from .mamba2 import mamba_decode, mamba_dims, mamba_forward, mamba_templates
from .slot_state import make_slot_hooks
from .transformer import _block, _lm_logits, _rope


def hybrid_templates(cfg) -> dict:
    dims = mamba_dims(cfg)
    return {
        "embed": embed_templates(cfg.padded_vocab, cfg.d_model),
        "mamba": stack_layers({"norm": PT((cfg.d_model,), "zeros"),
                               "block": mamba_templates(dims)},
                              cfg.n_layers),
        "shared_attn": {
            "ln1": PT((cfg.d_model,), "zeros"),
            "attn": attn_templates(cfg),
            "ln2": PT((cfg.d_model,), "zeros"),
            "mlp": swiglu_templates(cfg.d_model, cfg.d_ff),
        },
        "final_norm": PT((cfg.d_model,), "zeros"),
        "lm_head": PT((cfg.d_model, cfg.padded_vocab), "scaled"),
    }


def _split_groups(cfg):
    """(k, number of full groups, tail layers without a shared block)."""
    k = cfg.shared_attn_every
    n_groups = cfg.n_layers // k
    return k, n_groups, cfg.n_layers - n_groups * k


# ---------------------------------------------------------------------------
# Training forward + loss.
# ---------------------------------------------------------------------------

def _mamba_layer(lp, x, cfg, dims):
    """The pre-norm Mamba2 residual (no state)."""
    h = rmsnorm(lp["norm"], x, cfg.norm_eps)
    return x + mamba_forward(lp["block"], h, dims, norm_eps=cfg.norm_eps)


def _shared_attn_block(sp, x, cfg):
    """The shared block: full-sequence causal attention at
    ``window=cfg.local_window`` (the flash kernel, under autograd), then
    SwiGLU."""
    return _block(sp, x, cfg, lambda p, h: attn_forward(
        p, h, cfg, window=cfg.local_window))


def hybrid_backbone(params, x, cfg, *, remat=True):
    """x (B, S, D) through the Mamba2 layers and the shared block after
    every ``k``-th; the counterpart of the reference's ``hybrid_backbone``.
    The stacked ``mamba`` leaves are taken apart once a call
    (``tree_unbind``); with ``remat`` each Mamba2 layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), the
    shared block does not."""
    dims = mamba_dims(cfg)
    k, _, _ = _split_groups(cfg)
    sp = params["shared_attn"]
    for i, lp in enumerate(tree_unbind(params["mamba"], cfg.n_layers)):
        if remat:
            x = checkpoint(_mamba_layer, lp, x, cfg, dims, use_reentrant=False)
        else:
            x = _mamba_layer(lp, x, cfg, dims)
        if (i + 1) % k == 0:
            x = _shared_attn_block(sp, x, cfg)
    return x


def hybrid_loss(params, batch, cfg, *, remat=True, xent_chunk=512):
    """(mean loss, {"loss", "accuracy"}) of next-token prediction over
    ``batch["labels"]`` (and ``batch["label_mask"]``, optional): the final
    RMSNorm and the chunked cross-entropy against the untied ``lm_head``.
    S must be at most 64 or a multiple of 64 (the SSD scan's chunk rule:
    the scan raises ``ValueError`` otherwise)."""
    x = embed_lookup(params["embed"], batch["tokens"])
    x = hybrid_backbone(params, x, cfg, remat=remat)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    loss, acc = softmax_xent_chunked(
        x, params["lm_head"], batch["labels"], chunk=xent_chunk,
        label_mask=batch.get("label_mask"), valid_vocab=cfg.vocab_size)
    return loss, {"loss": loss, "accuracy": acc}


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------

# batch axis of every cache leaf (the serving slot axis)
HYBRID_STATE_AXES = {"conv": 1, "ssm": 1, "attn_k": 1, "attn_v": 1}

hybrid_cache_expand, hybrid_cache_slot_write, hybrid_cache_slot_reset = \
    make_slot_hooks(HYBRID_STATE_AXES)


def hybrid_prefill(params, batch, cfg, *, cache_len=None):
    """Prefill a batch of prompts (B, S): S at most 64 or a multiple of 64
    (the SSD scan's chunk contract, as in the reference).  Returns
    (last-token logits (B, V) fp32, cache) with ``pos`` the 0-d S.

    B > 1 prefills row by row.  On the card a GEMM's reduction order
    follows its shape (cuBLAS splits K for few rows), so a batched prefill
    rounds other than the batch-1 prefill of continuous batching, and the
    recurrent state carries the difference into other tokens; row by row,
    lockstep serves the tokens continuous batching serves, as the
    reference asserts for scan families."""
    tokens = batch["tokens"]
    if tokens.shape[0] > 1:
        rows = [hybrid_prefill(params, {"tokens": tokens[i:i + 1]}, cfg,
                               cache_len=cache_len)
                for i in range(tokens.shape[0])]
        cache = {k: torch.cat([c[k] for _, c in rows], dim=ax)
                 for k, ax in HYBRID_STATE_AXES.items()}
        cache["pos"] = rows[0][1]["pos"]
        return torch.cat([lg for lg, _ in rows]), cache
    dims = mamba_dims(cfg)
    k, n_groups, _ = _split_groups(cfg)
    b, s = tokens.shape
    cache_len = cache_len or s
    w = min(cache_len, cfg.local_window or cache_len)
    dev = tokens.device
    x = embed_lookup(params["embed"], tokens)                  # (B, S, D)
    rope = _rope(torch.arange(s, device=dev), cfg)
    hd = cfg.head_dim_resolved
    conv = torch.empty((cfg.n_layers, b, dims.d_conv - 1, dims.conv_dim),
                       dtype=x.dtype, device=dev)
    ssm = torch.empty((cfg.n_layers, b, dims.n_heads, dims.head_dim,
                       dims.d_state), dtype=torch.float32, device=dev)
    kv_shape = (n_groups, b, cfg.n_kv_heads, w, hd)
    attn_k = torch.empty(kv_shape, dtype=x.dtype, device=dev)
    attn_v = torch.empty(kv_shape, dtype=x.dtype, device=dev)
    sp = params["shared_attn"]

    def attn(gi):
        def run(p, h):
            out, (kc, vc) = attn_prefill(p, h, cfg, rope, cache_len=w,
                                         window=cfg.local_window)
            attn_k[gi], attn_v[gi] = kc, vc
            return out
        return run

    for i in range(cfg.n_layers):
        lp = tree_index(params["mamba"], i)
        h = rmsnorm(lp["norm"], x, cfg.norm_eps)
        out, (conv[i], ssm[i]) = mamba_forward(lp["block"], h, dims,
                                               return_state=True,
                                               norm_eps=cfg.norm_eps)
        x = x + out
        if (i + 1) % k == 0:                # the end of group (i + 1) // k
            x = _block(sp, x, cfg, attn((i + 1) // k - 1))
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache = {"conv": conv, "ssm": ssm, "attn_k": attn_k, "attn_v": attn_v,
             "pos": torch.tensor(s, dtype=torch.int32, device=dev)}
    return _lm_logits(params, x[:, -1], cfg), cache


def hybrid_decode_step(params, cache, tokens, cfg):
    """tokens: (B, 1) against the hybrid cache, updated in place.  ``pos``
    is 0-d (lockstep) or (B,) (the slot pool); every row decodes and
    advances, idle slots included: their ring writes land at ``pos % W``
    and their state rows touch no other row.  Returns (logits (B, V),
    cache)."""
    dims = mamba_dims(cfg)
    k, _, _ = _split_groups(cfg)
    pos = cache["pos"]
    b = tokens.shape[0]
    x = embed_lookup(params["embed"], tokens)                  # (B, 1, D)
    rope = _rope((pos.expand(b) if pos.dim() == 0 else pos)[:, None], cfg)
    sp = params["shared_attn"]
    for i in range(cfg.n_layers):
        lp = tree_index(params["mamba"], i)
        h = rmsnorm(lp["norm"], x, cfg.norm_eps)
        out, cache["conv"][i], cache["ssm"][i] = mamba_decode(
            lp["block"], h, cache["conv"][i], cache["ssm"][i], dims,
            norm_eps=cfg.norm_eps)
        x = x + out
        if (i + 1) % k == 0:
            kc = cache["attn_k"][(i + 1) // k - 1]
            vc = cache["attn_v"][(i + 1) // k - 1]
            x = _block(sp, x, cfg,
                       lambda p, hh: attn_decode(p, hh, kc, vc, pos, rope,
                                                 cfg, ring=True)[0])
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_logits(params, x[:, -1], cfg)
    cache["pos"] = pos + 1
    return logits, cache
