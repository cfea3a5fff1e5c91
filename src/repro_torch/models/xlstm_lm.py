"""xLSTM language model (the ssm family): mLSTM blocks with an sLSTM block
every ``slstm_every``-th layer, in groups of (k - 1) mLSTM blocks and one
sLSTM block.  The port's counterpart of ``repro/models/xlstm_lm.py``: the
training loss and the serving paths.

Python loops over the groups and their layers take the place of the
reference's nested ``lax.scan``.  The loss takes the stacked leaves apart
once a call (the ``mlstm`` leaves on both of their stacked axes) and, with
``remat``, checkpoints every block.  The decode state is O(1) a token and
fully recurrent, kept in a per-slot layout whose batch (slot) axis is 2 for
the mLSTM leaves, stacked (n_groups, m_per, B, ...), and 1 for the sLSTM
leaves, (n_groups, B, ...): one slot's state is one index of each leaf, so
the slot hooks of ``models.slot_state`` admit, evict and zero one request
at a time.  Decode updates the leaves in place.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .layers import (PT, embed_lookup, embed_templates, rmsnorm,
                     softmax_xent_chunked, stack_layers, tree_index,
                     tree_unbind)
from .slot_state import make_slot_hooks
from .transformer import _lm_logits
from .xlstm import (mlstm_block, mlstm_block_decode,
                    mlstm_block_templates, mlstm_block_with_state,
                    slstm_block, slstm_block_decode, slstm_block_templates)


def _groups(cfg):
    """(n_groups, mLSTM blocks a group)."""
    k = cfg.slstm_every
    if cfg.n_layers % k:
        raise ValueError(f"xlstm: n_layers {cfg.n_layers} must be a multiple "
                         f"of slstm_every {k}")
    return cfg.n_layers // k, k - 1


def xlstm_templates(cfg) -> dict:
    n_groups, m_per = _groups(cfg)
    return {
        "embed": embed_templates(cfg.padded_vocab, cfg.d_model),
        "mlstm": stack_layers(
            stack_layers(mlstm_block_templates(cfg.d_model, cfg.n_heads),
                         m_per), n_groups),
        "slstm": stack_layers(
            slstm_block_templates(cfg.d_model, cfg.n_heads), n_groups),
        "final_norm": PT((cfg.d_model,), "zeros"),
        "lm_head": PT((cfg.d_model, cfg.padded_vocab), "scaled"),
    }


# ---------------------------------------------------------------------------
# Training forward + loss.
# ---------------------------------------------------------------------------

def _m_layer(lp, x, cfg):
    return mlstm_block(lp, x, cfg.n_heads, norm_eps=cfg.norm_eps)


def _s_layer(lp, x, cfg):
    return slstm_block(lp, x, cfg.n_heads, norm_eps=cfg.norm_eps)


def xlstm_backbone(params, x, cfg, *, remat=True):
    """x (B, S, D) through every group: ``m_per`` mLSTM blocks, then one
    sLSTM block; the counterpart of the reference's ``xlstm_backbone``.
    With ``remat`` each block runs under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``)."""
    n_groups, m_per = _groups(cfg)

    def run(layer, lp, h):
        if remat:
            return checkpoint(layer, lp, h, cfg, use_reentrant=False)
        return layer(lp, h, cfg)

    groups = zip(tree_unbind(params["mlstm"], n_groups),
                 tree_unbind(params["slstm"], n_groups))
    for mparams, sparams in groups:
        for lp in tree_unbind(mparams, m_per):
            x = run(_m_layer, lp, x)
        x = run(_s_layer, sparams, x)
    return x


def xlstm_loss(params, batch, cfg, *, remat=True, xent_chunk=512):
    """(mean loss, {"loss", "accuracy"}) of next-token prediction over
    ``batch["labels"]`` (and ``batch["label_mask"]``, optional): the final
    RMSNorm and the chunked cross-entropy against the untied ``lm_head``.
    S must be at most 256 or a multiple of 256 (the mLSTM chunk rule: the
    cell raises ``ValueError`` otherwise)."""
    x = embed_lookup(params["embed"], batch["tokens"])
    x = xlstm_backbone(params, x, cfg, remat=remat)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    loss, acc = softmax_xent_chunked(
        x, params["lm_head"], batch["labels"], chunk=xent_chunk,
        label_mask=batch.get("label_mask"), valid_vocab=cfg.vocab_size)
    return loss, {"loss": loss, "accuracy": acc}


# ---------------------------------------------------------------------------
# Serving.
# ---------------------------------------------------------------------------

# batch axis of every cache leaf (the serving slot axis); ``pos`` is the
# implicit per-slot position vector
XLSTM_STATE_AXES = {
    "m_conv": 2, "m_c": 2, "m_n": 2, "m_m": 2,
    "s_conv": 1, "s_c": 1, "s_n": 1, "s_h": 1, "s_m": 1,
}
_M_KEYS = ("m_conv", "m_c", "m_n", "m_m")
_S_KEYS = ("s_conv", "s_c", "s_n", "s_h", "s_m")

xlstm_cache_expand, xlstm_cache_slot_write, xlstm_cache_slot_reset = \
    make_slot_hooks(XLSTM_STATE_AXES)


def xlstm_prefill(params, batch, cfg, *, cache_len=None):
    """Prefill a batch of prompts (B, S): S at most 256 or a multiple of 256
    (the mLSTM chunk rule, as in the reference; ``ValueError`` otherwise).
    Returns (last-token logits (B, V) fp32, cache) with ``pos`` the 0-d S.
    ``cache_len`` is ignored: the state does not grow with the context.

    B > 1 prefills row by row, as the hybrid family does: on the card a
    GEMM's reduction order follows its shape, and the recurrent state would
    carry a batched prefill's other rounding into the tokens; row by row,
    lockstep serves the tokens continuous batching serves."""
    del cache_len
    tokens = batch["tokens"]
    if tokens.shape[0] > 1:
        rows = [xlstm_prefill(params, {"tokens": tokens[i:i + 1]}, cfg)
                for i in range(tokens.shape[0])]
        cache = {k: torch.cat([c[k] for _, c in rows], dim=ax)
                 for k, ax in XLSTM_STATE_AXES.items()}
        cache["pos"] = rows[0][1]["pos"]
        return torch.cat([lg for lg, _ in rows]), cache
    n_groups, m_per = _groups(cfg)
    x = embed_lookup(params["embed"], tokens)                  # (B, S, D)
    b, s, d = x.shape
    di = 2 * d
    mstates = {k: [] for k in _M_KEYS}
    sstates = {k: [] for k in _S_KEYS}
    for gi in range(n_groups):
        group = {k: [] for k in _M_KEYS}
        for j in range(m_per):
            lp = tree_index(tree_index(params["mlstm"], gi), j)
            conv0 = torch.zeros((b, 3, di), dtype=x.dtype, device=x.device)
            x, (conv, (c, n, m)) = mlstm_block_with_state(
                lp, x, cfg.n_heads, conv0, None, norm_eps=cfg.norm_eps)
            for k, v in zip(_M_KEYS, (conv, c, n, m)):
                group[k].append(v)
        for k in _M_KEYS:
            mstates[k].append(torch.stack(group[k]))
        x, (s_conv, (sc, sn, sh, sm)) = slstm_block(
            tree_index(params["slstm"], gi), x, cfg.n_heads,
            norm_eps=cfg.norm_eps, return_state=True)
        for k, v in zip(_S_KEYS, (s_conv, sc, sn, sh, sm)):
            sstates[k].append(v)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache = {k: torch.stack(v) for k, v in {**mstates, **sstates}.items()}
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    return _lm_logits(params, x[:, -1], cfg), cache


def xlstm_decode_step(params, cache, tokens, cfg):
    """tokens: (B, 1) against the xlstm cache, updated in place.  ``pos``
    is 0-d (lockstep) or (B,) (the slot pool) and only advances: the
    recurrence does not read it.  Every row decodes, idle slots included
    (their state rows touch no other row).  Returns (logits (B, V),
    cache)."""
    n_groups, m_per = _groups(cfg)
    x = embed_lookup(params["embed"], tokens)                  # (B, 1, D)
    for gi in range(n_groups):
        for j in range(m_per):
            lp = tree_index(tree_index(params["mlstm"], gi), j)
            x, conv, (c, n, m) = mlstm_block_decode(
                lp, x, cfg.n_heads, cache["m_conv"][gi, j],
                (cache["m_c"][gi, j], cache["m_n"][gi, j],
                 cache["m_m"][gi, j]), norm_eps=cfg.norm_eps)
            for k, v in zip(_M_KEYS, (conv, c, n, m)):
                cache[k][gi, j] = v
        x, conv, state = slstm_block_decode(
            tree_index(params["slstm"], gi), x, cfg.n_heads,
            cache["s_conv"][gi],
            tuple(cache[k][gi] for k in _S_KEYS[1:]), norm_eps=cfg.norm_eps)
        for k, v in zip(_S_KEYS, (conv, *state)):
            cache[k][gi] = v
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = _lm_logits(params, x[:, -1], cfg)
    cache["pos"] = cache["pos"] + 1
    return logits, cache
