"""Whisper-style encoder-decoder (the encdec family).  The port's counterpart
of ``repro/models/encdec.py``: the training loss and the serving paths.

The conv/mel frontend is a stub, as in the reference: a request brings
precomputed frame embeddings (B, S_enc, d_model).  Sinusoidal positions on
both sides, GELU MLPs, pre-LN with LayerNorm.  Python loops over the layers
take the place of the reference's ``lax.scan``; the stacked layer leaves
are taken apart once a call (``tree_unbind``).  Every attention, the
encoder's non-causal self-attention, the decoder's causal self-attention and
its cross-attention, goes through ``ops.attention``: the flash kernel, under
autograd ``FlashAttention``.

Decode state per request: the decoder's self-attention KV strip (``k`` /
``v``, written at ``pos``) and the cross-attention strip (``xk`` / ``xv``),
projected once from the request's encoder output at prefill and read-only
after.  Every leaf is stacked (n_layers, B, ...) with its batch (slot) axis
at 1, so the slot hooks of ``models.slot_state`` admit, evict and zero one
request at a time; the cross strip rides in the slot as the self strip
does.  Its width is the frames' length (whisper's 30 s window is
``CROSS_LEN`` frames).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .attention import (attn_cross_decode, attn_decode, attn_forward,
                        attn_prefill, attn_templates, project_kv)
from .layers import (PT, embed_lookup, embed_templates, gelu_mlp_apply,
                     gelu_mlp_templates, layernorm, sinusoid_div,
                     sinusoidal_positions, softmax_xent_chunked,
                     stack_layers, tree_index, tree_unbind)
from .slot_state import make_slot_hooks
from .transformer import _lm_logits

CROSS_LEN = 1500  # whisper's 30 s encoder output length


def _ln_t(d: int) -> dict:
    return {"w": PT((d,), "ones"), "b": PT((d,), "zeros")}


def _ln(p, x, eps):
    return layernorm(p["w"], p["b"], x, eps)


def encdec_templates(cfg) -> dict:
    d = cfg.d_model
    return {
        "embed": embed_templates(cfg.padded_vocab, d),
        "enc_layers": stack_layers({
            "ln1": _ln_t(d), "attn": attn_templates(cfg),
            "ln2": _ln_t(d), "mlp": gelu_mlp_templates(d, cfg.d_ff),
        }, cfg.n_enc_layers),
        "enc_final": _ln_t(d),
        "dec_layers": stack_layers({
            "ln1": _ln_t(d), "self_attn": attn_templates(cfg),
            "lnx": _ln_t(d), "cross_attn": attn_templates(cfg),
            "ln2": _ln_t(d), "mlp": gelu_mlp_templates(d, cfg.d_ff),
        }, cfg.n_layers),
        "dec_final": _ln_t(d),
        "lm_head": PT((d, cfg.padded_vocab), "scaled"),
    }


def _add_positions(x):
    """x (B, S, D) plus the (S, D) sinusoid table in x's dtype."""
    s, d = x.shape[1], x.shape[2]
    return x + sinusoidal_positions(s, d, x.device).to(x.dtype)


def encode(params, frames, cfg):
    """frames (B, S_enc, D) -> the encoder output (B, S_enc, D): every
    layer's attention non-causal through the flash kernel."""
    x = _add_positions(frames)
    for lp in tree_unbind(params["enc_layers"], cfg.n_enc_layers):
        h = _ln(lp["ln1"], x, cfg.norm_eps)
        x = x + attn_forward(lp["attn"], h, cfg, causal=False)
        h = _ln(lp["ln2"], x, cfg.norm_eps)
        x = x + gelu_mlp_apply(lp["mlp"], h)
    return _ln(params["enc_final"], x, cfg.norm_eps)


def _decoder_layer(lp, x, enc_out, cfg):
    """One decoder layer: causal self-attention, cross-attention over
    ``project_kv(enc_out)`` and the GELU MLP, each pre-LN."""
    h = _ln(lp["ln1"], x, cfg.norm_eps)
    x = x + attn_forward(lp["self_attn"], h, cfg, causal=True)
    h = _ln(lp["lnx"], x, cfg.norm_eps)
    ckv = project_kv(lp["cross_attn"], enc_out, cfg, rope=False)
    x = x + attn_forward(lp["cross_attn"], h, cfg, cross_kv=ckv)
    h = _ln(lp["ln2"], x, cfg.norm_eps)
    return x + gelu_mlp_apply(lp["mlp"], h)


def _decoder(params, tokens, enc_out, cfg, *, remat=False):
    """The full-sequence decoder over ``tokens`` (B, S) against
    ``enc_out``; with ``remat`` each layer runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``).
    Returns the final-norm'd hiddens (B, S, D)."""
    x = _add_positions(embed_lookup(params["embed"], tokens))
    for lp in tree_unbind(params["dec_layers"], cfg.n_layers):
        if remat:
            x = checkpoint(_decoder_layer, lp, x, enc_out, cfg,
                           use_reentrant=False)
        else:
            x = _decoder_layer(lp, x, enc_out, cfg)
    return _ln(params["dec_final"], x, cfg.norm_eps)


def encdec_loss(params, batch, cfg, *, remat=True, xent_chunk=512):
    """(mean loss, {"loss", "accuracy"}) of next-token prediction over
    ``batch["labels"]`` (and ``batch["label_mask"]``, optional), the
    decoder reading the encoder's output of ``batch["frames"]`` (B, S_enc,
    D), cast to the weights' dtype (the reference's training inputs carry
    frames in the compute dtype).  The encoder is not checkpointed; with
    ``remat`` every decoder layer is."""
    frames = batch["frames"].to(params["embed"]["embedding"].dtype)
    enc_out = encode(params, frames, cfg)
    x = _decoder(params, batch["tokens"], enc_out, cfg, remat=remat)
    loss, acc = softmax_xent_chunked(
        x, params["lm_head"], batch["labels"], chunk=xent_chunk,
        label_mask=batch.get("label_mask"), valid_vocab=cfg.vocab_size)
    return loss, {"loss": loss, "accuracy": acc}


# batch axis of every cache leaf (the serving slot axis); ``pos`` is the
# implicit per-slot position vector
ENCDEC_STATE_AXES = {"k": 1, "v": 1, "xk": 1, "xv": 1}

encdec_cache_expand, encdec_cache_slot_write, encdec_cache_slot_reset = \
    make_slot_hooks(ENCDEC_STATE_AXES)


def encdec_prefill(params, batch, cfg, *, cache_len=None):
    """Encode ``batch["frames"]`` (B, S_enc, D), project every decoder
    layer's cross strip from it, and prefill the decoder's self cache with
    ``batch["tokens"]`` (B, S), zero-padded to ``cache_len`` (S by
    default).  Returns (last-token logits (B, V) fp32, cache) with ``pos``
    the 0-d S.

    B > 1 prefills row by row (frames split with the tokens), as the other
    slot-state families do: on the card a GEMM's reduction order follows
    its shape, so a batched encoder would round other than the batch-1
    prefill of continuous batching; row by row, lockstep serves the tokens
    continuous batching serves."""
    tokens, frames = batch["tokens"], batch["frames"]
    if tokens.shape[0] > 1:
        rows = [encdec_prefill(params, {"tokens": tokens[i:i + 1],
                                        "frames": frames[i:i + 1]}, cfg,
                               cache_len=cache_len)
                for i in range(tokens.shape[0])]
        cache = {k: torch.cat([c[k] for _, c in rows], dim=ax)
                 for k, ax in ENCDEC_STATE_AXES.items()}
        cache["pos"] = rows[0][1]["pos"]
        return torch.cat([lg for lg, _ in rows]), cache
    enc_out = encode(params, frames, cfg)
    s = tokens.shape[1]
    cache_len = cache_len or s
    x = _add_positions(embed_lookup(params["embed"], tokens))
    leaves = {k: [] for k in ENCDEC_STATE_AXES}
    for i in range(cfg.n_layers):
        lp = tree_index(params["dec_layers"], i)
        h = _ln(lp["ln1"], x, cfg.norm_eps)
        a, (k, v) = attn_prefill(lp["self_attn"], h, cfg, None,
                                 cache_len=cache_len)
        x = x + a
        xk, xv = project_kv(lp["cross_attn"], enc_out, cfg, rope=False)
        h = _ln(lp["lnx"], x, cfg.norm_eps)
        x = x + attn_forward(lp["cross_attn"], h, cfg, cross_kv=(xk, xv))
        h = _ln(lp["ln2"], x, cfg.norm_eps)
        x = x + gelu_mlp_apply(lp["mlp"], h)
        for name, t in zip(("k", "v", "xk", "xv"), (k, v, xk, xv)):
            leaves[name].append(t.contiguous())
    x = _ln(params["dec_final"], x, cfg.norm_eps)
    cache = {k: torch.stack(v) for k, v in leaves.items()}
    cache["pos"] = torch.tensor(s, dtype=torch.int32, device=x.device)
    return _lm_logits(params, x[:, -1], cfg), cache


def _decode_positions(pos, d: int):
    """The sinusoid at ``pos`` (0-d or (B,)), recomputed in fp32 as the
    reference's decode step does: (P, D) with P = 1 for a 0-d ``pos``."""
    div = torch.tensor(sinusoid_div(d), dtype=torch.float32,
                       device=pos.device)
    ang = pos.reshape(-1).float()[:, None] * div              # (P, D/2)
    pvec = torch.zeros((ang.shape[0], d), dtype=torch.float32,
                       device=pos.device)
    pvec[:, 0::2] = torch.sin(ang)
    pvec[:, 1::2] = torch.cos(ang)
    return pvec


def encdec_decode_step(params, cache, tokens, cfg):
    """tokens: (B, 1) against the encdec cache, the self strips updated in
    place.  ``cache["pos"]`` is 0-d (lockstep: every row at one position)
    or (B,) (the slot pool: each slot at its own).  Every row decodes and
    advances, idle slots included; a row past its strip writes nothing
    (``attn_decode``).  Returns (logits (B, V), cache)."""
    pos = cache["pos"]
    x = embed_lookup(params["embed"], tokens)                  # (B, 1, D)
    x = x + _decode_positions(pos, cfg.d_model)[:, None, :].to(x.dtype)
    for i in range(cfg.n_layers):
        lp = tree_index(params["dec_layers"], i)
        h = _ln(lp["ln1"], x, cfg.norm_eps)
        a, _, _ = attn_decode(lp["self_attn"], h, cache["k"][i],
                              cache["v"][i], pos, None, cfg)
        x = x + a
        h = _ln(lp["lnx"], x, cfg.norm_eps)
        x = x + attn_cross_decode(lp["cross_attn"], h, cache["xk"][i],
                                  cache["xv"][i], cfg)
        h = _ln(lp["ln2"], x, cfg.norm_eps)
        x = x + gelu_mlp_apply(lp["mlp"], h)
    x = _ln(params["dec_final"], x, cfg.norm_eps)
    logits = _lm_logits(params, x[:, -1], cfg)
    cache["pos"] = pos + 1
    return logits, cache
