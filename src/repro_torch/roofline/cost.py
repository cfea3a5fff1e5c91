"""Analytic cost of the serving phases: flops and device-memory bytes of one
launch per (phase, shape).  The port's counterpart of
``repro/roofline/hlo_cost.py``, which reads them off a compiled
executable's HLO text; the port runs eager PyTorch and has no HLO, so each
phase is counted from the model config and the engine's shapes.

**Flops are the reference's count**: every matrix product's multiply-adds
times 2, elementwise work ignored, at the extents the reference's XLA path
computes them:

* the weight products of every token the phase feeds (each projection of
  the layer stack), and the LM head (``d_model x padded_vocab``) on each
  decode row but on the last prefill token only;
* decode attention over the whole cache a row holds, masked past its
  length but not skipped: ``cache_len`` keys (dense), the block table's
  ``max_blocks * block_size`` (paged), the ring's ``min(cache_len,
  local_window)`` (hybrid);
* dense prefill attention over the full S x S square (the reference's
  flash path works in chunks of 1024 rows and keys; past one chunk a row
  chunk stops at the key chunk of its diagonal);
* the paged prefill chunk's attention over one block of keys: the
  reference walks the table in a loop whose trip count is traced, which
  the HLO count takes once, so a chunk costs the same at any position;
* moe: the router's ``d_model x n_experts`` on every token, and the
  expert SwiGLU on the reference's padded dropless dispatch: each group of
  T tokens fills ``n_experts x T`` rows (capacity T), so a token costs
  ``3 d_model d_ff`` for every expert, not only its top k;
* vlm: the patch projection (``n_patches x patch_embed_dim x d_model``) on
  every dense prefill and on every paged chunk (the reference projects the
  whole set in each chunk), and the ``n_patches`` prefix in the dense
  prefill's length;
* hybrid: the Mamba2 projections; in decode the depthwise conv's taps and
  the state read-out (contractions in the reference's ``mamba_decode`` and
  ``ssd_step_xla``); in prefill the SSD scan's four chunk products of
  ``ssd_xla`` at chunk 64 (C.B^T, the masked scores into dt x, C into the
  carried state, the state update); and the shared attention block after
  every ``shared_attn_every`` layers;
* ssm (xlstm): every block's projections (the mLSTM up, per-head q / k /
  v, the two gate columns and down; the sLSTM gates, recurrence and out)
  on every token; the sLSTM recurrence ``4 H dh^2`` once a token (the
  reference's token scan, its trip count read off the loop); in prefill
  the mLSTM chunk products of ``_mlstm_chunk`` at chunk ``min(256, S)``
  (scores, scores into V, q into the carried C and n, the C and n
  updates), one chunk's worth for each of the S / chunk chunks; in decode
  the conv taps (a contraction in ``*_block_decode``, elementwise in the
  prefill), and ``mlstm_step``'s read-out of C and n (its k v^T update is
  an outer product, which the HLO count does not take as a product);
* encdec (whisper): a prefill runs the encoder over the request's
  ``enc_len`` frames (its projections and MLP on every frame, attention
  non-causal over the full ``enc_len`` x ``enc_len`` square), projects
  every decoder layer's cross K/V from them, and runs the decoder's
  projections (self q / k / v / o, cross q / o) and GELU MLP on every
  token, its causal self-attention (``flash_pairs``) and its
  cross-attention over ``enc_len`` keys a token; a decode step runs the
  decoder's projections and MLP, self-attention over ``cache_len`` keys
  and cross-attention over ``enc_len`` keys a row;
* gemma3's sliding windows change no flops: the reference masks a window
  with a traced per-layer scalar, so its flash path skips no key chunk for
  it, and its paged gather paths walk the whole table as the kernels'
  count does.

**Bytes are the port's own count** (the HLO count adds every fusion's
operands and results, about 12x the compulsory traffic of a smoke decode
step, and is no target): what the phase must move on any implementation -
every weight read once (an untied embedding table only at the rows the
phase gathers; a tied one is read whole by the LM head), the K/V, ring and
SSM / conv state read and written at the extents the flops count, the
token ids (and a vlm's patch rows) read and the fp32 logits written.
Activations between the layers are left out (a fused implementation keeps
them on chip), and so is the fp32 copy of the LM head weight that
``models.transformer._lm_logits`` makes on every call: at qwen3-0.6b's
width that copy writes and reads 622 MB, so the port's own traffic in a
decode step is about twice this count.  The KV extents are the flops': the
card's kernels stop at each row's length, so for a decode step the count
bounds their reads from above (gemma3's local layers read the same
extents: the dense decode and the paged gather path mask the window but
read the whole cache).  xlstm's state (the conv tails and the fp32 cells)
is read and written once a decode step and written once a prefill.
encdec's frames are read and its cross strips written once a prefill; a
decode step reads the strips whole and no encoder weight.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import torch

from ..configs.base import ModelConfig
from ..models import build_model
from ..models.mamba2 import mamba_dims
from ..models.transformer import n_prefix
from ..models.xlstm import CHUNK as MLSTM_CHUNK

SSD_CHUNK = 64       # the reference's ssd_xla chunk
FLASH_CHUNK = 1024   # the reference's attention_xla row and key chunks
LOGIT_BYTES = 4      # serving logits are fp32
TOKEN_BYTES = 4      # int32 token ids


@dataclasses.dataclass(frozen=True)
class PhaseCost:
    """One launch of a phase: flops (2 x multiply-adds) and bytes moved."""
    flops: float
    mem_bytes: float

    @property
    def ai(self) -> float:
        """Arithmetic intensity (flops per byte)."""
        return self.flops / max(self.mem_bytes, 1e-9)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


@functools.lru_cache(maxsize=None)
def _read_whole_bytes(cfg: ModelConfig, dtype) -> int:
    """Bytes of every weight a phase reads whole: each parameter at its
    own dtype (Mamba2's fp32 vectors) or ``dtype``; the embedding table
    only when it is tied (the LM head reads it)."""
    tree = build_model(cfg).templates
    return _tree_bytes({k: v for k, v in tree.items()
                                 if k != "embed" or cfg.tie_embeddings},
                                _itemsize(dtype))


@functools.lru_cache(maxsize=None)
def _encoder_bytes(cfg: ModelConfig, dtype) -> int:
    """Bytes of an encdec model's encoder weights (0 for the others)."""
    if cfg.family != "encdec":
        return 0
    tree = build_model(cfg).templates
    return sum(_tree_bytes(tree[k], _itemsize(dtype))
               for k in ("enc_layers", "enc_final"))


def _tree_bytes(t, elem: int) -> int:
    if isinstance(t, dict):
        return sum(_tree_bytes(v, elem) for v in t.values())
    return math.prod(t.shape) * (_itemsize(t.dtype) if t.dtype else elem)


def weight_bytes(cfg: ModelConfig, rows: int, dtype=torch.bfloat16) -> int:
    """Bytes of the weights a phase feeding ``rows`` tokens reads: every
    weight once, an untied embedding table only at the ``rows`` rows it
    gathers."""
    total = _read_whole_bytes(cfg, dtype)
    if cfg.tie_embeddings:
        return total
    return total + rows * cfg.d_model * _itemsize(dtype)


def _attn_weight_macs(cfg) -> int:
    """Per token: q, k, v and output projections."""
    hd = cfg.head_dim_resolved
    return cfg.d_model * hd * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)


def _ffn_macs(cfg) -> int:
    """Per token: the SwiGLU, or the router and every expert's SwiGLU on
    the padded dropless dispatch."""
    if cfg.family == "moe":
        return cfg.n_experts * cfg.d_model * (1 + 3 * cfg.d_ff)
    return 3 * cfg.d_model * cfg.d_ff


def _block_macs(cfg) -> int:
    """Per token: one attention block's projections and its feed-forward."""
    return _attn_weight_macs(cfg) + _ffn_macs(cfg)


def _patch_macs(cfg) -> int:
    """One request's patch projection (none outside vlm)."""
    return n_prefix(cfg) * cfg.patch_embed_dim * cfg.d_model


def _patch_bytes(cfg, elem: int) -> int:
    """One request's patch rows, read by a prefill or a chunk."""
    return n_prefix(cfg) * cfg.patch_embed_dim * elem


def _attn_macs(cfg, pairs: int) -> int:
    """Q.K^T and P.V over ``pairs`` (query, key) pairs, all query heads."""
    return 2 * cfg.n_heads * cfg.head_dim_resolved * pairs


def flash_pairs(s: int) -> int:
    """(query, key) pairs of the reference's causal flash path over an
    S-token prefill: S x S up to one chunk; past it each chunk of rows
    stops at the key chunk holding its last row."""
    c = min(FLASH_CHUNK, s)
    return sum(min(c, s - lo) * min(s, lo + c)
               for lo in range(0, s, c))


def _encdec_dec_macs(cfg) -> int:
    """Per decoder token of encdec: self q / k / v / o, cross q / o and
    the GELU MLP."""
    hq = cfg.n_heads * cfg.head_dim_resolved
    return (_attn_weight_macs(cfg) + 2 * cfg.d_model * hq
            + 2 * cfg.d_model * cfg.d_ff)


def _cross_kv_macs(cfg) -> int:
    """Per encoder frame: one layer's cross K / V projection."""
    return 2 * cfg.d_model * cfg.n_kv_heads * cfg.head_dim_resolved


def _strip_bytes(cfg, elem: int, positions: int) -> int:
    """K and V of every decoder layer at ``positions`` positions."""
    return (cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim_resolved
            * elem * positions)


def _need_enc_len(cfg, enc_len):
    if enc_len is None:
        raise ValueError(f"{cfg.name}: an encdec phase's cost needs "
                         "enc_len, the frames' length")
    return enc_len


def _n_shared(cfg) -> int:
    return cfg.n_layers // cfg.shared_attn_every


def ring_width(cfg, cache_len: int) -> int:
    """The hybrid shared block's decode ring: its keys per row."""
    return min(cache_len, cfg.local_window or cache_len)


def _xlstm_dims(cfg):
    """(n mLSTM blocks, n sLSTM blocks, d, di, H, mLSTM head dim, sLSTM
    head dim) of an xlstm config (projection factor 2, as the templates)."""
    k = cfg.slstm_every
    n_groups = cfg.n_layers // k
    d, h = cfg.d_model, cfg.n_heads
    return (n_groups * (k - 1), n_groups, d, 2 * d, h, 2 * d // h, d // h)


XLSTM_CONV = 4       # the blocks' causal conv taps (``d_conv``)


def _xlstm_token_macs(cfg) -> int:
    """Per token, every block: the projections and the sLSTM recurrence."""
    n_m, n_s, d, di, h, dh, dhs = _xlstm_dims(cfg)
    mlstm = d * 2 * di + 3 * h * dh * dh + 2 * di * h + di * d
    slstm = d * 4 * d + d * d + 4 * h * dhs * dhs
    return n_m * mlstm + n_s * slstm


def _xlstm_state_bytes(cfg, elem: int) -> int:
    """One slot's xlstm state: the conv tails in the weights' dtype and
    the fp32 cells (mLSTM C, n, m; sLSTM c, n, h, m)."""
    n_m, n_s, d, di, h, dh, dhs = _xlstm_dims(cfg)
    tails = (XLSTM_CONV - 1) * elem
    return (n_m * (tails * di + 4 * (h * dh * dh + h * dh + h))
            + n_s * (tails * d + 4 * 4 * h * dhs))


def decode_keys(cfg, layout: str, cache_len: int,
                block_size: int | None = None) -> int:
    """Keys a decode row attends over in the reference's count."""
    if cfg.family == "hybrid":
        return ring_width(cfg, cache_len)
    if cfg.family == "ssm":
        return 0
    if layout == "paged":
        return -(-cache_len // block_size) * block_size
    return cache_len


def decode(cfg, *, batch: int, keys: int, dtype=torch.bfloat16,
           enc_len: int | None = None) -> PhaseCost:
    """One decode step over ``batch`` slot rows, each attending ``keys``
    keys (``decode_keys``) and, for encdec, its ``enc_len`` cross keys."""
    elem = _itemsize(dtype)
    head = cfg.d_model * cfg.padded_vocab
    hd = cfg.head_dim_resolved
    weights = weight_bytes(cfg, batch, dtype)
    if cfg.family == "encdec":
        enc_len = _need_enc_len(cfg, enc_len)
        macs = cfg.n_layers * (_encdec_dec_macs(cfg) + _attn_macs(
            cfg, keys + enc_len)) + head
        kv = _strip_bytes(cfg, elem, keys + 1 + enc_len)
        weights -= _encoder_bytes(cfg, dtype)
    elif cfg.family == "hybrid":
        dims = mamba_dims(cfg)
        state = dims.n_heads * dims.head_dim * dims.d_state
        mamba = (dims.d_model * dims.proj_dim + dims.d_inner * dims.d_model
                 + dims.d_conv * dims.conv_dim + state)
        macs = (cfg.n_layers * mamba
                + _n_shared(cfg) * (_block_macs(cfg)
                                    + _attn_macs(cfg, keys)) + head)
        kv = _n_shared(cfg) * 2 * cfg.n_kv_heads * hd * elem * (keys + 1)
        # fp32 SSM state and the conv tail, each read and written
        kv += cfg.n_layers * 2 * (state * 4 + (dims.d_conv - 1)
                                  * dims.conv_dim * elem)
    elif cfg.family == "ssm":
        n_m, n_s, d, di, h, dh, _ = _xlstm_dims(cfg)
        macs = (_xlstm_token_macs(cfg)
                + n_m * (XLSTM_CONV * di + h * dh * dh + h * dh)
                + n_s * XLSTM_CONV * d + head)
        kv = 2 * _xlstm_state_bytes(cfg, elem)
    else:
        macs = cfg.n_layers * (_block_macs(cfg) + _attn_macs(cfg, keys)) \
            + head
        kv = cfg.n_layers * 2 * cfg.n_kv_heads * hd * elem * (keys + 1)
    return PhaseCost(2.0 * batch * macs,
                float(weights + batch * (
                    kv + TOKEN_BYTES + cfg.padded_vocab * LOGIT_BYTES)))


def prefill(cfg, *, seq: int, cache_len: int | None = None,
            dtype=torch.bfloat16, enc_len: int | None = None) -> PhaseCost:
    """One dense prefill of one ``seq``-token prompt (the port prefills a
    slot at a time), a vlm's patch prefix ahead of it, an encdec's
    ``enc_len`` frames encoded beside it."""
    elem = _itemsize(dtype)
    head = cfg.d_model * cfg.padded_vocab
    hd = cfg.head_dim_resolved
    tokens, seq = seq, n_prefix(cfg) + seq
    attn = _attn_macs(cfg, flash_pairs(seq))
    if cfg.family == "encdec":
        e = _need_enc_len(cfg, enc_len)
        encoder = cfg.n_enc_layers * (
            e * (_attn_weight_macs(cfg) + 2 * cfg.d_model * cfg.d_ff)
            + _attn_macs(cfg, e * e))
        decoder = cfg.n_layers * (seq * _encdec_dec_macs(cfg)
                                  + e * _cross_kv_macs(cfg) + attn
                                  + _attn_macs(cfg, seq * e))
        macs = encoder + decoder + head
        # the frames read; the self strips and cross strips written
        written = (e * cfg.d_model * elem
                   + _strip_bytes(cfg, elem, seq + e))
    elif cfg.family == "hybrid":
        dims = mamba_dims(cfg)
        hs, p, n = dims.n_heads, dims.head_dim, dims.d_state
        q = min(SSD_CHUNK, seq)
        ssd = -(-seq // q) * (hs * q * q * n + q * hs * p * q
                              + 2 * q * hs * p * n)
        macs = (cfg.n_layers * (seq * (dims.d_model * dims.proj_dim
                                       + dims.d_inner * dims.d_model) + ssd)
                + _n_shared(cfg) * (seq * _block_macs(cfg) + attn) + head)
        w = ring_width(cfg, cache_len or seq)
        written = (_n_shared(cfg) * 2 * cfg.n_kv_heads * hd * elem
                   * min(seq, w)
                   + cfg.n_layers * (hs * p * n * 4 + (dims.d_conv - 1)
                                     * dims.conv_dim * elem))
    elif cfg.family == "ssm":
        n_m, _, _, _, h, dh, _ = _xlstm_dims(cfg)
        q = min(MLSTM_CHUNK, seq)
        chunks = -(-seq // q) * (2 * h * q * q * dh + 2 * h * q * dh * dh
                                 + 2 * h * q * dh)
        macs = seq * _xlstm_token_macs(cfg) + n_m * chunks + head
        written = _xlstm_state_bytes(cfg, elem)
    else:
        macs = (cfg.n_layers * (seq * _block_macs(cfg) + attn) + head
                + _patch_macs(cfg))
        written = cfg.n_layers * 2 * cfg.n_kv_heads * hd * elem * seq
    return PhaseCost(2.0 * macs,
                float(weight_bytes(cfg, tokens, dtype) + written
                      + tokens * TOKEN_BYTES + _patch_bytes(cfg, elem)
                      + cfg.padded_vocab * LOGIT_BYTES))


def prefill_chunk(cfg, *, block_size: int,
                  dtype=torch.bfloat16) -> PhaseCost:
    """One paged prefill chunk of ``block_size`` positions: its K/V written
    into one block and one block of keys read back."""
    elem = _itemsize(dtype)
    macs = (cfg.n_layers * (block_size * _block_macs(cfg)
                            + _attn_macs(cfg, block_size * block_size))
            + cfg.d_model * cfg.padded_vocab + _patch_macs(cfg))
    kv = (cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim_resolved * elem
          * 2 * block_size)
    return PhaseCost(2.0 * macs,
                float(weight_bytes(cfg, block_size, dtype) + kv
                      + block_size * TOKEN_BYTES + _patch_bytes(cfg, elem)
                      + cfg.padded_vocab * LOGIT_BYTES))


def phase_cost(cfg, key: tuple, *, cache_len: int,
               block_size: int | None = None, dtype=torch.bfloat16,
               enc_len: int | None = None) -> PhaseCost:
    """The cost of the phase a memo key names: ``("decode", layout, name,
    B)``, ``("prefill", name, S)`` or ``("prefill_chunk", name,
    block_size)``, for an engine of ``cache_len`` (and ``block_size`` when
    paged) whose weights are ``dtype``; an encdec engine also gives its
    frames' length ``enc_len``."""
    kind = key[0]
    if kind == "decode":
        return decode(cfg, batch=key[3], dtype=dtype, enc_len=enc_len,
                      keys=decode_keys(cfg, key[1], cache_len, block_size))
    if kind == "prefill":
        return prefill(cfg, seq=key[2], cache_len=cache_len, dtype=dtype,
                       enc_len=enc_len)
    if kind == "prefill_chunk":
        return prefill_chunk(cfg, block_size=key[2], dtype=dtype)
    raise ValueError(f"unknown phase {kind!r} in key {key!r}")
