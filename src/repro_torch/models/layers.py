"""Model substrate: param templates and init, norms, RoPE, sinusoidal
positions, SwiGLU and GELU MLPs, embedding, and the chunked cross-entropy
fused with the LM head.

The port's counterpart of ``repro/models/layers.py``.  Parameters are plain
nested dicts of tensors with the reference's tree layout (layer stacks on
axis 0), so the weight bridge (``repro_torch.bridge``) maps one onto the
other leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import zlib

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

# ---------------------------------------------------------------------------
# Param templates.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PT:
    """Param template: shape + init scheme (``normal | zeros | ones |
    scaled | ssm_dt | ssm_a``) + stddev override + the leaf's own dtype
    (None: the dtype ``init_params`` is given; Mamba2's ``a_log``,
    ``dt_bias`` and ``d_skip`` stay fp32, as in the reference)."""
    shape: tuple[int, ...]
    init: str = "normal"
    scale: float | None = None
    dtype: torch.dtype | None = None


def stack_layers(template: dict, n_layers: int) -> dict:
    """Stack a per-layer template tree along a leading layer axis."""
    return {k: (stack_layers(v, n_layers) if isinstance(v, dict)
                else dataclasses.replace(v, shape=(n_layers,) + v.shape))
            for k, v in template.items()}


def leaf_path(path: tuple[str, ...]) -> str:
    """The reference's ``jax.tree_util.keystr`` of a dict path, e.g.
    ``"['layers']['attn']['wq']"`` — the string each leaf's seed hashes."""
    return "".join(f"[{k!r}]" for k in path)


# the most elements one draw makes: a leaf larger than this is drawn in
# runs of whole rows along axis 0 (layers, for a stacked leaf), each scaled
# in place and cast into the leaf, so the fp32 transient stays at 1 GiB
# however large the leaf (gemma3-27b's stacked MLP holds 7.2e9 elements)
INIT_CHUNK_ELEMS = 1 << 28


def _draw_rows(shape, draw, finish, device, dtype) -> torch.Tensor:
    """A leaf of ``shape`` in ``dtype`` from fp32 draws: ``draw(shape)``
    makes a run of rows, ``finish(x)`` maps it to the leaf's values (in
    place where it can) before the cast."""
    n = math.prod(shape)
    if n <= INIT_CHUNK_ELEMS or len(shape) < 2:
        return finish(draw(shape)).to(dtype)
    out = torch.empty(shape, dtype=dtype, device=device)
    rows = max(1, INIT_CHUNK_ELEMS // (n // shape[0]))
    for lo in range(0, shape[0], rows):
        hi = min(lo + rows, shape[0])
        out[lo:hi].copy_(finish(draw((hi - lo,) + tuple(shape[1:]))))
    return out


def _init_leaf(t: PT, gen: torch.Generator, device, dtype) -> torch.Tensor:
    dtype = t.dtype or dtype
    if t.init == "zeros":
        return torch.zeros(t.shape, dtype=dtype, device=device)
    if t.init == "ones":
        return torch.ones(t.shape, dtype=dtype, device=device)

    def uniform(shape):
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=device)

    def normal(shape):
        return torch.randn(shape, generator=gen, dtype=torch.float32,
                           device=device)

    if t.init == "ssm_dt":      # dt bias: softplus^-1 of U(0.001, 0.1)
        return _draw_rows(t.shape, uniform,
                          lambda u: torch.log(torch.expm1(0.001 + 0.099 * u)),
                          device, dtype)
    if t.init == "ssm_a":       # a_log: log U(1, 16)
        return _draw_rows(t.shape, uniform,
                          lambda u: torch.log(1.0 + 15.0 * u), device, dtype)
    if t.init == "scaled":     # fan-in scaled normal
        fan_in = t.shape[-2] if len(t.shape) >= 2 else t.shape[-1]
        std = t.scale if t.scale is not None else 1.0 / math.sqrt(fan_in)
    elif t.init == "normal":
        std = t.scale if t.scale is not None else 0.02
    else:
        raise ValueError(f"init scheme {t.init!r} is not ported")
    return _draw_rows(t.shape, normal, lambda x: x.mul_(std), device, dtype)


def init_params(templates: dict, seed: int, *, device,
                dtype=torch.bfloat16, _path=()) -> dict:
    """Walk a template tree, drawing each leaf from its own generator.

    A leaf's generator is seeded from ``seed`` and the crc32 of its path
    (as ``repro/models/layers.py::init_params`` folds the crc32 into its
    key), never from ``hash()``, so "same seed, same params" holds across
    processes.  The values differ from the reference's (another generator);
    parity tests carry the reference's weights over the bridge instead.
    A leaf past ``INIT_CHUNK_ELEMS`` elements is drawn in runs of rows, so
    the peak stays near the weights themselves at any width."""
    out = {}
    for k, v in templates.items():
        path = _path + (k,)
        if isinstance(v, dict):
            out[k] = init_params(v, seed, device=device, dtype=dtype,
                                 _path=path)
            continue
        # crc32 of the path, chained on the seed's own crc32: a 32-bit
        # seed (the CPU generator keeps only 32 bits of what it is given)
        digest = zlib.crc32(leaf_path(path).encode(),
                            zlib.crc32(str(seed).encode()))
        gen = torch.Generator(device=device)
        gen.manual_seed(digest)
        out[k] = _init_leaf(v, gen, device, dtype)
    return out


def tree_index(tree: dict, i: int) -> dict:
    """Entry ``i`` of every leaf of a stacked tree (views, no copies)."""
    return {k: tree_index(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def tree_unbind(tree: dict, n: int) -> list[dict]:
    """The ``n`` entries of a stacked tree, one ``torch.unbind`` a leaf:
    under autograd each entry's gradient lands in its own slice of the
    leaf's (one stack in the backward), where :func:`tree_index` would
    make every entry's backward write a zero gradient of the whole
    stack."""
    cols = {k: tree_unbind(v, n) if isinstance(v, dict) else torch.unbind(v)
            for k, v in tree.items()}
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def param_count(templates: dict) -> int:
    return sum(param_count(v) if isinstance(v, dict)
               else int(np.prod(v.shape)) for v in templates.values())


# ---------------------------------------------------------------------------
# Norms / activations.
# ---------------------------------------------------------------------------

def rmsnorm(w, x, eps=1e-6):
    """fp32 RMSNorm with a ``(1 + w)`` gain, cast back to x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w.float())).to(x.dtype)


def layernorm(w, b, x, eps=1e-5):
    """fp32 LayerNorm (population variance) with scale and shift, cast back
    to x's dtype."""
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * w.float() + b.float()).to(x.dtype)


def silu(x):
    return x * torch.sigmoid(x)


def softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` (``F.softplus`` switches to
    the identity above a threshold of 20, which the reference does not)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


# ---------------------------------------------------------------------------
# RoPE (split halves).
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    """Inverse frequencies in float64 numpy, as the reference computes them."""
    return 1.0 / (theta ** (np.arange(0, head_dim, 2) / head_dim))


def rope_cos_sin(positions, head_dim: int, theta: float):
    """cos/sin tables for ``positions`` ((S,) or (B, S)), shaped to
    broadcast over (B, H, S, D/2): computed once per step and shared by
    every layer."""
    inv = torch.tensor(rope_freqs(head_dim, theta), dtype=torch.float32,
                       device=positions.device)
    ang = positions.float()[..., None] * inv     # (S, D/2) or (B, S, D/2)
    ang = ang[None, None] if ang.dim() == 2 else ang[:, None]
    return torch.cos(ang), torch.sin(ang)


def apply_rope_cs(x, cos, sin):
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (B, H, S, D); positions: (S,) or (B, S)."""
    return apply_rope_cs(x, *rope_cos_sin(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# Sinusoidal positions (the encoder-decoder family).
# ---------------------------------------------------------------------------

def sinusoid_div(d: int) -> np.ndarray:
    """The sinusoids' frequencies, float64 numpy (d / 2,)."""
    return np.exp(-np.log(10000.0) * np.arange(0, d, 2) / d)


@functools.lru_cache(maxsize=16)
def _sinusoid_table(n: int, d: int) -> np.ndarray:
    pos = np.arange(n)[:, None]
    pe = np.zeros((n, d), np.float32)
    pe[:, 0::2] = np.sin(pos * sinusoid_div(d))
    pe[:, 1::2] = np.cos(pos * sinusoid_div(d))
    return pe


def sinusoidal_positions(n: int, d: int, device="cpu") -> torch.Tensor:
    """(n, d) fp32 table, sin on even and cos on odd columns: built in
    float64 numpy and cast to fp32, as the reference builds it (once per
    shape; each call gets its own copy)."""
    return torch.from_numpy(_sinusoid_table(n, d)).to(device, copy=True)


# ---------------------------------------------------------------------------
# MLP and embedding.
# ---------------------------------------------------------------------------

def swiglu_templates(d_model: int, d_ff: int) -> dict:
    return {
        "gate": PT((d_model, d_ff), "scaled"),
        "up": PT((d_model, d_ff), "scaled"),
        "down": PT((d_ff, d_model), "scaled"),
    }


def swiglu_apply(p, x):
    g = silu(torch.matmul(x, p["gate"]))
    u = torch.matmul(x, p["up"])
    return torch.matmul(g * u, p["down"])


def gelu_mlp_templates(d_model: int, d_ff: int) -> dict:
    return {
        "up": PT((d_model, d_ff), "scaled"),
        "up_b": PT((d_ff,), "zeros"),
        "down": PT((d_ff, d_model), "scaled"),
        "down_b": PT((d_model,), "zeros"),
    }


def gelu_mlp_apply(p, x):
    """Biased up and down projections around a GELU in its tanh form
    (``jax.nn.gelu``'s default; the erf form parts from it near 1e-3)."""
    h = torch.nn.functional.gelu(torch.matmul(x, p["up"]) + p["up_b"],
                                 approximate="tanh")
    return torch.matmul(h, p["down"]) + p["down_b"]


def embed_templates(vocab: int, d_model: int) -> dict:
    return {"embedding": PT((vocab, d_model), "normal")}


def embed_lookup(p, tokens):
    return p["embedding"][tokens.long()]


# ---------------------------------------------------------------------------
# Chunked cross-entropy, fused with the LM head so the (B, S, V) logits never
# exist at once.
# ---------------------------------------------------------------------------

def _xent_chunk(h, w32, labels, mask, logit_softcap, valid_vocab):
    """(loss sum, token count, correct count) of one chunk of rows, from
    its fp32 logits ``h @ w``."""
    logits = torch.matmul(h.float(), w32)                    # (B, c, V)
    if valid_vocab is not None and valid_vocab < logits.shape[-1]:
        # the padded vocab columns (Megatron-style padding) at -1e30
        col = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(col < valid_vocab, logits, -1e30)
    if logit_softcap is not None:
        logits = logit_softcap * torch.tanh(logits / logit_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels[..., None])[..., 0]
    # torch.argmax takes the first maximum, as jnp.argmax does
    correct = (torch.argmax(logits, dim=-1) == labels).float()
    return ((lse - gold) * mask).sum(), mask.sum(), (correct * mask).sum()


def softmax_xent_chunked(h, w_out, labels, *, chunk=512, label_mask=None,
                         logit_softcap=None, valid_vocab=None):
    """h: (B, S, D), w_out: (D, V), labels: (B, S) int.  Returns (mean
    loss, accuracy), fp32 0-d tensors, over the rows ``label_mask`` keeps
    (all by default).

    The counterpart of the reference's ``softmax_xent_chunked``
    (``repro/models/layers.py:227-264``): the rows are taken ``chunk`` at a
    time, the chunk shrunk to the largest divisor of S; each chunk's fp32
    logits are masked past ``valid_vocab`` and softcapped, and the chunk
    runs under ``torch.utils.checkpoint``, so its V-wide logits are made
    again in the backward rather than kept (the reference's
    ``jax.checkpoint``).  ``w_out`` is cast to fp32 once a call."""
    b, s, _ = h.shape
    chunk = min(chunk, s)
    while s % chunk:   # largest divisor of s <= the requested chunk
        chunk -= 1
    labels = labels.long()
    mask = (label_mask.float() if label_mask is not None
            else torch.ones(labels.shape, device=h.device))
    w32 = w_out.float()
    zero = torch.zeros((), device=h.device)
    loss_sum, n_tok, n_correct = zero, zero, zero
    for c0 in range(0, s, chunk):
        part = slice(c0, c0 + chunk)
        ls, nt, nc = checkpoint(_xent_chunk, h[:, part], w32, labels[:, part],
                                mask[:, part], logit_softcap, valid_vocab,
                                use_reentrant=False)
        loss_sum, n_tok, n_correct = loss_sum + ls, n_tok + nt, n_correct + nc
    denom = torch.clamp(n_tok, min=1.0)
    return loss_sum / denom, n_correct / denom
