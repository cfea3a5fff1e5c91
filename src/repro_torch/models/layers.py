"""Model substrate: param templates and init, norms, RoPE, SwiGLU, embedding.

The port's counterpart of ``repro/models/layers.py``.  Parameters are plain
nested dicts of tensors with the reference's tree layout (layer stacks on
axis 0), so the weight bridge (``repro_torch.bridge``) maps one onto the
other leaf for leaf.
"""
from __future__ import annotations

import dataclasses
import math
import zlib

import numpy as np
import torch

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


def _init_leaf(t: PT, gen: torch.Generator, device, dtype) -> torch.Tensor:
    dtype = t.dtype or dtype
    if t.init == "zeros":
        return torch.zeros(t.shape, dtype=dtype, device=device)
    if t.init == "ones":
        return torch.ones(t.shape, dtype=dtype, device=device)
    if t.init in ("ssm_dt", "ssm_a"):
        u = torch.rand(t.shape, generator=gen, dtype=torch.float32,
                       device=device)
        if t.init == "ssm_dt":    # dt bias: softplus^-1 of U(0.001, 0.1)
            return torch.log(torch.expm1(0.001 + 0.099 * u)).to(dtype)
        return torch.log(1.0 + 15.0 * u).to(dtype)    # a_log: log U(1, 16)
    if t.init == "scaled":     # fan-in scaled normal
        fan_in = t.shape[-2] if len(t.shape) >= 2 else t.shape[-1]
        std = t.scale if t.scale is not None else 1.0 / math.sqrt(fan_in)
    elif t.init == "normal":
        std = t.scale if t.scale is not None else 0.02
    else:
        raise ValueError(f"init scheme {t.init!r} is not ported")
    x = torch.randn(t.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def init_params(templates: dict, seed: int, *, device,
                dtype=torch.bfloat16, _path=()) -> dict:
    """Walk a template tree, drawing each leaf from its own generator.

    A leaf's generator is seeded from ``seed`` and the crc32 of its path
    (as ``repro/models/layers.py::init_params`` folds the crc32 into its
    key), never from ``hash()``, so "same seed, same params" holds across
    processes.  The values differ from the reference's (another generator);
    parity tests carry the reference's weights over the bridge instead."""
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


def embed_templates(vocab: int, d_model: int) -> dict:
    return {"embedding": PT((vocab, d_model), "normal")}


def embed_lookup(p, tokens):
    return p["embedding"][tokens.long()]
