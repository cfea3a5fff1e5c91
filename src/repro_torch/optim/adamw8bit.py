"""8-bit AdamW, the port's counterpart of ``repro/optim/adamw8bit.py``: m
and v kept quantized in blocks of 256 values along each parameter's LAST
axis, in the parameter's layout; masters fp32.

m is symmetric int8 (``q = round(m / s)``, s = the block's max |m| / 127);
v is kept as sqrt(v) in unsigned uint8 (s = the block's max sqrt(v) / 255),
which halves its dynamic range.  ``q`` keeps the parameter's shape with its
last axis padded to a multiple of 256, and the fp32 scales ``s`` its
leading dims and one entry a block: the reference's layout, so either
package restores the other's checkpoint.  A block of zeros takes the scale
1.0; ``torch.round`` rounds half to even, as ``jnp.round`` does.  The state
is quantized again from the updated fp32 value every step, so the rounding
does not accumulate.  Plain PyTorch, as the reference leaves its optimizer
to XLA; one device.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ..tree import tree_leaves, tree_map
from .adamw import AdamW

BLOCK = 256
_I8_MAX = 127.0
_U8_MAX = 255.0


def padded_last(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _blocks(x):
    """x (..., n) fp32 -> (..., blocks, BLOCK), the last axis zero-padded."""
    n = x.shape[-1]
    x = F.pad(x, (0, padded_last(n) - n))
    return x.reshape(*x.shape[:-1], x.shape[-1] // BLOCK, BLOCK)


def _quantize(b, mag, lo: float, hi: float, dtype):
    """Blocks ``b`` over the scales ``max(mag) / hi`` (1.0 for a zero
    block): (q in ``dtype``, (..., padded n), scales (..., blocks))."""
    scale = mag.amax(dim=-1) / hi
    scale = torch.where(scale == 0, 1.0, scale)
    q = torch.clamp(torch.round(b / scale[..., None]), lo, hi).to(dtype)
    return q.reshape(*q.shape[:-2], -1), scale


def _q_sym(x):
    """m: symmetric int8 blocks."""
    b = _blocks(x.float())
    return _quantize(b, b.abs(), -_I8_MAX, _I8_MAX, torch.int8)


def _q_pos(x):
    """v >= 0: its square root in unsigned uint8 blocks."""
    b = torch.sqrt(_blocks(x.float()))
    return _quantize(b, b, 0.0, _U8_MAX, torch.uint8)


def _dq(q, scale, shape, *, square=False):
    """The fp32 value of ``shape`` that (q, scale) hold (squared for v)."""
    b = q.reshape(*q.shape[:-1], q.shape[-1] // BLOCK, BLOCK).float()
    x = (b * scale[..., None]).reshape(q.shape)
    x = x[..., :shape[-1]].reshape(shape)
    return x * x if square else x


@dataclasses.dataclass(frozen=True)
class AdamW8bit(AdamW):
    """AdamW (its hyperparameters, schedule, step and
    ``params_from_state``) with m and v kept in 8 bits."""

    def init(self, params) -> dict:
        """{"master": fp32 copies, "m", "v": {"q", "s"} a leaf, quantized
        zeros, "step": 0-d int32}, on the params' devices."""
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

        def qm(p):
            q, s = _q_sym(zeros(p))
            return {"q": q, "s": s}

        def qv(p):
            q, s = _q_pos(zeros(p))
            return {"q": q, "s": s}

        return {
            "master": tree_map(lambda p: p.detach().to(torch.float32,
                                                       copy=True), params),
            "m": tree_map(qm, params),
            "v": tree_map(qv, params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device),
        }

    @torch.no_grad()
    def update(self, grads, state: dict) -> dict:
        """One step from ``grads`` (a tree like the params, any dtype): the
        moments dequantized to fp32, AdamW's fp32 step with decoupled
        weight decay, the moments quantized again.  The masters are
        updated in place and each leaf's ``q`` / ``s`` replaced (the
        reference donates the state); the state is returned."""
        lr, c1, c2 = self._next_step(state)
        b1, b2 = self.b1, self.b2

        def upd(g, mq, vq, master):
            g = g.float()
            m = _dq(mq["q"], mq["s"], g.shape)
            v = _dq(vq["q"], vq["s"], g.shape, square=True)
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if master.dim() >= self.decay_min_ndim and self.weight_decay:
                delta = delta + self.weight_decay * master
            master.sub_(lr * delta)
            mq["q"], mq["s"] = _q_sym(m)
            vq["q"], vq["s"] = _q_pos(v)

        def walk(g, m, v, w):
            # the masters' tree names the parameters; m and v hold a
            # {"q", "s"} dict where it holds a tensor
            if isinstance(w, dict):
                for k in w:
                    walk(g[k], m[k], v[k], w[k])
            else:
                upd(g, m, v, w)

        walk(grads, state["m"], state["v"], state["master"])
        return state
