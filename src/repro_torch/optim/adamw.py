"""AdamW, mixed precision: fp32 masters, ``m`` and ``v`` beside compute
parameters of any dtype (bf16 on the card).  The port's counterpart of
``repro/optim/adamw.py``; one device, no sharding."""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable | float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    # no weight decay on leaves of fewer dims (norms, biases)
    decay_min_ndim: int = 2

    def init(self, params) -> dict:
        """{"master": fp32 copies, "m", "v": fp32 zeros, "step": 0-d int32},
        on the params' devices."""
        return {
            "master": tree_map(lambda p: p.detach().to(torch.float32,
                                                       copy=True), params),
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                device=p.device), params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=tree_leaves(params)[0].device),
        }

    def _next_step(self, state: dict):
        """Advance ``state["step"]``; (its learning rate, the bias
        corrections 1 - b1^step and 1 - b2^step in fp32)."""
        state["step"] += 1
        step = state["step"].float()
        lr = self.lr(state["step"]) if callable(self.lr) else self.lr
        c1 = 1.0 - torch.pow(torch.tensor(self.b1, device=step.device), step)
        c2 = 1.0 - torch.pow(torch.tensor(self.b2, device=step.device), step)
        return lr, c1, c2

    @torch.no_grad()
    def update(self, grads, state: dict) -> dict:
        """One step from ``grads`` (a tree like the params, any dtype):
        bias-corrected Adam moments and decoupled weight decay, all in fp32.
        The state's tensors are updated in place (the reference donates
        them) and the state is returned."""
        lr, c1, c2 = self._next_step(state)
        b1, b2 = self.b1, self.b2

        def upd(g, m, v, master):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            delta = (m / c1) / (torch.sqrt(v / c2) + self.eps)
            if master.dim() >= self.decay_min_ndim and self.weight_decay:
                delta = delta + self.weight_decay * master
            master.sub_(lr * delta)

        for g, m, v, w in zip(tree_leaves(grads), tree_leaves(state["m"]),
                              tree_leaves(state["v"]),
                              tree_leaves(state["master"])):
            upd(g, m, v, w)
        return state

    def params_from_state(self, state: dict, like):
        """The masters cast to the dtypes of ``like`` (a tree of tensors or
        of dtypes), always as new tensors."""
        return tree_map(
            lambda w, p: w.to(p if isinstance(p, torch.dtype) else p.dtype,
                              copy=True), state["master"], like)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global L2 norm of at most ``max_norm``, the norm
    before clipping).  Each leaf is scaled in fp32 and cast back to its
    dtype, as the reference's ``(g * scale).astype(g.dtype)``."""
    leaves = tree_leaves(grads)
    gn = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn
