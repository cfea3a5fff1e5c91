"""Top-k MoE layer with sort-based capacity dispatch.  The port's
counterpart of ``repro/models/moe.py``.

Token -> expert assignments are sorted by expert id, each assignment's
position within its expert comes from the sorted run's start, and tokens
are scattered into a dense ``(G, E, C, d)`` buffer that the stacked expert
SwiGLU consumes as one batched product an expert.  ``exact=True`` sets the
capacity to the group's length, so nothing is ever dropped: every serving
path routes so.

Every step has a fixed order, so a token's output is the same bits from
run to run on the card:

* the top-k breaks ties toward the lower expert id, as ``jax.lax.top_k``
  does (a stable descending sort; ``torch.topk`` promises no tie order on
  the card);
* the sort is stable, so slots within an expert follow token order, as
  ``jnp.argsort`` does;
* the combine uses no atomic scatter: each token's k rows are gathered
  back through the inverse permutation and added in the reference's order
  (ascending expert id, the order its ``.at[].add`` visits the sorted
  rows), one elementwise add a choice.

The reference's mesh hints (``constrain``) are dropped: the port has no
mesh.  The expert products stay PyTorch batched products, as the
reference leaves its einsums to XLA; they keep the padded ``(E, G * C)``
rows, so the work is the reference's.
"""
from __future__ import annotations

import torch

from .layers import PT, silu

GROUP_TOKENS = 2048   # the reference's routing group (one a chip there)


def moe_templates(d_model: int, d_ff: int, n_experts: int) -> dict:
    return {
        "router": PT((d_model, n_experts), "scaled", dtype=torch.float32),
        "gate": PT((n_experts, d_model, d_ff), "scaled"),
        "up": PT((n_experts, d_model, d_ff), "scaled"),
        "down": PT((n_experts, d_ff, d_model), "scaled"),
    }


def _top_k(probs, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest, ties toward the
    lower index."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def _gates(p, xt, top_k: int):
    """Router probabilities (fp32) and each token's top-k normalized gates
    and expert ids."""
    logits = torch.matmul(xt.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = _top_k(probs, top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    return probs, gate_vals, expert_ids


def _route(p, x3, top_k: int, cap: int):
    """Route G groups at once.  x3: (G, T, d).  Returns the dispatch buffer
    (G, E, C, d) and the combine metadata (slot, order, gate, keep, probs,
    ids), each (G, T * k) in expert-sorted order but the last two."""
    g, t, d = x3.shape
    e = p["router"].shape[1]
    probs, gate_vals, expert_ids = _gates(p, x3, top_k)
    flat_expert = expert_ids.reshape(g, t * top_k)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    se = flat_expert.gather(1, order)
    st = order // top_k                        # each sorted row's token
    sg = gate_vals.reshape(g, t * top_k).gather(1, order)
    # se is sorted: a row's position within its expert is its index less
    # the index where that expert's run starts
    experts = torch.arange(e, device=x3.device).expand(g, e).contiguous()
    starts = torch.searchsorted(se, experts)
    pos = (torch.arange(t * top_k, device=x3.device)
           - starts.gather(1, se))
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, torch.full_like(se, e * cap))
    buf = torch.zeros((g, e * cap + 1, d), dtype=x3.dtype, device=x3.device)
    rows = torch.arange(g, device=x3.device)[:, None]
    buf[rows, slot] = x3[rows, st]             # overflow rows share slot E*C
    dispatched = buf[:, :e * cap].reshape(g, e, cap, d)
    return dispatched, (slot, order, sg, keep, probs, expert_ids)


def _experts(p, dispatched):
    """The stacked expert SwiGLU over (G, E, C, d): one batched product an
    expert over its G * C rows."""
    g, e, cap, d = dispatched.shape
    xe = dispatched.transpose(0, 1).reshape(e, g * cap, d)
    h = silu(torch.bmm(xe, p["gate"])) * torch.bmm(xe, p["up"])
    y = torch.bmm(h, p["down"])
    return y.reshape(e, g, cap, d).transpose(0, 1)


def _combine(y, meta, t: int, top_k: int):
    """Each token's k expert rows, weighted by their gates and added in
    ascending expert id (no atomics).  y: (G, E, C, d) -> (G, T, d)."""
    slot, order, sg, keep, _, _ = meta
    g, e, cap, d = y.shape
    y_flat = torch.cat([y.reshape(g, e * cap, d),
                        torch.zeros((g, 1, d), dtype=y.dtype,
                                    device=y.device)], dim=1)
    contrib = (y_flat.gather(1, slot[..., None].expand(-1, -1, d))
               * sg.to(y.dtype)[..., None] * keep.to(y.dtype)[..., None])
    # inv[j]: the sorted index of flat row j = (token j // k, choice j % k);
    # a token's sorted indices, ascending, follow its experts ascending
    n = t * top_k
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(n, device=y.device).expand(g, n))
    idx = inv.reshape(g, t, top_k).sort(dim=-1).values.reshape(g, n)
    c = contrib.gather(1, idx[..., None].expand(-1, -1, d)).reshape(
        g, t, top_k, d)
    out = c[:, :, 0]
    for j in range(1, top_k):
        out = out + c[:, :, j]
    return out


def moe_apply(p, x, *, top_k: int, capacity_factor: float = 1.25,
              return_aux: bool = False, exact: bool = False):
    """x: (..., d) -> (..., d).  Tokens beyond an expert's capacity are
    dropped (contribute zero), as in Switch / GShard; ``exact=True`` sets
    the capacity to the group's length (no drops ever).

    Routing is grouped as the reference groups it: a (B, S, d) input
    routes each batch row alone (a decode step's (B, 1, d) routes each
    token alone), a row whose length is a multiple of ``GROUP_TOKENS`` in
    groups of that many tokens, and an input of at most two dims as one
    group.  With ``return_aux`` also returns ``lb_loss`` (the load-balance
    loss) and ``drop_frac`` (the share of assignments dropped)."""
    orig_shape = x.shape
    d = orig_shape[-1]
    x3 = (x.reshape(1, -1, d) if x.dim() <= 2
          else x.reshape(orig_shape[0], -1, d))
    b0, t0, _ = x3.shape
    gs = GROUP_TOKENS if t0 % GROUP_TOKENS == 0 else t0
    x3 = x3.reshape(b0 * (t0 // gs), gs, d)
    t = x3.shape[1]
    e = p["router"].shape[1]
    cap = t if exact else max(1, int(top_k * t * capacity_factor / e))
    dispatched, meta = _route(p, x3, top_k, cap)
    y = _experts(p, dispatched)
    out = _combine(y, meta, t, top_k).reshape(orig_shape)
    if return_aux:
        probs, expert_ids, keep = meta[4], meta[5], meta[3]
        me = probs.mean(dim=(0, 1))
        ce = torch.nn.functional.one_hot(expert_ids[..., 0], e).float() \
            .mean(dim=(0, 1))
        aux = {"lb_loss": e * torch.sum(me * ce),
               "drop_frac": 1.0 - keep.float().mean()}
        return out, aux
    return out


def moe_apply_dense(p, x, *, top_k: int):
    """The reference's oracle: every expert on every token, weighted by the
    gates (exact, no capacity drops)."""
    xt = x.reshape(-1, x.shape[-1])
    probs, gate_vals, expert_ids = _gates(p, xt, top_k)
    full_gates = torch.zeros_like(probs).scatter_(1, expert_ids, gate_vals)
    g = silu(torch.einsum("td,edf->tef", xt, p["gate"]))
    u = torch.einsum("td,edf->tef", xt, p["up"])
    y = torch.einsum("tef,efd->ted", g * u, p["down"])
    out = torch.einsum("ted,te->td", y.float(), full_gates)
    return out.to(x.dtype).reshape(x.shape)
