"""The port's moe family (``repro_torch.models.moe`` and the moe layer
stack) against the reference's (``repro.models.moe``, ``repro.models``).

* ``moe_apply`` on the reference's own weights and inputs, in both modes:
  dropless (``exact=True``) and capacity routing with drops (out,
  ``lb_loss`` and ``drop_frac``); the reference's contracts re-asserted on
  the port (dispatch == ``moe_apply_dense``, exact never drops, capacity
  drops bounded, the aux terms); the top-k's tie order; the combine's
  fixed order.
* Prefill, paged-chunk and decode logits of the granite-moe and
  qwen3-moe smoke configs against the reference (``torch_parity``): fp32
  weights at atol = rtol = 1e-4 on every row; bf16 at 4% of the logits'
  scale on every row whose call routed no token at a near tie.
* Greedy tokens of the engine equal the reference's with fp32 weights,
  dense and paged.

On the card (``tests/test_torch_gpu.py``, which imports no JAX): the
attention kernels at granite's head dim, and a narrow fp32 granite copy
serving the same tokens paged and dense.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from helpers import given, settings, st
from repro.configs import smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.models.layers import init_params as ref_init_params
from repro.models.moe import moe_apply as ref_moe_apply
from repro.models.moe import moe_templates as ref_moe_templates
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch.configs import smoke_config
from repro_torch.models import build_model
from repro_torch.models.moe import moe_apply, moe_apply_dense
from repro_torch.serving import Request, ServeEngine

KEY = jax.random.key(5)
ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-235b-a22b")


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them about
    as fast as many and keeps parallel test workers off each other's
    cores.  The old count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layer(d=32, f=16, e=4):
    """The reference's seeded expert layer, and the port's copy (fp32)."""
    p = ref_init_params(ref_moe_templates(d, f, e), KEY)
    return p, {k: torch.from_numpy(np.array(v, np.float32))
               for k, v in p.items()}


def _x(i, shape):
    x = jax.random.normal(jax.random.fold_in(KEY, i), shape)
    return x, torch.from_numpy(np.array(x))


# (shape, e, kwargs): exact; capacity with room; capacity with drops; the
# regrouped path (a row of GROUP_TOKENS tokens); 2-d input
MODES = {
    "exact": ((3, 32), 4, dict(exact=True)),
    "exact-rows": ((4, 9, 32), 4, dict(exact=True)),
    "capacity-room": ((6, 11, 32), 4, dict(capacity_factor=8.0)),
    "capacity-drops": ((16, 16, 32), 4, dict(capacity_factor=1.0)),
    "capacity-tight-e8": ((5, 7, 32), 8, dict(capacity_factor=0.5)),
    "grouped": ((1, 2048, 32), 4, dict(capacity_factor=1.0)),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_moe_apply_matches_reference(mode):
    """Out, lb_loss and drop_frac of the port against the reference on the
    same weights and inputs, fp32: the same routing (drop_frac exactly),
    the outputs within 1e-5."""
    shape, e, kw = MODES[mode]
    rp, tp = _layer(e=e)
    x, tx = _x(1, shape)
    want, waux = ref_moe_apply(rp, x, top_k=2, return_aux=True, **kw)
    got, gaux = moe_apply(tp, tx, top_k=2, return_aux=True, **kw)
    assert got.shape == tx.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    assert float(gaux["drop_frac"]) == float(waux["drop_frac"])
    np.testing.assert_allclose(float(gaux["lb_loss"]),
                               float(waux["lb_loss"]), rtol=1e-5)
    if kw.get("exact"):
        assert float(gaux["drop_frac"]) == 0.0
    if mode in ("capacity-drops", "capacity-tight-e8"):
        assert float(gaux["drop_frac"]) > 0.0    # the drops are exercised


def test_dispatch_matches_dense_oracle():
    _, tp = _layer()
    _, x = _x(1, (6, 11, 32))
    got = moe_apply(tp, x, top_k=2, capacity_factor=8.0)
    want = moe_apply_dense(tp, x, top_k=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)


def test_exact_mode_never_drops():
    _, tp = _layer()
    _, x = _x(2, (3, 32))
    got, aux = moe_apply(tp, x, top_k=2, exact=True, return_aux=True)
    want = moe_apply_dense(tp, x, top_k=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5)
    assert float(aux["drop_frac"]) == 0.0


@settings(max_examples=10, deadline=None)
@given(st.integers(min_value=1, max_value=4))
def test_topk_mass_and_aux(k):
    _, tp = _layer(e=8)
    _, x = _x(3, (5, 7, 32))
    out, aux = moe_apply(tp, x, top_k=k, capacity_factor=8.0,
                         return_aux=True)
    assert out.shape == x.shape
    assert float(aux["drop_frac"]) == 0.0        # cf=8 on e=8: no drops
    assert float(aux["lb_loss"]) > 0.0
    assert bool(torch.isfinite(out).all())


def test_capacity_drops_are_bounded():
    """With tight capacity some tokens drop, the output stays finite and
    close in norm."""
    _, tp = _layer()
    _, x = _x(4, (16, 16, 32))
    full = moe_apply(tp, x, top_k=2, capacity_factor=8.0)
    tight, aux = moe_apply(tp, x, top_k=2, capacity_factor=1.0,
                           return_aux=True)
    assert bool(torch.isfinite(tight).all())
    assert 0.0 < float(aux["drop_frac"]) < 0.5
    assert float(tight.norm()) <= float(full.norm()) * 1.1


def test_top_k_breaks_ties_toward_the_lower_expert():
    """Equal router probabilities: the port picks the experts
    ``jax.lax.top_k`` picks (ties toward the lower index), so routing and
    its combine order follow the reference on exact ties too."""
    from repro_torch.models.moe import _top_k
    probs = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(probs), 2)
    gv, gi = _top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_combine_adds_in_ascending_expert_order():
    """bf16: ``_combine`` gives each token its k gated expert rows added one
    at a time in ascending expert id, bit for bit (the order the
    reference's ``.at[].add`` visits the expert-sorted rows), with no
    scatter-add."""
    from repro_torch.models.moe import _combine, _experts, _route
    _, tp = _layer(e=8)
    tp = {k: v if k == "router" else v.to(torch.bfloat16)
          for k, v in tp.items()}
    _, x = _x(5, (1, 7, 32))
    x = x.to(torch.bfloat16)
    dispatched, meta = _route(tp, x, 3, cap=7)
    y = _experts(tp, dispatched)
    got = _combine(y, meta, 7, 3)
    _, _, _, _, probs, ids = meta
    gates = torch.gather(probs, -1, ids)
    gates = (gates / gates.sum(-1, keepdim=True))[0]
    for t in range(7):
        acc = None
        for e in sorted(ids[0, t].tolist()):
            j = ids[0, t].tolist().index(e)
            # expert e's rows hold its tokens in token order (stable sort)
            pos = sum(e in ids[0, u].tolist() for u in range(t))
            row = y[0, e, pos] * gates[t, j].to(torch.bfloat16)
            acc = row if acc is None else acc + row
        assert torch.equal(got[0, t], acc), t


def test_moe_is_repeatable_and_row_independent_in_exact_mode():
    """Exact routing: the same input gives the same bits on every call, and
    a token's output does not depend on the tokens routed with it (each
    decode row is its own group)."""
    _, tp = _layer(e=8)
    _, x = _x(6, (4, 1, 32))
    a = moe_apply(tp, x, top_k=2, exact=True)
    assert torch.equal(a, moe_apply(tp, x, top_k=2, exact=True))
    for i in range(4):
        alone = moe_apply(tp, x[i:i + 1], top_k=2, exact=True)
        np.testing.assert_allclose(alone.numpy(), a[i:i + 1].numpy(),
                                   atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_logits_match_reference(arch, dtype):
    """Dense prefill, dense decode, paged chunks and paged decode of the
    smoke config against the reference (``torch_parity``).  In bf16 a row
    whose call routed a token at a near tie may part (either side may pick
    either expert there): at most one such row a trace.  qwen3-moe's smoke
    weights have one (a router gap of 6e-4 at layer 1 of the prompt's
    first chunk; ROADMAP §3), where the port's bf16 row is within 1% of
    its fp32 row and the reference's 18%."""
    got, want, gaps = torch_parity.logit_rows(ref_smoke(arch),
                                              smoke_config(arch), dtype)
    parted = torch_parity.assert_logits_close(got, want, gaps, dtype)
    assert len(parted) <= 1, parted


@pytest.mark.parametrize("layout", ["dense", "paged"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_engine_tokens_equal_reference(arch, layout):
    """fp32 weights: the port's engine serves the reference's greedy tokens
    on both layouts (3 slots, 4 prompts of 4 to 13 tokens)."""
    ref_cfg, cfg = ref_smoke(arch), smoke_config(arch)
    rp, params = torch_parity.weights(ref_cfg, cfg)
    prompts = [[(5 * i + j) % cfg.vocab_size for j in range(4 + 3 * i)]
               for i in range(4)]
    kw = dict(block_size=8) if layout == "paged" else {}
    ref = RefServeEngine(ref_build(ref_cfg), rp, max_batch=3, cache_len=48,
                         kv_layout=layout, **kw)
    eng = ServeEngine(build_model(cfg), params, max_batch=3, cache_len=48,
                      kv_layout=layout, **kw)
    want = [r.tokens for r in ref.generate(
        [RefRequest(p, 6, rid=i) for i, p in enumerate(prompts)])]
    got = [r.tokens for r in eng.generate(
        [Request(p, 6, rid=i) for i, p in enumerate(prompts)])]
    assert got == want


def test_expert_leaves_cross_the_bridge():
    """The router stays fp32 in a bf16 model, and the stacked (L, E, d, f)
    expert leaves arrive bit for bit."""
    ref_cfg, cfg = ref_smoke("granite-moe-1b-a400m"), \
        smoke_config("granite-moe-1b-a400m")
    rp, params = torch_parity.weights(ref_cfg, cfg, "bfloat16")
    m = params["layers"]["moe"]
    assert m["router"].dtype == torch.float32
    assert m["gate"].dtype == torch.bfloat16
    assert tuple(m["gate"].shape) == (cfg.n_layers, cfg.n_experts,
                                      cfg.d_model, cfg.d_ff)
    assert tuple(m["down"].shape) == (cfg.n_layers, cfg.n_experts,
                                      cfg.d_ff, cfg.d_model)
    np.testing.assert_array_equal(
        m["up"].view(torch.int16).numpy(),
        np.asarray(rp["layers"]["moe"]["up"]).view(np.int16))
    assert build_model(cfg).init(0, device="cpu")["layers"]["moe"][
        "router"].dtype == torch.float32
