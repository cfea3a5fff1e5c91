"""The rest of the port's training held against the reference on the CPU:
the hybrid, ssm and encdec losses, the SSD scan under autograd and the
8-bit AdamW.

* ``SSDScan`` (``ops.ssd_scan`` under autograd): y and the gradients of x,
  dt, a_log, B, C and d_skip against ``jax.grad`` through the reference's
  ``ssd_xla``, fp32 within 1e-5 of each one's scale (G 1 and 2, with and
  without d_skip, S 64 and 128); outside autograd the plain call;
* the reference's chunked scans (``ssd_xla``, ``mlstm_parallel``) take
  exp of the masked upper triangle, which overflows past 88, so their
  gradients are NaN (0 * inf) once a chunk's decay spans that much: at
  zamba2's smoke init already, at xlstm's from S 256.  The port masks the
  exponent first; its gradients stay finite and agree with ``jax.grad``
  through the reference's sequential oracles (``ref.ssd_ref``, a scan of
  ``mlstm_step``), its forward with the chunked scans (ROADMAP section 3);
* ``Model.loss`` of zamba2-1.2b (``hybrid_loss``), xlstm-350m
  (``xlstm_loss``) and whisper-base (``encdec_loss``) at their smoke
  configs: loss, accuracy and every gradient leaf against
  ``jax.value_and_grad(model.loss)`` (its scans on the sequential oracles:
  ``oracle_scans``), fp32 within 1e-4 of each leaf's scale; ``remat`` bit
  for bit; the S contracts;
* ``AdamW8bit``: three updates' int8 and uint8 bytes equal to the
  reference's, scales and masters within rtol 1e-6; the quantization round
  trip, quadratic descent and state bytes of ``tests/test_optim8bit.py``;
* checkpoints of the 8-bit state: exact round trips, and a checkpoint the
  reference's ``Trainer`` wrote restoring bit for bit;
* the ``Trainer``: its first 3 losses against the reference's ``Trainer``
  (1x1 mesh, fp32 weights) on the three families with AdamW and on qwen3
  with ``AdamW8bit``; 8-bit 4 steps + resume equal to 6 straight;
* ``launch/train.py`` on the CPU for each of the three archs and for
  ``--opt adamw8bit``.

Weights are the reference's own ``Model.init`` carried over by the bridge;
inputs are made from a seed with numpy and handed to both sides.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke
from repro.data import SyntheticTokens as RefSyntheticTokens
from repro.distributed.sharding import ShardingPolicy
from repro.kernels import ops as ref_ops
from repro.kernels.ref import ssd_ref
from repro.kernels.ssd_scan import ssd_xla
from repro.launch.mesh import make_mesh
from repro.models import build_model as ref_build
from repro.models import layers as jlayers
from repro.models import xlstm as jxlstm
from repro.optim import AdamW as RefAdamW
from repro.optim import AdamW8bit as RefAdamW8bit
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.train import TrainConfig as RefTrainConfig
from repro.train import Trainer as RefTrainer
from repro_torch.bridge import params_from_reference
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.optim import AdamW, AdamW8bit, warmup_cosine
from repro_torch.optim import adamw8bit
from repro_torch.train import TrainConfig, Trainer
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import tree_leaves, tree_map

@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them about
    as fast as many and keeps parallel test workers off each other's
    cores.  The old count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


def _scale_close(got, want, tol, what=""):
    """|got - want| within ``tol`` of want's largest magnitude."""
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3e} of scale {scale:.3e} > {tol}"


# ---------------------------------------------------------------------------
# The SSD scan under autograd.
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, *, b=2, s=64, h=4, p=8, g=1, n=8):
    rng = np.random.default_rng(seed)
    return dict(
        x=rng.standard_normal((b, s, h, p)).astype(np.float32),
        dt=rng.uniform(0.01, 0.2, (b, s, h)).astype(np.float32),
        a_log=rng.uniform(-1.0, 1.0, (h,)).astype(np.float32),
        b_mat=rng.standard_normal((b, s, g, n)).astype(np.float32),
        c_mat=rng.standard_normal((b, s, g, n)).astype(np.float32),
        d_skip=rng.standard_normal((h,)).astype(np.float32),
        dy=rng.standard_normal((b, s, h, p)).astype(np.float32))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("with_skip", [True, False])
@pytest.mark.parametrize("s", [64, 128])          # one chunk, two chunks
def test_ssd_scan_autograd_matches_reference(g, with_skip, s):
    inp = _ssd_inputs(g * 7 + s + with_skip, s=s, g=g)
    names = ["x", "dt", "a_log", "b_mat", "c_mat"] + (
        ["d_skip"] if with_skip else [])

    def ref(*args):
        kw = dict(zip(names, args))
        y, _ = ssd_xla(kw["x"], kw["dt"], kw["a_log"], kw["b_mat"],
                       kw["c_mat"], d_skip=kw.get("d_skip"))
        return jnp.sum(y * jnp.asarray(inp["dy"])), y
    (_, ry), rg = jax.jit(jax.value_and_grad(
        ref, argnums=tuple(range(len(names))), has_aux=True))(
        *(jnp.asarray(inp[k]) for k in names))
    leaves = {k: _t(inp[k]).requires_grad_() for k in names}
    y, h_final = ops.ssd_scan(leaves["x"], leaves["dt"], leaves["a_log"],
                              leaves["b_mat"], leaves["c_mat"],
                              d_skip=leaves.get("d_skip"))
    assert "SSDScan" in type(y.grad_fn).__name__
    assert not h_final.requires_grad
    (y * _t(inp["dy"])).sum().backward()
    _scale_close(y.detach().numpy(), ry, 1e-5, "y")
    for k, want in zip(names, rg):
        _scale_close(leaves[k].grad.numpy(), want, 1e-5, f"d{k}")


def test_ssd_scan_outside_autograd_is_the_plain_call():
    """Without an input that requires grad, or under no_grad, ops.ssd_scan
    is the plain call (no graph); with one, only the inputs that require
    grad get a gradient."""
    inp = _ssd_inputs(3, s=128, g=2)
    args = [_t(inp[k]) for k in ("x", "dt", "a_log", "b_mat", "c_mat")]
    skip = _t(inp["d_skip"])
    want = ss.ssd_plain(*args, d_skip=skip)
    got = ops.ssd_scan(*args, d_skip=skip)
    assert got[0].grad_fn is None
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    x = args[0].clone().requires_grad_()
    with torch.no_grad():
        y, _ = ops.ssd_scan(x, *args[1:], d_skip=skip)
    assert y.grad_fn is None and torch.equal(y, want[0])
    y, _ = ops.ssd_scan(x, *args[1:], d_skip=skip)
    assert torch.equal(y.detach(), want[0])
    y.sum().backward()
    assert x.grad is not None and args[1].grad is None


def test_ssd_scan_refuses_a_gradient_through_h0():
    """SSDScan's backward gives h0 no gradient, so an h0 that requires
    grad raises rather than dropping its gradient."""
    inp = _ssd_inputs(5, s=64, g=1)
    args = [_t(inp[k]) for k in ("x", "dt", "a_log", "b_mat", "c_mat")]
    b, _, h, p = args[0].shape
    h0 = torch.zeros((b, h, p, args[3].shape[-1]), requires_grad=True)
    with pytest.raises(NotImplementedError, match="h0"):
        ops.ssd_scan(*args, h0=h0)


# ---------------------------------------------------------------------------
# The reference's chunked scans overflow in their gradients; its
# sequential oracles do not.
# ---------------------------------------------------------------------------

def _ssd_oracle(x, dt, a_log, b_mat, c_mat, *, d_skip=None, h0=None):
    """The reference's ``ops.ssd_scan`` on its sequential oracle."""
    return ssd_ref(x, dt, a_log, b_mat, c_mat, d_skip=d_skip, h0=h0)


def _mlstm_oracle(q, k, v, i_gate, f_gate, *, chunk=256, state=None):
    """The reference's ``mlstm_parallel`` as a scan of its ``mlstm_step``
    (``tests/test_xlstm.py``'s oracle): y is the same function."""
    b, h, _, dk = q.shape
    if state is None:
        state = (jnp.zeros((b, h, dk, v.shape[-1])), jnp.zeros((b, h, dk)),
                 jnp.full((b, h), -1e30))

    def step(st, inp):
        return jxlstm.mlstm_step(st, *inp)
    state, ys = jax.lax.scan(step, state, tuple(
        jnp.moveaxis(a, 2, 0) for a in (q, k, v, i_gate, f_gate)))
    return jnp.moveaxis(ys, 0, 2), state


# the port's chunked scans against the sequential oracles' gradients: the
# oracle multiplies S decays one by one where a chunk takes the exp of
# their sum, so long sums of cancelling terms (a_log's gradient, 1.4e-4 of
# its scale at the SSD case below) round apart more than one algorithm's
# two implementations do
ORACLE_TOL = 5e-4


@pytest.fixture
def oracle_scans(monkeypatch):
    """The reference's loss with its SSD and mLSTM scans on their
    sequential oracles (its chunked scans' gradients overflow to NaN)."""
    monkeypatch.setattr(ref_ops, "ssd_scan", _ssd_oracle)
    monkeypatch.setattr(jxlstm, "mlstm_parallel", _mlstm_oracle)


def test_ssd_gradients_finite_where_the_reference_overflows():
    """dt * exp(a_log) summing past 88 in a 64-token chunk: jax.grad
    through ``ssd_xla`` is NaN, the port's SSDScan is finite, its
    gradients match ``jax.grad`` through ``ssd_ref`` within ORACLE_TOL of
    scale and its y ``ssd_xla``'s."""
    inp = _ssd_inputs(21, s=128, g=2)
    inp["dt"] = np.random.default_rng(22).uniform(
        0.5, 2.0, inp["dt"].shape).astype(np.float32)
    inp["a_log"] = np.log(np.linspace(1.0, 16.0, 4)).astype(np.float32)
    names = ("x", "dt", "a_log", "b_mat", "c_mat", "d_skip")

    def ref(fn):
        def loss(*args):
            y, _ = fn(*args[:5], d_skip=args[5])
            return jnp.sum(y * jnp.asarray(inp["dy"])), y
        return jax.jit(jax.value_and_grad(loss, argnums=tuple(range(6)),
                                          has_aux=True))(
            *(jnp.asarray(inp[k]) for k in names))
    (_, chunked_y), chunked = ref(ssd_xla)
    (_, oracle_y), oracle = ref(ssd_ref)
    assert any(np.isnan(np.asarray(g)).any() for g in chunked)
    leaves = {k: _t(inp[k]).requires_grad_() for k in names}
    y, _ = ops.ssd_scan(*(leaves[k] for k in names[:5]),
                        d_skip=leaves["d_skip"])
    (y * _t(inp["dy"])).sum().backward()
    _scale_close(y.detach().numpy(), chunked_y, 1e-6, "y")
    _scale_close(y.detach().numpy(), oracle_y, 1e-5, "y (oracle)")
    for k, want in zip(names, oracle):
        assert torch.isfinite(leaves[k].grad).all(), k
        _scale_close(leaves[k].grad.numpy(), want, ORACLE_TOL, f"d{k}")


def test_mlstm_gradients_finite_where_the_reference_overflows():
    """A 256-token chunk whose forget gates sum past 88: jax.grad through
    ``mlstm_parallel`` is NaN, the port's is finite, matches jax.grad
    through the ``mlstm_step`` scan within ORACLE_TOL of scale, and its y
    ``mlstm_parallel``'s."""
    from repro_torch.models import xlstm
    rng = np.random.default_rng(23)
    b, h, s, d = 1, 2, 256, 8
    q, k, v, dy = (rng.standard_normal((b, h, s, d)).astype(np.float32)
                   for _ in range(4))
    ig = rng.standard_normal((b, h, s)).astype(np.float32)
    fg = (rng.standard_normal((b, h, s)) - 1.0).astype(np.float32)
    args = (q, k, v, ig, fg)

    def ref(fn):
        def loss(*a):
            y, _ = fn(*a)
            return jnp.sum(y * jnp.asarray(dy)), y
        return jax.jit(jax.value_and_grad(loss, argnums=tuple(range(5)),
                                          has_aux=True))(
            *map(jnp.asarray, args))
    (_, chunked_y), chunked = ref(jxlstm.mlstm_parallel)
    (_, oracle_y), oracle = ref(_mlstm_oracle)
    assert any(np.isnan(np.asarray(g)).any() for g in chunked)
    leaves = [_t(a).requires_grad_() for a in args]
    y, _ = xlstm.mlstm_parallel(*leaves)
    (y * _t(dy)).sum().backward()
    _scale_close(y.detach().numpy(), chunked_y, 1e-5, "y")
    _scale_close(y.detach().numpy(), oracle_y, 1e-5, "y (oracle)")
    for name, got, want in zip("qkvif", leaves, oracle):
        assert torch.isfinite(got.grad).all(), name
        _scale_close(got.grad.numpy(), want, ORACLE_TOL, f"d{name}")


# ---------------------------------------------------------------------------
# hybrid_loss, xlstm_loss and encdec_loss against the reference's loss.
# ---------------------------------------------------------------------------

def _fp32_weights(arch, seed=0):
    rcfg, cfg = ref_smoke(arch), smoke_config(arch)
    rp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      ref_build(rcfg).init(jax.random.key(seed)))
    return rcfg, cfg, rp, params_from_reference(
        jax.tree.map(np.asarray, rp), cfg, device="cpu")


def _batch(cfg, *, b=2, s=64, s_enc=40, masked=False, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if masked:
        out["label_mask"] = (rng.random((b, s)) > 0.3).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (b, s_enc, cfg.d_model)).astype(np.float32)
    return out


def _port_loss(model, params, batch, remat):
    """(loss, metrics, gradient leaves in the reference's order) of the
    port's Model.loss on fresh leaves that require grad."""
    params = tree_map(lambda x: x.detach().clone().requires_grad_(), params)
    loss, metrics = model.loss(params, {n: _t(a) for n, a in batch.items()},
                               remat=remat)
    loss.backward()
    return loss.detach(), metrics, [x.grad for x in tree_leaves(params)]


# (arch, S, masked): zamba2 at S 64 with a label mask; xlstm at S 128, two
# checkpointed sLSTM segments of 64; whisper's 32 tokens over 40 frames
LOSS_CASES = (("zamba2-1.2b", 64, True), ("xlstm-350m", 128, False),
              ("whisper-base", 32, False))


@pytest.mark.parametrize("arch,s,masked", LOSS_CASES)
def test_family_loss_matches_reference(arch, s, masked, oracle_scans):
    """Loss, accuracy and every gradient leaf in fp32 (1e-4 of each leaf's
    scale; the leaves in the reference's flattening order), and remat=True
    bit for bit equal to remat=False in the port; every gradient finite."""
    rcfg, cfg, rp, tp = _fp32_weights(arch)
    batch = _batch(cfg, s=s, masked=masked)
    (rl, rmet), rg = jax.jit(jax.value_and_grad(ref_build(rcfg).loss,
                                                has_aux=True))(
        rp, {n: jnp.asarray(a) for n, a in batch.items()})
    model = build_model(cfg)
    loss, metrics, grads = _port_loss(model, tp, batch, remat=True)
    np.testing.assert_allclose(float(loss), float(rl), rtol=1e-5)
    assert float(metrics["accuracy"]) == pytest.approx(
        float(rmet["accuracy"]), abs=1e-7)
    ref_leaves = jax.tree_util.tree_leaves(rg)
    assert len(ref_leaves) == len(grads)
    for i, (got, want) in enumerate(zip(grads, ref_leaves)):
        assert torch.isfinite(got).all(), f"{arch} leaf {i}"
        _scale_close(got.numpy(), want, 1e-4, f"{arch} leaf {i}")
    loss2, _, grads2 = _port_loss(model, tp, batch, remat=False)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))


@pytest.mark.parametrize("arch,s", [("zamba2-1.2b", 96),
                                    ("xlstm-350m", 320)])
def test_family_loss_sequence_contract(arch, s):
    """hybrid: S at most 64 or a multiple of 64 (the SSD chunk); xlstm: at
    most 256 or a multiple of 256 (the mLSTM chunk)."""
    cfg = smoke_config(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    batch = {n: _t(a) for n, a in _batch(cfg, b=1, s=s).items()}
    with pytest.raises(ValueError, match="multiple of"):
        model.loss(params, batch)


# ---------------------------------------------------------------------------
# AdamW8bit.
# ---------------------------------------------------------------------------

# a last axis past one block and not a multiple of it; a leaf whose first
# row's gradients are zero (a zero block at every step); a 1-D leaf (no
# decay)
SHAPES8 = {"w": (6, 300), "z": (4, 256), "norm": (40,)}


def _tree8(rng, scale=1.0, zero_row=False):
    t = {k: (rng.standard_normal(s) * scale).astype(np.float32)
         for k, s in SHAPES8.items()}
    if zero_row:
        t["z"][0] = 0.0
    return t


@pytest.mark.parametrize("lr", [2e-2, "warmup_cosine"])
def test_adamw8bit_three_updates_match_reference(lr):
    rng = np.random.default_rng(4)
    params = _tree8(rng)
    grads = [_tree8(rng, 0.1, zero_row=True) for _ in range(3)]
    kw = dict(weight_decay=0.1)
    ref_opt = RefAdamW8bit(lr=(ref_warmup_cosine(3e-2, 2, 10)
                               if lr == "warmup_cosine" else lr), **kw)
    opt = AdamW8bit(lr=warmup_cosine(3e-2, 2, 10) if lr == "warmup_cosine"
                    else lr, **kw)
    rstate = ref_opt.init({k: jnp.asarray(v) for k, v in params.items()})
    state = opt.init({k: _t(v) for k, v in params.items()})
    for g in grads:
        rstate = ref_opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                rstate)
        state = opt.update({k: _t(v) for k, v in g.items()}, state)
    assert int(state["step"]) == int(rstate["step"]) == 3
    for k in SHAPES8:
        for part, dtype in (("m", torch.int8), ("v", torch.uint8)):
            q, rq = state[part][k]["q"], np.asarray(rstate[part][k]["q"])
            assert q.dtype == dtype and q.shape == rq.shape
            assert q.numpy().tobytes() == rq.tobytes(), f"{part} {k}"
            np.testing.assert_allclose(state[part][k]["s"].numpy(),
                                       np.asarray(rstate[part][k]["s"]),
                                       rtol=1e-6)
        np.testing.assert_allclose(state["master"][k].numpy(),
                                   np.asarray(rstate["master"][k]),
                                   rtol=1e-6, atol=1e-9)
    # the zero row is one zero block: scale 1.0, q 0
    assert float(state["m"]["z"]["s"][0, 0]) == 1.0
    assert not state["m"]["z"]["q"][0].any()
    # with zero gradients the update is the decay alone: the 1-D leaf
    # keeps its master, the others shrink by lr * wd * master
    zero = AdamW8bit(lr=0.5, weight_decay=0.1)
    st = zero.init({k: _t(v) for k, v in params.items()})
    zero.update({k: torch.zeros(s) for k, s in SHAPES8.items()}, st)
    assert torch.equal(st["master"]["norm"], _t(params["norm"]))
    torch.testing.assert_close(st["master"]["w"], _t(params["w"]) * 0.95)


def test_quantization_roundtrip():
    """As the reference's test: m within a 120th of its max, v within a
    100th of its max."""
    x = _t(np.random.default_rng(0).standard_normal((4, 300)).astype(
        np.float32))
    q, s = adamw8bit._q_sym(x)
    assert q.dtype == torch.int8 and q.shape == (4, 512) and s.shape == (4, 2)
    torch.testing.assert_close(adamw8bit._dq(q, s, x.shape), x, rtol=0,
                               atol=float(x.abs().max()) / 120)
    v = x * x
    q, s = adamw8bit._q_pos(v)
    assert q.dtype == torch.uint8
    torch.testing.assert_close(adamw8bit._dq(q, s, v.shape, square=True), v,
                               rtol=0, atol=float(v.max()) / 100)


def test_8bit_trains_comparably():
    """On a quadratic, 40 steps of the 8-bit AdamW descend strongly and
    within a factor of the fp32 AdamW's loss, as the reference's test."""
    target = _t(np.random.default_rng(1).standard_normal((32, 32)).astype(
        np.float32))

    def run(opt):
        state = opt.init({"w": torch.zeros((32, 32))})
        for _ in range(40):
            w = state["master"]["w"].clone().requires_grad_()
            torch.mean((w - target) ** 2).backward()
            state = opt.update({"w": w.grad}, state)
        return float(torch.mean((state["master"]["w"] - target) ** 2))

    init = float(torch.mean(target ** 2))
    l32 = run(AdamW(lr=5e-2, weight_decay=0.0))
    l8 = run(AdamW8bit(lr=5e-2, weight_decay=0.0))
    assert l8 < 0.15 * init, (l8, init)
    assert l8 < 6 * l32 + 1e-3, (l8, l32)


def test_8bit_state_bytes():
    """m in about 1.06 bytes a parameter instead of 4."""
    st = AdamW8bit().init({"w": torch.zeros((1024, 1024))})
    m = st["m"]["w"]
    assert m["q"].numel() * 1 + m["s"].numel() * 4 < 1024 * 1024 * 1.1


# ---------------------------------------------------------------------------
# Checkpoints of the 8-bit state.
# ---------------------------------------------------------------------------

def test_checkpoint_round_trips_the_8bit_state(tmp_path):
    rng = np.random.default_rng(8)
    opt = AdamW8bit(lr=1e-2)
    state = opt.init({k: _t(v) for k, v in _tree8(rng).items()})
    state = opt.update({k: _t(v) for k, v in _tree8(rng).items()}, state)
    ckpt.save(str(tmp_path), 1, state)
    step, tree = ckpt.restore(str(tmp_path))
    assert step == 1
    la, lb = tree_leaves(state), tree_leaves(tree)
    assert len(la) == len(lb)
    assert {x.dtype for x in lb} == {torch.float32, torch.int8, torch.uint8,
                                     torch.int32}
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(la, lb))


def _fp32_templates(templates, pt_cls):
    return jax.tree.map(lambda t: dataclasses.replace(t, dtype=jnp.float32),
                        templates, is_leaf=lambda x: isinstance(x, pt_cls))


def _ref_trainer_run(arch, opt_cls, *, b, s, steps=3, ckpt_dir=None):
    """The reference's Trainer (1x1 mesh, fp32 templates) from its own
    fp32 init: (its log, its final state, the port's copy of the initial
    weights)."""
    rcfg, cfg = ref_smoke(arch), smoke_config(arch)
    rmodel = ref_build(rcfg)
    rmodel = dataclasses.replace(
        rmodel, templates=_fp32_templates(rmodel.templates, jlayers.PT))
    rp = rmodel.init(jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, rp), cfg,
                               device="cpu")   # before rp is donated
    ropt = opt_cls(lr=ref_warmup_cosine(3e-3, 2, 20))
    rtrainer = RefTrainer(rmodel, ropt, ShardingPolicy(),
                          make_mesh((1, 1), ("data", "model")),
                          RefSyntheticTokens(rcfg, b, s, seed=0),
                          RefTrainConfig(steps=steps, log_every=100,
                                         ckpt_dir=ckpt_dir,
                                         ckpt_async=False),
                          log=lambda m: None)
    rstate, rlog = rtrainer.run(state=ropt.init(rp))
    return rlog, rstate, tp


# ---------------------------------------------------------------------------
# The Trainer.
# ---------------------------------------------------------------------------

def _fp32_model(model):
    """The model with every template in fp32: the trainer computes in fp32
    (its compute dtypes are the templates')."""
    def walk(t):
        return {k: walk(v) if isinstance(v, dict)
                else dataclasses.replace(v, dtype=torch.float32)
                for k, v in t.items()}
    return dataclasses.replace(model, templates=walk(model.templates))


def _port_trainer_log(arch, opt_cls, tp, *, b, s, steps=3):
    cfg = smoke_config(arch)
    opt = opt_cls(lr=warmup_cosine(3e-3, 2, 20))
    trainer = Trainer(_fp32_model(build_model(cfg)), opt,
                      SyntheticTokens(cfg, b, s, seed=0),
                      TrainConfig(steps=steps, log_every=100), device="cpu",
                      log=lambda m: None)
    return trainer.run(state=opt.init(tp))[1]


def _same_losses(log, rlog):
    assert len(log) == len(rlog) == 3
    for got, want in zip(log, rlog):
        assert np.isfinite(got["loss"]) and np.isfinite(got["grad_norm"])
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)


@pytest.mark.parametrize("arch,s", [("zamba2-1.2b", 64), ("xlstm-350m", 64),
                                    ("whisper-base", 32)])
def test_trainer_matches_reference_trainer(arch, s, oracle_scans):
    """The slice as a whole: the first 3 losses and grad norms of the
    port's Trainer against the reference's Trainer on a 1x1 mesh (its
    scans on the sequential oracles), both in fp32 from the same weights
    and the same batches, with AdamW."""
    rlog, _, tp = _ref_trainer_run(arch, RefAdamW, b=2, s=s)
    _same_losses(_port_trainer_log(arch, AdamW, tp, b=2, s=s), rlog)


def test_trainer_8bit_matches_reference_and_restores_its_checkpoint(
        tmp_path):
    """The reference's Trainer on the smoke qwen3 with AdamW8bit, 3 steps,
    its checkpoint written at the end: the port's Trainer from the same
    weights follows its losses and grad norms, and the port restores its
    checkpoint bit for bit, the int8 and uint8 leaves in their dtypes."""
    rlog, rstate, tp = _ref_trainer_run("qwen3-0.6b", RefAdamW8bit, b=2,
                                        s=32, ckpt_dir=str(tmp_path))
    _same_losses(_port_trainer_log("qwen3-0.6b", AdamW8bit, tp, b=2, s=32),
                 rlog)
    step, tree = ckpt.restore(str(tmp_path))
    assert step == 3
    want = jax.tree_util.tree_leaves(jax.tree.map(np.asarray, rstate))
    got = tree_leaves(tree)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert str(a.dtype)[6:] == str(b.dtype)
        assert a.numpy().tobytes() == b.tobytes()
    assert tree["m"]["embed"]["embedding"]["q"].dtype == torch.int8
    assert tree["v"]["embed"]["embedding"]["q"].dtype == torch.uint8


def test_trainer_8bit_resume_is_bit_exact(tmp_path):
    """With AdamW8bit: 6 straight steps against 4, a checkpoint, and a
    resume to 6: the same losses at steps 5 and 6 and the same final
    state, int8 and uint8 leaves included, bit for bit."""
    cfg = smoke_config("qwen3-0.6b")

    def trainer(sub, steps):
        tc = TrainConfig(steps=steps, ckpt_dir=str(tmp_path / sub),
                         ckpt_every=4, log_every=1)
        return Trainer(build_model(cfg),
                       AdamW8bit(lr=warmup_cosine(3e-3, 2, 20)),
                       SyntheticTokens(cfg, 2, 32, seed=0), tc, device="cpu",
                       log=lambda m: None)
    state_a, log_a = trainer("a", 6).run()
    trainer("b", 4).run()
    state_b, log_b = trainer("b", 6).run()
    assert [r["loss"] for r in log_a[4:]] == [r["loss"] for r in log_b]
    assert state_b["m"]["embed"]["embedding"]["q"].dtype == torch.int8
    assert all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip(tree_leaves(state_a), tree_leaves(state_b)))


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flags", [["--arch", "zamba2-1.2b"],
                                   ["--arch", "xlstm-350m"],
                                   ["--arch", "whisper-base"],
                                   ["--opt", "adamw8bit"]])
def test_launch_train_families_on_the_cpu(flags, tmp_path, capsys):
    log = launch_train.main(["--smoke", "--steps", "3", "--device", "cpu",
                             "--batch", "2", "--seq", "64",
                             "--ckpt-dir", str(tmp_path), *flags])
    assert [r["step"] for r in log] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert "[train] done" in capsys.readouterr().out
    assert (tmp_path / "step_00000003" / "tree.json").exists()
