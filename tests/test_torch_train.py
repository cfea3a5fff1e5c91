"""The port's training path (``repro_torch.models``, ``repro_torch.train``,
``repro_torch.launch.train``) held against the reference's on the CPU.

* ``softmax_xent_chunked``: loss, accuracy and the gradients of h and w
  against ``jax.value_and_grad`` of the reference's, fp32 within 1e-5;
* the flash autograd path: the plain forward (with its log-sum-exp) and
  ``flash_attention_backward_plain`` against ``jax.vjp`` through the
  reference's ``attention_xla`` (its custom-VJP flash backward), and
  ``ops.attention`` under autograd (``FlashAttention``), fp32 within 1e-5;
* the moe layer's capacity routing under autograd, with assignments
  dropped, against the reference's gradients;
* ``Model.loss`` (``decoder_loss``): loss, accuracy and every gradient leaf
  against ``jax.value_and_grad(model.loss)`` on the smoke configs of
  qwen3-0.6b, gemma3-27b (windows, softcap), granite-moe-1b-a400m and
  phi-3-vision-4.2b (patches), fp32 within 1e-4 of each leaf's scale;
  ``remat`` bit for bit; qwen3 in bf16 against the reference's fp32 loss;
* the ``Trainer``: the loss falls, resume counts its steps, 4 + resume
  equals 6 straight bit for bit, the watchdog, and its first losses against
  the reference's ``Trainer`` on a 1x1 mesh from the same fp32 weights;
* ``launch/train.py`` on the CPU, and the distributed flags it refuses.

The hybrid, ssm and encdec losses, ``SSDScan`` and the 8-bit AdamW are
held in ``test_torch_train_families.py``.

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
from repro.kernels.attention import attention_xla
from repro.launch.mesh import make_mesh
from repro.models import build_model as ref_build
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.optim import AdamW as RefAdamW
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.distributed.sharding import ShardingPolicy
from repro.data import SyntheticTokens as RefSyntheticTokens
from repro.train import TrainConfig as RefTrainConfig
from repro.train import Trainer as RefTrainer
from repro_torch.bridge import params_from_reference
from repro_torch.configs import smoke_config
from repro_torch.data import SyntheticTokens
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model, layers, moe
from repro_torch.optim import AdamW, warmup_cosine
from repro_torch.train import TrainConfig, Trainer, Watchdog
from repro_torch.tree import tree_leaves, tree_map

TOL = dict(rtol=1e-5, atol=1e-5)


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
# Chunked cross-entropy.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,chunk,v,valid,softcap,masked", [
    (32, 16, 64, None, None, False),
    (32, 8, 64, 50, None, True),          # padded vocab, label mask
    (24, 16, 64, None, 5.0, False),       # chunk shrinks to 12; softcap
    (24, 16, 96, 80, 3.0, True),          # all of it
])
def test_xent_chunked_matches_reference(s, chunk, v, valid, softcap, masked):
    rng = np.random.default_rng(s + v)
    b, d = 2, 16
    h = rng.standard_normal((b, s, d)).astype(np.float32)
    w = (rng.standard_normal((d, v)) * 0.5).astype(np.float32)
    labels = rng.integers(0, valid or v, (b, s)).astype(np.int32)
    mask = ((rng.random((b, s)) > 0.3).astype(np.float32) if masked
            else None)
    kw = dict(chunk=chunk, logit_softcap=softcap, valid_vocab=valid)

    def ref_loss(hh, ww):
        return jlayers.softmax_xent_chunked(
            hh, ww, jnp.asarray(labels),
            label_mask=None if mask is None else jnp.asarray(mask), **kw)
    (rl, racc), (rgh, rgw) = jax.jit(jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True))(jnp.asarray(h),
                                                 jnp.asarray(w))
    th, tw = _t(h).requires_grad_(), _t(w).requires_grad_()
    loss, acc = layers.softmax_xent_chunked(
        th, tw, _t(labels), label_mask=None if mask is None else _t(mask),
        **kw)
    loss.backward()
    np.testing.assert_allclose(float(loss), float(rl), **TOL)
    assert float(acc) == pytest.approx(float(racc), abs=1e-7)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(rgh), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(rgw), **TOL)


def test_xent_argmax_takes_the_first_maximum():
    """Tied logits count as correct only at the first maximal column."""
    h = torch.ones((1, 2, 1))
    w = torch.ones((1, 4))                       # every logit equal
    _, acc = layers.softmax_xent_chunked(h, w, torch.tensor([[0, 3]]))
    assert float(acc) == 0.5


# ---------------------------------------------------------------------------
# Flash attention under autograd.
# ---------------------------------------------------------------------------

def _attn_inputs(seed, *, b=2, hkv=2, g=2, s=64, d=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hkv * g, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv * g, s, d)).astype(np.float32))


@pytest.mark.parametrize("g,causal,window", [(1, True, None),
                                             (2, True, None),
                                             (2, True, 24),
                                             (2, False, None)])
def test_flash_backward_plain_matches_reference(g, causal, window):
    """Several q and kv chunks walked (16 of 64): out, lse and (dq, dk,
    dv) against jax.vjp through attention_xla at the same chunks."""
    q, k, v, do = _attn_inputs(g * 10 + (window or 0), g=g)
    kw = dict(causal=causal, window=window)
    chunks = dict(q_chunk=16, kv_chunk=16)
    def ref(a, b_, c, dout):
        out, vjp = jax.vjp(lambda *x: attention_xla(*x, **kw, **chunks),
                           a, b_, c)
        return (out, *vjp(dout))
    rout, rdq, rdk, rdv = jax.jit(ref)(*map(jnp.asarray, (q, k, v, do)))
    out, lse = fa.flash_attention_plain(_t(q), _t(k), _t(v), **kw, **chunks,
                                        return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), **TOL)
    # lse: the log-sum-exp of each row's visible scaled logits
    logits = torch.einsum("bhqd,bhkd->bhqk", _t(q),
                          _t(k).repeat_interleave(g, dim=1)) / 4.0
    pos = torch.arange(64)
    logits = torch.where(fa._mask(pos, pos, causal, window), logits, -1e30)
    np.testing.assert_allclose(lse.numpy(),
                               torch.logsumexp(logits, -1).numpy(), **TOL)
    grads = fa.flash_attention_backward_plain(_t(q), _t(k), _t(v), out, lse,
                                              _t(do), **kw, **chunks)
    for got, want in zip(grads, (rdq, rdk, rdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ops_attention_autograd_matches_reference():
    """ops.attention with inputs that require grad goes through
    FlashAttention; its gradients against jax.grad through attention_xla
    (default chunks), windowed, g 2; without grad it is the plain call."""
    q, k, v, do = _attn_inputs(7, g=2)
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    out = ops.attention(tq, tk, tv, causal=True, window=20)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    (out * _t(do)).sum().backward()
    rg = jax.jit(jax.grad(lambda a, b_, c: jnp.sum(
        attention_xla(a, b_, c, causal=True, window=20) * jnp.asarray(do)),
        argnums=(0, 1, 2)))(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for got, want in zip((tq.grad, tk.grad, tv.grad), rg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with torch.no_grad():
        plain = ops.attention(tq, tk, tv, causal=True, window=20)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def test_flash_backward_plain_keeps_dtypes():
    q, k, v, do = (_t(x).to(torch.bfloat16) for x in _attn_inputs(3))
    out, lse = fa.flash_attention_plain(q, k, v, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:3]
    grads = fa.flash_attention_backward_plain(q, k, v, out, lse, do)
    assert [x.dtype for x in grads] == [torch.bfloat16] * 3


# ---------------------------------------------------------------------------
# moe: capacity routing under autograd.
# ---------------------------------------------------------------------------

def test_moe_capacity_gradients_match_reference():
    """Capacity factor 0.75 drops assignments: the output and the
    gradients of x, the router and the experts against the reference's."""
    rng = np.random.default_rng(5)
    d, f, e, k, b, s = 16, 32, 4, 2, 2, 24
    p = {"router": rng.standard_normal((d, e)).astype(np.float32),
         "gate": (rng.standard_normal((e, d, f)) * 0.3).astype(np.float32),
         "up": (rng.standard_normal((e, d, f)) * 0.3).astype(np.float32),
         "down": (rng.standard_normal((e, f, d)) * 0.3).astype(np.float32)}
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    dy = rng.standard_normal((b, s, d)).astype(np.float32)
    kw = dict(top_k=k, capacity_factor=0.75)

    def ref(pp, xx):
        out, aux = jmoe.moe_apply(pp, xx, return_aux=True, **kw)
        return jnp.sum(out * jnp.asarray(dy)), aux
    (_, raux), (rgp, rgx) = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True))(
        {n: jnp.asarray(a) for n, a in p.items()}, jnp.asarray(x))
    tp = {n: _t(a).requires_grad_() for n, a in p.items()}
    tx = _t(x).requires_grad_()
    out, aux = moe.moe_apply(tp, tx, return_aux=True, **kw)
    assert float(aux["drop_frac"]) > 0.2
    assert float(aux["drop_frac"]) == pytest.approx(float(raux["drop_frac"]))
    (out * _t(dy)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rgx), **TOL)
    for n in p:
        np.testing.assert_allclose(tp[n].grad.numpy(), np.asarray(rgp[n]),
                                   **TOL)


# ---------------------------------------------------------------------------
# decoder_loss against the reference's Model.loss.
# ---------------------------------------------------------------------------

def _fp32_weights(arch, seed=0):
    rcfg, cfg = ref_smoke(arch), smoke_config(arch)
    rp = jax.tree.map(lambda a: a.astype(jnp.float32),
                      ref_build(rcfg).init(jax.random.key(seed)))
    return rcfg, cfg, rp, params_from_reference(
        jax.tree.map(np.asarray, rp), cfg, device="cpu")


def _batch(cfg, b=2, s=32, seed=1):
    rng = np.random.default_rng(seed)
    st = s - (cfg.n_patches if cfg.family == "vlm" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, st)).astype(
               np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, st)).astype(
               np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.patch_embed_dim)).astype(np.float32)
    return out


def _port_loss(model, params, batch, remat):
    """(loss, metrics, gradient leaves in the reference's order) of the
    port's Model.loss on fresh leaves that require grad."""
    params = tree_map(lambda x: x.detach().clone().requires_grad_(), params)
    loss, metrics = model.loss(params, {n: _t(a) for n, a in batch.items()},
                               remat=remat)
    loss.backward()
    return loss, metrics, [x.grad for x in tree_leaves(params)]


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-27b",
                                  "granite-moe-1b-a400m",
                                  "phi-3-vision-4.2b"])
def test_decoder_loss_matches_reference(arch):
    """Loss, accuracy and every gradient leaf in fp32 (1e-4 of each
    leaf's scale; the leaves in the reference's flattening order), and
    remat=True bit for bit equal to remat=False in the port.  For qwen3
    also the port in bf16 on the reference init's own bf16 weights (the
    fp32 weights are their exact casts): its loss within 2e-2 (relative)
    of the reference's fp32 loss, bf16 rounding activations at every
    layer, and its gradients in bf16."""
    rcfg, cfg, rp, tp = _fp32_weights(arch)
    batch = _batch(cfg)
    if cfg.local_window:
        assert 32 > cfg.local_window          # the window cuts the context
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
        _scale_close(got.numpy(), want, 1e-4, f"{arch} leaf {i}")
    loss2, _, grads2 = _port_loss(model, tp, batch, remat=False)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    if arch == "qwen3-0.6b":
        tp16 = params_from_reference(
            jax.tree.map(np.asarray, ref_build(rcfg).init(jax.random.key(0))),
            cfg, device="cpu")
        loss16, _, grads16 = _port_loss(model, tp16, batch, remat=True)
        assert all(g.dtype == torch.bfloat16 for g in grads16)
        np.testing.assert_allclose(float(loss16), float(rl), rtol=2e-2)


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


def _trainer(ckpt_dir=None, steps=6, log=lambda s: None, ckpt_every=4):
    cfg = smoke_config("qwen3-0.6b")
    tc = TrainConfig(steps=steps, ckpt_dir=ckpt_dir and str(ckpt_dir),
                     ckpt_every=ckpt_every, log_every=1)
    return Trainer(build_model(cfg), AdamW(lr=warmup_cosine(3e-3, 2, 20)),
                   SyntheticTokens(cfg, 2, 32, seed=0), tc, device="cpu",
                   log=log)


def test_trainer_loss_falls_and_resume_counts_steps(tmp_path):
    _, rows = _trainer(tmp_path, steps=8).run()
    assert [r["step"] for r in rows] == list(range(1, 9))
    assert rows[-1]["loss"] < rows[0]["loss"] - 0.05
    msgs = []
    _, rows2 = _trainer(tmp_path, steps=11, log=msgs.append).run()
    assert "[trainer] resumed from step 8" in msgs
    assert [r["step"] for r in rows2] == [9, 10, 11]


def test_trainer_resume_is_bit_exact(tmp_path):
    """6 straight steps against 4, a checkpoint, and a resume to 6: the
    same losses at steps 5 and 6 and the same final state, bit for bit."""
    state_a, log_a = _trainer(tmp_path / "a", steps=6).run()
    _trainer(tmp_path / "b", steps=4).run()
    state_b, log_b = _trainer(tmp_path / "b", steps=6).run()
    assert [r["loss"] for r in log_a[4:]] == [r["loss"] for r in log_b]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(state_a),
                                                 tree_leaves(state_b)))


def test_watchdog():
    w = Watchdog(factor=2.0, max_step_time=10.0)
    for _ in range(6):
        assert w.observe(1.0) is None
    assert w.observe(3.5) == "straggler"
    assert w.stragglers == 1
    assert w.observe(11.0) == "abort"


def test_trainer_matches_reference_trainer():
    """The slice as a whole: the first 3 losses and grad norms of the
    port's Trainer against the reference's Trainer on a 1x1 mesh, both
    computing in fp32 from the same fp32 weights and the same batches."""
    rcfg, cfg = ref_smoke("qwen3-0.6b"), smoke_config("qwen3-0.6b")
    rmodel = ref_build(rcfg)
    rmodel = dataclasses.replace(rmodel, templates=jax.tree.map(
        lambda t: dataclasses.replace(t, dtype=jnp.float32), rmodel.templates,
        is_leaf=lambda x: isinstance(x, jlayers.PT)))
    rp = rmodel.init(jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, rp), cfg,
                               device="cpu")   # before rp is donated
    ropt = RefAdamW(lr=ref_warmup_cosine(3e-3, 2, 20))
    rtrainer = RefTrainer(rmodel, ropt, ShardingPolicy(),
                          make_mesh((1, 1), ("data", "model")),
                          RefSyntheticTokens(rcfg, 2, 32, seed=0),
                          RefTrainConfig(steps=3, log_every=100),
                          log=lambda s: None)
    _, rlog = rtrainer.run(state=ropt.init(rp))
    model = _fp32_model(build_model(cfg))
    opt = AdamW(lr=warmup_cosine(3e-3, 2, 20))
    trainer = Trainer(model, opt, SyntheticTokens(cfg, 2, 32, seed=0),
                      TrainConfig(steps=3, log_every=100), device="cpu",
                      log=lambda s: None)
    _, log = trainer.run(state=opt.init(tp))
    for got, want in zip(log, rlog):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=1e-4)


def test_microbatches_and_steps_per_dispatch():
    """Two microbatches give the full batch's gradients up to rounding
    (the mean of two means over equal halves: the first moments agree
    within 1e-5 of their scale), and K = 2 steps a call equal two
    calls."""
    from repro_torch.train import make_train_step
    cfg = smoke_config("qwen3-0.6b")
    model = _fp32_model(build_model(cfg))
    opt = AdamW(lr=1e-3)
    data = SyntheticTokens(cfg, 2, 16, seed=3)
    batches = [{n: _t(a) for n, a in data(i).items()} for i in range(2)]

    def fresh():
        return opt.init(model.init(0, device="cpu"))
    one = make_train_step(model, opt)
    two = make_train_step(model, opt, microbatches=2)
    s1, m1 = one(fresh(), batches[0])
    s2, m2 = two(fresh(), batches[0])
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    for a, b in zip(tree_leaves(s1["m"]), tree_leaves(s2["m"])):
        _scale_close(b.numpy(), a.numpy(), 1e-5, "first moment")
    k2 = make_train_step(model, opt, steps_per_dispatch=2)
    sa = fresh()
    for b in batches:
        sa, ma = one(sa, b)
    sb, mb = k2(fresh(), {n: torch.stack([b[n] for b in batches])
                          for n in batches[0]})
    assert torch.equal(ma["loss"], mb["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(sa),
                                                 tree_leaves(sb)))


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------

def test_launch_train_on_the_cpu(tmp_path, capsys):
    log = launch_train.main(["--smoke", "--steps", "3", "--device", "cpu",
                             "--batch", "2", "--seq", "16",
                             "--ckpt-dir", str(tmp_path)])
    assert [r["step"] for r in log] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in log)
    assert "[train] done" in capsys.readouterr().out
    assert (tmp_path / "step_00000003" / "tree.json").exists()


@pytest.mark.parametrize("flags", [["--mesh", "2x1"], ["--fsdp"], ["--sp"]])
def test_launch_train_refuses(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP section 1"):
        launch_train.main(["--smoke", "--steps", "1", "--device", "cpu",
                           *flags])
