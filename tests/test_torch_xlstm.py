"""The port's ssm family (xlstm: mLSTM blocks with an sLSTM block every
``slstm_every`` layers) held against the reference on the reference's own
weights, carried over by the bridge: the mLSTM cell (one chunk, several
chunks, a carried state, the one-token step), the sLSTM scan, the four
block functions, the model's prefill and decode (logits and every cache
leaf), and the ``ServeEngine`` (continuous and lockstep, greedy and
sampled) token for token.  Inside the port: preempt + replay is
byte-identical, a freed slot holds zero state, and the knobs a scan family
cannot take raise, as does a prompt that breaks the mLSTM chunk rule.

Configs: ``SMOKE`` (4 layers, an sLSTM block every 2) and a narrow copy of
xlstm-350m (6 layers, one group of 5 mLSTM blocks and an sLSTM block, 4
heads as at full width).  Tolerances as in ``test_torch_hybrid.py``: fp32
weights at atol = rtol = 1e-4 (other summation orders), bf16 at 4% of each
tensor's scale (bf16 rounding at other points in XLA and in PyTorch, which
the recurrent state carries on; the logits of a 512-token smoke prompt
reached 3.3% of scale, so bf16 runs prompts of at most 256 tokens here, and
the fp32 cases hold the multi-chunk carried state).  bf16 runs on the smoke
config only: the narrow config in bf16 is too ill conditioned to compare
(the reference's own bf16 logits part from its fp32 ones by more than 4%
of their scale there)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get
from repro.configs import smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.models import xlstm as rx
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import build_model
from repro_torch.models import xlstm as tx
from repro_torch.serving import Request, ServeEngine

ARCH = "xlstm-350m"
NARROW = dict(n_layers=6, d_model=64, vocab_size=500)
CONFIGS = {
    "smoke": (ref_smoke(ARCH), smoke_config(ARCH)),
    "narrow": (dataclasses.replace(ref_get(ARCH), **NARROW),
               dataclasses.replace(get_config(ARCH), **NARROW)),
}
CACHE_KEYS = ("m_conv", "m_c", "m_n", "m_m", "s_conv", "s_c", "s_n", "s_h",
              "s_m")
FP32_KEYS = CACHE_KEYS[1:4] + CACHE_KEYS[5:]


def _weights(ref_cfg, cfg, dtype="float32"):
    rp = ref_build(ref_cfg).init(jax.random.key(0))
    if dtype == "float32":
        rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), cfg,
                                     device="cpu")


def _prompts(vocab, lens, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _assert_near(got, want, dtype, what):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 0.04 * scale, what


def _f32(t):
    return t.float().numpy()


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# The cells and the blocks (fp32).
# ---------------------------------------------------------------------------

def _cell_inputs(seed, b=2, h=3, s=64, dk=8, dv=12):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, s, dk), np.float32)
    k = rng.standard_normal((b, h, s, dk), np.float32)
    v = rng.standard_normal((b, h, s, dv), np.float32)
    ig = rng.standard_normal((b, h, s), np.float32)
    fg = rng.standard_normal((b, h, s), np.float32) + 2.0
    return q, k, v, ig, fg


@pytest.mark.parametrize("s,chunk,carried", [(64, 256, False),
                                             (96, 32, False),
                                             (64, 16, True)])
def test_mlstm_parallel_matches_reference(s, chunk, carried):
    """One chunk (S < the chunk), several chunks, and a state carried from
    a first call into a second: y and the (C, n, m) state."""
    args = _cell_inputs(1, s=s)
    jstate = tstate = None
    if carried:
        first = _cell_inputs(2, s=32)
        _, jstate = rx.mlstm_parallel(*map(jnp.asarray, first), chunk=chunk)
        _, tstate = tx.mlstm_parallel(*map(_t, first), chunk=chunk)
    want, wstate = rx.mlstm_parallel(*map(jnp.asarray, args), chunk=chunk,
                                     state=jstate)
    got, gstate = tx.mlstm_parallel(*map(_t, args), chunk=chunk,
                                    state=tstate)
    _assert_near(got, want, "float32", "y")
    for g, w, name in zip(gstate, wstate, ("C", "n", "m")):
        _assert_near(g, w, "float32", name)


def test_mlstm_parallel_refuses_a_ragged_length():
    """S past one chunk must be a multiple of it (the reference asserts)."""
    with pytest.raises(ValueError, match="256"):
        tx.mlstm_parallel(*map(_t, _cell_inputs(1, s=300)))
    assert tx.chunk_len(7) == 7 and tx.chunk_len(512) == 256


def test_mlstm_step_matches_reference():
    """Three steps from the state a 32-token prefill left."""
    pre = _cell_inputs(3, s=32)
    _, jstate = rx.mlstm_parallel(*map(jnp.asarray, pre))
    _, tstate = tx.mlstm_parallel(*map(_t, pre))
    rng = np.random.default_rng(4)
    for step in range(3):
        q, k, v, ig, fg = _cell_inputs(int(rng.integers(1 << 30)), s=1)
        args = (q[:, :, 0], k[:, :, 0], v[:, :, 0], ig[..., 0], fg[..., 0])
        jstate, want = rx.mlstm_step(jstate, *map(jnp.asarray, args))
        tstate, got = tx.mlstm_step(tstate, *map(_t, args))
        _assert_near(got, want, "float32", f"y {step}")
        for g, w, name in zip(tstate, jstate, ("C", "n", "m")):
            _assert_near(g, w, "float32", f"{name} {step}")


@pytest.mark.parametrize("s", [1, 20, 128])
def test_slstm_scan_matches_reference(s):
    """One token, a short prompt, and 128 tokens (the reference scans two
    checkpointed segments of 64 there): hs and the (c, n, h, m) state."""
    rng = np.random.default_rng(5)
    b, h, dh = 2, 3, 8
    gates = rng.standard_normal((b, s, h, dh, 4), np.float32)
    r_w = (rng.standard_normal((4, h, dh, dh)) / np.sqrt(dh)).astype(
        np.float32)
    want, wstate = rx.slstm_scan(jnp.asarray(gates), jnp.asarray(r_w),
                                 rx.slstm_init_state(b, h, dh))
    got, gstate = tx.slstm_scan(_t(gates), _t(r_w),
                                tx.slstm_init_state(b, h, dh, "cpu"))
    _assert_near(got, want, "float32", "hs")
    for g, w, name in zip(gstate, wstate, ("c", "n", "h", "m")):
        _assert_near(g, w, "float32", name)


def test_blocks_match_reference():
    """The narrow config's first mLSTM block over two chunks of 256 (then
    a step from the state it left) and its sLSTM block over 64 tokens (then
    a step), fp32: outputs, conv tails and cell states."""
    ref_cfg, cfg = CONFIGS["narrow"]
    rp, params = _weights(ref_cfg, cfg)
    rm = jax.tree.map(lambda a: a[0, 0], rp["mlstm"])
    tm = {k: v[0, 0] for k, v in params["mlstm"].items()}
    rs = jax.tree.map(lambda a: a[0], rp["slstm"])
    ts = {k: v[0] for k, v in params["slstm"].items()}
    h = cfg.n_heads
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 512, 64), np.float32)
    conv0 = np.zeros((2, 3, 128), np.float32)
    want, (rconv, rstate) = jax.jit(lambda p, x, c: rx.mlstm_block_with_state(
        p, x, h, c, None))(rm, jnp.asarray(x), jnp.asarray(conv0))
    got, (conv, state) = tx.mlstm_block_with_state(tm, _t(x), h, _t(conv0),
                                                   None)
    _assert_near(got, want, "float32", "mlstm out")
    _assert_near(conv, rconv, "float32", "mlstm conv")
    for g, w, name in zip(state, rstate, ("C", "n", "m")):
        _assert_near(g, w, "float32", f"mlstm {name}")
    xt = x[:, :1] * 0.5
    want = jax.jit(lambda p, x, c, s: rx.mlstm_block_decode(p, x, h, c, s))(
        rm, jnp.asarray(xt), rconv, rstate)
    got = tx.mlstm_block_decode(tm, _t(xt), h, conv, state)
    _assert_near(got[0], want[0], "float32", "mlstm decode out")
    _assert_near(got[1], want[1], "float32", "mlstm decode conv")
    for g, w, name in zip(got[2], want[2], ("C", "n", "m")):
        _assert_near(g, w, "float32", f"mlstm decode {name}")
    assert tx.mlstm_block(tm, _t(x[:, :64]), h).shape == (2, 64, 64)

    want, (rconv, rstate) = jax.jit(lambda p, x: rx.slstm_block(
        p, x, h, return_state=True))(rs, jnp.asarray(x[:, :64]))
    got, (conv, state) = tx.slstm_block(ts, _t(x[:, :64]), h,
                                        return_state=True)
    _assert_near(got, want, "float32", "slstm out")
    _assert_near(conv, rconv, "float32", "slstm conv")
    for g, w, name in zip(state, rstate, ("c", "n", "h", "m")):
        _assert_near(g, w, "float32", f"slstm {name}")
    want = jax.jit(lambda p, x, c, s: rx.slstm_block_decode(p, x, h, c, s))(
        rs, jnp.asarray(xt), rconv, rstate)
    got = tx.slstm_block_decode(ts, _t(xt), h, conv, state)
    _assert_near(got[0], want[0], "float32", "slstm decode out")
    _assert_near(got[1], want[1], "float32", "slstm decode conv")
    for g, w, name in zip(got[2], want[2], ("c", "n", "h", "m")):
        _assert_near(g, w, "float32", f"slstm decode {name}")


# ---------------------------------------------------------------------------
# The model.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,dtype,s", [
    ("smoke", "float32", 64), ("smoke", "float32", 512),
    ("smoke", "bfloat16", 64), ("smoke", "bfloat16", 256),
    ("narrow", "float32", 512)])
def test_prefill_and_decode_match_reference(name, dtype, s):
    """A batch of two prompts prefilled (one or two mLSTM chunks), then 3
    lockstep decode steps: logits and every cache leaf after each call;
    the cell states stay fp32 at any weight dtype.  A bf16 run is held
    against the reference in fp32 on the same (bf16-valued) weights: the
    recurrence carries each side's bf16 rounding its own way, and at one
    decode step of these cases the two bf16 runs part by more than 4% of
    the logits' scale while each stays within 4% of the fp32 logits.  The
    bf16 cell states drift further (past 4% of their scale after three
    steps), so a bf16 run's leaves are held to their dtypes and to finite
    values, and the fp32 cases hold every leaf."""
    ref_cfg, cfg = CONFIGS[name]
    rmodel, model = ref_build(ref_cfg), build_model(cfg)
    rp, params = _weights(ref_cfg, cfg, dtype)
    rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    toks = np.asarray(_prompts(cfg.vocab_size, [s, s]), np.int32)
    rl, rc = jax.jit(rmodel.prefill)(rp, {"tokens": jnp.asarray(toks)})
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)})
    decode = jax.jit(rmodel.decode)
    for step in range(4):
        _assert_near(_f32(tl), rl, dtype, f"logits {step}")
        for k in CACHE_KEYS:
            assert tc[k].dtype == (torch.float32 if k in FP32_KEYS or
                                   dtype == "float32" else torch.bfloat16)
            if dtype == "float32":
                _assert_near(_f32(tc[k]), rc[k], dtype, f"{k} {step}")
            else:
                assert bool(torch.isfinite(tc[k]).all()), k
        assert int(tc["pos"]) == int(rc["pos"]) == s + step
        if step == 3:
            break
        feed = np.asarray(rl).argmax(-1).astype(np.int32)[:, None]
        rl, rc = decode(rp, rc, jnp.asarray(feed))
        tl, tc = model.decode(params, tc, torch.from_numpy(feed))


# ---------------------------------------------------------------------------
# The engine (dense slot layout).
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    ref_cfg, cfg = CONFIGS["smoke"]
    rp, params = _weights(ref_cfg, cfg)
    return ref_cfg, cfg, rp, params


def _tokens(eng, reqs, **kw):
    return [r.tokens for r in eng.generate(reqs, **kw)]


@pytest.mark.parametrize("mode,lens", [("continuous", [5, 13, 64]),
                                       ("lockstep", [16, 16, 16])])
def test_tokens_match_reference_engine(smoke, mode, lens):
    """Same trace (3 requests on 2 slots), same fp32 weights: the same
    greedy tokens, and at temperature 0.7 the same sampled tokens.
    Lockstep runs uniform lengths (its left pads would enter the state),
    and there it equals continuous."""
    ref_cfg, cfg, rp, params = smoke
    prompts = _prompts(cfg.vocab_size, lens)
    ref = RefServeEngine(ref_build(ref_cfg), rp, max_batch=2, cache_len=40,
                         mode=mode)
    eng = ServeEngine(build_model(cfg), params, max_batch=2, cache_len=40,
                      mode=mode)
    cont = ServeEngine(build_model(cfg), params, max_batch=2, cache_len=40)
    for temp in (0.0, 0.7):
        want = _tokens(ref, [RefRequest(p, 6, temp, rid=i)
                             for i, p in enumerate(prompts)])
        reqs = [Request(p, 6, temp, rid=i) for i, p in enumerate(prompts)]
        assert _tokens(eng, reqs) == want, (mode, temp)
        if mode == "lockstep":
            assert _tokens(cont, reqs) == want


@pytest.mark.parametrize("depth,temp", [(1, 0.0), (5, 0.7)])
def test_preempt_and_replay_is_byte_identical(smoke, depth, temp):
    """A request preempted after ``depth`` tokens and re-admitted (prompt
    prefill, ``done`` replayed through decode) returns the uninterrupted
    stream, and the replay is counted."""
    _, cfg, _, params = smoke
    p0, p1 = _prompts(cfg.vocab_size, [9, 6], seed=3)

    def fresh():
        return ServeEngine(build_model(cfg), params, max_batch=2,
                           cache_len=40)
    reqs = [Request(p0, 10, temp, rid=0), Request(p1, 10, temp, rid=1)]
    want = _tokens(fresh(), reqs)
    eng = fresh()
    eng.begin_session()
    eng.session_admit(reqs[0], tag=0)
    eng.session_admit(reqs[1], tag=1)
    for _ in range(depth - 1):
        eng.session_step()
    _, requeued = eng.session_preempt(0)
    assert len(requeued.done) == depth
    got = {}
    assert eng.session_admit(requeued, tag=0) is None
    while eng.session_active:
        for tag, res in eng.session_step():
            got[tag] = res.tokens
    eng.end_session()
    assert eng.last_metrics.counter("resume_replay_tokens").n == depth
    assert [got[0], got[1]] == want


def _slot_rows(cache, slot):
    """Every state leaf's rows of ``slot`` (the mLSTM leaves on axis 2,
    the sLSTM leaves on axis 1)."""
    return {k: cache[k][:, :, slot] if k.startswith("m_")
            else cache[k][:, slot] for k in CACHE_KEYS}


def test_freed_slots_hold_zero_state(smoke):
    """A preempted slot's conv tails, cell states and position are zero at
    once, and so are those of the slot the drain's last step frees."""
    _, cfg, _, params = smoke
    eng = ServeEngine(build_model(cfg), params, max_batch=2, cache_len=40)
    eng.begin_session()
    p0, p1 = _prompts(cfg.vocab_size, [7, 12], seed=5)
    eng.session_admit(Request(p0, 4, rid=0), tag=0)
    eng.session_admit(Request(p1, 8, rid=1), tag=1)
    eng.session_step()
    cache = eng._sess.cache
    assert all(bool(v.any()) for v in _slot_rows(cache, 1).values())
    eng.session_preempt(1)
    for k, v in _slot_rows(cache, 1).items():
        assert not v.any(), k
    assert int(cache["pos"][1]) == 0
    while eng.session_active:
        eng.session_step()
    for k, v in _slot_rows(cache, 0).items():
        assert not v.any(), k
    assert int(cache["pos"][0]) == 0
    eng.end_session()


def test_scan_family_refuses_bucketing_paged_and_ragged_prompts(smoke):
    """``bucket=`` and the paged layout raise, and so does a prompt past
    one mLSTM chunk that is not a multiple of it (300 tokens)."""
    _, cfg, _, params = smoke
    model = build_model(cfg)
    assert model.paged_cache_init is None and not model.bounded_cache
    with pytest.raises(ValueError, match="bucket"):
        ServeEngine(model, params, max_batch=2, cache_len=32, bucket="pow2")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(model, params, max_batch=2, cache_len=32,
                    kv_layout="paged")
    eng = ServeEngine(model, params, max_batch=2, cache_len=512)
    with pytest.raises(ValueError, match="multiple"):
        eng.generate([Request(_prompts(cfg.vocab_size, [300])[0], 2)])


def test_unbounded_state_skips_the_budget_check(smoke):
    """An xlstm request may run past ``cache_len`` (its state does not grow
    with the context); the reference serves it, and so does the port, with
    the same tokens."""
    ref_cfg, cfg, rp, params = smoke
    prompt = _prompts(cfg.vocab_size, [12], seed=6)[0]
    want = _tokens(RefServeEngine(ref_build(ref_cfg), rp, max_batch=1,
                                  cache_len=8),
                   [RefRequest(prompt, 10, rid=0)])
    got = _tokens(ServeEngine(build_model(cfg), params, max_batch=1,
                              cache_len=8), [Request(prompt, 10, rid=0)])
    assert got == want


def test_bridge_keeps_the_fp32_leaves():
    """The reference keeps ``w_i``, ``w_f``, ``b_i``, ``b_f`` and ``r_w`` in
    fp32 beside bf16 weights; the bridge carries each leaf at its own dtype
    (bit for bit), and the port's own init makes the same dtypes (``b_f``
    ones, ``b_i`` zeros)."""
    ref_cfg, cfg = CONFIGS["smoke"]
    rp, params = _weights(ref_cfg, cfg, "bfloat16")
    for stack, keys in (("mlstm", ("w_i", "w_f", "b_i", "b_f")),
                        ("slstm", ("r_w",))):
        for k in keys:
            assert params[stack][k].dtype == torch.float32, k
            np.testing.assert_array_equal(params[stack][k].numpy(),
                                          np.asarray(rp[stack][k]))
    assert params["mlstm"]["up"].dtype == torch.bfloat16
    assert params["slstm"]["w_gates"].dtype == torch.bfloat16
    own = build_model(cfg).init(0, device="cpu")
    assert all(own["mlstm"][k].dtype == torch.float32
               for k in ("w_i", "w_f", "b_i", "b_f"))
    assert own["slstm"]["r_w"].dtype == torch.float32
    assert bool((own["mlstm"]["b_f"] == 1).all())
    assert not own["mlstm"]["b_i"].any()
