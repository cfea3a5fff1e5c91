"""The port's hybrid family (zamba2: Mamba2 layers and one shared attention
block) held against the reference on the reference's own weights, carried
over by the bridge: the Mamba2 block, the model's prefill and decode
(logits and every cache leaf), and the ``ServeEngine`` (continuous and
lockstep, greedy and sampled) token for token.  Inside the port: preempt +
replay is byte-identical, a freed slot holds zero state, and the knobs a
scan family cannot take raise.

Configs: ``SMOKE`` (4 layers, a shared block after every 2) and a narrow
copy of zamba2-1.2b with a tail (5 layers, every 2: one tail layer without
a shared block).  Tolerances as in ``test_torch_dense.py``: fp32 weights at
atol = rtol = 1e-4 (other summation orders), bf16 at 4% of each tensor's
scale (bf16 rounding at other points in XLA and in PyTorch).  The bf16
difference is rounding noise that compounds layer by layer through the
recurrent state: at 5 layers and one chunk it stays under 3.1% of scale on
three weight seeds, at two chunks it reached 4.6% on one of them, and at 7
layers 7.3%; so bf16 runs one chunk, and the fp32 cases hold the
multi-chunk carried state exactly."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get
from repro.configs import smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.models.mamba2 import mamba_decode as ref_mamba_decode
from repro.models.mamba2 import mamba_dims as ref_mamba_dims
from repro.models.mamba2 import mamba_forward as ref_mamba_forward
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import build_model
from repro_torch.models.mamba2 import mamba_decode, mamba_dims, mamba_forward
from repro_torch.serving import Request, ServeEngine

ARCH = "zamba2-1.2b"
NARROW = dict(n_layers=5, shared_attn_every=2, d_model=64, d_ff=128,
              n_heads=4, n_kv_heads=4, head_dim=16, ssm_head_dim=16,
              ssm_state=16, vocab_size=500)
CONFIGS = {
    "smoke": (ref_smoke(ARCH), smoke_config(ARCH)),
    "narrow": (dataclasses.replace(ref_get(ARCH), **NARROW),
               dataclasses.replace(get_config(ARCH), **NARROW)),
}
CACHE_KEYS = ("conv", "ssm", "attn_k", "attn_v")


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
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 0.04 * scale, what


def _f32(t):
    return t.float().numpy()


def test_mamba_block_matches_reference():
    """``mamba_forward`` (chunked scan, two chunks of 64) with its returned
    conv / SSD state, then ``mamba_decode`` from that state: fp32."""
    ref_cfg, cfg = CONFIGS["narrow"]
    rp, params = _weights(ref_cfg, cfg)
    rlp = jax.tree.map(lambda a: a[0], rp["mamba"]["block"])
    lp = {k: v[0] for k, v in params["mamba"]["block"].items()}
    x = np.random.default_rng(1).standard_normal((2, 128, 64), np.float32)
    want, (rconv, rssm) = jax.jit(lambda p, x: ref_mamba_forward(
        p, x, ref_mamba_dims(ref_cfg), return_state=True))(rlp,
                                                          jnp.asarray(x))
    got, (conv, ssm) = mamba_forward(lp, torch.from_numpy(x),
                                     mamba_dims(cfg), return_state=True)
    for g, w, name in ((got, want, "out"), (conv, rconv, "conv"),
                       (ssm, rssm, "ssm")):
        _assert_near(_f32(g), w, "float32", name)
    xt = x[:, :1] * 0.5
    want = jax.jit(lambda *a: ref_mamba_decode(
        *a, ref_mamba_dims(ref_cfg)))(rlp, jnp.asarray(xt), rconv, rssm)
    got = mamba_decode(lp, torch.from_numpy(xt), conv, ssm, mamba_dims(cfg))
    for g, w, name in zip(got, want, ("out", "conv", "ssm")):
        _assert_near(_f32(g), w, "float32", f"decode {name}")


@pytest.mark.parametrize("name,dtype,s,cache_len", [
    ("smoke", "float32", 64, 80), ("smoke", "bfloat16", 64, 80),
    ("narrow", "float32", 128, 160), ("narrow", "bfloat16", 64, 80),
    ("narrow", "float32", 64, 40)])
def test_prefill_and_decode_match_reference(name, dtype, s, cache_len):
    """A batch of two prompts prefilled (one or two SSD chunks), then 3
    lockstep decode steps: logits and every cache leaf after each call.
    The last case's prompt is longer than ``cache_len``: the shared block's
    ring (W = 40) holds the prompt's last 40 keys at their ring slots, and
    decode wraps it."""
    ref_cfg, cfg = CONFIGS[name]
    rmodel, model = ref_build(ref_cfg), build_model(cfg)
    rp, params = _weights(ref_cfg, cfg, dtype)
    toks = np.asarray(_prompts(cfg.vocab_size, [s, s]), np.int32)
    rl, rc = jax.jit(lambda p, b: rmodel.prefill(p, b, cache_len=cache_len))(
        rp, {"tokens": jnp.asarray(toks)})
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                           cache_len=cache_len)
    decode = jax.jit(rmodel.decode)
    for step in range(4):
        _assert_near(_f32(tl), rl, dtype, f"logits {step}")
        for k in CACHE_KEYS:
            assert tc[k].dtype == (torch.float32 if k == "ssm" or
                                   dtype == "float32" else torch.bfloat16)
            _assert_near(_f32(tc[k]), rc[k], dtype, f"{k} {step}")
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


def test_freed_slots_hold_zero_state(smoke):
    """A preempted slot's conv, ssm, ring KV and position are zero at once,
    and so are those of the slot the drain's last step frees.  (A slot
    freed earlier keeps decoding as an idle row until the session ends, as
    in the reference.)"""
    _, cfg, _, params = smoke
    eng = ServeEngine(build_model(cfg), params, max_batch=2, cache_len=40)
    eng.begin_session()
    p0, p1 = _prompts(cfg.vocab_size, [7, 12], seed=5)
    eng.session_admit(Request(p0, 4, rid=0), tag=0)
    eng.session_admit(Request(p1, 8, rid=1), tag=1)
    eng.session_step()
    cache = eng._sess.cache
    assert all(bool(cache[k][:, 1].any()) for k in CACHE_KEYS)
    eng.session_preempt(1)
    for k in CACHE_KEYS:
        assert not cache[k][:, 1].any(), k
    assert int(cache["pos"][1]) == 0
    while eng.session_active:
        eng.session_step()
    for k in CACHE_KEYS:
        assert not cache[k][:, 0].any(), k
    assert int(cache["pos"][0]) == 0
    eng.end_session()


def test_scan_family_refuses_bucketing_and_paged(smoke):
    _, cfg, _, params = smoke
    model = build_model(cfg)
    with pytest.raises(ValueError, match="bucket"):
        ServeEngine(model, params, max_batch=2, cache_len=32, bucket="pow2")
    with pytest.raises(ValueError, match="paged"):
        ServeEngine(model, params, max_batch=2, cache_len=32,
                    kv_layout="paged")


def test_unbounded_state_skips_the_budget_check(smoke):
    """A hybrid request may write past ``cache_len`` (its ring wraps); the
    reference serves it, and so does the port, with the same tokens."""
    ref_cfg, cfg, rp, params = smoke
    prompt = _prompts(cfg.vocab_size, [12], seed=6)[0]
    want = _tokens(RefServeEngine(ref_build(ref_cfg), rp, max_batch=1,
                                  cache_len=8),
                   [RefRequest(prompt, 10, rid=0)])
    got = _tokens(ServeEngine(build_model(cfg), params, max_batch=1,
                              cache_len=8), [Request(prompt, 10, rid=0)])
    assert got == want


def test_bridge_keeps_the_fp32_leaves():
    """The reference keeps ``a_log``, ``dt_bias`` and ``d_skip`` in fp32
    beside bf16 weights; the bridge carries each leaf at its own dtype, and
    the port's own init makes the same dtypes."""
    ref_cfg, cfg = CONFIGS["smoke"]
    rp, params = _weights(ref_cfg, cfg, "bfloat16")
    block = params["mamba"]["block"]
    for k in ("a_log", "dt_bias", "d_skip"):
        assert block[k].dtype == torch.float32
        np.testing.assert_array_equal(block[k].numpy(),
                                      np.asarray(rp["mamba"]["block"][k]))
    assert block["in_proj"].dtype == torch.bfloat16
    own = build_model(cfg).init(0, device="cpu")
    assert all(own["mamba"]["block"][k].dtype == torch.float32
               for k in ("a_log", "dt_bias", "d_skip"))
    assert own["mamba"]["block"]["conv_w"].dtype == torch.bfloat16
    a = -torch.exp(own["mamba"]["block"]["a_log"])
    assert bool(((a <= -1.0) & (a >= -16.0)).all())
