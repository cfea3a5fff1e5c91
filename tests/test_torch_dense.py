"""The port's dense KV layout held against the reference: the model's dense
serving hooks (prefill, decode, slot pool) on the reference's own weights
carried over by the bridge, and the ``ServeEngine`` on that layout —
continuous, lockstep and bucketed, greedy and sampled — token for token
against the reference's engine.  Inside the port, dense and paged serve the
same greedy tokens, and an idle slot runs past its strip without a fault.

Configs: the ``SMOKE`` and a narrow copy of the real config (2 layers,
d_model 128, d_ff 256, vocab 1000) of qwen3-0.6b (qk-norm, 16/8 heads of
128) and of qwen2.5-3b (qkv bias, 16/2 heads: g = 8).  Tolerances as in
``test_torch_model.py``: fp32 weights at atol = rtol = 1e-4 (other
summation orders), bf16 at 4% of the logits' scale (bf16 rounding at other
points in XLA and in PyTorch)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get
from repro.configs import smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.models.attention import attn_forward as ref_attn_forward
from repro.models.attention import project_kv as ref_project_kv
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import build_model
from repro_torch.models.attention import attn_forward, project_kv
from repro_torch.serving import Request, ServeEngine

NARROW = dict(n_layers=2, d_model=128, d_ff=256, vocab_size=1000)
CONFIGS = {
    f"{arch}-{size}": (
        (ref_smoke(arch), smoke_config(arch)) if size == "smoke" else
        (dataclasses.replace(ref_get(arch), **NARROW),
         dataclasses.replace(get_config(arch), **NARROW)))
    for arch in ("qwen3-0.6b", "qwen2.5-3b") for size in ("smoke", "narrow")
}
LENS = [5, 13, 21]


def _weights(ref_cfg, cfg, dtype="float32"):
    rp = ref_build(ref_cfg).init(jax.random.key(0))
    if dtype == "float32":
        rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), cfg,
                                     device="cpu")


def _prompts(vocab, lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lens]


def _logit_rows(ref_cfg, cfg, dtype):
    """Every logits row of a bucketed prefill of three right-padded prompts
    and 3 decode steps at their (B,) positions — reference and port.  (The
    0-d position of lockstep is held by the engine tests below.)"""
    rmodel, model = ref_build(ref_cfg), build_model(cfg)
    rp, params = _weights(ref_cfg, cfg, dtype)
    prompts = _prompts(cfg.vocab_size)
    toks = np.zeros((3, 24), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    lens = np.asarray(LENS, np.int32)
    want, got = [], []
    rl, rc = jax.jit(lambda p, b: rmodel.prefill(p, b, cache_len=40))(
        rp, {"tokens": jnp.asarray(toks), "prefill_len": jnp.asarray(lens)})
    tl, tc = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                    "prefill_len": torch.from_numpy(lens)},
                           cache_len=40)
    want.append(np.asarray(rl))
    got.append(tl.float().numpy())
    decode = jax.jit(rmodel.decode)
    for _ in range(3):
        feed = want[-1].argmax(-1).astype(np.int32)[:, None]
        rl, rc = decode(rp, rc, jnp.asarray(feed))
        tl, tc = model.decode(params, tc, torch.from_numpy(feed))
        want.append(np.asarray(rl))
        got.append(tl.float().numpy())
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(rc["pos"]))
    return np.concatenate(got), np.concatenate(want)


@pytest.mark.parametrize("name,dtype", [
    (name, dtype) for name in CONFIGS for dtype in ("float32", "bfloat16")
    if dtype == "float32" or name.startswith("qwen3")])
def test_dense_logits_match_reference(name, dtype):
    got, want = _logit_rows(*CONFIGS[name], dtype)
    assert got.shape == want.shape == (12, CONFIGS[name][1].vocab_size)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    else:
        assert np.abs(got - want).max() <= 0.04 * np.abs(want).max()


def test_forward_and_kv_projection_match_reference():
    """``attn_forward`` (through the flash path) and ``project_kv`` of one
    layer, on the narrow qwen2.5 copy (qkv bias, g = 8), fp32."""
    ref_cfg, cfg = CONFIGS["qwen2.5-3b-narrow"]
    rp, params = _weights(ref_cfg, cfg)
    rlp = jax.tree.map(lambda a: a[0], rp["layers"]["attn"])
    lp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    x = np.random.default_rng(2).standard_normal((2, 19, 128), np.float32)
    for window in (None, 6):
        np.testing.assert_allclose(
            attn_forward(lp, torch.from_numpy(x), cfg, window=window).numpy(),
            np.asarray(ref_attn_forward(rlp, jnp.asarray(x), ref_cfg,
                                        window=window)),
            rtol=1e-4, atol=1e-4)
    for got, want in zip(project_kv(lp, torch.from_numpy(x), cfg),
                         ref_project_kv(rlp, jnp.asarray(x), ref_cfg)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The engine on the dense layout.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    ref_cfg, cfg = CONFIGS["qwen3-0.6b-smoke"]
    rp, params = _weights(ref_cfg, cfg)
    return ref_cfg, cfg, rp, params


def _tokens(eng, reqs, **kw):
    return [r.tokens for r in eng.generate(reqs, **kw)]


@pytest.mark.parametrize("kw", [dict(), dict(bucket="pow2"),
                                dict(mode="lockstep")],
                         ids=["continuous", "pow2", "lockstep"])
def test_greedy_and_sampled_tokens_match_reference_engine(smoke, kw):
    """Same trace (3 requests on 2 slots), same fp32 weights: the same
    greedy tokens, and at temperature 0.7 the same sampled tokens (JAX's
    threefry streams, keyed by rid and token index)."""
    ref_cfg, cfg, rp, params = smoke
    prompts = _prompts(cfg.vocab_size)
    ref = RefServeEngine(ref_build(ref_cfg), rp, max_batch=2, cache_len=40,
                         **kw)
    eng = ServeEngine(build_model(cfg), params, max_batch=2, cache_len=40,
                      **kw)
    for temp in (0.0, 0.7):
        want = _tokens(ref, [RefRequest(p, 6, temp, rid=i)
                             for i, p in enumerate(prompts)])
        got = _tokens(eng, [Request(p, 6, temp, rid=i)
                            for i, p in enumerate(prompts)])
        assert got == want, (kw, temp)
        assert eng.last_stats.kv_layout == "dense"
        assert eng.last_stats.prefill_compiles == \
            ref.last_stats.prefill_compiles


def test_dense_equals_paged_and_streams_are_slot_free(smoke):
    """Inside the port, the dense and paged layouts serve the same greedy
    tokens; a sampled stream is the same whichever slot and scheduler
    serve it, and a non-default key changes it."""
    _, cfg, _, params = smoke
    prompts = _prompts(cfg.vocab_size, [5, 13, 21, 9])
    reqs = [Request(p, 5, rid=i) for i, p in enumerate(prompts)]
    runs = [_tokens(ServeEngine(build_model(cfg), params, max_batch=b,
                                cache_len=40, kv_layout=layout,
                                block_size=8), reqs)
            for layout in ("dense", "paged") for b in (1, 3)]
    assert all(r == runs[0] for r in runs)
    sampled = [Request(p, 5, 0.7, rid=i) for i, p in enumerate(prompts)]
    a = _tokens(ServeEngine(build_model(cfg), params, max_batch=3,
                            cache_len=40), sampled)
    b = _tokens(ServeEngine(build_model(cfg), params, max_batch=1,
                            cache_len=40, mode="lockstep"), sampled)
    c = _tokens(ServeEngine(build_model(cfg), params, max_batch=3,
                            cache_len=40), sampled, key=(0, 1))
    assert a == b and a != c


def test_idle_slot_past_its_strip(smoke):
    """A slot left idle keeps decoding and its position keeps advancing
    until it passes ``cache_len``: the step must not raise, the idle row
    writes nothing, and the live request's tokens equal the reference's
    (whose one-hot write has no hot entry there)."""
    ref_cfg, cfg, rp, params = smoke
    p0, p1 = _prompts(cfg.vocab_size, [8, 2])
    ref = RefServeEngine(ref_build(ref_cfg), rp, max_batch=2, cache_len=16)
    want = _tokens(ref, [RefRequest(p0, 2, rid=0), RefRequest(p1, 15, rid=1)])
    eng = ServeEngine(build_model(cfg), params, max_batch=2, cache_len=16)
    got = _tokens(eng, [Request(p0, 2, rid=0), Request(p1, 15, rid=1)])
    assert got == want
    # the model step alone: row 1 sits past its strip (pos 16 + 3)
    model = build_model(cfg)
    cache = model.cache_expand(model.prefill(
        params, {"tokens": torch.tensor([p0])}, cache_len=16)[1], 2)
    rng = np.random.default_rng(4)
    for name in ("k", "v"):
        cache[name].copy_(torch.from_numpy(
            rng.standard_normal(cache[name].shape).astype(np.float32)))
    cache["pos"].copy_(torch.tensor([5, 19], dtype=torch.int32))
    before = {n: cache[n].clone() for n in ("k", "v")}
    logits, cache = model.decode(params, cache, torch.tensor([[7], [9]]))
    assert torch.isfinite(logits).all()
    for name in ("k", "v"):
        changed = (cache[name] != before[name]).nonzero()[:, :4]
        assert set(map(tuple, changed[:, [1, 3]].tolist())) == {(0, 5)}
    assert cache["pos"].tolist() == [6, 20]
