"""The port's encdec family (whisper: a non-causal encoder over stub frame
embeddings, a decoder with causal self-attention and cross-attention over
the encoder's output) held against the reference on the reference's own
weights, carried over by the bridge: the three layers the family adds
(LayerNorm, the sinusoid table, the GELU MLP), the encoder and the
full-sequence decoder, the prefill
(logits and all four cache leaves) and three decode steps on its cache,
with a 0-d ``pos`` (lockstep) and a (B,) ``pos`` (the slot pool, an idle
slot among the rows), at frames of 6 and of 40 rows.  Inside the port: a
B = 3 prefill equals three B = 1 prefills, and the config, templates and
``n_params`` of the full whisper-base equal the reference's.

Configs: ``SMOKE`` (2 + 2 layers, d 64, 4 heads of 16) and a narrow copy of
whisper-base (2 + 2 layers, d 128, 8 heads of 64 as at full width).
Tolerances: fp32 weights at atol = rtol = 1e-4 (other summation orders);
bf16 weights against the reference's fp32 run within ``BF16_TOL`` of the
logits' scale (bf16 rounding at other points in XLA and in PyTorch: the
port's bf16 prefill logits sit 0.68% and 0.45% of their scale from the
reference's fp32 ones at frames of 6 and 40, the reference's own bf16
logits 0.91% and 0.52%)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get
from repro.configs import smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.models import encdec as re
from repro.models import layers as rl
from repro_torch.bridge import params_from_reference
from repro_torch.configs import get_config, smoke_config
from repro_torch.models import build_model
from repro_torch.models import encdec as te
from repro_torch.models import layers as tl

ARCH = "whisper-base"
NARROW = dict(n_layers=2, n_enc_layers=2, d_model=128, d_ff=256,
              vocab_size=500)
CONFIGS = {
    "smoke": (ref_smoke(ARCH), smoke_config(ARCH)),
    "narrow": (dataclasses.replace(ref_get(ARCH), **NARROW),
               dataclasses.replace(get_config(ARCH), **NARROW)),
}
CACHE_KEYS = ("k", "v", "xk", "xv")
B, PLEN, CACHE_LEN, N_DECODE = 2, 7, 12, 3
BF16_TOL = 0.02


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_fns():
    """One jitted reference prefill / decode a config (compiled once per
    shape for the whole module)."""
    out = {}
    for name, (ref_cfg, _) in CONFIGS.items():
        m = ref_build(ref_cfg)
        out[name] = (jax.jit(m.prefill, static_argnames="cache_len"),
                     jax.jit(m.decode))
    return out


@functools.lru_cache(maxsize=None)
def _weights(config, dtype):
    """(reference params, port params) of ``CONFIGS[config]``: the
    reference's seeded init, cast to fp32 or kept bf16, carried over bit
    for bit; built once a module."""
    ref_cfg, cfg = CONFIGS[config]
    rp = ref_build(ref_cfg).init(jax.random.key(0))
    if dtype == "float32":
        rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), cfg,
                                     device="cpu")


def _inputs(cfg, frames, b=B, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, cfg.vocab_size, (b, PLEN)).astype(np.int32),
            rng.standard_normal((b, frames, cfg.d_model)).astype(np.float32))


def _np(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor)
                      else jnp.asarray(t, jnp.float32))


def _assert_near(got, want, what, tol=None):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    assert np.isfinite(got).all(), what
    if tol is None:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=what)
    else:
        assert np.abs(got - want).max() <= tol * np.abs(want).max(), what


def _row(cache, i):
    """Batch-1 cache of row ``i`` (every leaf's batch axis at 1), of
    either package."""
    return {**{k: cache[k][:, i:i + 1] for k in CACHE_KEYS},
            "pos": cache["pos"]}


def test_layers_match_reference():
    """LayerNorm (population variance), the GELU MLP (tanh form) and the
    sinusoid table (bit for bit: both are numpy fp64 cast to fp32)."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    want = rl.layernorm(jnp.asarray(w), jnp.asarray(b), jnp.asarray(x), 1e-6)
    got = tl.layernorm(torch.from_numpy(w), torch.from_numpy(b),
                       torch.from_numpy(x), 1e-6)
    _assert_near(got, want, "layernorm")
    mlp = {"up": rng.standard_normal((64, 96)).astype(np.float32) / 8,
           "up_b": rng.standard_normal(96).astype(np.float32),
           "down": rng.standard_normal((96, 64)).astype(np.float32) / 10,
           "down_b": rng.standard_normal(64).astype(np.float32)}
    want = rl.gelu_mlp_apply({k: jnp.asarray(v) for k, v in mlp.items()},
                             jnp.asarray(x))
    got = tl.gelu_mlp_apply({k: torch.from_numpy(v) for k, v in mlp.items()},
                            torch.from_numpy(x))
    _assert_near(got, want, "gelu_mlp_apply")
    for n, d in ((6, 64), (40, 128), (te.CROSS_LEN, 512)):
        np.testing.assert_array_equal(
            tl.sinusoidal_positions(n, d).numpy(),
            np.asarray(rl.sinusoidal_positions(n, d)))


@pytest.mark.parametrize("frames", [6, 40])
@pytest.mark.parametrize("config", sorted(CONFIGS))
def test_encode_and_decoder_match_reference(config, frames):
    """The encoder's output, and the full-sequence decoder's hiddens over
    it (causal self-attention, cross-attention over every frame)."""
    ref_cfg, cfg = CONFIGS[config]
    rp, params = _weights(config, "float32")
    toks, fr = _inputs(cfg, frames)
    want = jax.jit(re.encode, static_argnums=2)(rp, jnp.asarray(fr), ref_cfg)
    got = te.encode(params, torch.from_numpy(fr), cfg)
    _assert_near(got, want, f"{config} encode frames={frames}")
    want = jax.jit(re._decoder, static_argnums=3)(
        rp, jnp.asarray(toks), want, ref_cfg)
    got = te._decoder(params, torch.from_numpy(toks), got, cfg)
    _assert_near(got, want, f"{config} decoder frames={frames}")


# (config, dtype, frames): fp32 on both configs, bf16 on the smoke config
CASES = [("smoke", "float32", 6), ("smoke", "float32", 40),
         ("narrow", "float32", 6), ("narrow", "float32", 40),
         ("smoke", "bfloat16", 6), ("smoke", "bfloat16", 40)]


@pytest.mark.parametrize("config,dtype,frames", CASES)
def test_prefill_and_decode_match_reference(ref_fns, config, dtype, frames):
    """A B = 2 prefill (logits and every cache leaf), three greedy decode
    steps at a 0-d ``pos`` on its cache, then the two rows written into a
    3-slot pool (slots 2 and 0, slot 1 idle) and three steps at a (B,)
    ``pos``.  fp32: every row at 1e-4.  bf16: the port's bf16 run within
    ``BF16_TOL`` of the reference's fp32 run's scale."""
    _, cfg = CONFIGS[config]
    rprefill, rdecode = ref_fns[config]
    model = build_model(cfg)
    rp32, _ = _weights(config, "float32")
    _, params = _weights(config, dtype)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    toks, fr = _inputs(cfg, frames)
    ref_batch = {"tokens": jnp.asarray(toks), "frames": jnp.asarray(fr)}
    rlg, rc = rprefill(rp32, ref_batch, cache_len=CACHE_LEN)
    lg, c = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                   "frames": torch.from_numpy(fr).to(tdt)},
                          cache_len=CACHE_LEN)
    what = f"{config} {dtype} frames={frames}"
    tol = None if dtype == "float32" else BF16_TOL
    _assert_near(lg, rlg, f"{what} prefill logits", tol)
    assert int(c["pos"]) == int(rc["pos"]) == PLEN and c["pos"].dim() == 0
    for k in CACHE_KEYS:
        assert c[k].dtype == tdt
        _assert_near(c[k], rc[k], f"{what} prefill {k}", tol)
    # the slot pool: row 0 in slot 2, row 1 in slot 0, slot 1 idle
    pool = model.cache_expand(_row(c, 0), 3)
    rpool = re.encdec_cache_expand(_row(rc, 0), 3)
    for i, slot in ((0, 2), (1, 0)):
        pool = model.cache_slot_write(pool, _row(c, i), slot)
        rpool = re.encdec_cache_slot_write(rpool, _row(rc, i), slot)
    assert pool["pos"].tolist() == [PLEN, 0, PLEN]
    for label, cache, rcache, rows in (("0-d pos", c, rc, B),
                                       ("(B,) pos", pool, rpool, 3)):
        feed = np.zeros((rows, 1), np.int32)
        for step in range(N_DECODE):
            rlg, rcache = rdecode(rp32, rcache, jnp.asarray(feed))
            lg, cache = model.decode(params, cache, torch.from_numpy(feed))
            _assert_near(lg, rlg, f"{what} {label} decode step {step}", tol)
            feed = np.argmax(np.asarray(rlg), -1).astype(np.int32)[:, None]
        for k in ("k", "v"):
            _assert_near(cache[k], rcache[k], f"{what} {label} decode {k}",
                         tol)
        assert np.array_equal(np.asarray(cache["pos"]),
                              np.asarray(rcache["pos"]))


def test_batched_prefill_is_row_by_row():
    """A B = 3 prefill (frames split with the tokens) equals three B = 1
    prefills, logits and every cache leaf, bit for bit."""
    _, cfg = CONFIGS["smoke"]
    _, params = _weights("smoke", "float32")
    model = build_model(cfg)
    toks, fr = _inputs(cfg, 6, b=3, seed=5)
    lg, c = model.prefill(params, {"tokens": torch.from_numpy(toks),
                                   "frames": torch.from_numpy(fr)},
                          cache_len=CACHE_LEN)
    for i in range(3):
        lg1, c1 = model.prefill(params, {
            "tokens": torch.from_numpy(toks[i:i + 1]),
            "frames": torch.from_numpy(fr[i:i + 1])}, cache_len=CACHE_LEN)
        assert torch.equal(lg[i:i + 1], lg1)
        for k in CACHE_KEYS:
            assert torch.equal(c[k][:, i:i + 1], c1[k]), k


def test_full_width_matches_reference_shapes():
    """whisper-base at full width: the reference's config, templates (names,
    shapes, fp32 leaves) and n_params; the model's serving flags."""
    cfg = get_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_get(ARCH))
    model, ref_model = build_model(cfg), ref_build(ref_get(ARCH))

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else v.shape
                for k, v in t.items()}
    assert shapes(model.templates) == shapes(ref_model.templates)
    assert model.n_params == ref_model.n_params
    assert model.bounded_cache and not model.supports_prefill_len
    assert model.cache_slot_reset is not None and model.decode_paged is None
    assert te.ENCDEC_STATE_AXES == re.ENCDEC_STATE_AXES
    assert te.CROSS_LEN == re.CROSS_LEN == 1500
