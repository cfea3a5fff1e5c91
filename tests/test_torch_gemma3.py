"""gemma3's 5:1 sliding-window schedule in the port, held against the
reference:

* ``ModelConfig.layer_window`` and the per-layer schedule equal the
  reference's ``windows_array`` (its ``_BIG_WINDOW`` on a global layer is
  the port's ``None``);
* the windowed paged paths (``paged_*_attention_plain(window=...)``,
  which ``ops`` takes for any windowed paged call on every device) against
  the reference's ``paged_decode_attention_xla`` /
  ``paged_prefill_attention_xla`` at windows 8 and 5 and block sizes that
  divide neither;
* gemma3's smoke logits through dense prefill and decode, paged chunks and
  paged decode (``torch_parity``), at a 30-token prompt: past its window of
  16 on every local layer, fp32 at atol = rtol = 1e-4 and bf16 at 4% of
  the logits' scale;
* the engine's greedy tokens on the reference's with fp32 weights, dense
  and paged, on prompts and decode runs past the window;
* ``init_params`` draws a leaf past ``INIT_CHUNK_ELEMS`` in runs of rows
  (the fp32 transient of a full-width gemma3 leaf stays at 1 GiB), and the
  same seed makes the same params.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parity
from repro.configs import get_config as ref_get
from repro.configs import smoke_config as ref_smoke
from repro.kernels.paged_attention import (paged_decode_attention_xla,
                                           paged_prefill_attention_xla)
from repro.models import build_model as ref_build
from repro.models.transformer import windows_array
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.models import build_model, layers
from repro_torch.serving import Request, ServeEngine

ARCH = "gemma3-27b"
BIG_WINDOW = 1 << 30    # the reference's window of a global layer


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them about
    as fast as many and keeps parallel test workers off each other's
    cores.  The old count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# The schedule.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
@pytest.mark.parametrize("smoke", [False, True])
def test_layer_windows_equal_reference_schedule(arch, smoke):
    """Every arch the port builds, full and smoke: the port's per-layer
    windows are the reference's ``windows_array`` with its big window read
    as None, and None throughout where the reference has no schedule."""
    cfg = smoke_config(arch) if smoke else get_config(arch)
    ref_cfg = ref_smoke(arch) if smoke else ref_get(arch)
    ours = [cfg.layer_window(i) for i in range(cfg.n_layers)]
    assert ours == [ref_cfg.layer_window(i) for i in range(cfg.n_layers)]
    ws = windows_array(ref_cfg)
    if ws is None:
        assert ours == [None] * cfg.n_layers
    else:
        assert [w or BIG_WINDOW for w in ours] == np.asarray(ws).tolist()


def test_full_width_schedule():
    """62 layers at 5:1: 10 global layers (5, 11, ..., 59) and 52 local
    ones of window 1024."""
    cfg = get_config(ARCH)
    ws = [cfg.layer_window(i) for i in range(cfg.n_layers)]
    assert [i for i, w in enumerate(ws) if w is None] == list(range(5, 62, 6))
    assert ws.count(1024) == 52


# ---------------------------------------------------------------------------
# The windowed paged paths.
# ---------------------------------------------------------------------------

def _pools(seed, *, bs, n_blocks=12, hkv=2, d=16):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((n_blocks, hkv, bs, d), np.float32)
    vp = rng.standard_normal((n_blocks, hkv, bs, d), np.float32)
    return kp, vp


# rows own disjoint blocks; trailing entries on the null block 0
TABLE = np.array([[3, 7, 1, 9, 5], [2, 11, 0, 0, 0], [4, 6, 8, 0, 0]],
                 np.int32)


@pytest.mark.parametrize("window", [8, 5])
@pytest.mark.parametrize("bs", [6, 3])
def test_windowed_paged_decode_matches_reference(window, bs):
    """kv lengths at and around the window and block edges, one row inside
    its first window; block sizes that do not divide the window."""
    kp, vp = _pools(1, bs=bs)
    q = np.random.default_rng(2).standard_normal((3, 6, 1, 16), np.float32)
    for lens in ([5 * bs, 2 * bs, 3], [window + 1, window, 3 * bs - 1],
                 [4 * bs + 1, bs + 1, 1]):
        kv = np.asarray(lens, np.int32)
        want = paged_decode_attention_xla(*map(jnp.asarray,
                                               (q, kp, vp, TABLE, kv)),
                                          window=window)
        args = [torch.from_numpy(np.array(a)) for a in (q, kp, vp, TABLE, kv)]
        got = ops.paged_decode_attention(*args, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=str(lens))


@pytest.mark.parametrize("window", [8, 5])
@pytest.mark.parametrize("bs", [6, 3])
def test_windowed_paged_prefill_matches_reference(window, bs):
    """A chunk of ``bs`` queries at the first, a middle and the last chunk
    of the table, and past its window at every later position."""
    kp, vp = _pools(3, bs=bs)
    q = np.random.default_rng(4).standard_normal((3, 4, bs, 16), np.float32)
    for starts in ([4 * bs, bs, 0], [0, 0, 2 * bs], [2 * bs, bs, bs]):
        qs = np.asarray(starts, np.int32)
        want = paged_prefill_attention_xla(*map(jnp.asarray,
                                                (q, kp, vp, TABLE, qs)),
                                           window=window)
        args = [torch.from_numpy(np.array(a)) for a in (q, kp, vp, TABLE, qs)]
        got = ops.paged_prefill_attention(*args, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=str(starts))


def test_gather_path_ignores_what_it_must_not_read():
    """NaN everywhere outside each row's window and past its length: the
    gather paths return what they return on clean pools."""
    bs, window = 6, 8
    kp, vp = _pools(5, bs=bs)
    t = torch.from_numpy
    q = t(np.random.default_rng(6).standard_normal((3, 6, 1, 16),
                                                   np.float32))
    kv = torch.tensor([5 * bs, 2 * bs - 1, 3], dtype=torch.int32)
    bt = t(TABLE)
    clean = pa.paged_decode_attention_plain(q, t(kp), t(vp), bt, kv,
                                            window=window)
    kd, vd = t(kp).clone(), t(vp).clone()
    for row in range(3):
        n = int(kv[row])
        for pos in list(range(0, max(n - window, 0))) + list(
                range(n, 5 * bs)):
            blk = int(TABLE[row, pos // bs])
            if blk:
                kd[blk, :, pos % bs] = float("nan")
                vd[blk, :, pos % bs] = float("nan")
    kd[0], vd[0] = float("nan"), float("nan")
    dirty = pa.paged_decode_attention_plain(q, kd, vd, bt, kv,
                                            window=window)
    assert torch.equal(dirty, clean)


# ---------------------------------------------------------------------------
# The model and the engine.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma3_logits_match_reference(dtype):
    """Dense prefill and decode, paged chunks and paged decode of the
    smoke config at a 30-token prompt (window 16) against the reference."""
    got, want, gaps = torch_parity.logit_rows(ref_smoke(ARCH),
                                              smoke_config(ARCH), dtype,
                                              plen=30)
    assert got.shape == (2 + 3 * 2 + 4 + 3, smoke_config(ARCH).vocab_size)
    assert torch_parity.assert_logits_close(got, want, gaps, dtype) == []


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_gemma3_engine_tokens_equal_reference(layout):
    """fp32 weights: the port's engine serves the reference's greedy tokens
    on both layouts (3 slots, prompts of 4 to 28 tokens, 12 new tokens:
    every request's decode passes the window of 16)."""
    ref_cfg, cfg = ref_smoke(ARCH), smoke_config(ARCH)
    rp, params = torch_parity.weights(ref_cfg, cfg)
    prompts = [[(5 * i + j) % cfg.vocab_size for j in range(4 + 8 * i)]
               for i in range(4)]
    kw = dict(block_size=8) if layout == "paged" else {}
    ref = RefServeEngine(ref_build(ref_cfg), rp, max_batch=3, cache_len=48,
                         kv_layout=layout, **kw)
    eng = ServeEngine(build_model(cfg), params, max_batch=3, cache_len=48,
                      kv_layout=layout, **kw)
    want = [r.tokens for r in ref.generate(
        [RefRequest(p, 12, rid=i) for i, p in enumerate(prompts)])]
    got = [r.tokens for r in eng.generate(
        [Request(p, 12, rid=i) for i, p in enumerate(prompts)])]
    assert got == want


# ---------------------------------------------------------------------------
# Init at 27B.
# ---------------------------------------------------------------------------

def test_init_draws_large_leaves_in_runs_of_rows(monkeypatch):
    """A leaf past ``INIT_CHUNK_ELEMS`` is drawn a run of rows at a time
    (no draw larger than the limit), into a leaf of the asked dtype with
    the scale of its scheme; one within the limit is one draw, as before;
    the same seed gives the same params, another seed others."""
    monkeypatch.setattr(layers, "INIT_CHUNK_ELEMS", 1000)
    sizes = []
    randn = torch.randn

    def spy(*a, **kw):
        out = randn(*a, **kw)
        sizes.append(out.numel())
        return out
    monkeypatch.setattr(torch, "randn", spy)
    t = {"w": layers.PT((7, 20, 30), "scaled"),
         "e": layers.PT((300, 5), "normal"),
         "b": layers.PT((40,), "zeros")}
    p = layers.init_params(t, 3, device="cpu", dtype=torch.bfloat16)
    assert max(sizes) <= 1000 and sum(sizes) == 7 * 20 * 30 + 300 * 5
    assert sizes.count(600) == 7 and p["w"].dtype == torch.bfloat16
    std = p["w"].float().std().item()
    assert abs(std - 1 / np.sqrt(20)) < 0.02
    again = layers.init_params(t, 3, device="cpu", dtype=torch.bfloat16)
    other = layers.init_params(t, 4, device="cpu", dtype=torch.bfloat16)
    assert all(torch.equal(p[k], again[k]) for k in t)
    assert not torch.equal(p["w"], other["w"])
    sizes.clear()
    monkeypatch.setattr(layers, "INIT_CHUNK_ELEMS", 1 << 28)
    layers.init_params(t, 3, device="cpu", dtype=torch.bfloat16)
    assert sizes == [7 * 20 * 30, 300 * 5]


def test_full_width_leaves_fit_the_init_limit():
    """At gemma3-27b's width every leaf past the limit is a stack whose
    rows each fit it, so no fp32 draw exceeds 1 GiB; the model is 27.0e9
    parameters (54.0 GB in bf16)."""
    model = build_model(get_config(ARCH))
    assert model.n_params == 27_008_335_616

    def leaves(t):
        for v in t.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)
    for leaf in leaves(model.templates):
        n = int(np.prod(leaf.shape))
        assert n // leaf.shape[0] <= layers.INIT_CHUNK_ELEMS
