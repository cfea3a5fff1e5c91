"""The port's optimizer, schedules, data pipeline and checkpoints
(``repro_torch.optim``, ``repro_torch.data``, ``repro_torch.train.checkpoint``)
held against the reference's on the CPU.

* AdamW: three updates from the same state and gradients equal to the
  reference's (rtol 1e-6), no decay on 1-D leaves; the global-norm clip and
  both schedules likewise;
* ``SyntheticTokens``: batches byte-identical to the reference's (dense and
  vlm, steps 0 and 7); ``MMapTokens`` on a temporary file; the
  ``Prefetcher``'s order and stop;
* checkpoints: exact round trips of fp32, bf16 and int leaves, the latest
  step and cleanup, async saves, restoring a given step, no partial
  checkpoint, and each package restoring the other's bit for bit.

Inputs are made from a seed with numpy and handed to both sides.
"""
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke
from repro.data import MMapTokens as RefMMapTokens
from repro.data import SyntheticTokens as RefSyntheticTokens
from repro.optim import AdamW as RefAdamW
from repro.optim import clip_by_global_norm as ref_clip
from repro.optim import warmup_cosine as ref_warmup_cosine
from repro.optim import wsd as ref_wsd
from repro.train import checkpoint as ref_ckpt
from repro_torch.configs import smoke_config
from repro_torch.data import MMapTokens, Prefetcher, SyntheticTokens
from repro_torch.optim import AdamW, clip_by_global_norm, warmup_cosine, wsd
from repro_torch.train import checkpoint as ckpt
from repro_torch.tree import tree_leaves

SHAPES = {"w": (6, 8), "emb": (3, 4, 5), "norm": (8,)}


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them about
    as fast as many and keeps parallel test workers off each other's
    cores.  The old count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(rng, scale=1.0):
    return {k: (rng.standard_normal(s) * scale).astype(np.float32)
            for k, s in SHAPES.items()}


def _torch(tree):
    return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}


@pytest.mark.parametrize("lr", [2e-2, "warmup_cosine"])
def test_adamw_three_updates_match_reference(lr):
    rng = np.random.default_rng(0)
    params = _tree(rng)
    grads = [_tree(rng, 0.1) for _ in range(3)]
    kw = dict(weight_decay=0.1)
    ref_opt = RefAdamW(lr=(ref_warmup_cosine(3e-2, 2, 10)
                           if lr == "warmup_cosine" else lr), **kw)
    opt = AdamW(lr=warmup_cosine(3e-2, 2, 10) if lr == "warmup_cosine"
                else lr, **kw)
    rstate = ref_opt.init({k: jnp.asarray(v) for k, v in params.items()})
    state = opt.init(_torch(params))
    for g in grads:
        rstate = ref_opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                rstate)
        state = opt.update(_torch(g), state)
    assert int(state["step"]) == int(rstate["step"]) == 3
    for part in ("master", "m", "v"):
        for k in SHAPES:
            np.testing.assert_allclose(state[part][k].numpy(),
                                       np.asarray(rstate[part][k]),
                                       rtol=1e-6, atol=1e-9)


def test_adamw_decays_only_leaves_of_two_dims_or_more():
    """With zero gradients the update is the decay alone: 1-D leaves keep
    their masters, the others shrink by lr * wd * master."""
    params = _torch(_tree(np.random.default_rng(1)))
    opt = AdamW(lr=0.5, weight_decay=0.1)
    state = opt.init(params)
    state = opt.update({k: torch.zeros_like(v) for k, v in params.items()},
                       state)
    assert torch.equal(state["master"]["norm"], params["norm"])
    for k in ("w", "emb"):
        torch.testing.assert_close(state["master"][k], params[k] * 0.95)


def test_params_from_state_casts_to_like():
    params = {"a": torch.ones(3, dtype=torch.bfloat16), "b": torch.ones(2)}
    opt = AdamW()
    state = opt.init(params)
    assert state["master"]["a"].dtype == torch.float32
    out = opt.params_from_state(state, {"a": torch.bfloat16,
                                        "b": torch.float32})
    assert out["a"].dtype == torch.bfloat16
    assert out["b"].data_ptr() != state["master"]["b"].data_ptr()


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_matches_reference(max_norm):
    """fp32 and bf16 leaves, clipped and not: the scaled leaves in their
    own dtypes, bit for bit in bf16, and the norm (rtol 1e-6)."""
    rng = np.random.default_rng(2)
    g32 = rng.standard_normal((5, 7)).astype(np.float32)
    g16 = rng.standard_normal((9,)).astype(ml_dtypes.bfloat16)
    rout, rgn = ref_clip({"a": jnp.asarray(g32), "b": jnp.asarray(g16)},
                         max_norm)
    out, gn = clip_by_global_norm(
        {"a": torch.from_numpy(g32),
         "b": torch.from_numpy(g16.view(np.int16).copy()).view(
             torch.bfloat16)}, max_norm)
    np.testing.assert_allclose(float(gn), float(rgn), rtol=1e-6)
    np.testing.assert_allclose(out["a"].numpy(), np.asarray(rout["a"]),
                               rtol=1e-6)
    assert out["b"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        out["b"].view(torch.int16).numpy(),
        np.asarray(rout["b"]).view(np.int16))


@pytest.mark.parametrize("which", ["warmup_cosine", "wsd"])
def test_schedules_match_reference(which):
    ref = {"warmup_cosine": ref_warmup_cosine, "wsd": ref_wsd}[which]
    port = {"warmup_cosine": warmup_cosine, "wsd": wsd}[which]
    r, t = ref(1e-3, 5, 40), port(1e-3, 5, 40)
    for step in range(0, 45):
        np.testing.assert_allclose(
            float(t(torch.tensor(step, dtype=torch.int32))),
            float(r(jnp.asarray(step, jnp.int32))), rtol=1e-6, atol=1e-12)


# ---------------------------------------------------------------------------
# Data.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "phi-3-vision-4.2b"])
@pytest.mark.parametrize("step", [0, 7])
def test_synthetic_tokens_byte_identical(arch, step):
    ref = RefSyntheticTokens(ref_smoke(arch), 2, 32, seed=3)(step)
    got = SyntheticTokens(smoke_config(arch), 2, 32, seed=3)(step)
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape
        assert got[k].tobytes() == ref[k].tobytes()


def test_mmap_tokens_match_reference(tmp_path):
    path = str(tmp_path / "toks.bin")
    rng = np.random.default_rng(4)
    rng.integers(0, 400, 1000).astype(np.uint16).tofile(path)
    ref = RefMMapTokens(path, ref_smoke("qwen3-0.6b"), 3, 16, seed=1)
    got = MMapTokens(path, smoke_config("qwen3-0.6b"), 3, 16, seed=1)
    for step in (0, 5, 40):                    # 40: past the first epoch
        a, b = ref(step), got(step)
        for k in a:
            assert a[k].tobytes() == b[k].tobytes()
        assert b["tokens"].max() < 256         # clipped to the vocab
    with pytest.raises(ValueError):
        MMapTokens(path, smoke_config("qwen3-0.6b"), 100, 16)


def test_prefetcher_order_and_stop():
    src = SyntheticTokens(smoke_config("qwen3-0.6b"), 2, 8, seed=0)
    pf = Prefetcher(src, start_step=5, depth=2, device="cpu")
    for want in (5, 6, 7):
        step, batch = pf.next()
        assert step == want
        assert isinstance(batch["tokens"], torch.Tensor)
        assert batch["tokens"].numpy().tobytes() == \
            src(want)["tokens"].tobytes()
    pf.stop()
    assert not pf.thread.is_alive()


# ---------------------------------------------------------------------------
# Checkpoints.
# ---------------------------------------------------------------------------

def _state():
    g = torch.Generator().manual_seed(0)
    return {"master": {"w": torch.randn(4, 6, generator=g),
                       "n": torch.randn(6, generator=g)},
            "emb": torch.randn(3, 5, generator=g).to(torch.bfloat16),
            "step": torch.tensor(17, dtype=torch.int32),
            "ids": [torch.arange(4), (torch.ones(2, dtype=torch.int64),)]}


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def test_checkpoint_round_trip_and_layout(tmp_path):
    d = str(tmp_path)
    assert ckpt.save(d, 3, _state()) is None
    step, tree = ckpt.restore(d)
    assert step == 3 and _same(tree, _state())
    assert isinstance(tree["ids"][1], tuple)
    meta = json.load(open(os.path.join(d, "step_00000003", "tree.json")))
    dtypes = {info["dtype"] for info in meta["leaves"]}
    assert {"raw:bfloat16", "float32", "int32", "int64"} <= dtypes


def test_checkpoint_latest_cleanup_async_and_given_step(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(d)
    for s in (1, 2, 3, 4):
        st = _state()
        st["step"] += s
        th = ckpt.save(d, s, st, async_=True, keep_last=2)
        th.join()
    assert ckpt.list_steps(d) == [3, 4] and ckpt.latest_step(d) == 4
    step, tree = ckpt.restore(d, step=3)
    assert step == 3 and int(tree["step"]) == 20


def test_checkpoint_never_lists_a_partial_save(tmp_path):
    """A save cut short leaves ``step_N.tmp`` (or a directory with no
    tree.json), which list_steps and restore skip."""
    d = str(tmp_path)
    ckpt.save(d, 1, _state())
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    os.makedirs(os.path.join(d, "step_00000003"))
    assert ckpt.list_steps(d) == [1]
    assert ckpt.restore(d)[0] == 1


def test_checkpoints_cross_between_the_packages(tmp_path):
    """A checkpoint the reference wrote restores in the port bit for bit
    (bf16 as raw bytes, fp32, int32), and one the port wrote restores in
    the reference."""
    rng = np.random.default_rng(6)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    e = rng.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    ref_tree = {"master": {"w": jnp.asarray(w)}, "emb": jnp.asarray(e),
                "step": jnp.asarray(9, jnp.int32)}
    ref_ckpt.save(str(tmp_path / "ref"), 9, ref_tree)
    step, tree = ckpt.restore(str(tmp_path / "ref"))
    assert step == 9 and int(tree["step"]) == 9
    assert tree["step"].dtype == torch.int32
    assert tree["master"]["w"].numpy().tobytes() == w.tobytes()
    assert tree["emb"].dtype == torch.bfloat16
    assert tree["emb"].view(torch.int16).numpy().tobytes() == e.tobytes()
    ckpt.save(str(tmp_path / "port"), 9, tree)
    rstep, rtree = ref_ckpt.restore(str(tmp_path / "port"))
    assert rstep == 9
    for a, b in zip(jax.tree_util.tree_leaves(rtree),
                    jax.tree_util.tree_leaves(ref_tree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
