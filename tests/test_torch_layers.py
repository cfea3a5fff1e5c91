"""The port's layers (``repro_torch.models.layers``) against the
reference's (``repro.models.layers``) on the same numpy inputs.

Tolerances: fp32 at 1e-5 (summation order differs); RoPE at 1e-5 too —
both sides build frequencies in float64 numpy and rotate in fp32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


def test_rmsnorm_matches_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 64), np.float32) * 3.0
    w = rng.standard_normal((64,), np.float32) * 0.1
    _close(tl.rmsnorm(torch.from_numpy(w), torch.from_numpy(x), 1e-6),
           jl.rmsnorm(jnp.asarray(w), jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("per_row", [False, True])
def test_rope_matches_reference(theta, per_row):
    """Split-half RoPE at shared positions (S,) and per-row positions
    (B, S), at the smoke theta and the real config's."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 4, 5, 16), np.float32)
    pos = (rng.integers(0, 4096, (2, 5)) if per_row
           else np.arange(100, 105)).astype(np.int32)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta))
    np.testing.assert_array_equal(tl.rope_freqs(16, theta),
                                  jl.rope_freqs(16, theta))


def test_swiglu_and_embedding_match_reference():
    rng = np.random.default_rng(2)
    p = {k: rng.standard_normal(s, np.float32) * 0.1 for k, s in
         (("gate", (32, 48)), ("up", (32, 48)), ("down", (48, 32)))}
    x = rng.standard_normal((2, 3, 32), np.float32)
    _close(tl.swiglu_apply({k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x)),
           jl.swiglu_apply({k: jnp.asarray(v) for k, v in p.items()},
                           jnp.asarray(x)))
    emb = rng.standard_normal((50, 8), np.float32)
    tok = rng.integers(0, 50, (2, 3)).astype(np.int32)
    _close(tl.embed_lookup({"embedding": torch.from_numpy(emb)},
                           torch.from_numpy(tok)),
           jl.embed_lookup({"embedding": jnp.asarray(emb)}, jnp.asarray(tok)))


def test_leaf_path_matches_reference_keystr():
    """The string each leaf's seed hashes is the reference's keystr."""
    import jax
    tree = {"layers": {"attn": {"wq": 0}}, "embed": {"embedding": 0}}
    paths = [jax.tree_util.keystr(p) for p, _ in
             jax.tree_util.tree_flatten_with_path(tree)[0]]
    assert sorted(paths) == sorted([
        tl.leaf_path(("layers", "attn", "wq")),
        tl.leaf_path(("embed", "embedding"))])


def test_init_is_seeded_per_leaf_and_templated():
    """Same seed, same params; another seed, other params; leaves differ
    from each other; init schemes follow the templates."""
    t = {"a": tl.PT((64, 32), "scaled"), "b": tl.PT((64, 32), "scaled"),
         "n": {"z": tl.PT((8,), "zeros"), "e": tl.PT((100, 8), "normal")}}
    p1 = tl.init_params(t, 0, device="cpu", dtype=torch.float32)
    p2 = tl.init_params(t, 0, device="cpu", dtype=torch.float32)
    p3 = tl.init_params(t, 1, device="cpu", dtype=torch.float32)
    assert torch.equal(p1["a"], p2["a"]) and torch.equal(p1["n"]["e"],
                                                         p2["n"]["e"])
    assert not torch.equal(p1["a"], p3["a"])
    assert not torch.equal(p1["a"], p1["b"])
    assert not p1["n"]["z"].any()
    assert abs(p1["a"].std().item() - 1 / np.sqrt(64)) < 0.02
    assert abs(p1["n"]["e"].std().item() - 0.02) < 0.005
    assert tl.init_params(t, 0, device="cpu")["a"].dtype == torch.bfloat16
