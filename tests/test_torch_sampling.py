"""The port's threefry sampling (``repro_torch.serving.sampling``) held
against ``jax.random`` under its defaults (jax 0.9:
``jax_threefry_partitionable=True``), and the engine's request-keyed
``_sample_rows`` against the reference's.

Bits, keys and uniforms must match exactly.  Gumbel noise is
``-log(-log(u))``, and torch's ``log`` and XLA's differ by up to one ulp
each; near ``u = 1/e`` the outer log is ill-conditioned, so the noise is
held to 2 ulp of ``max(|g|, 1)`` rather than of ``g`` itself.  Draws must
match exactly on the tested inputs."""
import jax
import numpy as np
import pytest
import torch

from repro.serving.engine import _sample_rows as ref_sample_rows
from repro_torch.serving import sampling
from repro_torch.serving.engine import _sample_rows

TINY = np.finfo(np.float32).tiny


def _words(key):
    """A jax key's two words as (1, 1) int64 tensors (one row)."""
    k = np.asarray(jax.random.key_data(key)).astype(np.int64)
    return torch.tensor([[k[0]]]), torch.tensor([[k[1]]])


def test_key_and_fold_in_match_jax():
    for seed in (0, 1, 42, 2 ** 31 - 1):
        want = np.asarray(jax.random.key_data(jax.random.key(seed)))
        assert sampling.key(seed) == tuple(int(w) for w in want)
    base = jax.random.key(7)
    kd = sampling.as_key(np.asarray(jax.random.key_data(base)))
    data = [0, 1, 3, 12345, 2 ** 31 + 5, 2 ** 32 - 1]
    a, b = sampling.fold_in(kd, torch.tensor(data))
    for i, d in enumerate(data):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(base, d)))
        assert [int(a[i]), int(b[i])] == want.tolist(), d
    # nested, one key per row: the engine's fold_in(fold_in(key, rid), t)
    rid, t = torch.tensor([3, 9]), torch.tensor([0, 17])
    a, b = sampling.fold_in(sampling.fold_in(kd, rid), t)
    for i in range(2):
        want = jax.random.fold_in(jax.random.fold_in(base, int(rid[i])),
                                  int(t[i]))
        assert [int(a[i]), int(b[i])] == \
            np.asarray(jax.random.key_data(want)).tolist()
    assert sampling.as_key(None) == sampling.key(0)
    with pytest.raises(ValueError):
        sampling.as_key([1, 2, 3])


@pytest.mark.parametrize("n", [1, 1001, 151936])
def test_bits_and_uniforms_match_jax_exactly(n):
    key = jax.random.key(n)
    bits = sampling.random_bits(_words(key), n, "cpu")[0]
    want = np.asarray(jax.random.bits(key, (n,)))
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32), want)
    u = sampling.uniform(bits)
    want_u = np.asarray(jax.random.uniform(key, (n,), minval=TINY,
                                           maxval=1.0))
    np.testing.assert_array_equal(u.numpy(), want_u)


def test_gumbel_within_two_ulp():
    key = jax.random.key(3)
    n = 100_000
    got = sampling.gumbel(_words(key), n, "cpu")[0].numpy()
    want = np.asarray(jax.random.gumbel(key, (n,)))
    assert np.isfinite(got).all()
    bound = 2 * np.spacing(np.maximum(np.abs(want), 1.0))
    assert (np.abs(got - want) <= bound).all()


def test_categorical_matches_jax():
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((64, 3000)) * 3).astype(np.float32)
    keys = jax.random.split(jax.random.key(11), 64)
    want = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    kd = np.asarray(jax.random.key_data(keys)).astype(np.int64)
    got = sampling.categorical(
        (torch.from_numpy(kd[:, 0]), torch.from_numpy(kd[:, 1])),
        torch.from_numpy(logits))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sample_rows_matches_reference():
    """Greedy and sampled rows side by side, at several temperatures, rids
    and stream indices, with the vocabulary of qwen3: the reference's jitted
    ``_sample_rows`` and the port's draw the same tokens."""
    rng = np.random.default_rng(1)
    logits = (rng.standard_normal((6, 151936)) * 4).astype(np.float32)
    temps = np.asarray([0.0, 0.7, 1.0, 0.0, 1.3, 0.2], np.float32)
    rids = np.asarray([0, 1, 5, 2, 77, 3], np.int32)
    idx = np.asarray([0, 0, 3, 9, 31, 2], np.int32)
    key = jax.random.key(0)
    want = np.asarray(jax.jit(ref_sample_rows)(logits, temps, key, rids, idx))
    got = _sample_rows(torch.from_numpy(logits), temps, sampling.key(0),
                       rids, idx)
    np.testing.assert_array_equal(got, want)
    assert (got[[0, 3]] == logits[[0, 3]].argmax(-1)).all()
