"""JAX's threefry random streams and categorical sampling, bit for bit, in
integer torch ops on the logits' device.

The reference samples with ``jax.random`` (``repro/serving/engine.py:451``):
row ``i``'s ``t``-th token draws ``categorical(fold_in(fold_in(key, rid),
t), logits / temperature)``.  torch's own generators (Philox) give other
numbers from the same seed, so the port carries JAX's generator itself, as
jax 0.9 defines it with ``jax_threefry_partitionable=True`` (its default):

* ``threefry2x32`` — Threefry-2x32, 20 rounds, key schedule with
  ``0x1BD11BDA`` (``jax/_src/prng.py:883``);
* ``fold_in(key, data)`` — the hash of the counter pair ``(0, data)``
  (``prng.py:1163``);
* ``random_bits`` — 32-bit words of a shape: the hash of each element's
  flat index as the pair ``(hi, lo)``, the two halves xor-ed
  (``prng.py:1184``);
* ``uniform`` in ``[tiny, 1)``, ``gumbel = -log(-log(u))`` (mode "low") and
  ``categorical = argmax(logits + gumbel)`` (``jax/_src/random.py:435``,
  ``:1723``, ``:1739``).

A key is a pair of uint32 words, ``jax.random.key_data(jax.random.key(s))``:
``key(s)`` gives it for an integer seed.  Words live in int64 tensors masked
to 32 bits (torch's uint32 lacks arithmetic on some builds).  The bits and
the uniforms match JAX exactly; ``log`` may differ from XLA's by an ulp.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


def key(seed: int) -> tuple[int, int]:
    """The key of an integer seed (``jax.random.key(seed)``'s two words:
    the seed's high and low 32 bits)."""
    if seed < 0:
        raise ValueError(f"seed {seed} must be non-negative")
    return (seed >> 32) & MASK32, seed & MASK32


def as_key(k) -> tuple[int, int]:
    """A key given as two words (a tuple, a numpy array or a tensor), or
    None for seed 0 (the reference's default)."""
    if k is None:
        return key(0)
    words = [int(w) for w in k]
    if len(words) != 2:
        raise ValueError(f"a key is two uint32 words, got {len(words)}")
    return words[0] & MASK32, words[1] & MASK32


def _rotl(x, d: int):
    return ((x << d) | (x >> (32 - d))) & MASK32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32 of the counter pair ``(x1, x2)`` under the key
    ``(k1, k2)``; all four broadcast (ints or int64 tensors of 32-bit
    words).  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & MASK32
    b = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK32
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK32
        b = (b + ks[(i + 2) % 3] + i + 1) & MASK32
    return a, b


def fold_in(k, data):
    """``jax.random.fold_in``: ``k`` a key (two ints, or two int64 tensors
    for one key per row), ``data`` an int64 tensor (one word per row).
    Returns the new keys as two int64 tensors shaped like ``data``."""
    data = data & MASK32
    return threefry2x32(k[0], k[1], torch.zeros_like(data), data)


def random_bits(k, n: int, device):
    """``n`` 32-bit words per key, as ``jax.random.bits(key, (n,))`` draws
    them: ``k`` is two (R, 1) int64 tensors; returns (R, n) int64."""
    lo = torch.arange(n, dtype=torch.int64, device=device)[None, :]
    a, b = threefry2x32(k[0], k[1], torch.zeros_like(lo), lo)
    return a ^ b


def uniform(bits):
    """float32 uniforms in ``[tiny, 1)`` from 32-bit words, as
    ``jax.random.uniform(minval=tiny, maxval=1)``: the top 23 bits become
    the mantissa of a float in [1, 2), less 1, scaled and shifted."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = torch.tensor(_TINY, dtype=torch.float32, device=bits.device)
    hi = torch.tensor(1.0, dtype=torch.float32, device=bits.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(k, n: int, device):
    """Standard Gumbel noise (mode "low"), ``n`` draws per key."""
    return -torch.log(-torch.log(uniform(random_bits(k, n, device))))


def categorical(k, logits):
    """One draw per row of ``logits`` (R, V) under the row's key (two (R,)
    int64 tensors): ``argmax(logits + gumbel)``, the first index on ties."""
    rows = (k[0][:, None], k[1][:, None])
    noise = gumbel(rows, logits.shape[-1], logits.device)
    return torch.argmax(noise + logits, dim=-1)
