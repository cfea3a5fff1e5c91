"""Shared parity helpers for the port's moe and vlm tests: the reference's
own ``Model.init`` weights carried over by the bridge, and every logits row
of the dense and the paged serving paths from both packages on one set of
inputs."""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.models import build_model as ref_build
from repro_torch.bridge import params_from_reference
from repro_torch.models import build_model, moe

BS, M, B, N = 8, 8, 2, 24
# a top-k decision closer than this (relative gap between the k-th and the
# (k+1)-th router probability, one bf16 step) is within bf16 rounding of
# the router's input: the two packages round the hidden states at other
# points, so either may pick either expert
NEAR_TIE = 2.0 ** -7


def weights(ref_cfg, cfg, dtype="float32"):
    """(reference params, port params): the reference's seeded init, cast
    to fp32 or kept bf16, carried over bit for bit."""
    rp = ref_build(ref_cfg).init(jax.random.key(0))
    if dtype == "float32":
        rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), cfg,
                                     device="cpu")


def patches(cfg, rows, seed=0):
    """Seeded normal patch rows (numpy fp32), or None outside vlm."""
    if cfg.family != "vlm":
        return None
    return np.random.default_rng(seed).standard_normal(
        (rows, cfg.n_patches, cfg.patch_embed_dim)).astype(np.float32)


@contextlib.contextmanager
def router_gaps():
    """Record the smallest relative top-k gap of every port routing call
    made inside the block (appended to the yielded list)."""
    seen = []
    orig = moe._gates

    def spy(p, xt, k):
        probs, gates, ids = orig(p, xt, k)
        top = torch.sort(probs, dim=-1, descending=True).values
        seen.append(float(((top[..., k - 1] - top[..., k])
                           / top[..., k - 1]).min()))
        return probs, gates, ids
    moe._gates = spy
    try:
        yield seen
    finally:
        moe._gates = orig


def logit_rows(ref_cfg, cfg, dtype, plen=13, n_decode=3):
    """(port rows, reference rows): a dense prefill of B prompts of
    ``plen`` tokens (with their patch rows for vlm) and ``n_decode`` greedy
    decode steps on its cache; then the first prompt prefilled chunk by
    chunk into slot 0 of a paged cache (shuffled blocks, slot 1 idle) and
    ``n_decode`` paged decode steps.  Every logits row of both packages, in
    call order, and for each row the smallest router gap of the port's call
    that made it (inf outside moe)."""
    with router_gaps() as seen:
        return _logit_rows(ref_cfg, cfg, dtype, plen, n_decode, seen)


def _logit_rows(ref_cfg, cfg, dtype, plen, n_decode, seen):
    rmodel, model = ref_build(ref_cfg), build_model(cfg)
    rp, params = weights(ref_cfg, cfg, dtype)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "float32"
                else (jnp.bfloat16, torch.bfloat16))
    prompts = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, plen)).astype(np.int32)
    jb = {"tokens": jnp.asarray(prompts)}
    tb = {"tokens": torch.from_numpy(prompts)}
    pat = patches(cfg, B)
    if pat is not None:
        jb["patches"] = jnp.asarray(pat, jdt)
        tb["patches"] = torch.from_numpy(pat).to(tdt)
    npre = cfg.n_patches if cfg.family == "vlm" else 0
    total = npre + plen
    want, got, gaps = [], [], []

    def take(rl, tl, rows=slice(None)):
        want.append(np.asarray(rl)[rows])
        got.append(tl[rows].numpy())
        gaps.extend([min(seen, default=np.inf)] * len(got[-1]))
        seen.clear()

    rl, rc = jax.jit(rmodel.prefill, static_argnames="cache_len")(
        rp, jb, cache_len=total + n_decode)
    tl, tc = model.prefill(params, tb, cache_len=total + n_decode)
    take(rl, tl)
    rdec = jax.jit(rmodel.decode)
    for _ in range(n_decode):
        feed = np.argmax(want[-1], axis=-1).astype(np.int32)[:, None]
        rl, rc = rdec(rp, rc, jnp.asarray(feed))
        tl, tc = model.decode(params, tc, torch.from_numpy(feed))
        take(rl, tl)

    rpc = rmodel.paged_cache_init(batch=B, n_blocks=N, block_size=BS,
                                  max_blocks=M, dtype=jdt)
    pc = model.paged_cache_init(batch=B, n_blocks=N, block_size=BS,
                                max_blocks=M, dtype=tdt, device="cpu")
    n_chunks = -(-total // BS)
    for i, blk in enumerate([3, 7, 1, 12, 5, 9, 20, 14][:n_chunks + 1]):
        rpc["bt"] = rpc["bt"].at[0, i].set(blk)
        pc["bt"][0, i] = blk
    seq = [0] * npre + prompts[0].tolist()
    prefill, decode = (jax.jit(rmodel.prefill_paged),
                       jax.jit(rmodel.decode_paged))
    for c in range(n_chunks):
        toks = np.zeros((1, BS), np.int32)
        seg = seq[c * BS:(c + 1) * BS]
        toks[0, :len(seg)] = seg
        jc = {"tokens": jnp.asarray(toks)}
        tch = {"tokens": torch.from_numpy(toks)}
        if pat is not None:
            jc["patches"], tch["patches"] = jb["patches"][:1], \
                tb["patches"][:1]
        rl, rpc = prefill(rp, rpc, jc, 0, c, total)
        tl, pc = model.prefill_paged(params, pc, tch, 0, c, total)
        take(rl, tl)
    assert int(pc["pos"][0]) == int(rpc["pos"][0]) == total
    for _ in range(n_decode):
        feed = np.array([[int(np.argmax(want[-1][0]))], [0]], np.int32)
        rl, rpc = decode(rp, rpc, jnp.asarray(feed))
        tl, pc = model.decode_paged(params, pc, torch.from_numpy(feed))
        take(rl, tl, slice(0, 1))
    return np.concatenate(got), np.concatenate(want), np.asarray(gaps)


def assert_logits_close(got, want, gaps, dtype):
    """fp32 weights at atol = rtol = 1e-4 (same math, other summation
    orders), every row.  bf16 at 4% of the logits' scale (bf16 rounding at
    other points in XLA and in PyTorch), as ``test_torch_model.py``
    states; a bf16 row past it must come from a call that routed a token
    within ``NEAR_TIE`` (where either side may take the other expert).
    Returns those rows (the test bounds them); fp32 excuses none."""
    assert got.shape == want.shape and len(gaps) == len(got)
    assert np.isfinite(got).all()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return []
    err = np.abs(got - want).max(axis=-1) / np.abs(want).max()
    parted = np.flatnonzero(err > 0.04)
    assert (gaps[parted] < NEAR_TIE).all(), (err, gaps)
    return parted.tolist()
