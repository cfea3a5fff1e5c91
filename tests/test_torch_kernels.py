"""The port's paged-attention kernels (``repro_torch.kernels``) held against
the reference's (``repro.kernels``): the plain PyTorch versions against the
reference's ``xla`` functions, its Pallas kernels in interpret mode and its
oracles, on the cases of ``tests/test_kvcache.py``.  The hand-written CUDA
kernels are held against the plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Inputs are made once from a seed with numpy and handed to both sides.
Tolerance: fp32, 1e-5 (the two sides sum in different orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_attention import (paged_decode_attention_pallas,
                                           paged_decode_attention_xla,
                                           paged_prefill_attention_pallas,
                                           paged_prefill_attention_xla)
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)
BT = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 0, 0]], np.int32)


def _case(seed, *, n_blocks=9, hkv=2, bs=16, d=16, b=3, g=3, sq=1):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((n_blocks, hkv, bs, d), np.float32)
    vp = rng.standard_normal((n_blocks, hkv, bs, d), np.float32)
    q = rng.standard_normal((b, hkv * g, sq, d), np.float32)
    return q, kp, vp


def _both(*arrays):
    """The same numpy inputs as (jax arrays, torch tensors)."""
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(np.array(a)) for a in arrays])


def _decode(seed, lens):
    q, kp, vp = _case(seed)
    return _both(q, kp, vp, BT, np.asarray(lens, np.int32))


def _prefill(seed, starts):
    q, kp, vp = _case(seed, bs=8, g=2, sq=8)
    return _both(q, kp, vp, BT, np.asarray(starts, np.int32))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or TOL))


# ---------------------------------------------------------------------------
# Decode.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lens", [[64, 23, 17], [16, 16, 16], [1, 32, 33],
                                  [48, 17, 1]])
def test_plain_decode_matches_reference_xla_and_pallas(lens):
    """Full and partial blocks, kv_len at and just past block boundaries
    (the masked tail of a block and fully masked trailing blocks)."""
    j, t = _decode(1, lens)
    got = pa.paged_decode_attention_plain(*t)
    _close(got, paged_decode_attention_xla(*j))
    _close(got, paged_decode_attention_pallas(*j, interpret=True))


def test_plain_decode_ignores_garbage_past_kv_len():
    """Whatever sits at or past kv_len — huge values in the null block that
    rows 1/2's trailing entries point at, or NaN in every masked position
    of every table — never reaches the output."""
    j, t = _decode(3, [64, 23, 17])
    want = paged_decode_attention_xla(*j)
    q, kp, vp, bt, kv = t
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[0], vp2[0] = 1e6, -1e6
    _close(pa.paged_decode_attention_plain(q, kp2, vp2, bt, kv)[1:],
           want[1:])
    kp3, vp3 = kp.clone(), vp.clone()
    for b, n in enumerate(kv.tolist()):
        for col, blk in enumerate(bt[b].tolist()):
            lo = max(n - col * 16, 0)
            if blk and lo < 16:
                kp3[blk, :, lo:] = float("nan")
                vp3[blk, :, lo:] = float("nan")
    kp3[0], vp3[0] = float("nan"), float("nan")
    _close(pa.paged_decode_attention_plain(q, kp3, vp3, bt, kv), want)


def test_plain_decode_caps_the_walk_at_the_table():
    """An idle slot's position runs past M * bs: every table entry is then
    live, and no index leaves the table (the reference's Pallas kernel
    walks exactly its M blocks)."""
    j, t = _decode(4, [64 + 16, 23, 200])
    got = pa.paged_decode_attention_plain(*t)
    _close(got, paged_decode_attention_pallas(*j, interpret=True))
    _close(got, paged_decode_attention_xla(*j))


def test_plain_decode_empty_row_returns_zero():
    """kv_len == 0: nothing to attend, the output row is 0 (the reference's
    Pallas kernel divides by 1 where l == 0)."""
    j, t = _decode(5, [0, 23, 17])
    got = pa.paged_decode_attention_plain(*t)
    want = paged_decode_attention_pallas(*j, interpret=True)
    _close(got, want)
    assert not got[0].any()


# ---------------------------------------------------------------------------
# Chunked prefill.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("starts", [[24, 8, 0], [0, 0, 0], [8, 16, 24],
                                    [24, 24, 24]])
def test_plain_prefill_matches_reference_paths(starts):
    """Every chunk index, the first (block 0 alone) and the last (frontier
    at the table's end) included."""
    j, t = _prefill(6, starts)
    got = pa.paged_prefill_attention_plain(*t)
    _close(got, jref.paged_prefill_attention_ref(*j))
    _close(got, paged_prefill_attention_xla(*j))
    _close(got, paged_prefill_attention_pallas(*j, interpret=True))


def test_plain_prefill_ignores_blocks_past_frontier():
    """Blocks beyond a chunk's causal frontier never reach the output,
    whatever they hold (huge values, or NaN)."""
    j, t = _prefill(7, [24, 8, 0])
    want = jref.paged_prefill_attention_ref(*j)
    q, kp, vp, bt, qs = t
    for fill in (1e6, float("nan")):
        kp2, vp2 = kp.clone(), vp.clone()
        kp2[0], vp2[0] = fill, -fill
        for b, start in enumerate(qs.tolist()):
            for blk in bt[b, start // 8 + 1:].tolist():
                kp2[blk], vp2[blk] = fill, fill
        _close(pa.paged_prefill_attention_plain(q, kp2, vp2, bt, qs), want)


# ---------------------------------------------------------------------------
# Oracles and dispatch.
# ---------------------------------------------------------------------------

def test_torch_oracle_matches_reference_oracle():
    j, t = _prefill(8, [24, 8, 0])
    _close(tref.paged_prefill_attention_ref(*t),
           jref.paged_prefill_attention_ref(*j))
    _close(tref.paged_prefill_attention_ref(*t, window=5),
           jref.paged_prefill_attention_ref(*j, window=5))


def test_ops_dispatch_by_device():
    """CPU tensors take the plain version; a window raises (gemma3's slice);
    a device that is neither CPU nor CUDA raises; the CUDA wrappers refuse
    CPU tensors rather than falling back, and count no launch."""
    _, t = _decode(10, [64, 23, 17])
    _close(ops.paged_decode_attention(*t),
           pa.paged_decode_attention_plain(*t).numpy())
    _, tp = _prefill(10, [24, 8, 0])
    _close(ops.paged_prefill_attention(*tp),
           pa.paged_prefill_attention_plain(*tp).numpy())
    with pytest.raises(NotImplementedError, match="window"):
        ops.paged_decode_attention(*t, window=8)
    with pytest.raises(NotImplementedError, match="window"):
        ops.paged_prefill_attention(*tp, window=8)
    with pytest.raises(ValueError, match="meta"):
        ops.paged_decode_attention(*[x.to("meta") for x in t])
    before = dict(pa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_decode_attention_cuda(*t)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_prefill_attention_cuda(*tp)
    assert pa.LAUNCHES == before
