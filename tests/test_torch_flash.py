"""The port's dense attention (``repro_torch.kernels``) held against the
reference's (``repro.kernels.attention``): ``flash_attention_plain`` against
``attention_xla`` and against the Pallas ``flash_attention_pallas`` in
interpret mode (bq = bk = 32, as ``tests/test_attention.py`` runs it), the
dense oracle against the reference's oracle, and the plain
``decode_attention`` against ``decode_attention_xla``; and the CUDA
wrapper's route predicate (which kernel takes a dtype and head dim).  The
CUDA kernels are held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Inputs are made once from a seed with numpy and handed to both sides.
Tolerance: fp32, 1e-5 (the two sides sum in different orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.attention import (attention_xla, decode_attention_xla,
                                     flash_attention_pallas)
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

TOL = dict(rtol=1e-5, atol=1e-5)


def _qkv(seed, *, b=2, hkv=2, g=2, sq=64, sk=None, d=16):
    rng = np.random.default_rng(seed)
    sk = sk or sq
    arrays = (rng.standard_normal((b, hkv * g, sq, d), np.float32),
              rng.standard_normal((b, hkv, sk, d), np.float32),
              rng.standard_normal((b, hkv, sk, d), np.float32))
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a.copy()) for a in arrays])


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("g,causal,window", [(1, True, None),
                                             (2, False, None),
                                             (4, True, 24), (2, False, 24)])
def test_plain_matches_reference_xla_and_pallas(g, causal, window):
    """Causal, non-causal and windowed, GQA ratios 1, 2 and 4, at a size
    both reference paths take (S a multiple of the Pallas tile)."""
    j, t = _qkv(g, g=g)
    got = fa.flash_attention_plain(*t, causal=causal, window=window)
    _close(got, attention_xla(*j, causal=causal, window=window))
    _close(got, flash_attention_pallas(*j, causal=causal, window=window,
                                       bq=32, bk=32, interpret=True))


@pytest.mark.parametrize("sq,sk,causal", [(37, 37, True), (7, 7, True),
                                          (50, 83, True), (1, 29, False)])
def test_plain_takes_ragged_lengths(sq, sk, causal):
    """Any Sq <= Sk (prompts arrive unbucketed): against attention_xla,
    which takes any S <= 1024 in one chunk, and with the plain version's
    own chunks cut short (q_chunk = kv_chunk = 16) for ragged chunks."""
    j, t = _qkv(5, sq=sq, sk=sk)
    want = attention_xla(*j, causal=causal, window=None)
    _close(fa.flash_attention_plain(*t, causal=causal), want)
    _close(fa.flash_attention_plain(*t, causal=causal, q_chunk=16,
                                    kv_chunk=16), want)


def test_right_aligned_queries_and_fully_masked_rows():
    """Sq < Sk: queries sit at the last Sq positions.  Sq > Sk with the
    causal mask: the first Sq - Sk rows see no key and, with the finite
    -1e30 fill, end as the mean of V over every key — in the Pallas
    kernel, attention_xla and the plain version alike (the -inf oracles
    give 0 there instead)."""
    j, t = _qkv(7, sq=32, sk=64)
    got = fa.flash_attention_plain(*t)
    _close(got, flash_attention_pallas(*j, bq=32, bk=32, interpret=True))
    _close(got, jref.attention_ref(*j))
    j, t = _qkv(8, sq=64, sk=32)
    got = fa.flash_attention_plain(*t)
    _close(got, flash_attention_pallas(*j, bq=32, bk=32, interpret=True))
    _close(got, attention_xla(*j))
    _close(fa.flash_attention_plain(*t, q_chunk=16, kv_chunk=16),
           attention_xla(*j))
    g = t[0].shape[1] // t[1].shape[1]
    mean_v = t[2].mean(dim=2).repeat_interleave(g, dim=1)     # (B, Hq, D)
    for i in range(32):
        _close(got[:, :, i], mean_v.numpy())
    oracle = tref.attention_ref(*t)
    assert not oracle[:, :, :32].any()
    _close(oracle[:, :, 32:], np.asarray(got[:, :, 32:]))


@pytest.mark.parametrize("window", [None, 5])
def test_torch_oracle_matches_reference_oracle(window):
    for sq, sk in ((24, 64), (64, 40)):
        j, t = _qkv(9, g=4, sq=sq, sk=sk)
        _close(tref.attention_ref(*t, window=window),
               jref.attention_ref(*j, window=window))


def test_plain_decode_attention_matches_reference():
    """The dense decode path (plain PyTorch on every device): kv_len per
    row, a window, and a row with nothing valid (uniform over the cache,
    as the reference's softmax of -1e30 gives)."""
    j, t = _qkv(11, sq=1, sk=48)
    for kv in ([48, 17], [0, 1], [30, 48]):
        lens = np.asarray(kv, np.int32)
        for window in (None, 8):
            _close(ops.decode_attention(*t, torch.from_numpy(lens),
                                        window=window),
                   decode_attention_xla(*j, jnp.asarray(lens),
                                        window=window))


def test_attention_dispatch_by_device():
    """CPU tensors take the plain version; a device that is neither CPU nor
    CUDA raises; the CUDA wrapper refuses CPU tensors rather than falling
    back, and counts no launch."""
    _, t = _qkv(12)
    _close(ops.attention(*t, causal=True, window=8),
           fa.flash_attention_plain(*t, causal=True, window=8).numpy())
    with pytest.raises(ValueError, match="meta"):
        ops.attention(*[x.to("meta") for x in t])
    before = dict(fa.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_cuda(*t)
    assert fa.LAUNCHES == before


@pytest.mark.parametrize("d,dp", [(8, 16), (16, 16), (24, 32), (32, 32),
                                  (40, 64), (64, 64), (72, 128), (96, 128),
                                  (128, 128)])
def test_route_bf16_takes_the_tensor_cores_at_the_next_template(d, dp):
    """bf16 goes to the tensor-core kernel, built for head dims 16, 32, 64
    and 128: a head dim between two is zero-padded up to the next; fp32
    goes to the CUDA-core kernel at its own head dim."""
    assert fa.route(torch.bfloat16, d) == ("mma", dp)
    assert fa.route(torch.float32, d) == ("simt", d)


@pytest.mark.parametrize("dtype,d,err", [(torch.float16, 64, TypeError),
                                         (torch.float64, 64, TypeError),
                                         (torch.bfloat16, 0, ValueError),
                                         (torch.bfloat16, 12, ValueError),
                                         (torch.bfloat16, 136, ValueError),
                                         (torch.float32, 20, ValueError)])
def test_route_raises_on_what_no_kernel_takes(dtype, d, err):
    """No route for another dtype, nor for a head dim that is not a
    multiple of 8 up to 128: the wrapper raises, it never falls back."""
    with pytest.raises(err):
        fa.route(dtype, d)


def test_routes_count_each_route_and_reset_with_the_launches():
    """``ROUTES`` has one count for each route :func:`fa.route` names, and
    ``reset_launches`` zeroes it with ``LAUNCHES``; a refused CPU call
    moves neither."""
    assert set(fa.ROUTES) == {fa.route(torch.bfloat16, 64)[0],
                              fa.route(torch.float32, 64)[0]}
    saved = dict(fa.LAUNCHES), dict(fa.ROUTES)
    try:
        fa.LAUNCHES["flash_attention"] += 3
        fa.ROUTES["mma"] += 2
        fa.ROUTES["simt"] += 1
        fa.reset_launches()
        assert set(fa.LAUNCHES.values()) == set(fa.ROUTES.values()) == {0}
        _, t = _qkv(13)
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_attention_cuda(*(x.to(torch.bfloat16) for x in t))
        assert set(fa.LAUNCHES.values()) == set(fa.ROUTES.values()) == {0}
    finally:
        fa.LAUNCHES.update(saved[0])
        fa.ROUTES.update(saved[1])


@pytest.mark.parametrize("g,blocks", [(1, 1), (8, 1), (64, 1), (65, 2),
                                      (128, 2), (129, 3), (300, 5)])
def test_group_blocks_cover_any_group(g, blocks):
    """The fp32 route cuts a kv head's group of g q-heads into blocks of
    at most 64 (its rows a block): ceil(g / 64) blocks, which cover the
    group once; the reference's kernel has no cap on g, and neither has
    the wrapper."""
    assert fa.group_blocks(g) == blocks
    gh = min(g, 64)
    heads = [h for b in range(blocks) for h in range(b * gh,
                                                     min(g, (b + 1) * gh))]
    assert heads == list(range(g))


@pytest.mark.parametrize("g", [65, 128])
def test_plain_version_takes_groups_past_64(g):
    """The plain version, the CPU's path, on a group past 64 q-heads:
    every q-head equals the same head run as a group of one."""
    rng = np.random.default_rng(g)
    q = torch.from_numpy(rng.standard_normal((1, g, 9, 16), np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((1, 1, 9, 16), np.float32))
            for _ in range(2))
    got = ops.attention(q, k, v, causal=True, window=4)
    for h in (0, 63, 64, g - 1):
        want = ops.attention(q[:, h:h + 1], k, v, causal=True, window=4)
        torch.testing.assert_close(got[:, h:h + 1], want, rtol=1e-6,
                                   atol=1e-6)
