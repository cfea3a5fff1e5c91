"""The port's pool kernels (``repro_torch.kernels``: matmul, dotproduct,
softmax, fft, conv2d, pathfinder, jacobi2d, dropout, exp, dwt; and
roi_align, which has no kernel on either side) held against the
reference's (``repro.kernels``): the
port's ``ops`` on the CPU (the plain versions) against the reference's
``ops`` with ``impl="interpret"`` (the Pallas bodies on the CPU, at shapes
their tile asserts allow) and ``impl="xla"`` (any shape, the ragged ones
included), and the port's oracles against the reference's.  The CUDA
kernels are held against the plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.

Inputs are made once from a seed with numpy and handed to both sides (bf16
inputs are the same fp32 values rounded to nearest even on both).
Tolerances are the reference's own (``tests/test_kernels.py``): matmul
fp32 ``atol=2e-5 K``, bf16 ``2e-2 sqrt(K)`` with ``rtol=1e-2``; dotproduct
``rtol=1e-4, atol=1e-3``; softmax fp32 ``atol=1e-6``; conv2d ``1e-4``.
fft is held to ``5e-6 sqrt(n)``, about 2000 times tighter than the
reference's ``1e-2 sqrt(n)`` and some 7 times the reference's own distance
from an fp64 DFT; pathfinder, jacobi2d and dropout are held exactly, and
so are exp (against the Pallas body on the CPU) and dwt (fp32 against the
reference's oracle, bf16 against the Pallas body); the reference's own
tolerances for exp and dwt (``tests/test_kernels.py:63-117``) hold too."""
import fractions

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import expk as jexpk
from repro.kernels import ref as jref
from repro_torch.kernels import conv2d as k_conv2d
from repro_torch.kernels import dotproduct as k_dot
from repro_torch.kernels import dropout as k_dropout
from repro_torch.kernels import dwt as k_dwt
from repro_torch.kernels import expk as k_exp
from repro_torch.kernels import fft as k_fft
from repro_torch.kernels import jacobi2d as k_jacobi2d
from repro_torch.kernels import matmul as k_matmul
from repro_torch.kernels import ops
from repro_torch.kernels import pathfinder as k_pathfinder
from repro_torch.kernels import ref as tref
from repro_torch.kernels import softmax as k_softmax

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _both(seed, *shapes, dtype="float32", scale=1.0):
    """The same seeded normal inputs as (jax arrays, torch tensors)."""
    rng = np.random.default_rng(seed)
    arrays = [(rng.standard_normal(s) * scale).astype(np.float32)
              for s in shapes]
    jd, td = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _np(x):
    """A jax array or torch tensor as fp32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _mm_tol(dtype, k):
    if dtype == "float32":
        return dict(atol=2e-5 * k, rtol=1e-2)
    return dict(atol=2e-2 * np.sqrt(k), rtol=1e-2)


# ---------------------------------------------------------------------------
# matmul.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,k,n,aligned,kind", [
    (torch.float32, 4096, 4096, True, "sgemm"),
    (torch.float32, 129, 65, False, "sgemm"),
    (torch.bfloat16, 4096, 4096, True, "wgmma"),
    (torch.bfloat16, 8192, 512, True, "wgmma"),
    (torch.bfloat16, 8, 8, True, "wgmma"),
    (torch.bfloat16, 4096, 4096, False, "wmma"),
    (torch.bfloat16, 129, 65, True, "wmma"),
    (torch.bfloat16, 1000, 3, True, "wmma"),
    (torch.bfloat16, 12, 16, True, "wmma"),
    (torch.bfloat16, 0, 16, True, "wmma")])
def test_matmul_route_follows_what_tma_can_describe(dtype, k, n, aligned,
                                                    kind):
    """fp32 takes the CUDA-core kernel; bf16 the wgmma kernel wherever a
    TMA tensor map can describe both operands (K > 0, rows of A and B whole
    multiples of 16 bytes, 16-byte aligned bases), else the wmma kernel."""
    assert k_matmul.route(dtype, k, n, aligned=aligned) == kind


def test_matmul_route_raises_on_other_dtypes():
    with pytest.raises(TypeError):
        k_matmul.route(torch.float16, 64, 64)


def test_matmul_routes_reset_and_refuse_cpu_tensors():
    """``ROUTES`` has one count for each route :func:`k_matmul.route`
    names and ``reset_launches`` zeroes it with ``LAUNCHES``; neither the
    bf16 product nor the planted transpose-bit product runs on CPU tensors,
    and no count moves."""
    assert set(k_matmul.ROUTES) == {
        k_matmul.route(torch.float32, 64, 64),
        k_matmul.route(torch.bfloat16, 64, 64),
        k_matmul.route(torch.bfloat16, 63, 64)}
    saved = dict(k_matmul.LAUNCHES), dict(k_matmul.ROUTES)
    try:
        k_matmul.LAUNCHES["matmul"] += 3
        for name in k_matmul.ROUTES:
            k_matmul.ROUTES[name] += 1
        k_matmul.reset_launches()
        counts = (*k_matmul.LAUNCHES.values(), *k_matmul.ROUTES.values())
        assert set(counts) == {0}
        x = torch.ones((16, 16), dtype=torch.bfloat16)
        for fn in (k_matmul.matmul_cuda,
                   k_matmul.matmul_transpose_bit_flipped):
            with pytest.raises(ValueError, match="CUDA device"):
                fn(x, x)
        counts = (*k_matmul.LAUNCHES.values(), *k_matmul.ROUTES.values())
        assert set(counts) == {0}
    finally:
        k_matmul.LAUNCHES.update(saved[0])
        k_matmul.ROUTES.update(saved[1])


@pytest.mark.parametrize("m,k,n", [(128, 128, 128), (256, 384, 128),
                                   (128, 256, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_against_pallas_interpret(m, k, n, dtype):
    (jx, jw), (tx, tw) = _both(1, (m, k), (k, n), dtype=dtype)
    want = jops.matmul(jx, jw, impl="interpret", out_dtype=jnp.float32)
    got = ops.matmul(tx, tw, out_dtype=torch.float32)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(_np(got), _np(want), **_mm_tol(dtype, k))


@pytest.mark.parametrize("m,k,n", [(127, 129, 65), (1, 1, 1), (32, 32, 32),
                                   (5, 300, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matmul_ragged_against_xla(m, k, n, dtype):
    """Shapes no 128^3 tile divides; the default output dtype is x's."""
    (jx, jw), (tx, tw) = _both(2, (m, k), (k, n), dtype=dtype)
    want = jops.matmul(jx, jw, impl="xla")
    got = ops.matmul(tx, tw)
    assert got.dtype == DTYPES[dtype][1]
    np.testing.assert_allclose(_np(got), _np(want), **_mm_tol(dtype, k))


# ---------------------------------------------------------------------------
# dotproduct.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1024, 4096])
@pytest.mark.parametrize("impl", ["interpret", "xla"])
def test_dotproduct_against_reference(n, impl):
    (jx, jy), (tx, ty) = _both(3, (n,), (n,))
    got = ops.dotproduct(tx, ty)
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got),
                               float(jops.dotproduct(jx, jy, impl=impl)),
                               rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("n", [1000, 1, 65537])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dotproduct_ragged_against_xla(n, dtype):
    (jx, jy), (tx, ty) = _both(4, (n,), (n,), dtype=dtype)
    got = ops.dotproduct(tx, ty)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got),
                               float(jops.dotproduct(jx, jy, impl="xla")),
                               rtol=1e-4, atol=1e-3)


def test_dotproduct_grid_is_a_function_of_n():
    """The kernel's first-pass grid (and so its summation order) depends
    on n alone: one block per 4096 elements, 1 to 1024 blocks."""
    assert [k_dot.n_blocks(n) for n in (0, 1, 4096, 4097, 1 << 22,
                                        1 << 26)] == [1, 1, 1, 2, 1024, 1024]


# ---------------------------------------------------------------------------
# softmax.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 128), (32, 512)])
@pytest.mark.parametrize("impl", ["interpret", "xla"])
def test_softmax_against_reference(shape, impl):
    (jx,), (tx,) = _both(5, shape, scale=3.0)
    np.testing.assert_allclose(_np(ops.softmax(tx)),
                               _np(jops.softmax(jx, impl=impl)), atol=1e-6)


@pytest.mark.parametrize("shape", [(3, 1000), (1, 1), (5, 2, 7),
                                   (2, 12281)])
def test_softmax_ragged_against_xla(shape):
    """Any row count and width; leading axes are rows, as in ``xla``."""
    (jx,), (tx,) = _both(6, shape, scale=3.0)
    np.testing.assert_allclose(_np(ops.softmax(tx)),
                               _np(jops.softmax(jx, impl="xla")), atol=1e-6)


def test_softmax_large_logits_and_bf16():
    """A row scaled by 30 does not overflow (the max is subtracted first);
    bf16 rows come back in bf16, within one bf16 step of ``xla``."""
    (jx,), (tx,) = _both(7, (4, 1000), scale=30.0)
    got = ops.softmax(tx)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), _np(jops.softmax(jx, impl="xla")),
                               atol=1e-6)
    (jx,), (tx,) = _both(7, (3, 1000), dtype="bfloat16", scale=3.0)
    got = ops.softmax(tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(got), _np(jops.softmax(jx, impl="xla")),
                               atol=4e-3)


# ---------------------------------------------------------------------------
# conv2d.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(38, 64), (22, 32)])
def test_conv2d_against_pallas_interpret(hw):
    (jx, jw), (tx, tw) = _both(8, (3,) + hw, (3, 7, 7))
    want = jops.conv2d(jx, jw, impl="interpret")
    got = ops.conv2d(tx, tw)
    assert got.shape == (hw[0] - 6, hw[1] - 6)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("c,h,w,k", [(3, 128, 128, 7), (3, 7, 7, 7),
                                     (1, 9, 5, 3), (2, 40, 33, 1)])
def test_conv2d_ragged_against_xla(c, h, w, k):
    """bench_ideality's 3x128x128 (H-k+1 = 122, which conv2d_pallas's
    8-row blocks do not divide), a 1x1 output and odd shapes."""
    (jx, jw), (tx, tw) = _both(9, (c, h, w), (c, k, k))
    got = ops.conv2d(tx, tw)
    assert got.shape == (h - k + 1, w - k + 1)
    np.testing.assert_allclose(_np(got),
                               _np(jops.conv2d(jx, jw, impl="xla")),
                               atol=1e-4, rtol=1e-4)


def test_conv2d_bf16_follows_the_pallas_kernel():
    """bf16 in, bf16 out, as ``conv2d_pallas`` (``xla`` returns its
    oracle's fp32).  The port multiplies in fp32, the Pallas body rounds
    each product to bf16 before its fp32 sum, and both round the result to
    bf16: within 2e-2 absolute and relative (one bf16 step is 2^-8 of the
    value; |out| reaches ~8 here)."""
    (jx, jw), (tx, tw) = _both(10, (3, 38, 64), (3, 7, 7), dtype="bfloat16",
                               scale=1.0)
    want = jops.conv2d(jx, jw, impl="interpret")
    got = ops.conv2d(tx, tw)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert jops.conv2d(jx, jw, impl="xla").dtype == jnp.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-2, rtol=2e-2)


def _k_steps(k):
    """K-steps of 16 that the banded product takes a filter row: a 16 x 8
    output tile's band B[kk, n] = w[16 s + kk - n] spans k + 7 columns."""
    return -(-(k + 7) // 16)


def _conv2d_banded(x, w, shifted=None):
    """The mma route's arithmetic in plain torch: for each channel ci,
    filter row ki and K-step s, every 16 x 8 output tile gains A B with
    A[m, kk] = x[ci, i0+m+ki, j0+16s+kk] (zeros past the edge) and the
    Toeplitz band B[kk, n] = w[ci, ki, 16s+kk-n] (0 outside the filter
    row); bf16-valued operands, their exact products summed in fp32 a
    K-step at a time, the result rounded to x's dtype.  ``shifted=d``
    plants a fault: the band's diagonal kk - n = d moved to d + 1."""
    c, h, wd = x.shape
    k = w.shape[1]
    ho, wo = h - k + 1, wd - k + 1
    steps, tiles = _k_steps(k), -(-wo // 8)
    xp = torch.zeros((c, h, 8 * tiles + 16 * steps))
    xp[:, :, :wd] = x.float()
    kk, n = torch.arange(16)[:, None], torch.arange(8)[None, :]
    acc = torch.zeros((ho, tiles, 8))
    for ci in range(c):
        for ki in range(k):
            for s in range(steps):
                tap = 16 * s + kk - n                       # (16, 8)
                if shifted is not None:
                    tap = torch.where(tap == shifted + 1, shifted,
                                      torch.where(tap == shifted, -1, tap))
                band = torch.where((tap >= 0) & (tap < k),
                                   w[ci, ki].float()[tap.clamp(0, k - 1)],
                                   0.0)
                cols = 8 * torch.arange(tiles)[:, None] + 16 * s + \
                    torch.arange(16)[None, :]               # (tiles, 16)
                a = xp[ci, ki:ki + ho][:, cols]             # (ho, tiles, 16)
                acc += torch.einsum("mpk,kn->mpn", a, band)
    return acc.reshape(ho, 8 * tiles)[:, :wo].to(x.dtype)


# k 1 to 11 (two K-steps at 10 and up), W at 8m - 1, 8m and 8m + 1, and a
# 1 x 1 output; 8 output rows, one block of the Pallas kernel
BANDED_SHAPES = [(2, 7 + k, 32 + d, k) for k in (1, 3, 7, 9, 11)
                 for d in (-1, 0, 1)] + [(3, 7, 7, 7), (2, 11, 11, 11)]


@pytest.mark.parametrize("c,h,w,k", BANDED_SHAPES)
def test_conv2d_banded_product_against_the_reference(c, h, w, k):
    """The banded product on bf16 inputs against the plain version's
    arithmetic, the reference's oracle (``impl="xla"``) on the same values
    in fp32 (exact products) rounded to bf16, at atol 1e-4 and rtol one
    bf16 step, 2^-7; and against the Pallas body (``impl="interpret"`` on
    the bf16 inputs, which rounds each product to bf16, as ``xla`` does on
    bf16) within 2e-2 absolute and relative."""
    (jx, jw), (tx, tw) = _both(20 + k, (c, h, w), (c, k, k),
                               dtype="bfloat16")
    got = _conv2d_banded(tx, tw)
    assert got.dtype == torch.bfloat16 and got.shape == (h - k + 1, w - k + 1)
    plain = jops.conv2d(jx.astype(jnp.float32), jw.astype(jnp.float32),
                        impl="xla").astype(jnp.bfloat16)
    np.testing.assert_array_equal(_np(k_conv2d.conv2d_plain(tx, tw)),
                                  _np(plain))
    np.testing.assert_allclose(_np(got), _np(plain), atol=1e-4, rtol=2.0 ** -7)
    np.testing.assert_allclose(_np(got),
                               _np(jops.conv2d(jx, jw, impl="interpret")),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("k,shifted", [(3, 0), (7, 3), (11, 9)])
def test_conv2d_banded_tolerance_has_teeth(k, shifted):
    """A band with one diagonal moved a column over fails the tolerance
    the banded product is held to (so does the kernel's, on the card)."""
    (jx, jw), (tx, tw) = _both(30 + k, (2, 7 + k, 33), (2, k, k),
                               dtype="bfloat16")
    plain = _np(jops.conv2d(jx.astype(jnp.float32), jw.astype(jnp.float32),
                            impl="xla").astype(jnp.bfloat16))
    np.testing.assert_allclose(_np(_conv2d_banded(tx, tw)), plain,
                               atol=1e-4, rtol=2.0 ** -7)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(_np(_conv2d_banded(tx, tw, shifted)),
                                   plain, atol=1e-4, rtol=2.0 ** -7)


def test_conv2d_routes_and_counts():
    """bf16 takes the tensor cores (``mma``), fp32 the CUDA cores
    (``simt``), for every k (the kernels walk a large filter in bands);
    other dtypes and k < 1 raise; the band spans k + 7 columns, so k up to
    9 takes one K-step; ``reset_launches`` zeroes both counts."""
    for k in (1, 7, 9, 11, 61, 62, 97, 200):
        assert k_conv2d.route(torch.bfloat16, k) == "mma"
        assert k_conv2d.route(torch.float32, k) == "simt"
    with pytest.raises(TypeError):
        k_conv2d.route(torch.float16, 7)
    for k in (0, -1):
        with pytest.raises(ValueError):
            k_conv2d.route(torch.float32, k)
    assert [_k_steps(k) for k in (1, 9, 10, 25, 26, 61)] == \
        [1, 1, 2, 2, 3, 5]
    assert all(k_conv2d.k_steps(k) == _k_steps(k) for k in range(1, 300))
    assert set(k_conv2d.ROUTES) == {"mma", "simt"}
    k_conv2d.LAUNCHES["conv2d"] += 3
    k_conv2d.ROUTES["mma"] += 2
    k_conv2d.ROUTES["simt"] += 1
    k_conv2d.reset_launches()
    assert k_conv2d.LAUNCHES == {"conv2d": 0}
    assert k_conv2d.ROUTES == {"mma": 0, "simt": 0}
    assert k_conv2d.kernels_per_call((3, 64, 64), (3, 7, 7)) == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,c", [(1, 3), (7, 3), (61, 1), (61, 3), (62, 3),
                                 (97, 1), (121, 2), (122, 1), (200, 3),
                                 (513, 1)])
def test_conv2d_bands_walk_every_tap_once(dtype, k, c):
    """The kernel's band plan (``conv2d.bands``): a filter that fits (every
    k up to 62, the largest the first kernel took and one past it) takes
    one band, the kernel unchanged; any plan fits the card's 227 KB of
    shared memory and a TMA box of 256 a side; and the kernel's item order
    (channel, row band, column band) visits every filter tap of the route
    (simt: (ki, kj); mma: (ki, K-step)) exactly once, the simt route's in
    the fmaf order ki, kj."""
    kind = k_conv2d.route(dtype, k)
    units = k if kind == "simt" else k_conv2d.k_steps(k)
    kb, kw = k_conv2d.bands(dtype, k, c)
    if k <= 62:
        assert (kb, kw) == (k, units)
    assert k_conv2d.smem_bytes(kind, c, k, kb, kw) <= 227 * 1024
    assert 64 + kb - 1 <= 256 and k_conv2d._pitch(kind, kw) <= 256
    assert kw == units or kb == 1
    taps = [(ki, u) for rb in range(-(-k // kb)) for cb in range(-(-units // kw))
            for ki in range(rb * kb, min((rb + 1) * kb, k))
            for u in range(cb * kw, min((cb + 1) * kw, units))]
    assert sorted(taps) == [(ki, u) for ki in range(k) for u in range(units)]
    if kind == "simt":
        assert taps == sorted(taps)


# ---------------------------------------------------------------------------
# fft.
# ---------------------------------------------------------------------------

FFT_TOL = 5e-6      # times sqrt(n)


def _dft64(xr, xi):
    """The fp64 DFT of the inputs' values (numpy, an oracle only)."""
    return np.fft.fft(_np(xr).astype(np.float64)
                      + 1j * _np(xi).astype(np.float64))


def _fft_close(got, want, n):
    """Both planes of ``got`` (re, im) within 5e-6 sqrt(n) of ``want``, a
    complex array or a (re, im) pair."""
    if not isinstance(want, tuple):
        want = (want.real, want.imag)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w, np.float64),
                                   atol=FFT_TOL * np.sqrt(n), rtol=0)


@pytest.mark.parametrize("n", [2, 64, 512, 2048, 4096])
@pytest.mark.parametrize("impl", ["interpret", "xla"])
def test_fft_against_reference(n, impl):
    """fp32 out, within 5e-6 sqrt(n) of ``fft_pallas`` (interpret) and
    ``fft_xla``, and of an fp64 DFT."""
    (jr, ji), (tr, ti) = _both(30 + n, (n,), (n,))
    got = ops.fft(tr, ti)
    assert all(g.dtype == torch.float32 and g.shape == (n,) for g in got)
    _fft_close(got, tuple(map(_np, jops.fft(jr, ji, impl=impl))), n)
    _fft_close(got, _dft64(tr, ti), n)


def test_fft_bf16_planes_give_fp32():
    """bf16 planes in, fp32 out (as both reference impls), the transform
    of the bf16 values."""
    n = 2048
    (jr, ji), (tr, ti) = _both(31, (n,), (n,), dtype="bfloat16")
    got = ops.fft(tr, ti)
    assert all(g.dtype == torch.float32 for g in got)
    for impl in ("interpret", "xla"):
        want = jops.fft(jr, ji, impl=impl)
        assert all(w.dtype == jnp.float32 for w in want)
        _fft_close(got, tuple(map(_np, want)), n)
    _fft_close(got, _dft64(tr, ti), n)


def test_fft_parseval_and_the_bench_call():
    """Energy is kept (sum |y|^2 = n sum |x|^2, rtol 1e-5), and
    ``fft(a, a)``, the bench's call, is (1 + i) times a's transform."""
    n = 1024
    (_, _), (tr, ti) = _both(32, (n,), (n,))
    yr, yi = ops.fft(tr, ti)
    np.testing.assert_allclose(float((yr ** 2 + yi ** 2).sum()) / n,
                               float((tr ** 2 + ti ** 2).sum()), rtol=1e-5)
    ar, ai = ops.fft(tr, tr)
    want = (1 + 1j) * np.fft.fft(_np(tr).astype(np.float64))
    _fft_close((ar, ai), want, n)


@pytest.mark.parametrize("n", [1, 6, 1000])
def test_fft_rejects_lengths_that_are_not_powers_of_two(n):
    x = torch.ones(n)
    with pytest.raises(ValueError, match="power of two"):
        ops.fft(x, x)
    with pytest.raises(ValueError, match="power of two"):
        k_fft.kernels_per_call((n,))


def test_fft_plan_covers_every_stage_once():
    """The kernel's launches for each n: one block up to 4096; beyond,
    passes through device memory of 12 stages each, in order from stage 0,
    the last one the rest: ceil(t / 12) launches, so 2 from 8192 up to
    2^24 and 3 beyond."""
    for t in range(1, 31):
        steps = k_fft.plan(1 << t)
        if t <= 12:
            assert steps == [("local", t)]
            continue
        s = 0
        for kind, q, start in steps:
            assert kind == "pass" and start == s and 1 <= q <= 12
            s += q
        assert s == t
        assert all(q == 12 for _, q, _ in steps[:-1])
        assert len(steps) == -(-(t - 12) // 12) + 1
    assert [k_fft.kernels_per_call((n,)) for n in (2, 4096, 8192, 1 << 24,
                                                   1 << 25)] \
        == [1, 1, 2, 2, 3]


# ---------------------------------------------------------------------------
# pathfinder.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(20, 257), (64, 4096), (1, 5), (2, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["interpret", "xla"])
def test_pathfinder_exact_against_reference(shape, dtype, impl):
    """|normal| costs: the last row equals the reference's bit for bit,
    fp32 out for bf16 costs too (``xla`` returns a single bf16 row as it
    came, the same values)."""
    (jw,), (tw,) = _both(33, shape, dtype=dtype)
    jw, tw = jnp.abs(jw), tw.abs()
    got = ops.pathfinder(tw)
    assert got.dtype == torch.float32 and got.shape == (shape[1],)
    np.testing.assert_array_equal(_np(got),
                                  _np(jops.pathfinder(jw, impl=impl)))


def test_pathfinder_fill_follows_the_pallas_kernel():
    """The edge fill is the Pallas kernel's 3.0e38 (``_BIG``), not the
    reference oracle's fp32 max: a path cost of 3.2e38 next to the edge
    gives 3.0e38, as ``pathfinder_pallas``, where ``pathfinder_xla``
    gives 3.2e38."""
    w = np.array([[3.2e38], [0.0]], np.float32)
    got = ops.pathfinder(torch.from_numpy(w))
    pallas = np.asarray(jops.pathfinder(jnp.asarray(w), impl="interpret"))
    xla = np.asarray(jops.pathfinder(jnp.asarray(w), impl="xla"))
    assert got.item() == np.float32(3.0e38) == pallas[0]
    assert xla[0] == np.float32(3.2e38)


def test_pathfinder_launches_cover_every_row():
    """One launch per 64 rows after the first, one for a single row."""
    assert [k_pathfinder.kernels_per_call((r, 5)) for r in
            (1, 2, 65, 66, 1024)] == [1, 1, 1, 2, 16]


# csrc/pathfinder.cu's window: 1024 columns, 4 columns a thread
PF_WINDOW, PF_COLS = 1024, 4
PF_FILL = 3.0e38


def _pathfinder_tiled(w):
    """An emulation of csrc/pathfinder.cu's tiling (on no path): launches
    of ``HEIGHT`` rows over 1024-column windows that overlap by ``HEIGHT``
    halo columns a side, a thread's 4 contiguous columns of each cost row
    in a (threads, 4) view, neighbours from
    the adjacent thread (by shuffle in a warp, through the warps' edge
    values at a warp's ends), 3.0e38 beside the window's two ends and in
    the columns outside [0, cols), which are never updated.  Returns the
    last row in fp32 and the launches it took."""
    rows, cols = w.shape
    height = k_pathfinder.HEIGHT
    threads = PF_WINDOW // PF_COLS
    out = PF_WINDOW - 2 * height
    fill = torch.tensor(PF_FILL)
    src, launches, row0 = None, 0, 1
    while launches == 0 or row0 < rows:
        nrows = min(height, rows - row0)
        dst = torch.empty(cols)
        for b in range(-(-cols // out)):
            g = b * out - height + torch.arange(PF_WINDOW).view(threads,
                                                               PF_COLS)
            inside = (g >= 0) & (g < cols)
            gi = g.clamp(0, cols - 1)
            v = torch.where(inside, (w[row0 - 1].float() if src is None
                                     else src)[gi], fill)
            for i in range(nrows):
                cost = w[row0 + i].float()[gi]
                # the neighbour of column k of thread t: thread t's k - 1
                # or k + 1, else thread t - 1's last / t + 1's first
                left = torch.cat([fill.view(1), v[:-1, -1]])
                right = torch.cat([v[1:, 0], fill.view(1)])
                lft = torch.cat([left[:, None], v[:, :-1]], 1)
                rgt = torch.cat([v[:, 1:], right[:, None]], 1)
                v = torch.where(inside, cost + torch.minimum(
                    v, torch.minimum(lft, rgt)), v)
            done = (g >= b * out) & (g < (b + 1) * out) & inside
            dst[g[done]] = v[done]
        src, launches, row0 = dst, launches + 1, row0 + nrows
    return src, launches


def _plant(a, cells, values):
    a = a.copy()
    for (i, j), v in zip(cells, values):
        a[i % a.shape[0], j % a.shape[1]] = v
    return a


# rows at k HEIGHT + {0, 1, 2}, columns at k out - 1, k out, k out + 1
# (out = 1024 - 2 HEIGHT = 896, the columns a window finishes)
PF_RAGGED = [(64, 895), (65, 896), (66, 897), (128, 1791), (129, 1792),
             (130, 1793)]


@pytest.mark.parametrize("shape", PF_RAGGED)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("planted", [False, True])
def test_pathfinder_tiling_exact_against_pallas_interpret(shape, dtype,
                                                          planted):
    """The tiling of csrc/pathfinder.cu, emulated: bit for bit against the
    Pallas body (``impl="interpret"``) and the port's plain version, NaN
    for NaN, on shapes around the window's and a launch's edges, with NaN
    and +-inf planted at a window edge, a launch edge and the last
    column; its launches are ``kernels_per_call``."""
    rng = np.random.default_rng(37)
    w = np.abs(rng.standard_normal(shape)).astype(np.float32)
    if planted:
        w = _plant(w, [(1, 895), (64, 896), (65, 127), (-1, -1), (2, 0)],
                   [np.nan, np.inf, -np.inf, np.nan, np.inf])
    jd, td = DTYPES[dtype]
    tw = torch.from_numpy(w).to(td)
    got, launches = _pathfinder_tiled(tw)
    assert launches == k_pathfinder.kernels_per_call(shape)
    want = _np(jops.pathfinder(jnp.asarray(w).astype(jd), impl="interpret"))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(ops.pathfinder(tw)), want)


# ---------------------------------------------------------------------------
# jacobi2d.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(34, 66), (10, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jacobi2d_exact_against_pallas_interpret(shape, dtype):
    """Shapes the Pallas kernel's 8-row blocks divide: bit for bit, in
    x's dtype (bf16 rounds each add and the product, 0.2 rounded to
    bf16)."""
    (jx,), (tx,) = _both(34, shape, dtype=dtype)
    got = ops.jacobi2d(tx)
    assert got.dtype == DTYPES[dtype][1] and got.shape == shape
    np.testing.assert_array_equal(_np(got),
                                  _np(jops.jacobi2d(jx, impl="interpret")))


@pytest.mark.parametrize("shape", [(35, 67), (3, 3), (2, 5), (1, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("steps", [1, 3])
def test_jacobi2d_exact_against_xla(shape, dtype, steps):
    """Any shape (below 3 rows or columns a sweep is a copy) and several
    sweeps: bit for bit against ``jacobi2d_xla``."""
    (jx,), (tx,) = _both(35, shape, dtype=dtype)
    got = ops.jacobi2d(tx, steps=steps)
    assert got.dtype == DTYPES[dtype][1] and got.shape == shape
    np.testing.assert_array_equal(
        _np(got), _np(jops.jacobi2d(jx, impl="xla", steps=steps)))


# csrc/jacobi2d.cu's strip: 128 threads of 16 bytes (4 fp32 or 8 bf16
# columns) walk 64 rows down, 6 rows loaded ahead of the one computed
JC_THREADS, JC_ROWS, JC_AHEAD = 128, 64, 6


def _jacobi2d_strips(x, rows=JC_ROWS):
    """An emulation of csrc/jacobi2d.cu's sweep (on no path): column strips
    of 128 threads a block, each thread's 16-byte vector of a row in a
    (threads, V) view; row strips of ``rows`` walked down with the rows
    above, at and below the one computed in a ring of ``JC_AHEAD + 2``
    slots, each row loaded once into slot (r - start + 1) mod size and
    never past the strip's halo row; left and right neighbours from the
    adjacent thread, a warp's two edge elements by their own load; the
    first and last rows and columns copied."""
    h, w = x.shape
    v_per = 16 // x.element_size()
    span = JC_THREADS * v_per
    blocks = -(-w // span)
    c0 = torch.arange(blocks * JC_THREADS) * v_per          # every thread
    lane = torch.arange(blocks * JC_THREADS) % 32
    cols = c0[:, None] + torch.arange(v_per)                # (threads, V)
    inside = cols < w
    fifth = torch.tensor(0.2).to(x.dtype)
    zero = torch.zeros((), dtype=x.dtype)

    def load(r):
        xr = x[r]
        v = torch.where(inside, xr[cols.clamp(max=w - 1)], zero)
        le = torch.where((lane == 0) & (c0 > 0) & (c0 <= w),
                         xr[(c0 - 1).clamp(0, w - 1)], zero)
        re = torch.where((lane == 31) & (c0 + v_per < w),
                         xr[(c0 + v_per).clamp(max=w - 1)], zero)
        return v, le, re

    y = torch.empty_like(x)
    ring_size = JC_AHEAD + 2
    for ra in range(0, h, rows):
        rb = min(ra + rows, h)
        last = min(rb, h - 1)
        ring = [load(r) if 0 <= r <= last else None
                for r in range(ra - 1, ra - 1 + ring_size)]
        for r in range(ra, rb):
            s = (r - ra) % ring_size
            cur = ring[(s + 1) % ring_size]
            out = cur[0]
            if 0 < r < h - 1:
                (up, _, _), (c, le, re), (dn, _, _) = (
                    ring[s], cur, ring[(s + 2) % ring_size])
                # thread t - 1's last / t + 1's first, unless the lane is a
                # warp's end
                left = torch.where(lane == 0, le,
                                   torch.cat([zero.view(1), c[:-1, -1]]))
                right = torch.where(lane == 31, re,
                                    torch.cat([c[1:, 0], zero.view(1)]))
                lft = torch.cat([left[:, None], c[:, :-1]], 1)
                rgt = torch.cat([c[:, 1:], right[:, None]], 1)
                out = fifth * ((((c + up) + dn) + lft) + rgt)
                out = torch.where((cols == 0) | (cols == w - 1), c, out)
            y[r] = out[inside]
            if r + JC_AHEAD + 1 <= last:
                ring[s] = load(r + JC_AHEAD + 1)
    return y


@pytest.mark.parametrize("w_mod", range(8))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_jacobi2d_strips_exact_against_reference(w_mod, dtype):
    """The strips of csrc/jacobi2d.cu, emulated, at every W mod 8 (the
    widths whose rows are not all 16-byte aligned), H = 66 (strips of 64
    and 2 rows; bit for bit against the Pallas body, whose 8-row blocks
    divide 64, and ``jacobi2d_xla``) and H = 65 (a strip of one row; against
    ``jacobi2d_xla``), and strips of one row throughout, with NaN and
    +-inf planted at a strip edge and a warp edge."""
    shape = (66, 1024 + w_mod)
    rng = np.random.default_rng(38 + w_mod)
    x = _plant(rng.standard_normal(shape).astype(np.float32),
               [(63, 31), (64, 32), (1, 512), (40, 1023)],
               [np.nan, np.inf, -np.inf, np.inf])
    jd, td = DTYPES[dtype]
    tx = torch.from_numpy(x).to(td)
    jx = jnp.asarray(x).astype(jd)
    want = _np(jops.jacobi2d(jx, impl="xla"))
    np.testing.assert_array_equal(_np(jops.jacobi2d(jx, impl="interpret")),
                                  want)
    np.testing.assert_array_equal(_np(_jacobi2d_strips(tx)), want)
    np.testing.assert_array_equal(_np(_jacobi2d_strips(tx, rows=1)), want)
    np.testing.assert_array_equal(
        _np(_jacobi2d_strips(tx[:65])),
        _np(jops.jacobi2d(jx[:65], impl="xla")))


def test_jacobi2d_rounds_in_bf16_as_the_reference():
    """The bf16 schedule matters: one fp32 sum rounded once differs from
    the reference on this input, the port does not."""
    (jx,), (tx,) = _both(36, (34, 66), dtype="bfloat16")
    want = _np(jops.jacobi2d(jx, impl="xla"))
    x = tx.float()
    once = x.clone()
    once[1:-1, 1:-1] = 0.2 * (x[1:-1, 1:-1] + x[:-2, 1:-1] + x[2:, 1:-1]
                              + x[1:-1, :-2] + x[1:-1, 2:])
    assert (_np(once.bfloat16()) != want).any()
    np.testing.assert_array_equal(_np(ops.jacobi2d(tx)), want)


# ---------------------------------------------------------------------------
# dropout.
# ---------------------------------------------------------------------------

EDGE_BITS = [0, 1 << 31, (1 << 32) - 129, (1 << 32) - 128, (1 << 32) - 1]


def _bits(seed, n, edge=()):
    """Seeded uint32 bits as (jax, torch) arrays, the first ones ``edge``."""
    b = np.random.default_rng(seed).integers(0, 1 << 32, n, dtype=np.uint32)
    b[:len(edge)] = np.asarray(edge, np.uint32)[:n]
    return jnp.asarray(b), torch.from_numpy(b)


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_exact_against_pallas_interpret(rate, dtype):
    """The same mask bit for bit, and in bf16 the same values.  In fp32
    the reference splits (ROADMAP §3): the Pallas body, like a jitted
    ``xla``, multiplies by the reciprocal XLA folds, fl(1 / fl(1 - rate)),
    where the oracle and eager ``xla`` divide, as the port does.  Each side
    is held to its own formula bit for bit; they meet where the reciprocal
    is exact (rate 0.5)."""
    (jx,), (tx,) = _both(37, (2048,), dtype=dtype)
    jb, tb = _bits(38, 2048)
    got = _np(ops.dropout(tx, tb, rate=rate))
    want = _np(jops.dropout(jx, jb, rate=rate, impl="interpret"))
    keep = got != 0
    np.testing.assert_array_equal(keep, want != 0)
    assert abs(float(keep.mean()) - (1 - rate)) < 0.06
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got, want)
        return
    x, d = _np(tx), np.float32(1.0 - rate)
    np.testing.assert_array_equal(got[keep], x[keep] / d)
    np.testing.assert_array_equal(want[keep], x[keep] * (np.float32(1) / d))
    assert (rate == 0.5) == np.array_equal(got, want)


@pytest.mark.parametrize("n", [1000, 1])
@pytest.mark.parametrize("rate", [0.0, 0.1, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_exact_against_xla(n, rate, dtype):
    """Any n, and the bits at the edges of the fp32 conversion: 2^32 - 129
    gives u = 1 - 2^-24, 2^32 - 128 and above u = 1.0 (kept at every rate
    here); rate 0 keeps everything, divided by 1."""
    (jx,), (tx,) = _both(39, (n,), dtype=dtype)
    jb, tb = _bits(40, n, EDGE_BITS)
    got = ops.dropout(tx, tb, rate=rate)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (n,)
    np.testing.assert_array_equal(
        _np(got), _np(jops.dropout(jx, jb, rate=rate, impl="xla")))


def test_dropout_divides_by_one_minus_rate_in_x_dtype():
    """bf16 divides by bf16(0.9) = 0.8984375 at rate 0.1; an fp32 divisor
    gives other values on this input, the port does not."""
    (jx,), (tx,) = _both(41, (4096,), dtype="bfloat16")
    jb, tb = _bits(42, 4096)
    want = _np(jops.dropout(jx, jb, rate=0.1, impl="xla"))
    got = _np(ops.dropout(tx, tb, rate=0.1))
    keep = got != 0
    fp32 = (tx.float() / 0.9).bfloat16().float().numpy()
    assert (fp32[keep] != want[keep]).any()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# exp.
# ---------------------------------------------------------------------------

# past the clip (89, 100, -88, -200), a flushed subnormal (-87.5), a value
# that bf16 rounds past the flush (-87.3), zero, the infinities, NaN, fp32's
# extremes and subnormal inputs
EXP_EDGE = [89.0, 100.0, -87.3, -87.5, -88.0, -200.0, 0.0, np.inf, -np.inf,
            np.nan, 1e30, -1e30, 3e38, -3e38, 1e-40, -1e-45, 88.7, -87.33654]


def _exp_inputs(seed, n, scale, dtype, edge=True):
    """Seeded scale * normal values, EXP_EDGE at the head, as (jax, torch)
    arrays of one dtype."""
    x = (np.random.default_rng(seed).standard_normal(n) * scale).astype(
        np.float32)
    if edge:
        x[:len(EXP_EDGE)] = EXP_EDGE
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _ulps(a, b):
    """|a - b| in fp32 units in the last place, elementwise (finite, same
    sign)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exp_exact_against_pallas_interpret(dtype):
    """The Pallas body on the CPU, bit for bit, NaN for NaN, in x's dtype:
    8192 values of 30 normal (past both ends of the clip) and the edges."""
    jx, tx = _exp_inputs(50, 8192, 30.0, dtype)
    got = ops.exp(tx)
    assert got.dtype == DTYPES[dtype][1] and got.shape == (8192,)
    want = _np(jops.exp(jx, impl="interpret"))
    np.testing.assert_array_equal(_np(got), want)      # NaN equals NaN here
    head = _np(got)[:10]
    if dtype == "float32":      # 89, 100, -87.3, -87.5, -88, -200, 0, +-inf, nan
        assert head[0] == np.float32(2.2448058e38) and head[3] == 0.0
        assert head[5] == np.float32(1.6180544e-38) and head[6] == 1.0
    assert np.isnan(head[7:]).all() and not np.signbit(head[3])


def test_exp_within_the_reference_tolerances():
    """The reference's own tolerances (tests/test_kernels.py:63-76): within
    rtol 2e-5 / atol 1e-6 of ``jnp.exp`` on 4 normal, and within rtol 5e-5
    of numpy on [-20, 20]."""
    jx, tx = _exp_inputs(8, 2048, 4.0, "float32", edge=False)
    np.testing.assert_allclose(_np(ops.exp(tx)),
                               _np(jops.exp(jx, impl="xla")), rtol=2e-5,
                               atol=1e-6)
    x = np.linspace(-20.0, 20.0, 4096, dtype=np.float32)
    np.testing.assert_allclose(_np(ops.exp(torch.from_numpy(x))), np.exp(x),
                               rtol=5e-5)


def test_exp_eager_schedule_is_more_than_one_ulp_away():
    """Rounding each product and sum apart (the reference's ``_exp_poly``
    called eagerly, and the port's polynomial with such a multiply-add)
    parts from the Pallas body by more than one ulp on some inputs: the
    bit-for-bit test can fail."""
    jx, tx = _exp_inputs(51, 8192, 30.0, "float32", edge=False)
    want = _np(jops.exp(jx, impl="interpret"))
    eager_ref = _np(jexpk._exp_poly(jx))
    eager_port = _np(tref.exp_poly(tx, fma=lambda a, b, c: a * b + c))
    fin = np.isfinite(want) & (want > 0)
    for eager in (eager_ref, eager_port):
        assert _ulps(eager[fin], want[fin]).max() > 1
    np.testing.assert_array_equal(eager_port, eager_ref)


def _exp_fp32_last_step(x):
    """exp as csrc/expk.cu computes its last step: one fp32 multiply p 2^n,
    +0 where n is clipped to -126 and |p| < 1."""
    p, ni, two_n = tref.exp_parts(x)
    return torch.where((ni == -126) & (p.abs() < 1.0), 0.0, p * two_n)


def test_exp_fp32_last_step_equals_the_exact_product():
    """The kernel's fp32 last step equals the plain version's exact fp64
    product and flush bit for bit, NaN for NaN, on every bf16 bit pattern
    (65,536, taken in fp32) and on fp32's edges: +-0, subnormals, the
    least normal and its neighbours, +-inf, NaN, +-88.7, +-1e30, fp32's
    extremes, and a sweep across the flush near -87.34."""
    bf16 = torch.arange(1 << 16, dtype=torch.int32).to(torch.int16).view(
        torch.bfloat16).float()
    tiny = np.float32(2.0 ** -126)
    edges = np.array(EXP_EDGE + [0.0, -0.0, 1e-45, -1e-45, 1e-39, -1e-39,
                                 float(tiny), float(-tiny), 88.7, -88.7,
                                 3.4028235e38, -3.4028235e38,
                                 float(np.nextafter(tiny, np.float32(0))),
                                 float(np.nextafter(tiny, np.float32(1)))],
                     np.float32)
    sweep = np.float32(-87.33654) + np.arange(-4096, 4096, dtype=np.float32) \
        * np.float32(2 ** -17)
    for x in (bf16, torch.from_numpy(edges),
              torch.from_numpy(sweep.astype(np.float32))):
        got, want = _exp_fp32_last_step(x), tref.exp_poly(x)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        fin = ~torch.isnan(want)
        assert torch.equal(got[fin].view(torch.int32),
                           want[fin].view(torch.int32))


def _round_fp32(exact):
    """The fp32 value nearest a rational ``exact``, ties to even."""
    f = np.float32(float(exact))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    best = min(cands, key=lambda c: (abs(fractions.Fraction(float(c))
                                         - exact),
                                     int(np.asarray(c).view(np.int32)) & 1))
    return np.float32(best)


def test_fma32_rounds_once():
    """``ref.fma32`` is the correctly rounded a * b + c: on a case where
    an fp64 sum rounded again lands on an fp32 tie the exact sum is not
    on (c = 1 + 2^-23, a b = 2^-24 - 2^-70), and on seeded triples whose
    product is a few ulps of c, against exact rational arithmetic."""
    a = torch.tensor([1 + 2 ** -23], dtype=torch.float32)
    b = torch.tensor([2 ** -24 - 2 ** -47], dtype=torch.float32)
    c = a.clone()
    naive = (a.double() * b.double() + c.double()).float()
    assert naive.item() == 1 + 2 ** -22                   # the double rounding
    assert tref.fma32(a, b, c).item() == 1 + 2 ** -23     # the exact sum's
    rng = np.random.default_rng(52)
    a = rng.standard_normal(400).astype(np.float32)
    b = (rng.standard_normal(400) * 2.0 ** -rng.integers(0, 40, 400)).astype(
        np.float32)
    c = rng.standard_normal(400).astype(np.float32)
    got = tref.fma32(*(torch.from_numpy(t) for t in (a, b, c))).numpy()
    F = fractions.Fraction
    want = [_round_fp32(F(float(x)) * F(float(y)) + F(float(z)))
            for x, y, z in zip(a, b, c)]
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))


def test_exp_flushes_subnormal_results_to_positive_zero():
    """p 2^n below 2^-126 is +0, as XLA:CPU flushes it (PyTorch does not):
    around -87.34 the result steps from the least normal fp32 to 0."""
    x = np.float32(-87.33654) + np.arange(-64, 64, dtype=np.float32) * \
        np.float32(2 ** -17)
    got = _np(ops.exp(torch.from_numpy(x)))
    want = _np(jops.exp(jnp.asarray(np.resize(x, 1024)),
                        impl="interpret"))[:128]
    np.testing.assert_array_equal(got, want)
    assert (got == 0).any() and (got >= np.float32(2.0 ** -126)).any()
    assert not np.signbit(got).any()
    assert not ((got > 0) & (got < np.float32(2.0 ** -126))).any()


# ---------------------------------------------------------------------------
# dwt.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("levels", [1, 2, 3, 5])
def test_dwt_fp32_exact_against_the_oracle(levels):
    """fp32: the reference's oracle (``dwt_haar_xla``, eager) bit for bit;
    the interpret path, which contracts across its inlined levels, within
    the reference's 1e-4."""
    (jx,), (tx,) = _both(53, (1024,))
    got = ops.dwt_haar(tx, levels=levels)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), _np(jops.dwt_haar(
        jx, levels=levels, impl="xla")))
    np.testing.assert_array_equal(_np(got), _np(jref.dwt_haar_ref(jx,
                                                                  levels)))
    np.testing.assert_allclose(_np(got), _np(jops.dwt_haar(
        jx, levels=levels, impl="interpret")), atol=1e-4)


@pytest.mark.parametrize("n,levels", [(1024, 1), (1024, 2), (1024, 3),
                                      (4096, 5)])
def test_dwt_bf16_exact_against_pallas_interpret(n, levels):
    """bf16: the Pallas kernel's bits and dtype (each level rounded to
    bf16); the oracle's fp32 schedule rounded once at the end parts from
    it past one level."""
    (jx,), (tx,) = _both(54, (n,), dtype="bfloat16")
    got = ops.dwt_haar(tx, levels=levels)
    want = jops.dwt_haar(jx, levels=levels, impl="interpret")
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    fp32 = _np(tref.dwt_haar_ref(tx.float(), levels).bfloat16())
    assert np.array_equal(fp32, _np(got)) == (levels == 1)


@pytest.mark.parametrize("levels", [1, 2, 3])
def test_dwt_preserves_energy(levels):
    """Orthonormal: the energy is kept (tests/test_kernels.py:115)."""
    (tx,) = _both(14, (1024,))[1]
    got = ops.dwt_haar(tx, levels=levels)
    np.testing.assert_allclose(float((got.double() ** 2).sum()),
                               float((tx.double() ** 2).sum()), rtol=1e-4)


def test_dwt_takes_any_n_that_2_to_the_levels_divides():
    """Any n divisible by 2^levels (the Pallas kernel also asks its 512-pair
    blocks to divide each level) against the oracle, and a ValueError
    otherwise; one launch a call up to 10 levels, two up to 20."""
    for n, levels in ((2, 1), (6, 1), (3 << 11, 11), (96, 5)):
        (jx,), (tx,) = _both(55, (n,))
        np.testing.assert_array_equal(
            _np(ops.dwt_haar(tx, levels=levels)),
            _np(jref.dwt_haar_ref(jx, levels)))
    for n, levels in ((12, 3), (7, 1), (1, 1), (8, 0)):
        with pytest.raises(ValueError):
            ops.dwt_haar(torch.zeros(n), levels=levels)
    with pytest.raises(ValueError, match="vector"):
        ops.dwt_haar(torch.zeros(4, 4))
    assert [k_dwt.kernels_per_call((1 << 20,), levels=lv)
            for lv in (1, 10, 11, 20, 21)] == [1, 1, 2, 2, 3]
    assert k_exp.kernels_per_call((5,)) == 1


# ---------------------------------------------------------------------------
# Oracles, dispatch, and the wrappers' refusals on the CPU.
# ---------------------------------------------------------------------------

def test_oracles_match_the_reference_oracles():
    (jx, jw), (tx, tw) = _both(11, (33, 17), (17, 9))
    np.testing.assert_allclose(_np(tref.matmul_ref(tx, tw)),
                               _np(jref.matmul_ref(jx, jw)), atol=1e-5)
    (jx, jy), (tx, ty) = _both(12, (999,), (999,))
    np.testing.assert_allclose(float(tref.dotproduct_ref(tx, ty)),
                               float(jref.dotproduct_ref(jx, jy)), rtol=1e-5)
    (jx,), (tx,) = _both(13, (6, 77), scale=5.0)
    np.testing.assert_allclose(_np(tref.softmax_ref(tx)),
                               _np(jref.softmax_ref(jx)), atol=1e-7)
    (jx, jw), (tx, tw) = _both(14, (2, 12, 10), (2, 3, 3))
    got = tref.conv2d_ref(tx, tw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(jref.conv2d_ref(jx, jw)),
                               atol=1e-5)
    # fft: the port's oracle is the Stockham schedule, the reference's
    # jnp.fft
    (jr, ji), (tr, ti) = _both(15, (256,), (256,))
    _fft_close(tref.fft_ref(tr, ti), tuple(map(_np, jref.fft_ref(jr, ji))),
               256)
    # pathfinder: equal wherever no path cost reaches the fills (3.0e38
    # here, fp32's max there)
    (jw,), (tw,) = _both(16, (9, 33))
    np.testing.assert_array_equal(_np(tref.pathfinder_ref(tw.abs())),
                                  _np(jref.pathfinder_ref(jnp.abs(jw))))
    for dtype in ("float32", "bfloat16"):
        (jx,), (tx,) = _both(17, (12, 10), dtype=dtype)
        np.testing.assert_array_equal(_np(tref.jacobi2d_ref(tx, 2)),
                                      _np(jref.jacobi2d_ref(jx, 2)))
        jb, tb = _bits(18, 12 * 10, EDGE_BITS)
        (jx,), (tx,) = _both(19, (120,), dtype=dtype)
        np.testing.assert_array_equal(_np(tref.dropout_ref(tx, tb, 0.2)),
                                      _np(jref.dropout_ref(jx, jb, 0.2)))


def test_ops_dispatch_by_device_only():
    """A CPU tensor takes the plain version; a tensor on any device other
    than the CPU or CUDA raises."""
    x = torch.empty((2, 2), device="meta")
    for call in (lambda: ops.matmul(x, x), lambda: ops.dotproduct(x[0], x[0]),
                 lambda: ops.softmax(x),
                 lambda: ops.conv2d(x[None], x[None]),
                 lambda: ops.fft(x[0], x[0]), lambda: ops.pathfinder(x),
                 lambda: ops.jacobi2d(x),
                 lambda: ops.dropout(x[0], x[0], rate=0.1),
                 lambda: ops.exp(x[0]), lambda: ops.dwt_haar(x[0])):
        with pytest.raises(ValueError, match="no implementation"):
            call()


def test_cuda_wrappers_refuse_cpu_tensors_without_building():
    """The kernels' wrappers check their operands before any build or
    launch: a CPU tensor raises, and no count moves."""
    x = torch.ones((4, 4))
    calls = ((k_matmul.matmul_cuda, (x, x)),
             (k_dot.dotproduct_cuda, (x[0], x[0])),
             (k_softmax.softmax_cuda, (x,)),
             (k_conv2d.conv2d_cuda, (x[None], x[None, :3, :3])),
             (k_fft.fft_cuda, (x[0], x[0])),
             (k_pathfinder.pathfinder_cuda, (x,)),
             (k_jacobi2d.jacobi2d_cuda, (x,)),
             (k_dropout.dropout_cuda, (x[0], x[0].to(torch.uint32))),
             (k_exp.exp_cuda, (x[0],)), (k_dwt.dwt_haar_cuda, (x[0],)))
    for fn, args in calls:
        before = dict(fn.__globals__["LAUNCHES"])
        kw = {"rate": 0.1} if fn is k_dropout.dropout_cuda else {}
        with pytest.raises(ValueError, match="CUDA device"):
            fn(*args, **kw)
        assert fn.__globals__["LAUNCHES"] == before


def test_roi_align_matches_reference():
    """ROI-align (plain PyTorch everywhere, as the reference's XLA path):
    against ``roi_align_xla`` within 1e-5, and against the port's oracle
    at the reference's own ``atol=1e-4``
    (``tests/test_kernels.py::test_roi_align``); the port's oracle against
    the reference's (jitted: its Python loops trace slowly) at a 3 x 3
    output.  One ROI reaches past the image, so the clipping is walked
    too."""
    import jax
    rng = np.random.default_rng(20)
    feat = rng.standard_normal((4, 32, 32)).astype(np.float32)
    y0 = np.abs(rng.standard_normal(5)).astype(np.float32) * 3
    x0 = np.abs(rng.standard_normal(5)).astype(np.float32) * 3
    rois = np.stack([y0, x0, y0 + 11, x0 + 9], -1)
    rois[4] = [-3.0, 20.5, 7.0, 36.0]
    tf, tr = torch.from_numpy(feat), torch.from_numpy(rois)
    for kw in ({}, {"out_size": 3, "sampling": 3}):
        got = ops.roi_align(tf, tr, **kw)
        want = jops.roi_align(jnp.asarray(feat), jnp.asarray(rois), **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(),
                                   tref.roi_align_ref(tf, tr, **kw).numpy(),
                                   atol=1e-4)
    small = dict(out_size=3, sampling=2)
    want = jax.jit(lambda f, r: jref.roi_align_ref(f, r, **small))(
        jnp.asarray(feat), jnp.asarray(rois))
    np.testing.assert_allclose(tref.roi_align_ref(tf, tr, **small).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
