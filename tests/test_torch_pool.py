"""The port's pool kernels (``repro_torch.kernels``: matmul, dotproduct,
softmax, conv2d) held against the reference's (``repro.kernels``): the
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
``rtol=1e-4, atol=1e-3``; softmax fp32 ``atol=1e-6``; conv2d ``1e-4``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import conv2d as k_conv2d
from repro_torch.kernels import dotproduct as k_dot
from repro_torch.kernels import matmul as k_matmul
from repro_torch.kernels import ops
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


def test_ops_dispatch_by_device_only():
    """A CPU tensor takes the plain version; a tensor on any device other
    than the CPU or CUDA raises."""
    x = torch.empty((2, 2), device="meta")
    for call in (lambda: ops.matmul(x, x), lambda: ops.dotproduct(x[0], x[0]),
                 lambda: ops.softmax(x),
                 lambda: ops.conv2d(x[None], x[None])):
        with pytest.raises(ValueError, match="no implementation"):
            call()


def test_cuda_wrappers_refuse_cpu_tensors_without_building():
    """The kernels' wrappers check their operands before any build or
    launch: a CPU tensor raises, and no count moves."""
    x = torch.ones((4, 4))
    calls = ((k_matmul.matmul_cuda, (x, x)),
             (k_dot.dotproduct_cuda, (x[0], x[0])),
             (k_softmax.softmax_cuda, (x,)),
             (k_conv2d.conv2d_cuda, (x[None], x[None, :3, :3])))
    for fn, args in calls:
        before = dict(fn.__globals__["LAUNCHES"])
        with pytest.raises(ValueError, match="CUDA device"):
            fn(*args)
        assert fn.__globals__["LAUNCHES"] == before
