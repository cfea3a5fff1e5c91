"""The port's SSD scan (``repro_torch.kernels.ssd_scan``) held against the
reference on the same numpy-seeded inputs: ``ssd_plain`` against
``ssd_xla``, ``ssd_pallas(interpret=True)`` and the sequential oracle
``ssd_ref`` (the reference's and the port's), ``ssd_step_plain`` against
``ssd_step_xla``, and the dispatch of ``ops.ssd_scan`` / ``ops.ssd_step``.
fp32 at atol 2e-5, as ``tests/test_ssd.py`` holds the reference (chunked
vs sequential: other summation orders)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import ssd_ref as ref_ssd_ref
from repro.kernels.ssd_scan import ssd_pallas, ssd_step_xla, ssd_xla
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels.ref import ssd_ref

ATOL = 2e-5


def make_inputs(b=2, s=128, h=4, p=16, g=2, n=8, seed=0, extras=False):
    """x, dt (softplus'd), a_log, B, C (and d_skip, h0) as numpy fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32) * 0.5
    dt = (np.logaddexp(rng.standard_normal((b, s, h)), 0.0) * 0.1
          ).astype(np.float32)
    a_log = rng.standard_normal(h).astype(np.float32) * 0.5
    bm = rng.standard_normal((b, s, g, n)).astype(np.float32) * 0.3
    cm = rng.standard_normal((b, s, g, n)).astype(np.float32) * 0.3
    out = [x, dt, a_log, bm, cm]
    if extras:
        out.append(rng.standard_normal(h).astype(np.float32) * 0.5)
        out.append(rng.standard_normal((b, h, p, n)).astype(np.float32) * 0.2)
    return out


def _jax(arrs):
    return [None if a is None else jnp.asarray(a) for a in arrs]


def _torch(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_plain_matches_xla_and_oracles(chunk, g):
    args = make_inputs(g=g)
    yx, hx = ssd_xla(*_jax(args), chunk=chunk)
    y, h = ss.ssd_plain(*_torch(args), chunk=chunk)
    _close(y, yx)
    _close(h, hx)
    yr, hr = ssd_ref(*_torch(args))
    _close(y, yr)
    _close(h, hr)
    yrr, hrr = ref_ssd_ref(*_jax(args))          # both oracles agree
    _close(yr, yrr)
    _close(hr, hrr)


@pytest.mark.parametrize("s", [7, 33, 64])
def test_short_prompt_is_one_chunk(s):
    """S <= 64: the whole sequence is one chunk of Q = S (ragged tile)."""
    args = make_inputs(s=s, g=1)
    yx, hx = ssd_xla(*_jax(args))
    y, h = ss.ssd_plain(*_torch(args))
    _close(y, yx)
    _close(h, hx)


def test_plain_matches_pallas_interpret():
    args = make_inputs()
    yp, hp = ssd_pallas(*_jax(args), chunk=32, interpret=True)
    y, h = ss.ssd_plain(*_torch(args), chunk=32)
    _close(y, yp)
    _close(h, hp)


@pytest.mark.parametrize("chunk", [16, 64])
def test_d_skip_and_h0(chunk):
    x, dt, a_log, bm, cm, d_skip, h0 = make_inputs(s=64, extras=True)
    yx, hx = ssd_xla(*_jax([x, dt, a_log, bm, cm]), d_skip=jnp.asarray(d_skip),
                     h0=jnp.asarray(h0), chunk=chunk)
    t = _torch([x, dt, a_log, bm, cm])
    y, h = ss.ssd_plain(*t, d_skip=torch.from_numpy(d_skip),
                        h0=torch.from_numpy(h0), chunk=chunk)
    _close(y, yx)
    _close(h, hx)
    yr, hr = ssd_ref(*t, d_skip=torch.from_numpy(d_skip),
                     h0=torch.from_numpy(h0))
    _close(y, yr)
    _close(h, hr)


def test_bf16_inputs_round_y_once():
    """bf16 x / B / C: fp32 math, y rounded once to bf16 (d_skip added in
    fp32 before the rounding, as ssd_xla does): within one bf16 step of
    ssd_xla's y at |y| < 1 (the fp32 values before rounding differ in the
    last bits, so a few land on the other side of a rounding boundary)."""
    x, dt, a_log, bm, cm, d_skip, _ = make_inputs(s=64, extras=True)
    xb, bb, cb = (torch.from_numpy(a).bfloat16() for a in (x, bm, cm))
    y, h = ss.ssd_plain(xb, torch.from_numpy(dt), torch.from_numpy(a_log),
                        bb, cb, d_skip=torch.from_numpy(d_skip))
    assert h.dtype == torch.float32
    yx, hx = ssd_xla(*_jax([xb.float().numpy(), dt, a_log, bb.float().numpy(),
                            cb.float().numpy()]), d_skip=jnp.asarray(d_skip))
    assert y.dtype == torch.bfloat16
    _close(y.float(), np.asarray(yx), atol=2 ** -8)
    _close(h, hx)


def test_step_matches_xla_and_is_a_prefix_of_the_scan():
    """ssd_step_plain against ssd_step_xla at every position, and the
    stepped recurrence equals the chunked scan token by token."""
    x, dt, a_log, bm, cm, d_skip, h0 = make_inputs(s=32, extras=True)
    t = _torch([x, dt, a_log, bm, cm, d_skip, h0])
    y_scan, h_scan = ss.ssd_plain(*t[:5], d_skip=t[5], h0=t[6], chunk=16)
    state_t, state_j = t[6], jnp.asarray(h0)
    for i in range(x.shape[1]):
        yt, state_t = ss.ssd_step_plain(state_t, t[0][:, i], t[1][:, i], t[2],
                                        t[3][:, i], t[4][:, i], d_skip=t[5])
        yj, state_j = ssd_step_xla(state_j, jnp.asarray(x[:, i]),
                                   jnp.asarray(dt[:, i]), jnp.asarray(a_log),
                                   jnp.asarray(bm[:, i]), jnp.asarray(cm[:, i]),
                                   d_skip=jnp.asarray(d_skip))
        _close(yt, yj)
        _close(state_t, state_j)
        _close(yt, y_scan[:, i])
    _close(state_t, h_scan)


def test_ragged_length_raises():
    """S > 64 and S % 64 != 0: the reference asserts, the port raises."""
    args = _torch(make_inputs(s=200))
    with pytest.raises(ValueError, match="multiple"):
        ss.ssd_plain(*args)
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_scan(*args)


def test_dispatch_follows_the_device():
    """ops.ssd_scan takes the plain version on a CPU tensor, h0 or not, and
    counts no launch; ops.ssd_step is plain everywhere."""
    x, dt, a_log, bm, cm, d_skip, h0 = _torch(make_inputs(s=64, extras=True))
    before = dict(ss.LAUNCHES)
    y, h = ops.ssd_scan(x, dt, a_log, bm, cm, d_skip=d_skip, h0=h0)
    yp, hp = ss.ssd_plain(x, dt, a_log, bm, cm, d_skip=d_skip, h0=h0)
    assert torch.equal(y, yp) and torch.equal(h, hp)
    assert ss.LAUNCHES == before
    with pytest.raises(ValueError, match="no implementation"):
        ops.ssd_scan(x.to("meta"), dt, a_log, bm, cm)
    ys, hs = ops.ssd_step(h0, x[:, 0], dt[:, 0], a_log, bm[:, 0], cm[:, 0],
                          d_skip=d_skip)
    assert torch.equal(ys, ss.ssd_step_plain(h0, x[:, 0], dt[:, 0], a_log,
                                             bm[:, 0], cm[:, 0],
                                             d_skip=d_skip)[0])


def test_cuda_wrapper_rejects_cpu_tensors_before_any_launch():
    """The kernel's wrapper raises on a tensor off the card (it is never a
    quiet path to the plain version) and counts nothing."""
    args = _torch(make_inputs(s=64))
    before = dict(ss.LAUNCHES)
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_cuda(*args)
    assert ss.LAUNCHES == before
