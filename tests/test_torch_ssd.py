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


# ---------------------------------------------------------------------------
# The bf16 route's design (csrc/ssd_scan.cu, route "mma"), emulated in plain
# PyTorch before the card: three phases, bf16 operands, fp32 sums.
# ---------------------------------------------------------------------------

def _bf16(v):
    return v.bfloat16().float()


def _parts(v, split):
    """v as the kernel feeds it to the tensor cores: hi = bf16(v) and
    lo = bf16(v - hi) (``split``), or hi alone (one rounding)."""
    hi = _bf16(v)
    return (hi, _bf16(v - hi)) if split else (hi,)


def _emulate_mma_route(x, dt, a_log, bm, cm, *, d_skip=None, h0=None,
                       split=True):
    """The mma route's arithmetic: chunk states dh_c = sum_j x_j (outer)
    (exp(s_last - s_j) dt_j B_j), a state pass h_c = exp(s_last,c) h_{c-1} +
    dh_c, and chunk outputs y = scores . x + exp(s_i) C . h_entering
    (+ d_skip x), scores = (C B^T) exp(s_i - s_j) dt_j under the causal mask.
    x, B and C are bf16 values; every product sums fp32 terms of bf16
    operands, the fp32 operand (w B, the scores, the entering state) split
    into hi + lo (``split``) or rounded once."""
    bsz, s, h, p = x.shape
    g, n = bm.shape[2:]
    q = ss.chunk_len(s)
    nc = s // q

    def chunks(t):
        return t.float().reshape(bsz, nc, q, *t.shape[2:])
    xc, dtc = chunks(x), chunks(dt)
    bc = chunks(bm).repeat_interleave(h // g, dim=3)       # (B, c, q, H, N)
    cc = chunks(cm).repeat_interleave(h // g, dim=3)
    s_ = torch.cumsum(dtc * -torch.exp(a_log.float()), dim=2)  # (B, c, q, H)
    last = s_[:, :, -1:]
    wb = (torch.exp(last - s_) * dtc)[..., None] * bc
    dh = sum(torch.einsum("bcjhp,bcjhn->bchpn", xc, part)
             for part in _parts(wb, split))
    dec = torch.exp(last[:, :, 0])                          # (B, c, H)
    state = (torch.zeros((bsz, h, p, n)) if h0 is None else h0.float())
    enter = []
    for c in range(nc):
        enter.append(state)
        state = dec[:, c, :, None, None] * state + dh[:, c]
    enter = torch.stack(enter, dim=1)                       # (B, c, H, P, N)
    st = s_.permute(0, 1, 3, 2)                             # (B, c, H, q)
    causal = torch.ones((q, q), dtype=torch.bool).tril()
    scores = torch.where(
        causal, torch.einsum("bcihn,bcjhn->bchij", cc, bc)
        * torch.exp(st[..., :, None] - st[..., None, :])
        * dtc.permute(0, 1, 3, 2)[..., None, :], 0.0)
    y = sum(torch.einsum("bchij,bcjhp->bcihp", part, xc)
            for part in _parts(scores, split))
    y = y + torch.exp(s_)[..., None] * sum(
        torch.einsum("bcihn,bchpn->bcihp", cc, part)
        for part in _parts(enter, split))
    if d_skip is not None:
        y = y + d_skip.float()[:, None] * xc
    return y.reshape(bsz, s, h, p).to(x.dtype), state


def _zamba2_ssd(s, seed):
    """bf16 x, B, C at zamba2-1.2b's SSD widths (H 64, P = N = 64, G 1) in
    the model's ranges, as numpy fp32 arrays of bf16 values: x normal,
    dt = softplus(N(-2, 1)), a_log = log U(1, 16), B and C 0.3 normal,
    d_skip normal, h0 0.2 normal."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def bf(a):
        return torch.from_numpy(a.astype(f32)).bfloat16().float().numpy()
    return [bf(rng.standard_normal((1, s, 64, 64))),
            np.logaddexp(rng.standard_normal((1, s, 64)) - 2.0, 0.0).astype(
                f32),
            np.log(rng.uniform(1.0, 16.0, 64)).astype(f32),
            bf(rng.standard_normal((1, s, 1, 64)) * 0.3),
            bf(rng.standard_normal((1, s, 1, 64)) * 0.3),
            rng.standard_normal(64).astype(f32),
            (rng.standard_normal((1, 64, 64, 64)) * 0.2).astype(f32)]


def _mma_vs_xla(s, extras, split):
    """(y within 1e-2, final state within 1e-4, max state error) of the
    emulation against ``ssd_xla`` on bf16 inputs at zamba2's widths."""
    x, dt, a_log, bm, cm, d_skip, h0 = _zamba2_ssd(s, seed=s + extras)
    kw = dict(d_skip=d_skip, h0=h0) if extras else {}
    yx, hx = ssd_xla(jnp.asarray(x, jnp.bfloat16), jnp.asarray(dt),
                     jnp.asarray(a_log), jnp.asarray(bm, jnp.bfloat16),
                     jnp.asarray(cm, jnp.bfloat16),
                     **{k: jnp.asarray(v) for k, v in kw.items()})
    y, h = _emulate_mma_route(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(dt),
        torch.from_numpy(a_log), torch.from_numpy(bm).bfloat16(),
        torch.from_numpy(cm).bfloat16(), split=split,
        **{k: torch.from_numpy(v) for k, v in kw.items()})
    assert y.dtype == torch.bfloat16 and h.dtype == torch.float32
    y_want = np.asarray(yx.astype(jnp.float32))
    y_ok = np.allclose(y.float().numpy(), y_want, atol=1e-2, rtol=1e-2)
    h_ok = np.allclose(h.numpy(), np.asarray(hx), atol=1e-4, rtol=1e-4)
    return y_ok, h_ok, float(np.abs(h.numpy() - np.asarray(hx)).max())


@pytest.mark.parametrize("extras", [False, True])
@pytest.mark.parametrize("s", [192, 960])
def test_mma_route_design_matches_xla_at_zamba2_widths(s, extras):
    """The bf16 route's three phases with split operands, against the
    reference's ``ssd_xla`` on the same bf16 inputs: y within the kernel's
    bf16 tolerance (1e-2), the final state within 1e-4, with and without
    h0 / d_skip, at S 192 (three chunks) and 960 (the served prompt)."""
    y_ok, h_ok, err = _mma_vs_xla(s, extras, split=True)
    assert y_ok and h_ok, err


def test_mma_route_with_one_bf16_rounding_fails_the_state_tolerance():
    """The same design with each fp32 operand rounded once to bf16 (as
    mamba_ssm's chunk kernels feed the tensor cores) misses the final
    state's 1e-4: the tolerance tells the two designs apart."""
    y_ok, h_ok, err = _mma_vs_xla(960, True, split=False)
    assert not h_ok and err > 1e-4, err


def test_routes_launches_and_workspace():
    """route: bf16 -> mma, fp32 -> simt, anything else raises.  Launches a
    call: mma 3 (states, state pass, outputs) or 1 where S is one chunk,
    simt 1.  The workspace holds every
    chunk's state and decay, 15.7 MB at the served shape, none for one
    chunk."""
    assert ss.route(torch.bfloat16) == "mma"
    assert ss.route(torch.float32) == "simt"
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        ss.route(torch.float16)
    assert [ss.kernels_per_call(s) for s in (7, 33, 64, 128, 960)] == \
        [1, 1, 1, 3, 3]
    assert [ss.kernels_per_call(s, torch.float32) for s in (7, 960)] == [1, 1]
    with pytest.raises(ValueError, match="multiple"):
        ss.kernels_per_call(200)
    assert ss.workspace_numel(1, 960, 64, 64, 64) * 4 == 15_732_480
    assert ss.workspace_numel(3, 192, 8, 16, 32) == 3 * 3 * 8 * (16 * 32 + 1)
    assert ss.workspace_numel(2, 64, 64, 64, 64) == 0
    ss.ROUTES["mma"] += 1
    ss.LAUNCHES["ssd_scan"] += 1
    ss.reset_launches()
    assert ss.ROUTES == {"mma": 0, "simt": 0}
    assert ss.LAUNCHES == {"ssd_scan": 0}
