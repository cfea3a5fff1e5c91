"""The port on the card: the hand-written CUDA kernels against their plain
PyTorch versions, their input checks and launch counts, and the model and
engine on CUDA against the same code on the CPU.

Every test here is marked ``gpu`` and skips without a card; the file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.kernels import conv2d as k_conv2d
from repro_torch.kernels import dotproduct as k_dot
from repro_torch.kernels import dropout as k_dropout
from repro_torch.kernels import dwt as k_dwt
from repro_torch.kernels import expk as k_exp
from repro_torch.kernels import fft as k_fft
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import jacobi2d as k_jacobi2d
from repro_torch.kernels import matmul as k_matmul
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import pathfinder as k_pathfinder
from repro_torch.kernels import ref
from repro_torch.kernels import softmax as k_softmax
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import ideality
from repro_torch.models import build_model
from repro_torch.serving import Request, ServeEngine

pytestmark = pytest.mark.gpu

BT = np.array([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 0, 0]], np.int32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU "
                    "interpret mode)")
    return torch.device("cuda")


def _case(seed, lens, *, bs, g, sq, dtype, dev, d=16, hkv=2):
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((9, hkv, bs, d), np.float32)
    vp = rng.standard_normal((9, hkv, bs, d), np.float32)
    q = rng.standard_normal((3, hkv * g, sq, d), np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (q, kp, vp, BT,
                                              np.asarray(lens, np.int32))]
    return [x.to(dtype) if x.is_floating_point() else x for x in t]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_kernels_match_plain_with_garbage_planted(cuda, dtype, tol):
    """Both kernels against their plain versions on the same inputs, with
    NaN wherever neither may read (masked tails, the null block, blocks
    past a chunk's frontier); the result must be finite.  fp32 at 1e-5; bf16 at 1e-2 (outputs
    rounded from fp32: one ulp at |x|~1 is 7.8e-3)."""
    for lens in ([64, 23, 17], [1, 32, 33], [80, 16, 0]):
        q, kp, vp, bt, kv = _case(1, lens, bs=16, g=3, sq=1, dtype=dtype,
                                  dev=cuda)
        kpn, vpn = kp.clone(), vp.clone()
        reads_null = False
        for b, n in enumerate(lens):
            for col, blk in enumerate(BT[b].tolist()):
                lo = max(n - col * 16, 0)
                if blk == 0:
                    reads_null |= lo > 0
                elif lo < 16:
                    kpn[blk, :, lo:], vpn[blk, :, lo:] = float("nan"), \
                        float("nan")
        if not reads_null:          # no row's valid range reaches block 0
            kpn[0], vpn[0] = float("nan"), float("nan")
        n0 = pa.LAUNCHES["paged_decode_attention"]
        got = pa.paged_decode_attention_cuda(q, kpn, vpn, bt, kv)
        assert pa.LAUNCHES["paged_decode_attention"] == n0 + 1
        want = pa.paged_decode_attention_plain(q, kpn, vpn, bt, kv)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
    for starts in ([24, 8, 0], [0, 0, 0], [8, 16, 24]):
        q, kp, vp, bt, qs = _case(2, starts, bs=8, g=2, sq=8, dtype=dtype,
                                  dev=cuda)
        kpn, vpn = kp.clone(), vp.clone()
        read = {blk for b, start in enumerate(starts)
                for blk in BT[b, :start // 8 + 1].tolist()}
        for b, start in enumerate(starts):
            for blk in set(BT[b, start // 8 + 1:].tolist()) - read:
                kpn[blk], vpn[blk] = float("nan"), float("nan")
        n0 = pa.LAUNCHES["paged_prefill_attention"]
        got = pa.paged_prefill_attention_cuda(q, kpn, vpn, bt, qs)
        assert pa.LAUNCHES["paged_prefill_attention"] == n0 + 1
        want = pa.paged_prefill_attention_plain(q, kpn, vpn, bt, qs)
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_kernels_reject_what_they_do_not_take(cuda):
    """Wrong dtypes, a non-contiguous q, a head_dim the kernel cannot tile:
    raise before any launch, and count none."""
    q, kp, vp, bt, kv = _case(3, [64, 23, 17], bs=16, g=3, sq=1,
                              dtype=torch.float32, dev=cuda)
    before = dict(pa.LAUNCHES)
    with pytest.raises(TypeError):
        pa.paged_decode_attention_cuda(q.half(), kp.half(), vp.half(), bt, kv)
    with pytest.raises(TypeError):
        pa.paged_decode_attention_cuda(q, kp, vp, bt.long(), kv)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_decode_attention_cuda(q.transpose(0, 1).contiguous()
                                       .transpose(0, 1), kp, vp, bt, kv)
    big = [torch.cat([x] * 18, dim=-1) for x in (q, kp, vp)]  # head_dim 288
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode_attention_cuda(*big, bt, kv)
    assert pa.LAUNCHES == before


def _params_on(params, dev):
    return {k: _params_on(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in params.items()}


def test_model_on_card_matches_cpu(cuda):
    """A narrow fp32 copy of qwen3-0.6b: chunked paged prefill and decode
    logits through the kernels on the card equal the plain path on the CPU
    at 1e-4 (fp32, other summation orders)."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                              d_model=128, d_ff=256, vocab_size=1000)
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    prompt = np.random.default_rng(4).integers(0, 1000, 37).tolist()
    rows = {}
    for dev, p in (("cpu", params), (cuda, _params_on(params, cuda))):
        pc = model.paged_cache_init(batch=2, n_blocks=8, block_size=16,
                                    max_blocks=4, dtype=torch.float32,
                                    device=dev)
        pc["bt"][0] = torch.tensor([3, 1, 6, 2], dtype=torch.int32)
        out = []
        for c in range(3):
            toks = torch.zeros((1, 16), dtype=torch.int32)
            seg = prompt[c * 16:(c + 1) * 16]
            toks[0, :len(seg)] = torch.tensor(seg)
            logits, pc = model.prefill_paged(p, pc, {"tokens": toks.to(dev)},
                                             0, c, 37)
            out.append(logits.cpu())
        for t in (5, 9, 11):
            feed = torch.tensor([[t], [0]], dtype=torch.int32, device=dev)
            logits, pc = model.decode_paged(p, pc, feed)
            out.append(logits[:1].cpu())
        rows[str(dev)] = torch.cat(out)
    torch.testing.assert_close(rows["cuda"], rows["cpu"], rtol=1e-4,
                               atol=1e-4)


def test_engine_on_card_drains_and_repeats(cuda):
    """The smoke model served on the card: every request finishes, the
    pool drains, a repeat run is token-identical, and both kernels ran."""
    cfg = smoke_config("qwen3-0.6b")
    model = build_model(cfg)
    eng = ServeEngine(model, model.init(0, device=cuda), max_batch=2,
                      cache_len=64, kv_layout="paged", block_size=16)
    prompts = [list(range(1, 1 + n)) for n in (3, 20, 33)]
    pa.reset_launches()
    first = [r.tokens for r in eng.generate(
        [Request(p, 6, rid=i) for i, p in enumerate(prompts)])]
    assert pa.LAUNCHES["paged_decode_attention"] == \
        cfg.n_layers * eng.last_stats.decode_steps > 0
    assert pa.LAUNCHES["paged_prefill_attention"] == \
        cfg.n_layers * (1 + 2 + 3)
    assert eng.allocator.n_live == 0
    eng.allocator.check_integrity()
    again = [r.tokens for r in eng.generate(
        [Request(p, 6, rid=i) for i, p in enumerate(prompts)])]
    assert first == again and all(len(t) == 6 for t in first)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_flash_kernel_matches_plain(cuda, dtype, tol):
    """The flash kernel against its plain version: GQA ratios 1, 2 and 8,
    causal, non-causal and windowed, ragged lengths (tail tiles), queries
    right-aligned (Sq < Sk), and Sq > Sk causal, whose first rows see no
    key and are the mean of V.  fp32 at 1e-4 (other summation orders);
    bf16 at 1e-2 (outputs rounded from fp32)."""
    rng = np.random.default_rng(5)
    cases = [(1, 64, 64, True, None), (2, 7, 7, True, None),
             (2, 200, 200, False, None), (8, 133, 133, True, 17),
             (2, 50, 300, True, None), (2, 90, 40, True, None),
             (4, 129, 257, False, 64)]
    for g, sq, sk, causal, window in cases:
        q, k, v = [torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .to(cuda, dtype) for shape in
                   ((2, 2 * g, sq, 32), (2, 2, sk, 32), (2, 2, sk, 32))]
        n0 = fa.LAUNCHES["flash_attention"]
        got = fa.flash_attention_cuda(q, k, v, causal=causal, window=window)
        assert fa.LAUNCHES["flash_attention"] == n0 + 1
        want = fa.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def _flash_qkv(seed, dev, dtype, *, b, hq, g, sq, sk, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32))
            .to(dev, dtype) for shape in
            ((b, hq, sq, d), (b, hq // g, sk, d), (b, hq // g, sk, d))]


@pytest.mark.parametrize("hq,g,s,d", [(32, 1, 960, 64), (16, 2, 900, 128),
                                      (16, 8, 900, 128), (4, 2, 200, 24),
                                      (4, 2, 200, 40), (4, 1, 130, 72)])
def test_flash_tensor_cores_on_served_shapes(cuda, hq, g, s, d):
    """bf16 goes to the tensor-core route at the served shapes: zamba2's
    shared block (g 1, D 64, S 960), qwen3 (g 2, D 128, S 900), qwen2.5-3b
    (g 8, D 128); and head dims between two templates, zero-padded in
    shared memory (D 24 to 32, 40 to 64, 72 to 128); causal, at the bf16
    tolerance 1e-2.  The worst error is printed."""
    q, k, v = _flash_qkv(7, cuda, torch.bfloat16, b=1, hq=hq, g=g, sq=s,
                         sk=s, d=d)
    n0, m0 = fa.LAUNCHES["flash_attention"], fa.ROUTES["mma"]
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    assert fa.LAUNCHES["flash_attention"] == n0 + 1
    assert fa.ROUTES["mma"] == m0 + 1
    want = fa.flash_attention_plain(q, k, v, causal=True)
    torch.cuda.synchronize()
    print(f"flash bf16 Hq={hq} g={g} S={s} D={d}: max_abs_err="
          f"{(got.float() - want.float()).abs().max().item():.3e}")
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-2,
                               atol=1e-2)


def test_flash_tensor_cores_are_batch_invariant(cuda):
    """A row's output depends on its q and on k / v only: B = 3 in one
    launch equals three B = 1 launches bit for bit (g 2, D 128, S 333)."""
    q, k, v = _flash_qkv(8, cuda, torch.bfloat16, b=3, hq=16, g=2, sq=333,
                         sk=333, d=128)
    whole = fa.flash_attention_cuda(q, k, v, causal=True)
    rows = torch.cat([fa.flash_attention_cuda(q[i:i + 1].contiguous(),
                                              k[i:i + 1].contiguous(),
                                              v[i:i + 1].contiguous(),
                                              causal=True)
                      for i in range(3)])
    assert torch.equal(whole, rows)


def flash_dropping_last_keys(q, k, v, drop=64):
    """A planted fault: causal attention with each row's last ``drop``
    visible keys left out (a row with none left is the mean of V, as a
    fully masked row), fp32, in q's dtype."""
    g = q.shape[1] // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) \
        / q.shape[-1] ** 0.5
    qpos = torch.arange(q.shape[2], device=q.device) + k.shape[2] - q.shape[2]
    kpos = torch.arange(k.shape[2], device=q.device)
    keep = kpos[None, :] <= qpos[:, None] - drop
    logits = torch.where(keep, logits, fa.NEG_INF)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1),
                        vf).to(q.dtype)


def test_flash_tolerance_rejects_dropped_keys(cuda):
    """The bf16 tolerance has teeth: with each row's last 64 visible keys
    dropped (S 900) the output is outside 1e-2 of the kernel's."""
    q, k, v = _flash_qkv(9, cuda, torch.bfloat16, b=1, hq=16, g=2, sq=900,
                         sk=900, d=128)
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    planted = flash_dropping_last_keys(q, k, v)
    assert not torch.allclose(got.float(), planted.float(), rtol=1e-2,
                              atol=1e-2)


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = [torch.zeros(shape, device=cuda) for shape in
               ((1, 4, 8, 32), (1, 2, 8, 32), (1, 2, 8, 32))]
    before = dict(fa.LAUNCHES)
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(TypeError):
        fa.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention_cuda(q.transpose(2, 3).contiguous()
                                .transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention_cuda(q, k, v, window=0)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_cuda(*[torch.cat([x] * 9, dim=-1)
                                  for x in (q, k, v)])           # D 288
    assert fa.LAUNCHES == before


def test_dense_engine_on_card_matches_cpu(cuda):
    """The fp32 smoke model on the dense layout: the card's greedy tokens
    (continuous and bucketed) equal the CPU's, the flash kernel runs
    once per layer and prefill, and a sampled run repeats exactly."""
    cfg = smoke_config("qwen3-0.6b")
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    prompts = [list(range(1, 1 + n)) for n in (3, 20, 33)]
    reqs = [Request(p, 6, rid=i) for i, p in enumerate(prompts)]
    want = [r.tokens for r in ServeEngine(model, params, max_batch=2,
                                          cache_len=64).generate(reqs)]
    on_card = _params_on(params, cuda)
    for kw, prefills in ((dict(), 3), (dict(bucket="pow2"), 3),
                         (dict(mode="lockstep"), 2)):
        eng = ServeEngine(model, on_card, max_batch=2, cache_len=64, **kw)
        fa.reset_launches()
        got = [r.tokens for r in eng.generate(reqs)]
        assert fa.LAUNCHES["flash_attention"] == cfg.n_layers * prefills
        if "mode" not in kw:    # lockstep left-pads: other tokens
            assert got == want
    eng = ServeEngine(model, on_card, max_batch=2, cache_len=64)
    sampled = [Request(p, 6, 0.7, rid=i) for i, p in enumerate(prompts)]
    first = [r.tokens for r in eng.generate(sampled)]
    assert first == [r.tokens for r in eng.generate(sampled)]


def _ssd_case(seed, b, s, h, p, g, n, dtype, dev):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((b, s, h, p), f32)
    dt = np.logaddexp(rng.standard_normal((b, s, h), f32) - 2.0, 0.0)
    a_log = np.log(rng.uniform(1.0, 16.0, h)).astype(f32)
    bm = rng.standard_normal((b, s, g, n), f32) * 0.3
    cm = rng.standard_normal((b, s, g, n), f32) * 0.3
    d_skip = rng.standard_normal(h, f32)
    h0 = rng.standard_normal((b, h, p, n), f32) * 0.2
    t = [torch.from_numpy(np.ascontiguousarray(a, f32)).to(dev)
         for a in (x, dt, a_log, bm, cm, d_skip, h0)]
    for i in (0, 3, 4):
        t[i] = t[i].to(dtype)
    return t


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_ssd_kernel_matches_plain(cuda, dtype, tol):
    """The SSD kernel against its plain version: one ragged chunk (S = 7,
    33) and several (S = 128, 192), groups 1, 2 and 4, P = 20 (a short
    16-row slice), with and without h0 and d_skip.  y at fp32 1e-4 (other
    summation orders) or bf16 1e-2 (outputs rounded from fp32); the final
    state, fp32 in both, at 1e-4."""
    for seed, (b, s, h, p, g, n) in enumerate([
            (1, 7, 4, 16, 1, 16), (2, 33, 4, 20, 2, 8),
            (2, 128, 8, 16, 4, 32), (1, 192, 4, 64, 1, 64)]):
        x, dt, a_log, bm, cm, d_skip, h0 = _ssd_case(seed, b, s, h, p, g, n,
                                                     dtype, cuda)
        for kw in (dict(), dict(d_skip=d_skip, h0=h0), dict(h0=h0)):
            n0 = ss.LAUNCHES["ssd_scan"]
            y, hf = ss.ssd_cuda(x, dt, a_log, bm, cm, **kw)
            assert ss.LAUNCHES["ssd_scan"] == n0 + 1
            yp, hp = ss.ssd_plain(x, dt, a_log, bm, cm, **kw)
            torch.cuda.synchronize()
            assert y.dtype == dtype and hf.dtype == torch.float32
            assert torch.isfinite(y.float()).all()
            torch.testing.assert_close(y.float(), yp.float(), rtol=tol,
                                       atol=tol)
            torch.testing.assert_close(hf, hp, rtol=1e-4, atol=1e-4)


def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, a_log, bm, cm, d_skip, h0 = _ssd_case(9, 1, 64, 4, 16, 2, 8,
                                                 torch.float32, cuda)
    before = dict(ss.LAUNCHES)
    with pytest.raises(TypeError):
        ss.ssd_cuda(x.half(), dt, a_log, bm.half(), cm.half())
    with pytest.raises(TypeError):
        ss.ssd_cuda(x, dt, a_log, bm.bfloat16(), cm)
    with pytest.raises(TypeError):
        ss.ssd_cuda(x, dt.double(), a_log, bm, cm)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssd_cuda(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                    a_log, bm, cm)
    with pytest.raises(ValueError, match="shapes"):
        ss.ssd_cuda(x, dt, a_log, bm[:, :, :1].repeat(1, 1, 3, 1).contiguous(),
                    cm[:, :, :1].repeat(1, 1, 3, 1).contiguous())  # G = 3
    with pytest.raises(ValueError, match="shapes"):
        ss.ssd_cuda(x, dt, a_log, bm, cm, h0=h0[:, :2].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        ss.ssd_cuda(x, dt, a_log, bm, cm, d_skip=d_skip.cpu())
    with pytest.raises(ValueError, match="multiple"):
        ss.ssd_cuda(*_ssd_case(9, 1, 200, 4, 16, 2, 8, torch.float32,
                               cuda)[:5])
    assert ss.LAUNCHES == before


def test_hybrid_engine_on_card_matches_cpu(cuda):
    """The fp32 zamba2 smoke model: the card's greedy tokens equal the
    CPU's, the SSD kernel runs once per Mamba2 layer and prefill, and a
    preempted request resumes on the card exactly."""
    cfg = smoke_config("zamba2-1.2b")
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    prompts = [list(range(1, 1 + n)) for n in (3, 20, 64)]
    reqs = [Request(p, 6, rid=i) for i, p in enumerate(prompts)]
    want = [r.tokens for r in ServeEngine(model, params, max_batch=2,
                                          cache_len=64).generate(reqs)]
    on_card = _params_on(params, cuda)
    eng = ServeEngine(model, on_card, max_batch=2, cache_len=64)
    ss.reset_launches()
    assert [r.tokens for r in eng.generate(reqs)] == want
    assert ss.LAUNCHES["ssd_scan"] == cfg.n_layers * len(prompts)
    eng.begin_session()
    eng.session_admit(reqs[2], tag=0)
    eng.session_step()
    _, requeued = eng.session_preempt(0)
    eng.session_admit(requeued, tag=0)
    got = None
    while eng.session_active:
        for _, res in eng.session_step():
            got = res.tokens
    eng.end_session()
    assert got == want[2]



def _randn(seed, dev, dtype, *shapes, scale=1.0, loc=0.0):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
             * scale + loc).to(device=dev, dtype=dtype) for sh in shapes]


def _counted(mod, name, fn, *args, **kw):
    """fn(*args), its count moving by the kernels one call launches."""
    n0 = mod.LAUNCHES[name]
    out = fn(*args, **kw)
    shapes = [a.shape for a in args if isinstance(a, torch.Tensor)]
    assert mod.LAUNCHES[name] == n0 + mod.kernels_per_call(*shapes, **kw)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_matmul_matches_plain(cuda, dtype):
    """Ragged shapes and the reference's 512^3, into each output dtype:
    atol 2e-5 K (fp32 inputs) or 2e-2 sqrt(K) (bf16), rtol 1e-5 for an
    fp32 output, which a TF32 product fails, or 1e-2 for bf16."""
    f32 = dtype == torch.float32
    for seed, (m, k, n) in enumerate([(127, 129, 65), (32, 32, 32),
                                      (512, 512, 512), (1, 1000, 3)]):
        x, w = _randn(seed, cuda, dtype, (m, k), (k, n))
        atol = 2e-5 * k if f32 else 2e-2 * k ** 0.5
        for out_dtype in (None, torch.float32, torch.bfloat16):
            got = _counted(k_matmul, "matmul", k_matmul.matmul_cuda, x, w,
                           out_dtype=out_dtype)
            want = k_matmul.matmul_plain(x, w, out_dtype=out_dtype)
            assert got.dtype == want.dtype
            rtol = 1e-5 if got.dtype == torch.float32 else 1e-2
            torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                       rtol=rtol)
        if f32 and k == 512:
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = x @ w
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            with pytest.raises(AssertionError):     # the tolerance has teeth
                torch.testing.assert_close(tf32, k_matmul.matmul_plain(x, w),
                                           atol=atol, rtol=1e-5)


@pytest.mark.parametrize("m,k,n,kind", [(4096, 4096, 4096, "wgmma"),
                                        (1024, 8192, 512, "wgmma"),
                                        (32, 32, 32, "wgmma"),
                                        (127, 129, 65, "wmma"),
                                        (1, 1000, 3, "wmma")])
def test_pool_matmul_bf16_routes(cuda, m, k, n, kind):
    """bf16 products on the route the TMA predicate names, the route's
    count moving by one: the wgmma route at 4096^3 and 1024 x 8192 x 512
    (and 32^3, one tile mostly out of bounds), the wmma route where a row
    of A or B is not a multiple of 16 bytes; at the pool's bf16 tolerance
    (atol 2e-2 sqrt(K), rtol 1e-2), fp32 and bf16 out."""
    x, w = _randn(m + n, cuda, torch.bfloat16, (m, k), (k, n))
    assert k_matmul.route(x.dtype, k, n) == kind
    for out_dtype in (torch.float32, torch.bfloat16):
        before = dict(k_matmul.ROUTES)
        got = _counted(k_matmul, "matmul", k_matmul.matmul_cuda, x, w,
                       out_dtype=out_dtype)
        assert k_matmul.ROUTES == {**before, kind: before[kind] + 1}
        want = k_matmul.matmul_plain(x, w, out_dtype=out_dtype)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=2e-2 * k ** 0.5, rtol=1e-2)


def test_pool_matmul_transpose_bit_plant_fails(cuda):
    """The bf16 tolerance has teeth for the wgmma route: at 512^3 a product
    with B's transpose bit flipped is outside it."""
    x, w = _randn(3, cuda, torch.bfloat16, (512, 512), (512, 512))
    planted = k_matmul.matmul_transpose_bit_flipped(x, w)
    want = k_matmul.matmul_plain(x, w, out_dtype=torch.float32)
    assert not torch.allclose(planted, want, atol=2e-2 * 512 ** 0.5,
                              rtol=1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_dotproduct_matches_plain(cuda, dtype):
    """Against the fp64 sum, within 1e-6 of sum |x_i y_i|, on inputs of
    mean 1, so that a sum without one first-pass block's share, or (up to
    2^16 elements) without the ragged tail, fails; two kernels counted a
    call; a repeated call bit-identical; an offset view (not 16-byte
    aligned) too."""
    for seed, n in enumerate([1, 1003, 1 << 16, (1 << 20) + 3]):
        x, y = _randn(seed, cuda, dtype, (n,), (n,), loc=1.0)
        for a, b in ((x, y), (x[1:], y[1:])):
            got = _counted(k_dot, "dotproduct", k_dot.dotproduct_cuda, a, b)
            assert got.dtype == torch.float32 and got.dim() == 0
            p = a.double() * b.double()
            want, tol = p.sum().item(), 1e-6 * p.abs().sum().item()
            assert abs(got.item() - want) <= tol, (n, got.item(), want, tol)
            assert torch.equal(got, k_dot.dotproduct_cuda(a, b))
            m = a.shape[0]
            blocks, tail = k_dot.n_blocks(m), m % (16 // a.element_size())
            if blocks > 1:                          # the tolerance has teeth
                assert abs(p[:m - m // blocks].sum().item() - want) > tol
            if tail and m <= 1 << 16:
                assert abs(p[:m - tail].sum().item() - want) > tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_softmax_matches_plain(cuda, dtype):
    """Cached rows (up to 12280 columns) and uncached ones (12281,
    20000); atol 1e-6 with rtol 0 (fp32) or one bf16 step, 2^-7 (bf16),
    which an all-zero or wrongly normalised output fails."""
    rtol = 0.0 if dtype == torch.float32 else 2.0 ** -7
    for seed, shape in enumerate([(3, 1000), (256, 1024), (2, 12280),
                                  (2, 12281), (2, 20000), (1, 1),
                                  (4, 3, 33)]):
        (x,) = _randn(seed, cuda, dtype, shape, scale=30.0 if seed else 3.0)
        got = _counted(k_softmax, "softmax", k_softmax.softmax_cuda, x)
        want = k_softmax.softmax_plain(x)
        assert got.dtype == dtype and torch.isfinite(got.float()).all()
        torch.testing.assert_close(got.float(), want.float(), atol=1e-6,
                                   rtol=rtol)
        with pytest.raises(AssertionError):     # the tolerance has teeth
            torch.testing.assert_close(torch.zeros_like(want).float(),
                                       want.float(), atol=1e-6, rtol=rtol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_conv2d_matches_plain(cuda, dtype):
    """bench_ideality's 3x128x128 and ragged shapes; out in x's dtype;
    1e-4 (fp32) or atol 1e-4, rtol one bf16 step (bf16)."""
    f32 = dtype == torch.float32
    for seed, (c, h, w, k) in enumerate([(3, 128, 128, 7), (3, 7, 7, 7),
                                         (1, 70, 33, 3), (2, 40, 65, 1)]):
        x, f = _randn(seed, cuda, dtype, (c, h, w), (c, k, k))
        got = _counted(k_conv2d, "conv2d", k_conv2d.conv2d_cuda, x, f)
        assert got.dtype == dtype and got.shape == (h - k + 1, w - k + 1)
        torch.testing.assert_close(got.float(),
                                   k_conv2d.conv2d_plain(x, f).float(),
                                   atol=1e-4, rtol=1e-4 if f32 else 2.0 ** -7)


def test_pool_kernels_reject_what_they_do_not_take(cuda):
    x, w = _randn(0, cuda, torch.float32, (8, 8), (8, 8))
    before = ideality.launches()
    with pytest.raises(TypeError):
        k_matmul.matmul_cuda(x.half(), w.half())
    with pytest.raises(TypeError):
        k_matmul.matmul_cuda(x, w.bfloat16())
    with pytest.raises(TypeError):
        k_matmul.matmul_cuda(x, w, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="CUDA"):
        k_matmul.matmul_cuda(x, w.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        k_matmul.matmul_cuda(x.T, w)
    with pytest.raises(ValueError, match="must be"):
        k_matmul.matmul_cuda(x, w[:5].contiguous())
    with pytest.raises(TypeError):
        k_dot.dotproduct_cuda(x[0].double(), w[0].double())
    with pytest.raises(ValueError, match="one length"):
        k_dot.dotproduct_cuda(x[0], w[0, :5].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        k_softmax.softmax_cuda(x.T)
    with pytest.raises(TypeError):
        k_softmax.softmax_cuda(x.half())
    with pytest.raises(ValueError, match="H, W >= k"):
        k_conv2d.conv2d_cuda(x[None], w[None].repeat(1, 2, 2).contiguous())
    with pytest.raises(TypeError):
        k_conv2d.conv2d_cuda(x[None], w[None, :3, :3].bfloat16())
    assert ideality.launches() == before


def test_ideality_entry_point_runs_the_kernels(cuda):
    """``launch.ideality`` on the card at both ladders: every row through
    the kernels, each call (warm-up included) counted by the kernels it
    launches (two a dotproduct, fft's passes, pathfinder's 64-row
    launches)."""
    for sizes in ("reference", "card"):
        for mod in ideality.POOL.values():
            mod.reset_launches()
        rows = ideality.run("cuda", sizes, out=lambda _: None)
        cases, _ = ideality.SIZES[sizes]
        assert ideality.launches() == ideality.expected_launches(sizes)
        timed = [r for r in rows if r[0].startswith("kernel/")]
        assert [r[0] for r in timed] == [f"kernel/{c.name}" for c in cases]
        assert all(us > 0 for _, us, _ in timed)


FFT_TOL = 5e-6      # times sqrt(n), against an fp64 transform


def _fft_distance(xr, xi, y):
    want = torch.fft.fft(torch.complex(xr.double(), xi.double()))
    return max((y[0].double() - want.real).abs().max().item(),
               (y[1].double() - want.imag).abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_fft_matches_fp64(cuda, dtype):
    """One block (n = 2, 64, 4096) and several passes (8192: one global
    pass and the local one; 2^20: two and the local one), kernel and plain
    version both within 5e-6 sqrt(n) of an fp64 transform, fp32 out."""
    for seed, n in enumerate([2, 64, 4096, 8192, 1 << 20]):
        xr, xi = _randn(seed, cuda, dtype, (n,), (n,))
        got = _counted(k_fft, "fft", k_fft.fft_cuda, xr, xi)
        assert all(g.dtype == torch.float32 and g.shape == (n,) for g in got)
        tol = FFT_TOL * n ** 0.5
        assert _fft_distance(xr, xi, got) <= tol
        assert _fft_distance(xr, xi, k_fft.fft_plain(xr, xi)) <= tol


def test_pool_fft_plant_fails_the_tolerance(cuda):
    """A transform with stage 0's twiddles conjugated lies far outside
    5e-6 sqrt(n): the tolerance has teeth."""
    def conjugated(s, l, device):
        wr, wi = ref.fft_twiddles(s, l, device)
        return (wr, -wi) if s == 0 else (wr, wi)
    for n in (4, 4096, 8192):
        xr, xi = _randn(n, cuda, torch.float32, (n,), (n,))
        planted = ref.fft_stages(xr, xi, conjugated)
        assert _fft_distance(xr, xi, planted) > FFT_TOL * n ** 0.5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_exact_kernels_match_plain(cuda, dtype):
    """pathfinder, jacobi2d and dropout equal their plain versions bit for
    bit, on ragged shapes and at card-like ones: pathfinder one row, one
    column, several windows and several launches; jacobi2d below 3 rows,
    odd shapes and three sweeps; dropout with the edge bits at rates 0,
    0.1 and 0.5."""
    for seed, shape in enumerate([(1, 5), (2, 1), (20, 257), (3, 70000),
                                  (200, 1000), (130, 1 << 16)]):
        (w,) = _randn(seed, cuda, dtype, shape)
        w = w.abs()
        got = _counted(k_pathfinder, "pathfinder",
                       k_pathfinder.pathfinder_cuda, w)
        assert got.dtype == torch.float32
        assert torch.equal(got, k_pathfinder.pathfinder_plain(w))
    for seed, (shape, steps) in enumerate([((35, 67), 1), ((3, 3), 1),
                                           ((2, 5), 1), ((1, 1), 2),
                                           ((35, 67), 3),
                                           ((4099, 2050), 2)]):
        (x,) = _randn(seed, cuda, dtype, shape)
        got = _counted(k_jacobi2d, "jacobi2d", k_jacobi2d.jacobi2d_cuda, x,
                       steps=steps)
        assert got.dtype == dtype
        assert torch.equal(got, k_jacobi2d.jacobi2d_plain(x, steps))
    edge = torch.tensor([0, 1 << 31, (1 << 32) - 129, (1 << 32) - 128,
                         (1 << 32) - 1], dtype=torch.int64)
    for seed, n in enumerate([1, 1000, (1 << 22) + 3]):
        (x,) = _randn(seed, cuda, dtype, (n,))
        bits = torch.from_numpy(np.random.default_rng(seed).integers(
            0, 1 << 32, n, dtype=np.uint32))
        bits[:5] = edge[:n].to(torch.uint32)
        bits = bits.to(cuda)
        for rate in (0.0, 0.1, 0.5):
            got = _counted(k_dropout, "dropout", k_dropout.dropout_cuda, x,
                           bits, rate=rate)
            assert got.dtype == dtype
            assert torch.equal(got, k_dropout.dropout_plain(x, bits,
                                                            rate=rate))


def test_pool_new_kernels_reject_what_they_do_not_take(cuda):
    x, y = _randn(0, cuda, torch.float32, (8,), (6,))
    bits = torch.zeros(8, dtype=torch.int64, device=cuda).to(torch.uint32)
    before = ideality.launches()
    with pytest.raises(ValueError, match="power of two"):
        k_fft.fft_cuda(y, y)
    with pytest.raises(ValueError, match="one length"):
        k_fft.fft_cuda(x, x[:4].contiguous())
    with pytest.raises(TypeError):
        k_fft.fft_cuda(x.half(), x.half())
    with pytest.raises(TypeError):
        k_fft.fft_cuda(x, x.bfloat16())
    with pytest.raises(ValueError, match="rows, cols"):
        k_pathfinder.pathfinder_cuda(x)
    with pytest.raises(ValueError, match="contiguous"):
        k_pathfinder.pathfinder_cuda(x.reshape(2, 4).T)
    with pytest.raises(TypeError):
        k_pathfinder.pathfinder_cuda(x.reshape(2, 4).double())
    with pytest.raises(ValueError, match="H, W"):
        k_jacobi2d.jacobi2d_cuda(x)
    with pytest.raises(ValueError, match="steps"):
        k_jacobi2d.jacobi2d_cuda(x.reshape(2, 4), steps=-1)
    with pytest.raises(TypeError):
        k_jacobi2d.jacobi2d_cuda(x.reshape(2, 4).half())
    with pytest.raises(TypeError):
        k_dropout.dropout_cuda(x, bits.to(torch.int32), rate=0.1)
    with pytest.raises(ValueError, match="one length"):
        k_dropout.dropout_cuda(x, bits[:5], rate=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        k_dropout.dropout_cuda(x, bits.cpu(), rate=0.1)
    assert ideality.launches() == before


EXP_EDGE = [89.0, 100.0, -87.3, -87.5, -88.0, -200.0, 0.0, float("inf"),
            -float("inf"), float("nan")]


def _same_bits(a, b):
    """torch.equal, NaN for NaN."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na], b[~nb])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_exp_matches_plain(cuda, dtype):
    """exp equals its plain version bit for bit (NaN for NaN) at a ragged
    length with the edge values at its head, at 2^26, and on an array
    that is not 16-byte aligned (the element-by-element path); a schedule
    that rounds each product and sum apart does not."""
    for seed, n in enumerate([1, 7, 1_000_003, 1 << 26]):
        (x,) = _randn(seed, cuda, dtype, (n,), scale=4.0)
        x[:len(EXP_EDGE)] = torch.tensor(EXP_EDGE[:n]).to(dtype)
        got = _counted(k_exp, "exp", k_exp.exp_cuda, x)
        assert got.dtype == dtype and got.shape == (n,)
        assert _same_bits(got, k_exp.exp_plain(x))
        if dtype == torch.float32 and n > 1000:
            eager = ref.exp_poly(x, fma=lambda a, b, c: a * b + c)
            assert not _same_bits(eager, got)
    (x,) = _randn(9, cuda, dtype, (1001,))
    x = x[1:]                                   # 4 or 2 bytes past 16
    assert _same_bits(_counted(k_exp, "exp", k_exp.exp_cuda, x),
                      k_exp.exp_plain(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_dwt_matches_plain(cuda, dtype):
    """dwt equals its plain version bit for bit from one level to past one
    launch's depth (3 2^11 at 1, 2, 3, 5 and 11 levels; 2^20 at 10 and 11;
    2^26 at 3), on an array that is not 16-byte aligned, and in x's dtype;
    a bf16 transform kept in fp32 through its levels does not."""
    for seed, (n, levels) in enumerate([(2, 1), (3 << 11, 1), (3 << 11, 2),
                                        (3 << 11, 3), (3 << 11, 5),
                                        (3 << 11, 11), (1 << 20, 10),
                                        (1 << 20, 11), (1 << 26, 3)]):
        (x,) = _randn(seed, cuda, dtype, (n,))
        got = _counted(k_dwt, "dwt", k_dwt.dwt_haar_cuda, x, levels=levels)
        assert got.dtype == dtype and got.shape == (n,)
        assert torch.equal(got, k_dwt.dwt_haar_plain(x, levels=levels))
        if dtype == torch.bfloat16 and levels > 1:
            fp32 = ref.dwt_haar_ref(x.float(), levels).to(dtype)
            assert not torch.equal(fp32, got)
    (x,) = _randn(20, cuda, dtype, (4097,))
    x = x[1:]
    assert torch.equal(_counted(k_dwt, "dwt", k_dwt.dwt_haar_cuda, x,
                                levels=4),
                       k_dwt.dwt_haar_plain(x, levels=4))


def test_pool_exp_dwt_reject_what_they_do_not_take(cuda):
    x = torch.ones(12, device=cuda)
    before = ideality.launches()
    with pytest.raises(ValueError, match="vector"):
        k_exp.exp_cuda(x.reshape(3, 4))
    with pytest.raises(TypeError):
        k_exp.exp_cuda(x.half())
    with pytest.raises(ValueError, match="CUDA"):
        k_exp.exp_cuda(x.cpu())
    with pytest.raises(ValueError, match="divisible"):
        k_dwt.dwt_haar_cuda(x, levels=3)
    with pytest.raises(ValueError, match="levels"):
        k_dwt.dwt_haar_cuda(x, levels=0)
    with pytest.raises(ValueError, match="vector"):
        k_dwt.dwt_haar_cuda(x.reshape(3, 4))
    with pytest.raises(TypeError):
        k_dwt.dwt_haar_cuda(x.double(), levels=2)
    assert ideality.launches() == before


def test_paged_equals_dense_in_fp32_on_card(cuda):
    """A narrow fp32 copy of qwen3-0.6b served on the card by the paged
    layout and by dense continuous: the greedy tokens agree row for row
    (paged == dense, byte for byte inside the port), and each layout ran
    its own kernels."""
    cfg = dataclasses.replace(get_config("qwen3-0.6b"), n_layers=2,
                              d_model=128, d_ff=256, vocab_size=1000)
    model = build_model(cfg)
    params = model.init(0, device=cuda, dtype=torch.float32)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 1000, n).tolist()
               for n in (7, 16, 17, 64, 200, 333)]
    toks = {}
    for layout, kw in (("paged", dict(kv_layout="paged", block_size=16)),
                       ("dense", {})):
        pa.reset_launches()
        fa.reset_launches()
        eng = ServeEngine(model, params, max_batch=4, cache_len=512, **kw)
        toks[layout] = [r.tokens for r in eng.generate(
            [Request(p, 16, rid=i) for i, p in enumerate(prompts)])]
        paged_ran = pa.LAUNCHES["paged_prefill_attention"] > 0
        assert paged_ran == (layout == "paged")
        assert (fa.LAUNCHES["flash_attention"] > 0) == (layout == "dense")
    assert toks["paged"] == toks["dense"]
