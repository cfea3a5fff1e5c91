"""The port on the card: the hand-written CUDA kernels against their plain
PyTorch versions, their input checks and launch counts, and the model and
engine on CUDA against the same code on the CPU.

Every test here is marked ``gpu`` and skips without a card; the file
imports no JAX, so it runs on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import math

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


def _prefill_nan_case(seed, starts, *, hq, hkv, d, bs, m, dtype, dev):
    """A prefill batch of Sq = bs on a shuffled table (each row its own
    blocks), NaN at every pool position at or past each row's frontier
    q_start + Sq and in the null block, which no table here holds."""
    b = len(starts)
    rng = np.random.default_rng(seed)
    n_blocks = b * m + 1
    kp = rng.standard_normal((n_blocks, hkv, bs, d), np.float32)
    vp = rng.standard_normal((n_blocks, hkv, bs, d), np.float32)
    bt = (rng.permutation(n_blocks - 1) + 1).reshape(b, m).astype(np.int32)
    q = rng.standard_normal((b, hq, bs, d), np.float32)
    for row, start in enumerate(starts):
        for col in range(m):
            lo = max(start + bs - col * bs, 0)
            if lo < bs:
                kp[bt[row, col], :, lo:] = np.nan
                vp[bt[row, col], :, lo:] = np.nan
    kp[0] = vp[0] = np.nan
    t = [torch.from_numpy(x).to(dev)
         for x in (q, kp, vp, bt, np.asarray(starts, np.int32))]
    return [x.to(dtype) if x.is_floating_point() else x for x in t]


# (Hq, Hkv, D, bs, M, q_starts), Sq = bs: qwen2.5-3b's shape (g 8, 128
# rows a kv head) at chunks 0, 1 (its frontier inside a 64-key tile) and
# 63; qwen3 at block_size 64 (chunks 0, 1, 15); B = 3 with different
# starts, one off a block boundary
PREFILL_WIDE = ((16, 2, 128, 16, 64, [0]), (16, 2, 128, 16, 64, [16]),
                (16, 2, 128, 16, 64, [1008]), (16, 8, 128, 64, 16, [0]),
                (16, 8, 128, 64, 16, [64]), (16, 8, 128, 64, 16, [960]),
                (16, 2, 128, 16, 64, [5, 500, 1000]),
                (16, 8, 64, 16, 64, [0, 333, 1008]))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_prefill_kernel_any_rows_with_nan_planted(cuda, dtype, tol):
    """The prefill kernel beyond 64 query rows a kv head and at bs 64
    against its plain version, NaN at every pool position at or past the
    frontier (a tensor-core p v multiplies the whole tile, and p = 0 times
    NaN is NaN, so those keys must be zeroed, not masked); each call on its
    dtype's route.  fp32 at 1e-4; bf16 at 1e-2 (outputs rounded from fp32,
    p rounded to bf16 before p v)."""
    kind = "simt" if dtype == torch.float32 else "mma"
    for i, (hq, hkv, d, bs, m, starts) in enumerate(PREFILL_WIDE):
        args = _prefill_nan_case(i, starts, hq=hq, hkv=hkv, d=d, bs=bs,
                                 m=m, dtype=dtype, dev=cuda)
        n0 = pa.LAUNCHES["paged_prefill_attention"]
        r0 = pa.ROUTES[kind]
        got = pa.paged_prefill_attention_cuda(*args)
        assert pa.LAUNCHES["paged_prefill_attention"] == n0 + 1
        assert pa.ROUTES[kind] == r0 + 1
        want = pa.paged_prefill_attention_plain(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


def test_prefill_tensor_cores_repeat_bit_identical(cuda):
    """The split prefill combines its partials in split order, whichever
    block arrives last: repeated calls give the same bits, and the arrival
    counters stay usable from one launch to the next."""
    args = _prefill_nan_case(9, [1008], hq=16, hkv=2, d=128, bs=16, m=64,
                             dtype=torch.bfloat16, dev=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pa.prefill_plan(2, 128, 16, 64, sms)[1] > 1
    first = pa.paged_prefill_attention_cuda(*args)
    for _ in range(5):
        assert torch.equal(pa.paged_prefill_attention_cuda(*args), first)


def test_paged_kernels_concurrent_streams_bit_identical(cuda):
    """Split decodes and prefills (B = 8, qwen3's heads, a 64-block table
    of 16, kv_len and q_start up to 1024, so every launch splits its keys
    and combines through the arrival counters) launched from two threads
    on two streams, 200 times each, as the cluster's threaded driver does:
    every output bit-identical to the same launch run alone, and the
    launch counts exact."""
    import threading
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pa.decode_plan(8, 2, 16, 64, sms)[1] > 1
    assert pa.prefill_plan(8, 2 * 16, 16, 64, sms)[1] > 1
    cases = []
    for t in range(2):
        rng = np.random.default_rng(40 + t)
        lens = rng.integers(900, 1025, 8).tolist()
        dec = _decode_nan_case(40 + t, lens, hq=16, hkv=8, d=128, bs=16,
                               m=64, dtype=torch.bfloat16, dev=cuda)
        starts = (rng.integers(50, 63, 8) * 16).tolist()
        pre = _prefill_nan_case(50 + t, starts, hq=16, hkv=8, d=128, bs=16,
                                m=64, dtype=torch.bfloat16, dev=cuda)
        cases.append((dec, pre))
    want = [(pa.paged_decode_attention_cuda(*dec),
             pa.paged_prefill_attention_cuda(*pre)) for dec, pre in cases]
    torch.cuda.synchronize()
    n0 = dict(pa.LAUNCHES)
    d0, p0 = pa.DECODE_ROUTES["mma"], pa.ROUTES["mma"]
    reps = 200
    outs = [[] for _ in cases]
    errors = []
    streams = [torch.cuda.Stream(cuda) for _ in cases]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(cuda))

    def run(t):
        try:
            with torch.cuda.stream(streams[t]):
                dec, pre = cases[t]
                for _ in range(reps):
                    outs[t].append((pa.paged_decode_attention_cuda(*dec),
                                    pa.paged_prefill_attention_cuda(*pre)))
            streams[t].synchronize()
        except BaseException as e:          # re-raised below
            errors.append(e)
    threads = [threading.Thread(target=run, args=(t,)) for t in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=300)
    assert not any(th.is_alive() for th in threads)
    assert not errors, errors
    assert pa.LAUNCHES == {
        "paged_decode_attention": n0["paged_decode_attention"] + 2 * reps,
        "paged_prefill_attention": n0["paged_prefill_attention"] + 2 * reps}
    assert pa.DECODE_ROUTES["mma"] == d0 + 2 * reps
    assert pa.ROUTES["mma"] == p0 + 2 * reps
    for t, (wd, wp) in enumerate(want):
        bad = [i for i, (d, p) in enumerate(outs[t])
               if not (torch.equal(d, wd) and torch.equal(p, wp))]
        assert not bad, (t, len(bad), bad[:5])


def _decode_nan_case(seed, lens, *, hq, hkv, d, bs, m, dtype, dev):
    """A decode batch on a shuffled table (each row its own blocks), NaN at
    every pool position at or past each row's kv_len (none for a kv_len past
    the table's M * bs: all its positions are live) and in the null block,
    which no table here holds."""
    b = len(lens)
    rng = np.random.default_rng(seed)
    n_blocks = b * m + 1
    kp = rng.standard_normal((n_blocks, hkv, bs, d), np.float32)
    vp = rng.standard_normal((n_blocks, hkv, bs, d), np.float32)
    bt = (rng.permutation(n_blocks - 1) + 1).reshape(b, m).astype(np.int32)
    q = rng.standard_normal((b, hq, 1, d), np.float32)
    for row, n in enumerate(lens):
        for col in range(m):
            lo = max(n - col * bs, 0)
            if lo < bs:
                kp[bt[row, col], :, lo:] = np.nan
                vp[bt[row, col], :, lo:] = np.nan
    kp[0] = vp[0] = np.nan
    t = [torch.from_numpy(x).to(dev)
         for x in (q, kp, vp, bt, np.asarray(lens, np.int32))]
    return [x.to(dtype) if x.is_floating_point() else x for x in t]


# (Hq, Hkv, D, bs, M, kv_lens): g 2, 8, 16 and 72; block sizes 16, 48 and
# 128; B 1 and 8; kv_len 0, 1, ends inside a 64-key tile, whole tables, and
# past the table (an idle slot's position)
DECODE_CASES = ((16, 8, 128, 16, 64, [1, 15, 16, 17, 1023, 1024, 500, 0]),
                (16, 2, 128, 16, 64, [1000]),
                (16, 1, 128, 48, 22, [0, 1, 47, 49, 95, 1056, 1100, 700]),
                (72, 1, 64, 128, 8, [1, 130, 1024]),
                (16, 8, 128, 128, 8, [77]),
                (16, 2, 128, 48, 22, [500, 1, 0, 63, 64, 65, 129, 1055]))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_decode_kernel_any_block_size_and_group_with_nan_planted(cuda, dtype,
                                                                 tol):
    """The decode kernel at any block size and any group against its plain
    version, NaN at every pool position at or past kv_len (the tensor cores
    multiply whole tiles, so those keys must be zeroed, not masked); each
    call on its dtype's route, a kv_len of 0 returning 0.  fp32 at 1e-4;
    bf16 at 1e-2 (outputs rounded from fp32, p rounded to bf16 before
    p v)."""
    kind = "simt" if dtype == torch.float32 else "mma"
    for i, (hq, hkv, d, bs, m, lens) in enumerate(DECODE_CASES):
        args = _decode_nan_case(i, lens, hq=hq, hkv=hkv, d=d, bs=bs, m=m,
                                dtype=dtype, dev=cuda)
        pa.reset_launches()
        got = pa.paged_decode_attention_cuda(*args)
        assert pa.LAUNCHES["paged_decode_attention"] == 1
        assert pa.DECODE_ROUTES[kind] == 1 and sum(pa.ROUTES.values()) == 0
        want = pa.paged_decode_attention_plain(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)
        for row, n in enumerate(lens):
            if n == 0:
                assert not got[row].any()


def test_decode_tensor_cores_repeat_bit_identical(cuda):
    """The split decode combines its partials in split order, whichever
    block arrives last: repeated calls give the same bits, a row's output
    does not depend on the rows batched with it, and the arrival counters
    stay usable from one launch to the next."""
    args = _decode_nan_case(11, [1000, 1, 500, 1055], hq=16, hkv=2, d=128,
                            bs=48, m=22, dtype=torch.bfloat16, dev=cuda)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert pa.decode_plan(2, 8, 48, 22, sms)[1] > 1
    first = pa.paged_decode_attention_cuda(*args)
    for _ in range(5):
        assert torch.equal(pa.paged_decode_attention_cuda(*args), first)
    q, kp, vp, bt, kv = args
    alone = pa.paged_decode_attention_cuda(q[2:3].contiguous(), kp, vp,
                                           bt[2:3].contiguous(),
                                           kv[2:3].contiguous())
    assert torch.equal(alone, first[2:3])


# (Hq, Hkv, D, bs, M, q_starts), Sq = bs: block sizes 48 (not a divisor of
# the 64-key tile) and 128 (two tiles a block) at the first, second and
# last chunk, and B = 3 with different starts
PREFILL_BS = ((16, 8, 128, 48, 22, [0]), (16, 8, 128, 48, 22, [48]),
              (16, 8, 128, 48, 22, [1008]), (16, 8, 128, 128, 8, [0]),
              (16, 8, 128, 128, 8, [128]), (16, 8, 128, 128, 8, [896]),
              (16, 2, 128, 48, 22, [5, 500, 1000]))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
def test_prefill_kernel_any_block_size_with_nan_planted(cuda, dtype, tol):
    """The prefill kernel at block sizes 48 and 128 against its plain
    version, NaN at every pool position at or past the frontier; each call
    on its dtype's route."""
    kind = "simt" if dtype == torch.float32 else "mma"
    for i, (hq, hkv, d, bs, m, starts) in enumerate(PREFILL_BS):
        args = _prefill_nan_case(20 + i, starts, hq=hq, hkv=hkv, d=d, bs=bs,
                                 m=m, dtype=dtype, dev=cuda)
        pa.reset_launches()
        got = pa.paged_prefill_attention_cuda(*args)
        assert pa.LAUNCHES["paged_prefill_attention"] == 1
        assert pa.ROUTES[kind] == 1
        want = pa.paged_prefill_attention_plain(*args)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


# (Hq, Hkv, D, bs, M, decode kv_lens, prefill q_starts): granite-moe's
# heads (16 / 8 of 64) at block size 16, and phi-3-vision's (32 / 32 of 96,
# padded to the 128 template) at block size 64 and its 2048-position table
MOE_VLM_HEADS = ((16, 8, 64, 16, 64, [1, 15, 16, 17, 1023, 1024, 500, 0],
                  [0, 16, 1008]),
                 (32, 32, 96, 64, 32, [1, 63, 64, 65, 1476, 2048, 600, 0],
                  [0, 576, 1984]))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("case", range(len(MOE_VLM_HEADS)),
                         ids=["d64-granite", "d96-phi3v"])
def test_paged_kernels_at_moe_and_vlm_head_dims(cuda, case, dtype, tol):
    """Both paged kernels at the head dims the moe and vlm paths serve
    against their plain versions, NaN at every pool position neither may
    read, each call on its dtype's route; decode's kv_len 0 returns 0."""
    hq, hkv, d, bs, m, lens, starts = MOE_VLM_HEADS[case]
    kind = "simt" if dtype == torch.float32 else "mma"
    args = _decode_nan_case(40 + case, lens, hq=hq, hkv=hkv, d=d, bs=bs,
                            m=m, dtype=dtype, dev=cuda)
    pa.reset_launches()
    got = pa.paged_decode_attention_cuda(*args)
    assert pa.DECODE_ROUTES[kind] == 1
    want = pa.paged_decode_attention_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and not got[lens.index(0)].any()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)
    args = _prefill_nan_case(50 + case, starts, hq=hq, hkv=hkv, d=d, bs=bs,
                             m=m, dtype=dtype, dev=cuda)
    got = pa.paged_prefill_attention_cuda(*args)
    assert pa.ROUTES[kind] == 1
    want = pa.paged_prefill_attention_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                               atol=tol)


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
                                      (4, 2, 200, 40), (4, 1, 130, 72),
                                      (16, 2, 900, 64), (32, 1, 1476, 96)])
def test_flash_tensor_cores_on_served_shapes(cuda, hq, g, s, d):
    """bf16 goes to the tensor-core route at the served shapes: zamba2's
    shared block (g 1, D 64, S 960), qwen3 (g 2, D 128, S 900), qwen2.5-3b
    (g 8, D 128), granite-moe (g 2, D 64) and phi-3-vision (g 1, D 96
    padded to 128, S 576 + 900); and head dims between two templates,
    zero-padded in shared memory (D 24 to 32, 40 to 64, 72 to 128); causal, at the bf16
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


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("g", [65, 128])
def test_flash_kernel_takes_any_group(cuda, g, dtype, tol):
    """Groups past 64 q-heads a kv head (the reference's kernel has no
    cap): the fp32 route cuts a group into ceil(g / 64) blocks of at most
    64 q-heads, the bf16 route runs a block a q-head as always; D 64, S
    256, causal and windowed, against the plain version (fp32 1e-4, bf16
    1e-2), each call on its route."""
    kind = "simt" if dtype == torch.float32 else "mma"
    q, k, v = _flash_qkv(10 + g, cuda, dtype, b=1, hq=2 * g, g=g, sq=256,
                         sk=256, d=64)
    for window in (None, 48):
        n0, r0 = fa.LAUNCHES["flash_attention"], fa.ROUTES[kind]
        got = fa.flash_attention_cuda(q, k, v, causal=True, window=window)
        assert fa.LAUNCHES["flash_attention"] == n0 + 1
        assert fa.ROUTES[kind] == r0 + 1
        want = fa.flash_attention_plain(q, k, v, causal=True, window=window)
        torch.cuda.synchronize()
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got.float(), want.float(), rtol=tol,
                                   atol=tol)


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
    16-row slice), N = 8 and 32, and the served shape (B 1, S 960, H 64,
    P = N = 64, G 1), with and without h0 and d_skip, each call on its
    dtype's route (bf16 on the tensor cores) with ``kernels_per_call``
    launches.  y at fp32 1e-4 (other summation orders) or bf16 1e-2
    (outputs rounded from fp32); the final state, fp32 in both, at 1e-4."""
    rt = ss.route(dtype)
    for seed, (b, s, h, p, g, n) in enumerate([
            (1, 7, 4, 16, 1, 16), (2, 33, 4, 20, 2, 8),
            (2, 128, 8, 16, 4, 32), (1, 192, 4, 64, 1, 64),
            (1, 960, 64, 64, 1, 64)]):
        x, dt, a_log, bm, cm, d_skip, h0 = _ssd_case(seed, b, s, h, p, g, n,
                                                     dtype, cuda)
        for kw in (dict(), dict(d_skip=d_skip, h0=h0), dict(h0=h0)):
            n0, r0 = ss.LAUNCHES["ssd_scan"], ss.ROUTES[rt]
            y, hf = ss.ssd_cuda(x, dt, a_log, bm, cm, **kw)
            k = ss.kernels_per_call(s, dtype)
            assert ss.LAUNCHES["ssd_scan"] == n0 + k
            assert ss.ROUTES[rt] == r0 + k
            yp, hp = ss.ssd_plain(x, dt, a_log, bm, cm, **kw)
            torch.cuda.synchronize()
            assert y.dtype == dtype and hf.dtype == torch.float32
            assert torch.isfinite(y.float()).all()
            torch.testing.assert_close(y.float(), yp.float(), rtol=tol,
                                       atol=tol)
            torch.testing.assert_close(hf, hp, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("s", [33, 960])
def test_ssd_mma_rows_are_batch_invariant_and_repeatable(cuda, s):
    """bf16 on the tensor cores: a B = 3 call's rows equal three B = 1
    calls bit for bit (y and the final state, with h0 and d_skip), and a
    rerun equals the first run bit for bit."""
    x, dt, a_log, bm, cm, d_skip, h0 = _ssd_case(30 + s, 3, s, 64, 64, 1, 64,
                                                 torch.bfloat16, cuda)
    kw = dict(d_skip=d_skip, h0=h0)
    y, hf = ss.ssd_cuda(x, dt, a_log, bm, cm, **kw)
    y2, hf2 = ss.ssd_cuda(x, dt, a_log, bm, cm, **kw)
    assert torch.equal(y, y2) and torch.equal(hf, hf2)
    for r in range(3):
        yr, hr = ss.ssd_cuda(x[r:r + 1].contiguous(), dt[r:r + 1].contiguous(),
                             a_log, bm[r:r + 1].contiguous(),
                             cm[r:r + 1].contiguous(), d_skip=d_skip,
                             h0=h0[r:r + 1].contiguous())
        assert torch.equal(yr, y[r:r + 1]) and torch.equal(hr, hf[r:r + 1])


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


@pytest.mark.parametrize("m,k,n", [(4096, 4096, 4096), (4096, 4095, 4097),
                                   (127, 129, 65), (1, 1000, 3),
                                   (513, 64, 515)])
def test_pool_sgemm_card_size_and_ragged(cuda, m, k, n):
    """The fp32 route (sgemm) at the card ladder's 4096^3, on ragged shapes
    (no 16-byte row of B: 4097, 3, 65, 515) and a product a K step covers,
    against the plain version at the fp32 tolerance (atol 2e-5 K, rtol
    1e-5), which a TF32 product fails; the route's count moves by one.
    Every output sums its K products in order, so the first 128 rows of
    the product are bit for bit those of the same rows alone (another
    tiling: a 128-row product has too few wide tiles to fill the card)."""
    x, w = _randn(m + k + n, cuda, torch.float32, (m, k), (k, n))
    assert k_matmul.route(x.dtype, k, n) == "sgemm"
    atol = 2e-5 * k
    before = dict(k_matmul.ROUTES)
    got = _counted(k_matmul, "matmul", k_matmul.matmul_cuda, x, w)
    assert k_matmul.ROUTES == {**before, "sgemm": before["sgemm"] + 1}
    want = k_matmul.matmul_plain(x, w)
    torch.testing.assert_close(got, want, atol=atol, rtol=1e-5)
    rows = k_matmul.matmul_cuda(x[:128].contiguous(), w)
    assert torch.equal(rows, got[:128])
    if m * n >= 1 << 20:          # enough outputs for TF32's error to show
        saved = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            tf32 = x @ w
        finally:
            torch.backends.cuda.matmul.allow_tf32 = saved
        with pytest.raises(AssertionError):     # the tolerance has teeth
            torch.testing.assert_close(tf32, want, atol=atol, rtol=1e-5)


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


def _conv2d_fmaf_chain(x, w):
    """fp32 ``acc = fmaf(w, x, acc)`` from 0 over ci, ki, kj, each fused
    multiply-add rounded once (``ref.fma32``): the arithmetic of the port's
    first conv2d kernel and of the simt route."""
    c, h, wd = x.shape
    k = w.shape[1]
    acc = torch.zeros((h - k + 1, wd - k + 1), device=x.device)
    for ci in range(c):
        for ki in range(k):
            for kj in range(k):
                acc = ref.fma32(w[ci, ki, kj].expand_as(acc),
                                x[ci, ki:ki + h - k + 1, kj:kj + wd - k + 1],
                                acc)
    return acc


def _conv2d_routed(x, w):
    """One counted call on the route its dtype names."""
    kind = k_conv2d.route(x.dtype, w.shape[1])
    before = dict(k_conv2d.ROUTES)
    out = _counted(k_conv2d, "conv2d", k_conv2d.conv2d_cuda, x, w)
    assert k_conv2d.ROUTES == {**before, kind: before[kind] + 1}
    return out


def _conv2d_close(got, x, w):
    """The conv2d tolerances: 1e-4 (fp32) or atol 1e-4, rtol one bf16 step,
    2^-7 (bf16), against the plain version; finite, in x's dtype."""
    want = k_conv2d.conv2d_plain(x, w)
    assert got.dtype == x.dtype and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    torch.testing.assert_close(
        got.float(), want.float(), atol=1e-4,
        rtol=1e-4 if x.dtype == torch.float32 else 2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_conv2d_routes_at_card_scale(cuda, dtype):
    """3 x 4096 x 4096, k 7 (the card ladder's case) on its route: bf16 on
    the tensor cores (mma), fp32 on the CUDA cores (simt), each within the
    pool's tolerance of the plain version, a repeat bit for bit, and a
    filter with its taps shifted a column shown to fail the tolerance."""
    x, w = _randn(1, cuda, dtype, (3, 4096, 4096), (3, 7, 7))
    got = _conv2d_routed(x, w)
    _conv2d_close(got, x, w)
    assert torch.equal(_conv2d_routed(x, w), got)
    shifted = torch.roll(w, 1, dims=2)
    with pytest.raises(AssertionError):
        _conv2d_close(k_conv2d.conv2d_plain(x, shifted), x, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_conv2d_ragged_shapes(cuda, dtype):
    """k 1 to 11 (two K-steps of the banded product at 11, three at 25) at
    W = 8m - 1, 8m, 8m + 1 (rows not on 16 bytes take the element-by-element
    copy), two output tiles each way, 1 x 1 outputs, 100 channels (B from w,
    not the table), every call counted on its route."""
    shapes = [(2, 64 + k, 128 + d, k) for k in (1, 3, 5, 7, 9, 11)
              for d in (-1, 0, 1)]
    shapes += [(1, 1, 1, 1), (3, 7, 7, 7), (2, 11, 11, 11), (100, 20, 40, 1),
               (2, 90, 100, 25), (4, 30, 30, 2)]
    for seed, (c, h, wd, k) in enumerate(shapes):
        x, w = _randn(seed, cuda, dtype, (c, h, wd), (c, k, k))
        _conv2d_close(_conv2d_routed(x, w), x, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_conv2d_nan_planted(cuda, dtype):
    """NaN and +-inf planted in x reach exactly the outputs whose window
    covers them (the banded product's zeros never meet them: a tile whose
    sums are not all finite is recomputed tap by tap); every other output
    within the tolerance."""
    for seed, (c, h, wd, k) in enumerate([(2, 100, 300, 7), (3, 130, 257, 3),
                                         (1, 40, 40, 11), (3, 200, 400, 7)]):
        x, w = _randn(seed, cuda, dtype, (c, h, wd), (c, k, k))
        x[c - 1, 50 % h, 140 % wd] = math.nan
        x[0, 10, 5] = math.inf
        x[0, h - 1, wd - 1] = -math.inf
        got = _conv2d_routed(x, w)
        want = k_conv2d.conv2d_plain(x, w)
        hit = torch.zeros((h, wd), dtype=torch.bool, device=cuda)
        hit[50 % h, 140 % wd] = hit[10, 5] = hit[h - 1, wd - 1] = True
        covered = torch.nn.functional.max_pool2d(
            hit[None, None].float(), k, stride=1)[0, 0].bool()
        assert torch.equal(~torch.isfinite(got.float()), covered)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        g, v = got[covered], want[covered]     # the plain version's bits
        assert torch.equal(g.isnan(), v.isnan())
        assert torch.equal(g[~g.isnan()], v[~v.isnan()])
        torch.testing.assert_close(
            got.float()[~covered], want.float()[~covered], atol=1e-4,
            rtol=1e-4 if dtype == torch.float32 else 2.0 ** -7)


@pytest.mark.parametrize("shape", [(3, 4096, 4096, 7), (2, 74, 129, 7),
                                   (2, 76, 127, 9), (2, 90, 100, 25),
                                   (1, 124, 200, 61)])
def test_pool_conv2d_simt_is_the_fmaf_chain(cuda, shape):
    """fp32 (simt) bit for bit the fmaf chain over ci, ki, kj that the first
    kernel computed: a filter in registers (k 7), the taps walked in
    chunks (k 9, 25, 61), rows off 16 bytes (W 127, 129)."""
    c, h, wd, k = shape
    x, w = _randn(2, cuda, torch.float32, (c, h, wd), (c, k, k))
    assert torch.equal(_conv2d_routed(x, w), _conv2d_fmaf_chain(x, w))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_conv2d_largest_filter(cuda, dtype):
    """k = 61, the largest filter the first kernel took (five K-steps of the
    banded product, 190 KB of shared memory for simt), against the exact
    fp64 sum: 3721 taps an output, so the sum's order moves it by up to
    ~1e-7 of sum |w x| (the pool's tolerance is for k 7); held to 1e-6 of
    sum |w x| plus one bf16 step (2^-8) of the value in bf16.  k = 62, which
    raised until the kernels walked large filters in bands, runs and is held
    the same way."""
    for k in (61, 62):
        x, w = _randn(3, cuda, dtype, (1, k + 63, 200), (1, k, k))
        got = _conv2d_routed(x, w).double()
        _conv2d_within_fp64(got, x, w)


def _conv2d_within_fp64(got, x, w):
    """``got`` within 1e-6 of sum |w x| (plus, in bf16, one bf16 step 2^-8
    of the value) of the exact fp64 convolution; finite."""
    exact = _conv2d_fp64(x, w)
    mass = _conv2d_fp64(x.abs(), w.abs())
    rel = 0.0 if x.dtype == torch.float32 else 2.0 ** -8
    assert torch.isfinite(got).all()
    assert ((got - exact).abs() <= 1e-6 * mass + rel * exact.abs()).all()


# (C, H, W, k): filters past one stage.  k 61 and 62 take one band; k 97
# two bands of filter rows in fp32 (one in bf16); k 200 one filter row a
# band in bands of columns on both routes.  W on 16 bytes (TMA) and off it
# (element copies), and two output tiles each way
BANDED = [(2, 61 + 64, 61 + 130, 61), (1, 62 + 65, 62 + 129, 62),
          (2, 97 + 64, 97 + 131, 97), (1, 97 + 70, 97 + 127, 97),
          (1, 200 + 64, 200 + 132, 200)]


@pytest.mark.parametrize("c,h,wd,k", BANDED)
def test_pool_conv2d_banded_filters(cuda, c, h, wd, k):
    """Filters larger than one stage holds (``conv2d.bands``): fp32 (simt)
    bit for bit the fmaf chain over ci, ki, kj, so the bands keep the
    first kernel's order; bf16 (mma) within 1e-6 of sum |w x| plus one
    bf16 step of the exact fp64 value, with NaN and inf planted reaching
    exactly the outputs whose window covers them.  Each call on its
    route."""
    x, w = _randn(4, cuda, torch.float32, (c, h, wd), (c, k, k))
    assert torch.equal(_conv2d_routed(x, w), _conv2d_fmaf_chain(x, w))
    xb, wb = x.bfloat16(), w.bfloat16()
    _conv2d_within_fp64(_conv2d_routed(xb, wb).double(), xb, wb)
    xb[0, 10, 5] = math.nan
    xb[c - 1, h - 1, wd - 1] = math.inf
    got = _conv2d_routed(xb, wb)
    hit = torch.zeros((h, wd), dtype=torch.bool, device=cuda)
    hit[10, 5] = hit[h - 1, wd - 1] = True
    covered = torch.nn.functional.max_pool2d(
        hit[None, None].float(), k, stride=1)[0, 0].bool()
    assert torch.equal(~torch.isfinite(got.float()), covered)
    want = k_conv2d.conv2d_plain(xb, wb)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    fin = ~covered              # the others: as without the plants
    clean = xb.clone()
    clean[0, 10, 5] = 0.0
    clean[c - 1, h - 1, wd - 1] = 0.0
    exact = _conv2d_fp64(clean, wb)[fin]
    mass = _conv2d_fp64(clean.abs(), wb.abs())[fin]
    assert ((got.double()[fin] - exact).abs()
            <= 1e-6 * mass + 2.0 ** -8 * exact.abs()).all()


def _conv2d_fp64(x, w):
    """The convolution's exact value (fp64 sums of exact products)."""
    return torch.nn.functional.conv2d(x.double()[None], w.double()[None])[0, 0]


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
    """One block (n = 2, 64, 4096) and passes of up to 12 stages (8192:
    12 and 1; 2^18: 12 and 6; 2^20; 2^24: 12 and 12; 2^25: 12, 12 and 1,
    the middle one twiddled), kernel and plain version both within 5e-6
    sqrt(n) of an fp64 transform, fp32 out."""
    for seed, n in enumerate([2, 64, 4096, 8192, 1 << 18, 1 << 20,
                              1 << 24, 1 << 25]):
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


# pathfinder: rows at k 64 + {0, 1, 2}, columns at k 896 + {-1, 0, 1} (a
# launch's rows, a window's finished columns); jacobi2d: every W mod 8, H
# not a multiple of the 64-row strip and strips of one row
PF_RAGGED = [(64, 895), (65, 896), (66, 897), (128, 1791), (129, 1792),
             (130, 1793)]
JC_RAGGED = [(66, 1024 + m) for m in range(8)] + [(65, 1027), (129, 515)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_pathfinder_jacobi2d_ragged_and_planted(cuda, dtype):
    """pathfinder and jacobi2d equal their plain versions bit for bit, NaN
    for NaN, on the shapes of the CPU emulations
    (``tests/test_torch_pool.py``), plain and with NaN and +-inf planted:
    pathfinder's at a window edge (column 895, 896), a launch edge (row
    64) and the last column; jacobi2d's at a strip edge (row 63 / 64), a
    warp edge (columns 127 / 128 in fp32, 255 / 256 in bf16: lanes 31 and
    0), a thread edge (columns 31 / 32) and the last column; jacobi2d also at three sweeps on a misaligned
    width, and in bf16 on subnormals.  Launches are ``kernels_per_call``."""
    warp = 32 * 16 // torch.tensor([], dtype=dtype).element_size()
    for seed, shape in enumerate(PF_RAGGED):
        (w,) = _randn(seed, cuda, dtype, shape)
        w = w.abs()
        for planted in (False, True):
            if planted:
                for (i, j), v in zip([(1, 895), (64, 896), (65, 127),
                                      (-1, -1), (2, 0)],
                                     [math.nan, math.inf, -math.inf,
                                      math.nan, math.inf]):
                    w[i % shape[0], j % shape[1]] = v
            got = _counted(k_pathfinder, "pathfinder",
                           k_pathfinder.pathfinder_cuda, w)
            assert got.dtype == torch.float32
            assert _same_bits(got, k_pathfinder.pathfinder_plain(w))
    for seed, shape in enumerate(JC_RAGGED):
        (x,) = _randn(seed, cuda, dtype, shape)
        for planted in (False, True):
            if planted:
                for (i, j), v in zip([(63, warp - 1), (64, warp), (1, 31),
                                      (2, 32), (40, -1)],
                                     [math.nan, math.inf, -math.inf,
                                      math.inf, math.nan]):
                    x[i % shape[0], j % shape[1]] = v
            for steps in (1, 3):
                got = _counted(k_jacobi2d, "jacobi2d",
                               k_jacobi2d.jacobi2d_cuda, x, steps=steps)
                assert got.dtype == dtype
                assert _same_bits(got, k_jacobi2d.jacobi2d_plain(x, steps))
    (x,) = _randn(99, cuda, dtype, (300, 301), scale=1e-38)
    got = _counted(k_jacobi2d, "jacobi2d", k_jacobi2d.jacobi2d_cuda, x)
    assert torch.equal(got, k_jacobi2d.jacobi2d_plain(x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_pathfinder_card_scale_matches_plain(cuda, dtype):
    """pathfinder at the card ladder's 1024 x 2^18, once, bit for bit
    against its plain version, in 16 launches."""
    (w,) = _randn(7, cuda, dtype, (1024, 1 << 18))
    w = w.abs()
    got = _counted(k_pathfinder, "pathfinder",
                   k_pathfinder.pathfinder_cuda, w)
    assert k_pathfinder.kernels_per_call(w.shape) == 16
    assert torch.equal(got, k_pathfinder.pathfinder_plain(w))


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_exp_every_bit_pattern(cuda, dtype):
    """exp equals its plain version bit for bit (NaN for NaN) on every bit
    pattern of its dtype: all 2^16 bf16 values, and all 2^32 fp32 values
    in chunks of 2^27."""
    bits = 16 if dtype == torch.bfloat16 else 32
    chunk = min(1 << bits, 1 << 27)
    for start in range(0, 1 << bits, chunk):
        raw = torch.arange(start, start + chunk, dtype=torch.int64,
                           device=cuda)
        if dtype == torch.bfloat16:
            x = raw.to(torch.int16).view(torch.bfloat16)
        else:
            x = (raw - (1 << 31)).to(torch.int32).view(torch.float32)
        assert _same_bits(_counted(k_exp, "exp", k_exp.exp_cuda, x),
                          k_exp.exp_plain(x))
        del raw, x


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


def test_granite_fp32_paged_equals_dense_on_card(cuda):
    """A narrow fp32 copy of granite-moe (TF32 off) served on the card by
    the paged layout and by dense continuous: the expert products and the
    combine depend neither on the chunk nor on the batch, so the greedy
    tokens agree row for row, and a repeat gives the same tokens."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m"),
                              n_layers=2, vocab_size=1000)
    model = build_model(cfg)
    params = model.init(0, device=cuda, dtype=torch.float32)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 1000, n).tolist()
               for n in (7, 16, 17, 64, 200, 333)]
    toks = []
    for kw in (dict(kv_layout="paged", block_size=16), {},
               dict(kv_layout="paged", block_size=16)):
        eng = ServeEngine(model, params, max_batch=4, cache_len=512, **kw)
        toks.append([r.tokens for r in eng.generate(
            [Request(p, 16, rid=i) for i, p in enumerate(prompts)])])
    assert toks[0] == toks[1] == toks[2]
