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


@pytest.mark.parametrize("g,bs,lens", [
    (8, 48, [150, 49, 47]),      # qwen2.5-3b's group; 48 does not divide 64
    (8, 128, [300, 129, 1]),     # 128-position blocks, two tiles each
    (72, 48, [192, 0, 96]),      # 72 rows a kv head; kv_len 0 returns 0
    (72, 128, [512, 128, 200]),
])
def test_plain_decode_any_block_size_and_group_matches_reference(g, bs,
                                                                 lens):
    """The plain decode at block sizes that do not divide the kernels'
    64-key tile (48) or span two of them (128), and at g 8 and 72 (two of
    the tensor-core kernel's 64-row tiles), against the reference's ``xla``
    path and its Pallas kernel (interpret), on a narrow D.  A row with
    kv_len 0 is held to the Pallas kernel's 0 (the ``xla`` path's softmax
    over no key averages V there)."""
    q, kp, vp = _case(12, bs=bs, g=g)
    j, t = _both(q, kp, vp, BT, np.asarray(lens, np.int32))
    got = pa.paged_decode_attention_plain(*t)
    assert got.shape == (3, 2 * g, 1, 16)
    live = [i for i, n in enumerate(lens) if n]
    _close(got[live], np.asarray(paged_decode_attention_xla(*j))[live])
    _close(got, paged_decode_attention_pallas(*j, interpret=True))
    if 0 in lens:
        assert not got[lens.index(0)].any()


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


@pytest.mark.parametrize("g,bs,starts", [
    (8, 16, [48, 16, 0]),     # qwen2.5-3b's group (16 / 2): 128 rows a kv head
    (2, 64, [192, 64, 0]),    # 64-token blocks (qwen3 at block_size 64)
])
def test_plain_prefill_beyond_64_rows_matches_reference(g, bs, starts):
    """g * Sq = 128 query rows a kv head, two of the tensor-core kernel's
    64-row tiles: the plain version against the reference's oracle, its
    ``xla`` path and its Pallas kernel (interpret), on a narrow D."""
    q, kp, vp = _case(11, bs=bs, g=g, sq=bs)
    j, t = _both(q, kp, vp, BT, np.asarray(starts, np.int32))
    got = pa.paged_prefill_attention_plain(*t)
    assert got.shape == (3, 2 * g, bs, 16)
    _close(got, jref.paged_prefill_attention_ref(*j))
    _close(got, paged_prefill_attention_xla(*j))
    _close(got, paged_prefill_attention_pallas(*j, interpret=True))


@pytest.mark.parametrize("hkv,rows,bs,m,want", [
    (8, 32, 16, 64, (1, 16)),     # qwen3-0.6b, block_size 16, 1024 tokens
    (2, 128, 16, 64, (2, 16)),    # qwen2.5-3b: two row tiles
    (8, 32, 64, 16, (1, 16)),     # qwen3 at block_size 64
    (8, 32, 16, 4096, (1, 17)),   # a wide table: enough blocks for the card
    (2, 128, 16, 1, (2, 1)),      # one block: one tile, one split
    (1, 1, 1, 1, (1, 1)),
])
def test_prefill_plan_covers_every_key_tile_once(hkv, rows, bs, m, want):
    """The tensor-core prefill's (row tiles, splits) for an H100's 132
    SMs, and the tiles of each split at every frontier the table allows:
    contiguous, in order, each tile exactly once, no split past the
    table's last tile; the plan reads neither the batch nor q_start."""
    row_tiles, splits = pa.prefill_plan(hkv, rows, bs, m, 132)
    assert (row_tiles, splits) == want
    assert (row_tiles - 1) * 64 < rows <= row_tiles * 64
    max_tiles = -(-m * bs // 64)
    assert 1 <= splits <= min(max_tiles, pa.MAX_SPLITS)
    for n_tiles in range(max_tiles + 1):
        ranges = pa.split_tiles(n_tiles, splits)
        assert len(ranges) == splits
        assert [t for r in ranges for t in r] == list(range(n_tiles))
        assert all(r.start <= n_tiles <= max_tiles for r in ranges)


# every block size a table may have, now that neither kernel needs bs to
# divide its 64-key tile: (hkv, g, bs, M, want) on an H100's 132 SMs
DECODE_PLANS = [
    (8, 2, 16, 64, (1, 16)),      # qwen3-0.6b, block_size 16, 1024 tokens
    (2, 8, 16, 64, (1, 16)),      # qwen2.5-3b's group of 8
    (1, 72, 16, 64, (2, 16)),     # g 72: two row tiles
    (8, 2, 48, 22, (1, 17)),      # 1056 keys: 16.5 tiles
    (8, 2, 128, 8, (1, 16)),
    (8, 2, 1, 64, (1, 1)),        # one position a block: one tile
    (8, 2, 64, 16, (1, 16)),
    (8, 2, 24, 3, (1, 2)),        # 72 keys: a tile and a ragged one
    (8, 2, 16, 4096, (1, 17)),    # a wide table: enough blocks for the card
]


@pytest.mark.parametrize("hkv,g,bs,m,want", DECODE_PLANS)
def test_decode_plan_covers_every_key_tile_once(hkv, g, bs, m, want):
    """The tensor-core decode's (row tiles, splits) for an H100's 132 SMs,
    and the tiles of each split at every kv_len the table allows (kv_len 0
    up to an idle slot's past M * bs): contiguous, in order, each tile
    exactly once, no split past the table's last tile.  The plan takes
    neither B nor kv_len, so it is the same for every batch and length."""
    import inspect
    assert set(inspect.signature(pa.decode_plan).parameters) == {
        "hkv", "g", "bs", "max_blocks", "n_sm"}
    row_tiles, splits = pa.decode_plan(hkv, g, bs, m, 132)
    assert (row_tiles, splits) == want
    assert (row_tiles - 1) * 64 < g <= row_tiles * 64
    max_tiles = -(-m * bs // 64)
    assert 1 <= splits <= min(max_tiles, pa.MAX_SPLITS)
    for kv_len in range(m * bs + 17):
        n_tiles = -(-min(kv_len, m * bs) // 64)     # the kernel's walk
        ranges = pa.split_tiles(n_tiles, splits)
        assert len(ranges) == splits
        assert [t for r in ranges for t in r] == list(range(n_tiles))
        assert all(r.start <= n_tiles <= max_tiles for r in ranges)


@pytest.mark.parametrize("bs", [1, 3, 16, 24, 48, 64, 100, 128, 256])
def test_prefill_plan_any_block_size(bs):
    """The prefill's plan at block sizes that need not divide the 64-key
    tile: at most one split a tile of the table's M * bs keys, every tile
    of every frontier walked once (Sq = bs, qwen2.5-3b's g 8)."""
    m = -(-1024 // bs)
    row_tiles, splits = pa.prefill_plan(2, 8 * bs, bs, m, 132)
    max_tiles = -(-m * bs // 64)
    assert row_tiles == -(-8 * bs // 64)
    assert 1 <= splits <= min(max_tiles, pa.MAX_SPLITS)
    for n_tiles in range(max_tiles + 1):
        assert [t for r in pa.split_tiles(n_tiles, splits)
                for t in r] == list(range(n_tiles))


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 8), (torch.bfloat16, 72),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 8), (torch.float32, 128)])
def test_both_kernels_fit_shared_memory_at_any_group(dtype, d):
    """Each route's shared memory at every head dim the kernels take and
    any rows a kv head (a block holds at most 64 of them), the combine of
    64 splits included, fits the H100's 227 KB; decode and prefill share
    the route of their dtype."""
    kind, dp = pa.route(dtype, d)
    assert (kind, dp) == pa.prefill_route(dtype, d)
    assert kind == ("mma" if dtype == torch.bfloat16 else "simt")
    for rows in (1, 2, 8, 64, 72, 1024):
        assert pa.smem_bytes(kind, dp, rows, pa.MAX_SPLITS) <= 227 * 1024


def test_decode_routes_are_counted_apart():
    """Decode's launches by route sit beside the prefill's (whose keys the
    existing callers read): ``ROUTE_COUNTS`` names each kernel's, and
    ``reset_launches`` zeroes both."""
    assert pa.ROUTE_COUNTS == {"paged_decode_attention": pa.DECODE_ROUTES,
                               "paged_prefill_attention": pa.ROUTES}
    saved = [dict(c) for c in (pa.LAUNCHES, pa.ROUTES, pa.DECODE_ROUTES)]
    try:
        for counts in (pa.LAUNCHES, pa.ROUTES, pa.DECODE_ROUTES):
            for name in counts:
                counts[name] += 2
        pa.reset_launches()
        assert not any(n for c in (pa.LAUNCHES, pa.ROUTES, pa.DECODE_ROUTES)
                       for n in c.values())
    finally:
        for counts, old in zip((pa.LAUNCHES, pa.ROUTES, pa.DECODE_ROUTES),
                               saved):
            counts.update(old)


def test_prefill_route_by_dtype():
    """bf16 on the tensor cores at d rounded up to a template, fp32 on CUDA
    cores; any other dtype raises."""
    assert pa.prefill_route(torch.bfloat16, 128) == ("mma", 128)
    assert pa.prefill_route(torch.bfloat16, 72) == ("mma", 128)
    assert pa.prefill_route(torch.bfloat16, 24) == ("mma", 32)
    assert pa.prefill_route(torch.bfloat16, 16) == ("mma", 16)
    assert pa.prefill_route(torch.float32, 24) == ("simt", 24)
    with pytest.raises(TypeError):
        pa.prefill_route(torch.float16, 64)


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
    """CPU tensors take the plain version; a window takes the gather path
    (as the reference routes it, on every device) and counts no launch; a
    device that is neither CPU nor CUDA raises; the CUDA wrappers refuse
    CPU tensors rather than falling back, and count no launch."""
    _, t = _decode(10, [64, 23, 17])
    _close(ops.paged_decode_attention(*t),
           pa.paged_decode_attention_plain(*t).numpy())
    _, tp = _prefill(10, [24, 8, 0])
    _close(ops.paged_prefill_attention(*tp),
           pa.paged_prefill_attention_plain(*tp).numpy())
    before, routes = dict(pa.LAUNCHES), dict(pa.ROUTES)
    _close(ops.paged_decode_attention(*t, window=8),
           pa.paged_decode_attention_plain(*t, window=8).numpy())
    _close(ops.paged_prefill_attention(*tp, window=8),
           pa.paged_prefill_attention_plain(*tp, window=8).numpy())
    assert pa.LAUNCHES == before and pa.ROUTES == routes
    with pytest.raises(ValueError, match="meta"):
        ops.paged_decode_attention(*[x.to("meta") for x in t])
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_decode_attention_cuda(*t)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_prefill_attention_cuda(*tp)
    assert pa.LAUNCHES == before and pa.ROUTES == routes


def test_launch_counts_and_first_builds_hold_across_threads(monkeypatch):
    """The cluster's threaded driver launches kernels from several threads
    at once: ``build.count`` loses no update (16 threads, a forced switch
    interval of 1 us), and 16 threads asking ``build.library`` for a source
    not yet built run one build and share its library."""
    import sys
    import threading

    from repro_torch.kernels import build
    launches, routes = {"k": 0}, {"mma": 0, "simt": 0}
    builds = []

    class FakeFn:
        pass

    class FakeLib:
        def __getattr__(self, name):
            return self.__dict__.setdefault(name, FakeFn())

    def fake_compile(source):
        builds.append(source)
        threading.Event().wait(0.05)      # a build takes a while
        return source
    monkeypatch.setattr(build, "_LIBS", {})
    monkeypatch.setattr(build, "_compile", fake_compile)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: FakeLib())
    libs = []

    def work(t):
        libs.append(build.library("fft.cu"))
        for _ in range(2000):
            build.count(launches, "k", 2, routes, "mma" if t % 2 else "simt")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(t,))
                   for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    assert launches == {"k": 16 * 2000 * 2}
    assert routes == {"mma": 8 * 2000 * 2, "simt": 8 * 2000 * 2}
    assert builds == ["fft.cu"] and len({id(lib) for lib in libs}) == 1
