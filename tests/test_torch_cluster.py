"""The port's multi-replica ``ClusterEngine`` (``repro_torch.serving``):
greedy tokens held against the reference's ``ClusterEngine`` on the same
fp32 weights in every topology and driver, and the reference's cluster
invariants (``tests/test_cluster.py``) asserted again port against port —
router independence, request-keyed sampling, invisible preemption, a shared
pool that drains clean, victim choice, hysteresis, loud failures, both
drivers and streaming.  The scan-family cells run zamba2-1.2b (the hybrid
family, the scan family the port has) in place of the reference's
xlstm-350m.  The launcher's cluster flags close the file."""
import collections
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.serving import ClusterEngine as RefClusterEngine
from repro.serving import Request as RefRequest
from repro_torch.bridge import params_from_reference
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.serving import (DRIVERS, ROUTER_POLICIES, BlockAllocator,
                                 ClusterEngine, FakeClock, PoolPressure,
                                 Request, ServeEngine, Tracer,
                                 validate_lifecycle)

CFG = smoke_config("qwen3-0.6b")
CACHE_LEN = 64
BLOCK = 8
HYBRID = "zamba2-1.2b"


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them
    about as fast as many, and keeps the test run's parallel workers (and
    the threaded driver's replica threads) from oversubscribing the
    cores.  The old count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    """The reference's own init, cast to fp32, on both sides."""
    rp = ref_build(ref_smoke("qwen3-0.6b")).init(jax.random.key(0))
    rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), CFG,
                                     device="cpu")


@pytest.fixture(scope="module")
def params(weights):
    return weights[1]


@pytest.fixture(scope="module")
def hybrid():
    cfg = smoke_config(HYBRID)
    model = build_model(cfg)
    return cfg, model, model.init(0, device="cpu", dtype=torch.float32)


def _cluster(params, **kw):
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("block_size", BLOCK)
    return ClusterEngine(build_model(CFG), params, **kw)


def _single(params, **kw):
    kw.setdefault("cache_len", CACHE_LEN)
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("block_size", BLOCK)
    return ServeEngine(build_model(CFG), params, **kw)


def _trace(n=10):
    return [Request([1 + i, 2 + i, 3 + i], 5 + (i % 4), rid=i)
            for i in range(n)]


def _pressure_trace(temperature=0.0, priority=None):
    """6 requests of 26 positions (4 blocks each) against small pools:
    growth must preempt."""
    return [Request([3 * i + 1, 3 * i + 2], 24, temperature, rid=i,
                    priority=0 if priority is None else priority(i))
            for i in range(6)]


def _tokens(results):
    return [r.tokens for r in results]


def _drained(pool):
    pool.check_integrity()
    return (pool.n_live == 0 and pool.n_reserved == 0
            and pool.n_free == pool.capacity and pool.live_by_owner() == {})


# ---------------------------------------------------------------------------
# Parity with the reference's ClusterEngine (fp32 weights, greedy).
# ---------------------------------------------------------------------------

PARITY_LENS = (3, 9, 12, 5, 11, 7)
# cell -> ClusterEngine kwargs (cache_len 48, block_size 8, as the
# reference's conformance matrix); 2x2-pressure: 7 allocatable blocks
# against 4 slots of up to 3 blocks each
PARITY_CELLS = {
    "1xN": dict(replicas=1, total_slots=3),
    **{f"Nx1-{r}": dict(replicas=3, total_slots=3, router=r)
       for r in ROUTER_POLICIES},
    "2x2-pressure": dict(replicas=2, total_slots=4, n_blocks=8),
    "Nx1-threaded": dict(replicas=3, total_slots=3, driver="threaded"),
    "2x2-pressure-threaded": dict(replicas=2, total_slots=4, n_blocks=8,
                                  driver="threaded"),
}


@pytest.mark.parametrize("cell", PARITY_CELLS)
def test_cluster_tokens_match_reference_cluster(weights, cell):
    """The same trace through the reference's cluster and the port's, in
    the same cell: the same greedy tokens, the same preemption count in
    the sequential cells (a deterministic schedule), at least one
    preemption in the pressure cells, and pools that drain clean."""
    rp, params = weights
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, n).tolist()
               for n in PARITY_LENS]
    kw = dict(PARITY_CELLS[cell], cache_len=48, block_size=BLOCK)
    ref = RefClusterEngine(ref_build(ref_smoke("qwen3-0.6b")), rp, **kw)
    want = _tokens(ref.generate([RefRequest(p, 8, rid=i)
                                 for i, p in enumerate(prompts)]))
    cl = ClusterEngine(build_model(CFG), params, **kw)
    got = _tokens(cl.generate([Request(p, 8, rid=i)
                               for i, p in enumerate(prompts)]))
    assert got == want, cell
    s = cl.last_stats
    assert s.mode == "cluster" and s.kv_layout == "paged"
    assert s.router_policy == kw.get("router", "round_robin")
    if "pressure" in cell:
        assert s.preempted >= 1 and ref.last_stats.preempted >= 1
    if kw.get("driver", "sequential") == "sequential":
        assert s.preempted == ref.last_stats.preempted
    assert _drained(cl.pool)


# ---------------------------------------------------------------------------
# Port-against-port invariants (the reference's tests/test_cluster.py).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("router", ROUTER_POLICIES)
def test_cluster_matches_single_engine(params, router):
    """Greedy outputs are placement- and router-independent: a 2x2 cluster
    emits one 4-slot engine's tokens; the stats are the cluster's."""
    reqs = _trace()
    ref = _single(params, max_batch=4).generate(reqs)
    cl = _cluster(params, replicas=2, total_slots=4, router=router)
    got = cl.generate(reqs)
    assert _tokens(got) == _tokens(ref), router
    s = cl.last_stats
    assert s.mode == "cluster" and s.router_policy == router
    assert len(cl.replica_stats) == 2
    assert s.generated_tokens == sum(r.max_new_tokens for r in reqs)
    assert s.decode_steps == sum(r.decode_steps for r in cl.replica_stats)


def test_cluster_sampled_matches_single_engine(params):
    """Request-keyed sampling: temperature > 0 streams equal a single
    engine's, and they do depend on the base key."""
    reqs = [Request([2 + i, 3 + i], 6, temperature=0.8, rid=i)
            for i in range(6)]
    ref = _single(params, max_batch=4).generate(reqs, key=(0, 7))
    got = _cluster(params, replicas=2, total_slots=4).generate(reqs,
                                                               key=(0, 7))
    assert _tokens(got) == _tokens(ref)
    other = _cluster(params, replicas=2, total_slots=4).generate(
        reqs, key=(0, 8))
    assert _tokens(other) != _tokens(ref)


@pytest.mark.parametrize("temperature", [0.0, 0.9])
def test_preemption_is_invisible(params, temperature):
    """Pool pressure preempts, every preempted request is requeued once a
    preemption, and the tokens (greedy and sampled) equal an uncontended
    run's."""
    reqs = _pressure_trace(temperature)
    ref = _single(params, max_batch=4).generate(reqs, key=(0, 11))
    cl = _cluster(params, replicas=2, total_slots=4, n_blocks=11)
    got = cl.generate(reqs, key=(0, 11))
    assert cl.last_stats.preempted >= 1
    assert cl.last_stats.requeued == cl.last_stats.preempted
    assert _tokens(got) == _tokens(ref)
    assert all(len(r.tokens) == 24 for r in got)


def test_shared_pool_drains_clean(params):
    """After every drain (with and without preemption) the shared pool is
    wholly free and unreserved, and the replicas' pool bytes are counted."""
    cl = _cluster(params, replicas=2, total_slots=4, n_blocks=11)
    for reqs in (_trace(8), _pressure_trace()):
        cl.generate(reqs)
        assert _drained(cl.pool)
        per_pos = CFG.n_layers * 2 * CFG.n_kv_heads * CFG.head_dim_resolved * 4
        assert cl.last_pool_bytes >= 2 * 11 * BLOCK * per_pos


def test_priority_guides_victim_selection(params):
    """Preemption evicts the lowest-priority request first: with rids 0/1
    low and the rest high, the preempted requests are low ones, and every
    request still completes with its uncontended tokens."""
    reqs = _pressure_trace(priority=lambda i: 0 if i < 2 else 1)
    ref = _single(params, max_batch=4).generate(reqs)
    cl = _cluster(params, replicas=2, total_slots=4, n_blocks=11,
                  tracer=Tracer())
    got = cl.generate(reqs)
    assert cl.last_stats.preempted >= 1
    assert _tokens(got) == _tokens(ref)
    picks = [e.args["rid"] for e in cl.tracer.events()
             if e.name == "preempt_pick"]
    assert picks and {0, 1} & set(picks)


def test_preemption_hysteresis_prevents_thrash(params):
    """With no hysteresis a victim bounces straight back into the
    pressure that evicted it; with it the same trace completes with
    strictly fewer preemptions, the tokens unchanged either way."""
    reqs = _pressure_trace()
    ref = _single(params, max_batch=4).generate(reqs)
    counts = {}
    for k in (0, 4):
        cl = _cluster(params, replicas=2, total_slots=4, n_blocks=11,
                      preempt_hysteresis=k)
        assert _tokens(cl.generate(reqs)) == _tokens(ref), k
        counts[k] = cl.last_stats.preempted
    assert counts[0] > counts[4] >= 1, counts


def test_hysteresis_waived_when_cluster_idle(params):
    """A cool-down never stalls an idle cluster: a victim still cooling
    down when every replica drains is admitted at once."""
    reqs = [Request([1, 2], 20, rid=0, priority=1),
            Request([5, 6], 20, rid=1, priority=0)]
    cl = _cluster(params, replicas=2, total_slots=2, n_blocks=5,
                  preempt_hysteresis=100)
    got = cl.generate(reqs)
    assert [len(r.tokens) for r in got] == [20, 20]
    assert cl.last_stats.preempted >= 1
    assert _tokens(got) == _tokens(_single(params, max_batch=2)
                                   .generate(reqs))


def test_cluster_rejects_impossible_request(params):
    """A request whose worst case exceeds the whole shared pool raises up
    front; the cluster stays usable."""
    cl = _cluster(params, replicas=2, total_slots=4, n_blocks=5)
    with pytest.raises(ValueError, match="KV blocks"):
        cl.generate([Request(list(range(8)), 40, rid=0)])
    assert cl.pool.n_live == 0
    assert len(cl.generate([Request([1, 2], 4, rid=1)])[0].tokens) == 4


def test_cluster_validates_shape_and_family(params, hybrid):
    model = build_model(CFG)
    with pytest.raises(ValueError, match="router"):
        ClusterEngine(model, params, router="random")
    with pytest.raises(ValueError, match="multiple"):
        ClusterEngine(model, params, replicas=3, total_slots=4)
    with pytest.raises(ValueError, match="hysteresis"):
        ClusterEngine(model, params, preempt_hysteresis=-1)
    _, hmodel, hparams = hybrid
    # the hybrid family clusters on the dense slot layout; asking for
    # paged fails loudly, and so does a prefix cache
    with pytest.raises(ValueError, match="paged"):
        ClusterEngine(hmodel, hparams, kv_layout="paged")
    with pytest.raises(ValueError, match="prefix_cache"):
        ClusterEngine(hmodel, hparams, prefix_cache=True)
    cl = ClusterEngine(hmodel, hparams, replicas=2, total_slots=4,
                       cache_len=32)
    assert cl.kv_layout == "dense" and cl.pool is None
    assert ClusterEngine(model, params).kv_layout == "paged"


def test_scan_cluster_matches_single_engine(hybrid):
    """Dense-layout cluster of the hybrid family (slot-addressable
    recurrent state): narrow replicas emit the single engine's streams,
    greedy and sampled rows alike, under both drivers."""
    _, model, params = hybrid
    reqs = [Request([1 + i, 2 + i, 3 + i], 4 + (i % 3),
                    temperature=(1.0 if i % 2 else 0.0), rid=i)
            for i in range(7)]
    ref = ServeEngine(model, params, max_batch=4, cache_len=32,
                      mode="continuous").generate(reqs, key=(0, 23))
    cl = ClusterEngine(model, params, replicas=2, total_slots=4,
                       cache_len=32)
    for driver in DRIVERS:
        got = cl.generate(reqs, key=(0, 23), driver=driver)
        assert _tokens(got) == _tokens(ref), driver
        assert cl.last_stats.kv_layout == "dense"
        assert cl.last_stats.preempted == 0   # no pool, no pressure


def test_scan_state_reset_on_preempt_no_leak(hybrid):
    """A preempted slot's recurrent state is zeroed at once, its next
    occupant decodes as on a fresh engine, and the victim's resume equals
    its uninterrupted stream."""
    _, model, params = hybrid
    eng = ServeEngine(model, params, max_batch=1, cache_len=32,
                      mode="continuous")
    eng.begin_session((0, 31))
    victim = Request([9, 8, 7], 8, temperature=1.3, rid=0)
    eng.session_admit(victim, tag=0)
    eng.session_step()
    eng.session_step()
    _, requeued = eng.session_preempt(0)
    assert len(requeued.done) == 3      # admit token + two step tokens
    cache = eng._sess.cache
    assert int(cache["pos"][0]) == 0
    for name in ("conv", "ssm", "attn_k", "attn_v"):
        assert not cache[name][:, 0].any(), name
    nxt = Request([1, 2, 3], 4, temperature=0.9, rid=1)
    eng.session_admit(nxt, tag=1)
    outs = {}
    while eng.session_active:
        for tag, res in eng.session_step():
            outs[tag] = res
    eng.end_session()

    def fresh(r):
        return ServeEngine(model, params, max_batch=1, cache_len=32,
                           mode="continuous").generate([r], key=(0, 31))[0]
    assert outs[1].tokens == fresh(nxt).tokens
    assert fresh(requeued).tokens == fresh(victim).tokens


def test_starvation_signal_preempts_on_a_dense_cluster(hybrid):
    """slo_adaptive's starvation signal on the hybrid family's dense
    cluster, which can never raise PoolPressure (the reference's
    ``tests/test_slo.py`` trace): two long decodes whose tight TTFT budget
    admits them first fall out of their slack, budgeted shorts queued
    behind them trip the guard band and preempt them (counted in
    ``slo_starve_preempts``), fifo never does, and the tokens are fifo's
    under both drivers."""
    _, model, params = hybrid
    longs = [Request([(7 * i + j) % 50 + 1 for j in range(8)], 64, rid=i,
                     slo_ttft_ms=30.0) for i in range(2)]
    shorts = [Request([(11 * i + j) % 50 + 1 for j in range(8)], 4,
                      rid=10 + i, slo_ttft_ms=300.0) for i in range(4)]
    runs = {}
    for policy in ("fifo", "slo_adaptive"):
        for driver in DRIVERS:
            cl = ClusterEngine(model, params, replicas=2, total_slots=2,
                               cache_len=96, policy=policy,
                               slo_guard_ms=250.0, preempt_hysteresis=64,
                               clock=FakeClock(0.0, tick=1e-3))
            runs[policy, driver] = _tokens(cl.generate(longs + shorts,
                                                       driver=driver))
            starved = cl.last_stats.slo_starve_preempts
            assert (starved >= 1) == (policy == "slo_adaptive"), \
                (policy, driver, starved)
    assert all(t == runs["fifo", "sequential"] for t in runs.values())


def _slot_kv(eng, slot, n):
    """The K and V bytes of a paged slot's first ``n`` positions, every
    layer: (L, Hkv, n, D) each."""
    pc, bs = eng._sess.cache, eng.block_size
    blocks = pc["bt"][slot, :-(-n // bs)].long()
    return [pc[name][:, blocks].permute(0, 2, 1, 3, 4).reshape(
        CFG.n_layers, CFG.n_kv_heads, -1, CFG.head_dim_resolved)[:, :, :n]
        for name in ("kp", "vp")]


def test_paged_readmission_replays_done_bit_for_bit(params):
    """A preempted paged request prefills its prompt and replays its
    ``done`` tokens through full-width decode steps: the K/V it holds for
    prompt + done is the uninterrupted run's bit for bit (a chunked
    prefill of prompt + done would write other bits), the replayed tokens
    are counted, and the stream continues unchanged."""
    prompt = list(range(3, 14))
    r, other = Request(prompt, 9, rid=0), Request([5, 6, 7], 9, rid=1)

    def engine():
        eng = _single(params, max_batch=2)
        eng.begin_session()
        eng.session_admit(r, tag=0)
        eng.session_admit(other, tag=1)
        return eng
    whole = engine()
    for _ in range(5):
        whole.session_step()
    eng = engine()
    for _ in range(3):
        eng.session_step()
    _, requeued = eng.session_preempt(0)
    assert len(requeued.done) == 4       # the prefill's token + 3 steps
    eng.session_admit(requeued, tag=0)
    eng.session_step()                  # prompt chunks, replay, a decode
    n = len(prompt) + len(requeued.done)
    for a, b in zip(_slot_kv(eng, 0, n), _slot_kv(whole, 0, n)):
        assert torch.equal(a, b)
    want, got = {}, {}
    for e, out in ((whole, want), (eng, got)):
        while e.session_active:
            for tag, res in e.session_step():
                out[tag] = res.tokens
        busy, offered = e.session_slot_steps()
        steps = e._sess.metrics.counter("decode_steps").n
        assert offered == 2 * steps and 0 < busy <= offered
        e.end_session()
    assert got == want
    assert eng.last_metrics.counter("resume_replay_tokens").n == 4


def test_cotenant_held_pool_fails_loudly(params):
    """generate() on an engine whose shared pool a co-tenant holds raises
    instead of spinning (only a cluster driver can interleave engines)."""
    pool = BlockAllocator(9, BLOCK)         # 8 allocatable blocks
    kw = dict(max_batch=1, allocator=pool, block_size=None)
    a = _single(params, owner="a", **kw)
    b = _single(params, owner="b", **kw)
    a.begin_session()
    # worst case 8 blocks (3 + 59 positions): a's reservation covers the
    # whole pool
    assert a.session_admit(Request([1, 2, 3], 60, rid=0), tag=0) is None
    with pytest.raises(MemoryError, match="co-tenants"):
        b.generate([Request([4, 5, 6], 60, rid=1)])
    a.session_preempt(0)
    a.end_session()
    assert pool.n_live == 0 and pool.n_reserved == 0


def test_shared_pool_rejects_conflicting_tenants(params):
    """A shared pool refuses mixed admission policies and conflicting
    block sizes."""
    pool = BlockAllocator(9, BLOCK)
    kw = dict(max_batch=1, allocator=pool, block_size=None)
    _single(params, admission="reserve", **kw)
    with pytest.raises(ValueError, match="admission"):
        _single(params, admission="overcommit", **kw)
    with pytest.raises(ValueError, match="block_size"):
        _single(params, max_batch=1, allocator=pool, block_size=BLOCK * 2)


def test_prefill_finished_result_survives_pool_pressure(params):
    """A Result finished in session_step's prefill phase survives a
    PoolPressure raised later in the same step: the retried step returns
    it."""
    eng = _single(params, max_batch=2, cache_len=32, n_blocks=3,
                  admission="overcommit")
    eng.begin_session()
    assert eng.session_admit(Request([1, 2, 3], 1, rid=0), tag=0) is None
    assert eng.session_admit(Request(list(range(17)), 4, rid=1),
                             tag=1) is None
    with pytest.raises(PoolPressure):
        eng.session_step()
    tag, requeued = eng.session_preempt(1)
    assert tag == 1 and requeued.done == () and requeued.requeues == 1
    finished = eng.session_step()
    assert [(t, r.rid, len(r.tokens)) for t, r in finished] == [(0, 0, 1)]
    eng.session_abort()
    assert eng.allocator.n_live == 0 and eng.allocator.n_reserved == 0


def test_mid_prefill_preemption_keeps_ttft_base(params):
    """A request evicted before its first token keeps its first admission
    as the TTFT base: its Result.prefill_ms spans the aborted attempt and
    the requeue wait."""
    clock = FakeClock(0.0)
    eng = _single(params, max_batch=2, cache_len=32, n_blocks=4,
                  admission="overcommit", clock=clock)
    eng.begin_session()
    assert eng.session_admit(Request([1, 2, 3], 2, rid=1), tag=1) is None
    assert eng.session_admit(Request(list(range(17)), 2, rid=0),
                             tag=0) is None
    with pytest.raises(PoolPressure):
        eng.session_step()
    _, requeued = eng.session_preempt(1)     # evict A (admitted 2nd)
    assert requeued.rid == 0 and requeued.done == ()
    assert requeued.first_admit_t is not None
    clock.advance(0.06)                      # the requeue wait
    finished = {}
    while eng.session_active:                # drain B, freeing its block
        for t, r in eng.session_step():
            finished[t] = r
    assert eng.session_admit(requeued, tag=0) is None
    while eng.session_active:
        for t, r in eng.session_step():
            finished[t] = r
    assert len(finished[0].tokens) == 2
    assert finished[0].prefill_ms >= 60.0    # spans eviction + wait
    eng.end_session()
    assert eng.allocator.n_live == 0


def test_overcommit_without_cluster_surfaces_pool_pressure(params):
    """An overcommitted single engine propagates PoolPressure from
    generate (preemption is the cluster's job) and leaks nothing."""
    eng = _single(params, max_batch=4, n_blocks=9, admission="overcommit")
    with pytest.raises(PoolPressure):
        eng.generate(_pressure_trace()[:4])
    assert eng.allocator.n_live == 0 and eng.allocator.n_reserved == 0


# ---------------------------------------------------------------------------
# The threaded driver: byte-identical to the sequential one.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("router", ROUTER_POLICIES)
def test_threaded_driver_matches_sequential(params, router):
    reqs = _trace()
    cl = _cluster(params, replicas=2, total_slots=4, router=router)
    seq = cl.generate(reqs, driver="sequential")
    thr = cl.generate(reqs, driver="threaded")
    assert _tokens(thr) == _tokens(seq), router
    s = cl.last_stats
    assert s.mode == "cluster" and s.router_policy == router
    assert s.generated_tokens == sum(r.max_new_tokens for r in reqs)


def test_threaded_driver_reserve_admission(params):
    """Reserve admission under the threaded driver (a worker-side
    reservation can lose the race the coordinator's check won:
    admit_retry): the same tokens, the pool drained."""
    reqs = _trace(8)
    cl = _cluster(params, replicas=2, total_slots=4, n_blocks=17,
                  admission="reserve")
    seq = cl.generate(reqs, driver="sequential")
    assert _tokens(cl.generate(reqs, driver="threaded")) == _tokens(seq)
    assert _drained(cl.pool)


def test_threaded_driver_sampled_matches_sequential(params):
    reqs = [Request([1 + i, 2 + i, 3 + i], 5 + (i % 4), temperature=0.9,
                    rid=i) for i in range(8)]
    cl = _cluster(params, replicas=2, total_slots=4)
    seq = cl.generate(reqs, key=(0, 7), driver="sequential")
    thr = cl.generate(reqs, key=(0, 7), driver="threaded")
    assert _tokens(thr) == _tokens(seq)


def test_threaded_driver_preemption_invisible(params):
    """Pool pressure under the threaded driver resolves through the
    coordinator (pressure event -> victim preempt -> resume), invisible in
    the output; the pool drains and the trace is well-formed."""
    reqs = _pressure_trace()
    ref = _single(params, max_batch=4).generate(reqs)
    cl = _cluster(params, replicas=2, total_slots=4, n_blocks=11,
                  driver="threaded")
    tracer = Tracer()
    cl.set_tracer(tracer)
    try:
        got = cl.generate(reqs)
    finally:
        cl.set_tracer(None)
    assert cl.last_stats.preempted >= 1
    assert cl.last_stats.requeued == cl.last_stats.preempted
    assert _tokens(got) == _tokens(ref)
    assert _drained(cl.pool)
    validate_lifecycle(tracer.events())


# ---------------------------------------------------------------------------
# Streaming and validation.
# ---------------------------------------------------------------------------

def test_cluster_stream_yields_ordered_tokens(params):
    """Per-rid TokenEvents arrive in index order with one final marker
    each and concatenate to generate's output, under both drivers."""
    reqs = _trace(6)
    cl = _cluster(params, replicas=2, total_slots=4)
    ref = cl.generate(reqs, driver="sequential")
    for driver in DRIVERS:
        by_rid = collections.defaultdict(list)
        finals = 0
        for ev in cl.stream(reqs, driver=driver):
            assert ev.index == len(by_rid[ev.rid])
            by_rid[ev.rid].append(ev.token)
            finals += ev.final
        assert finals == len(reqs), driver
        assert [by_rid[r.rid] for r in ref] == _tokens(ref), driver


def test_stream_propagates_failures(params):
    cl = _cluster(params, replicas=2, total_slots=4)
    bad = [Request(list(range(CACHE_LEN + 8)), 4, rid=0)]
    with pytest.raises(ValueError):
        list(cl.stream(bad, driver="threaded"))


def test_invalid_driver_rejected(params):
    with pytest.raises(ValueError, match="driver"):
        _cluster(params, replicas=2, total_slots=4, driver="asyncio")
    cl = _cluster(params, replicas=2, total_slots=4)
    with pytest.raises(ValueError, match="driver"):
        cl.generate(_trace(2), driver="greenlet")


# ---------------------------------------------------------------------------
# The launcher.
# ---------------------------------------------------------------------------

def _serve(flags):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve_cli.main(["--smoke", "--device", "cpu", "--prompts", "1 2 3",
                        "4 5 6 7 8 9 10 11 12", "7 8", "--max-new", "5",
                        *flags])
    return out.getvalue()


def test_serve_cli_cluster_on_cpu():
    """``--replicas 2 --router least_loaded --driver threaded`` prints the
    single engine's tokens and the cluster's stats line, and with
    ``--attribution`` the same tokens and the attribution line; a single
    engine refuses ``--driver threaded``, a cluster ``--kv-layout``."""
    def tokens(text):
        return [line.split("tokens=")[1] for line in text.splitlines()
                if line.startswith("[serve] rid=")]
    single = _serve([])
    cluster = _serve(["--replicas", "2", "--router", "least_loaded",
                      "--driver", "threaded"])
    assert len(tokens(single)) == 3 and tokens(cluster) == tokens(single)
    assert "mode=cluster kv=paged" in cluster
    assert "router=least_loaded replicas=2 driver=threaded" in cluster
    attributed = _serve(["--replicas", "2", "--router", "least_loaded",
                         "--driver", "threaded", "--attribution"])
    assert tokens(attributed) == tokens(single)
    assert "[metrics] attribution fu_utilization=" in attributed
    for flags in (["--driver", "threaded"],
                  ["--replicas", "2", "--kv-layout", "paged"]):
        err = io.StringIO()
        with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
            serve_cli.main(["--smoke", "--device", "cpu", *flags])
        assert "--" in err.getvalue()
