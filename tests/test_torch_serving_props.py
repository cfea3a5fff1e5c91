"""The reference's scheduler-matrix property (``tests/test_serving_props.py``)
asserted port against port: **for any trace, every scheduler / layout /
topology cell of the port emits byte-identical token streams**, greedy
rows by argmax and sampled rows keyed by (base key, rid, token index), and
every shared pool drains clean.

Cells (the reference's matrix): dense continuous (the reference cell),
dense lockstep (uniform-length traces only), paged continuous, paged with
the prefix cache, cluster 1xN, cluster Nx1 under each router, cluster 2x2
over a starved pool (overcommit: preemption mid-trace), the threaded driver
on Nx1 and on the starved 2x2, and the policy cells with no budgets set
(edf single engine, priority Nx1, slo_adaptive over the starved pool and
threaded, and the starved pool with the prefix cache).  Four cells run with
a live :class:`Tracer`, whose lifecycle must be well-formed and which must
not change a token.  The hybrid family (zamba2-1.2b, the scan family the
port has) runs its own matrix: continuous, lockstep, cluster 1xN and Nx1.
Both matrices run twice, attribution off and on (an :class:`Attributor`
attached to every cell, the reference cell's too): the tokens must not
move, and every attributed continuous step gets one verdict.  The moe
family (granite-moe's smoke config, routed dropless on every path) runs
the reference's moe matrix: dense, paged, paged with the prefix cache and
cluster 2x1.  The vlm family (phi-3-vision's smoke config, a seeded patch
row a request) runs dense continuous, lockstep (uniform lengths), paged
(at block size 8, and at 5, where the prefix ends inside a chunk),
``bucket="pow2"``, cluster 2x1 under both drivers and a starved 2x2
cluster that preempts.

Hypothesis draws the traces; the reference's seeds on record, 218 and
53156 (and 6480 for the hybrid family), are pinned with ``@example``
(ROADMAP §3).  The random examples are
bounded so the file stays near a minute on one CPU worker; without
hypothesis a seeded fallback runs the pinned seeds and a few more.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.models import build_model
from repro_torch.serving import (POLICIES, Attributor, ClusterEngine,
                                 MachineSpec, Request, ServeEngine, Tracer,
                                 make_policy, validate_lifecycle)

from helpers import HAS_HYPOTHESIS, given, settings, st

if HAS_HYPOTHESIS:
    from hypothesis import example
else:
    def example(*_a, **_kw):
        return lambda fn: fn

CACHE_LEN = 48
BLOCK = 8
SLOTS = 3
MAX_PROMPT = 12
MAX_NEW = 8
TEMPERATURES = (0.0, 0.0, 0.7, 1.3)   # half greedy, half sampled
PINNED = (218, 53156)                  # the reference's seeds on record
HYBRID_PINNED = 6480                   # the reference's hybrid split
N_EXAMPLES = 30                        # random traces beside the pinned
N_SCAN_EXAMPLES = 12
N_MOE_EXAMPLES = 30                    # the reference runs 12
N_VLM_EXAMPLES = 20
FALLBACK = PINNED + (1, 2, 3)
ATTRIBUTION = pytest.mark.parametrize("attributed", [False, True],
                                      ids=["attr-off", "attr-on"])


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
def harness():
    cfg = smoke_config("qwen3-0.6b")
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)

    def eng(**kw):
        kw.setdefault("cache_len", CACHE_LEN)
        return ServeEngine(model, params, **kw)

    def cluster(**kw):
        kw.setdefault("cache_len", CACHE_LEN)
        kw.setdefault("block_size", BLOCK)
        return ClusterEngine(model, params, **kw)

    engines = {
        "dense-continuous": eng(max_batch=SLOTS, mode="continuous"),
        "dense-lockstep": eng(max_batch=SLOTS, mode="lockstep"),
        "paged-continuous": eng(max_batch=SLOTS, kv_layout="paged",
                                block_size=BLOCK),
        "cluster-1xN": cluster(replicas=1, total_slots=SLOTS),
        **{f"cluster-Nx1-{r}": cluster(replicas=SLOTS, total_slots=SLOTS,
                                       router=r)
           for r in ("round_robin", "least_loaded", "shortest_queue")},
        # starved shared pool: 7 allocatable blocks against up to 6
        # requests wanting 3 each - overcommit admission must preempt
        "cluster-2x2-pressure": cluster(replicas=2, total_slots=4,
                                        n_blocks=8),
        "cluster-Nx1-threaded": cluster(replicas=SLOTS, total_slots=SLOTS,
                                        driver="threaded"),
        "cluster-2x2-pressure-threaded": cluster(replicas=2,
                                                 total_slots=4, n_blocks=8,
                                                 driver="threaded"),
        # scheduling policies, budgets unset: each must be fifo byte for
        # byte
        "dense-edf": eng(max_batch=SLOTS, mode="continuous", policy="edf"),
        "cluster-Nx1-priority": cluster(replicas=SLOTS, total_slots=SLOTS,
                                        policy="priority"),
        "cluster-2x2-pressure-slo": cluster(replicas=2, total_slots=4,
                                            n_blocks=8,
                                            policy="slo_adaptive"),
        "cluster-2x2-slo-threaded": cluster(replicas=2, total_slots=4,
                                            policy="slo_adaptive",
                                            driver="threaded"),
        # prefix cache on: cached blocks persist across traces, so every
        # later trace also checks hit against cold byte identity
        "paged-prefix-cache": eng(max_batch=SLOTS, kv_layout="paged",
                                  block_size=BLOCK, prefix_cache=True),
        "cluster-2x2-pressure-prefix": cluster(replicas=2, total_slots=4,
                                               n_blocks=8,
                                               prefix_cache=True),
    }
    return cfg, engines


def _draw_trace(rng: np.random.Generator, vocab: int):
    """The reference's trace draw: random trace + base key seed from one
    numpy generator; half the traces share a prompt prefix of at least one
    full block."""
    n = int(rng.integers(1, 7))
    uniform = bool(rng.integers(0, 2))
    fixed_len = int(rng.integers(1, MAX_PROMPT + 1))
    shared = ([int(t) for t in
               rng.integers(0, vocab, int(rng.integers(BLOCK, BLOCK + 2)))]
              if rng.integers(0, 2) else [])
    reqs = []
    for i in range(n):
        plen = fixed_len if uniform else int(rng.integers(1, MAX_PROMPT + 1))
        prompt = [int(t) for t in rng.integers(0, vocab, plen)]
        if shared and rng.integers(0, 2):
            prompt = shared + prompt[:int(rng.integers(0, plen + 1))]
        reqs.append(Request(
            prompt=prompt,
            max_new_tokens=int(rng.integers(1, MAX_NEW + 1)),
            temperature=float(TEMPERATURES[rng.integers(len(TEMPERATURES))]),
            rid=i,
            priority=int(rng.integers(0, 3))))
    return reqs, (0, int(rng.integers(0, 2 ** 31)))


# cells that also run traced: tokens still compare against the untraced
# reference, so these double as the tracer's observer-effect property
TRACED_CELLS = {"paged-continuous", "cluster-Nx1-round_robin",
                "cluster-2x2-pressure", "cluster-2x2-pressure-threaded"}


def _pool(eng):
    return getattr(eng, "pool", None) or getattr(eng, "allocator", None)


def _assert_drained(pool, what):
    pool.check_integrity()
    assert pool.n_live == 0, what
    assert pool.n_reserved == 0, what
    assert pool.n_free == pool.capacity, what


def _attributed_run(eng, run):
    """``run()`` with one Attributor attached to ``eng`` (every replica of
    a cluster); every decode step of a continuous cell must get exactly one
    verdict (the lockstep scheduler is not attributed)."""
    eng.set_attributor(Attributor(MachineSpec.detect("cpu")))
    try:
        out = run()
    finally:
        eng.set_attributor(None)
    s = eng.last_stats
    want = 0 if s.mode == "lockstep" else s.decode_steps
    assert sum(s.verdict_counts.values()) == want, (s.mode, s.verdict_counts)
    return out


def _check_conformance(harness, seed: int, attributed: bool = False):
    cfg, engines = harness
    reqs, key = _draw_trace(np.random.default_rng(seed), cfg.vocab_size)
    uniform = len({len(r.prompt) for r in reqs}) == 1
    ref_eng = engines["dense-continuous"]
    ref = ref_eng.generate(reqs, key=key)
    assert [r.rid for r in ref] == [q.rid for q in reqs]
    assert [len(r.tokens) for r in ref] == [q.max_new_tokens for q in reqs]
    for name, eng in engines.items():
        if (eng is ref_eng and not attributed) or (
                name == "dense-lockstep" and not uniform):
            continue
        tracer = Tracer() if name in TRACED_CELLS else None
        if tracer is not None:
            eng.set_tracer(tracer)
        try:
            if attributed:
                got = _attributed_run(eng,
                                      lambda: eng.generate(reqs, key=key))
            else:
                got = eng.generate(reqs, key=key)
        finally:
            if tracer is not None:
                eng.set_tracer(None)
        if tracer is not None:
            validate_lifecycle(tracer.events())
        for a, b in zip(ref, got):
            assert a.tokens == b.tokens, (
                f"{name} diverged on rid={a.rid} (seed {seed}): "
                f"{a.tokens} vs {b.tokens}")
        if _pool(eng) is not None:
            _assert_drained(_pool(eng), (name, seed))


@pytest.mark.skipif(not HAS_HYPOTHESIS,
                    reason="hypothesis drives the examples; the seeded "
                           "fallback below covers the no-dep environment")
@ATTRIBUTION
@settings(max_examples=N_EXAMPLES, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
@example(PINNED[0])
@example(PINNED[1])
def test_serving_conformance_random_traces(harness, attributed, seed):
    """Random traces across every cell of the matrix, attribution off and
    on, the reference's seeds on record pinned (a failure names the seed
    and the cell)."""
    _check_conformance(harness, seed, attributed)


@pytest.mark.skipif(HAS_HYPOTHESIS,
                    reason="hypothesis variant runs the examples")
@ATTRIBUTION
@pytest.mark.parametrize("seed", FALLBACK)
def test_serving_conformance_fallback(harness, attributed, seed):
    _check_conformance(harness, seed, attributed)


def test_pressure_cluster_actually_preempts(harness):
    """The starved cells really preempt (12 blocks wanted against 7), under
    both drivers, with the uncontended tokens."""
    cfg, engines = harness
    reqs = [Request(list(range(i, i + MAX_PROMPT)), MAX_NEW,
                    temperature=(0.9 if i % 2 else 0.0), rid=i)
            for i in range(6)]
    ref = engines["dense-continuous"].generate(reqs, key=(0, 17))
    for name in ("cluster-2x2-pressure", "cluster-2x2-pressure-threaded"):
        cl = engines[name]
        got = cl.generate(reqs, key=(0, 17))
        assert cl.last_stats.preempted >= 1, name
        assert cl.last_stats.requeued == cl.last_stats.preempted, name
        assert [r.tokens for r in got] == [r.tokens for r in ref], name
        _assert_drained(cl.pool, name)


def test_pressure_prefix_cluster_preempts_shared_holders(harness):
    """Preempting requests that hold shared prefix blocks only drops their
    references: the uncontended tokens, a prefix hit, a clean pool."""
    cfg, engines = harness
    shared = list(range(2, 2 + BLOCK))
    reqs = [Request(shared + list(range(40 + 4 * i, 44 + 4 * i)), MAX_NEW,
                    temperature=(0.9 if i % 2 else 0.0), rid=i)
            for i in range(6)]
    ref = engines["dense-continuous"].generate(reqs, key=(0, 23))
    cl = engines["cluster-2x2-pressure-prefix"]
    got = cl.generate(reqs, key=(0, 23))
    assert cl.last_stats.preempted >= 1
    assert cl.last_stats.prefix_hits >= 1
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    _assert_drained(cl.pool, "prefix")


def _with_policy(eng, policy, run):
    """Run ``run()`` with ``policy`` swapped in on a module-scoped engine
    (and its replicas), then restore the old one."""
    old = eng.policy
    pol = make_policy(policy)
    for e in (eng, *getattr(eng, "engines", ())):
        e.policy = pol
    try:
        return run()
    finally:
        for e in (eng, *getattr(eng, "engines", ())):
            e.policy = old


@pytest.mark.parametrize("seed", [3, 11])
def test_policy_matrix_no_budgets_identical(harness, seed):
    """Every policy x {single engine, sequential cluster, threaded
    cluster}, no budgets: fifo's tokens byte for byte."""
    cfg, engines = harness
    reqs, key = _draw_trace(np.random.default_rng(seed), cfg.vocab_size)
    ref = engines["dense-continuous"].generate(reqs, key=key)
    for policy in POLICIES:
        for cell in ("dense-continuous", "cluster-Nx1-round_robin",
                     "cluster-Nx1-threaded"):
            eng = engines[cell]
            got = _with_policy(eng, policy,
                               lambda: eng.generate(reqs, key=key))
            assert eng.last_stats.sched_policy == policy
            assert [r.tokens for r in got] == [r.tokens for r in ref], \
                (cell, policy, seed)


def test_policies_with_random_budgets_streams_unchanged(harness):
    """Random SLO budgets may reorder and preempt, but every policy's
    streams still equal the budget-less reference, and the pools drain."""
    cfg, engines = harness
    rng = np.random.default_rng(5)
    reqs, key = _draw_trace(rng, cfg.vocab_size)
    ref = engines["dense-continuous"].generate(reqs, key=key)
    budgeted = [dataclasses.replace(
        r, slo_ttft_ms=(float(rng.uniform(1.0, 200.0))
                        if rng.integers(0, 2) else None),
        slo_tpot_ms=(float(rng.uniform(0.5, 50.0))
                     if rng.integers(0, 2) else None)) for r in reqs]
    for policy in POLICIES:
        for cell in ("cluster-2x2-pressure-slo", "cluster-2x2-slo-threaded"):
            eng = engines[cell]
            got = _with_policy(eng, policy,
                               lambda: eng.generate(budgeted, key=key))
            assert [r.tokens for r in got] == [r.tokens for r in ref], \
                (cell, policy)
            _assert_drained(eng.pool, (cell, policy))


def test_paged_prefill_shape_is_trace_invariant(harness):
    """The chunked paged prefill runs one shape whatever the prompt
    lengths (the dense reference runs one a length)."""
    _, engines = harness
    eng = engines["paged-continuous"]
    eng.generate([Request(list(range(1, 2 + i)), 2, rid=i)
                  for i in range(MAX_PROMPT)])
    assert eng.last_stats.prefill_compiles == 0    # no dense prefill ran
    dense = engines["dense-continuous"]
    dense.generate([Request(list(range(1, 2 + i)), 2, rid=i)
                    for i in range(3)])
    assert dense.last_stats.prefill_compiles >= 3


# ---------------------------------------------------------------------------
# The hybrid family: slot-addressable recurrent state, dense clusters.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def scan_harness():
    cfg = smoke_config("zamba2-1.2b")
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    kw = dict(cache_len=CACHE_LEN)
    engines = {
        "continuous": ServeEngine(model, params, max_batch=SLOTS,
                                  mode="continuous", **kw),
        "lockstep": ServeEngine(model, params, max_batch=SLOTS,
                                mode="lockstep", **kw),
        "cluster-1xN": ClusterEngine(model, params, replicas=1,
                                     total_slots=SLOTS, **kw),
        "cluster-Nx1": ClusterEngine(model, params, replicas=SLOTS,
                                     total_slots=SLOTS, **kw),
        "cluster-Nx1-threaded": ClusterEngine(model, params, replicas=SLOTS,
                                              total_slots=SLOTS,
                                              driver="threaded", **kw),
    }
    assert engines["cluster-Nx1"].kv_layout == "dense"
    return cfg, engines


def _check_scan_conformance(scan_harness, seed: int,
                            attributed: bool = False):
    cfg, engines = scan_harness
    reqs, key = _draw_trace(np.random.default_rng(seed), cfg.vocab_size)
    uniform = len({len(r.prompt) for r in reqs}) == 1
    ref = engines["continuous"].generate(reqs, key=key)
    assert [len(r.tokens) for r in ref] == [q.max_new_tokens for q in reqs]
    for name, eng in engines.items():
        if (name == "continuous" and not attributed) or (
                name == "lockstep" and not uniform):
            continue
        if attributed:
            got = _attributed_run(eng, lambda: eng.generate(reqs, key=key))
        else:
            got = eng.generate(reqs, key=key)
        for a, b in zip(ref, got):
            assert a.tokens == b.tokens, (
                f"hybrid/{name} diverged on rid={a.rid} (seed {seed}): "
                f"{a.tokens} vs {b.tokens}")


@pytest.mark.skipif(not HAS_HYPOTHESIS,
                    reason="hypothesis drives the examples; the seeded "
                           "fallback below covers the no-dep environment")
@ATTRIBUTION
@settings(max_examples=N_SCAN_EXAMPLES, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
@example(PINNED[0])
@example(PINNED[1])
@example(HYBRID_PINNED)
def test_scan_family_conformance_random_traces(scan_harness, attributed,
                                               seed):
    """hybrid x {continuous, lockstep on uniform lengths} x {single, 1xN,
    Nx1 sequential and threaded} x attribution off and on: byte-identical
    tokens per trace."""
    _check_scan_conformance(scan_harness, seed, attributed)


@pytest.mark.skipif(HAS_HYPOTHESIS,
                    reason="hypothesis variant runs the examples")
@ATTRIBUTION
@pytest.mark.parametrize("seed", FALLBACK + (HYBRID_PINNED,))
def test_scan_family_conformance_fallback(scan_harness, attributed, seed):
    _check_scan_conformance(scan_harness, seed, attributed)


# ---------------------------------------------------------------------------
# The moe family: dropless routing on every path.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def moe_harness():
    cfg = smoke_config("granite-moe-1b-a400m")
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    kw = dict(cache_len=CACHE_LEN)
    engines = {
        "dense-continuous": ServeEngine(model, params, max_batch=SLOTS,
                                        mode="continuous", **kw),
        "paged-continuous": ServeEngine(model, params, max_batch=SLOTS,
                                        kv_layout="paged", block_size=BLOCK,
                                        **kw),
        "paged-prefix-cache": ServeEngine(model, params, max_batch=SLOTS,
                                          kv_layout="paged",
                                          block_size=BLOCK,
                                          prefix_cache=True, **kw),
        "cluster-2x1": ClusterEngine(model, params, replicas=2,
                                     total_slots=2, block_size=BLOCK, **kw),
    }
    return cfg, engines


def _check_family_conformance(harness, seed, family, extra=None):
    """Every cell of a family's matrix against its dense continuous cell:
    byte-identical tokens, every pool drained.  ``extra(reqs)`` gives the
    trace's per-request side inputs, set on every engine for the trace."""
    cfg, engines = harness
    reqs, key = _draw_trace(np.random.default_rng(seed), cfg.vocab_size)
    uniform = len({len(r.prompt) for r in reqs}) == 1
    if extra is not None:
        rows = extra(len(reqs), seed)
        for eng in engines.values():
            for e in (eng, *getattr(eng, "engines", ())):
                e.extra = rows
    ref = engines["dense-continuous"].generate(reqs, key=key)
    assert [len(r.tokens) for r in ref] == [q.max_new_tokens for q in reqs]
    for name, eng in engines.items():
        if name == "dense-continuous" or (
                name == "dense-lockstep" and not uniform):
            continue
        got = eng.generate(reqs, key=key)
        for a, b in zip(ref, got):
            assert a.tokens == b.tokens, (
                f"{family}/{name} diverged on rid={a.rid} (seed {seed}): "
                f"{a.tokens} vs {b.tokens}")
        if _pool(eng) is not None:
            _assert_drained(_pool(eng), (family, name, seed))


@pytest.mark.skipif(not HAS_HYPOTHESIS,
                    reason="hypothesis drives the examples; the seeded "
                           "fallback below covers the no-dep environment")
@settings(max_examples=N_MOE_EXAMPLES, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
@example(PINNED[0])
@example(PINNED[1])
def test_moe_family_conformance_random_traces(moe_harness, seed):
    """moe x {dense, paged, paged + prefix cache, cluster 2x1}:
    byte-identical tokens per trace, every pool drained."""
    _check_family_conformance(moe_harness, seed, "moe")


@pytest.mark.skipif(HAS_HYPOTHESIS,
                    reason="hypothesis variant runs the examples")
@pytest.mark.parametrize("seed", FALLBACK)
def test_moe_family_conformance_fallback(moe_harness, seed):
    _check_family_conformance(moe_harness, seed, "moe")


# ---------------------------------------------------------------------------
# The vlm family: a patch prefix and a side-input row a request.
# ---------------------------------------------------------------------------

def _vlm_rows(n, seed):
    """One seeded patch row a request of the trace."""
    cfg = smoke_config("phi-3-vision-4.2b")
    return {"patches": torch.from_numpy(
        np.random.default_rng(seed).standard_normal(
            (n, cfg.n_patches, cfg.patch_embed_dim)).astype(np.float32))}


@pytest.fixture(scope="module")
def vlm_harness():
    cfg = smoke_config("phi-3-vision-4.2b")
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    # the 8-position prefix: CACHE_LEN covers it, the longest prompt and
    # the decode writes
    kw = dict(cache_len=CACHE_LEN + cfg.n_patches)

    def cluster(**ckw):
        return ClusterEngine(model, params, block_size=BLOCK, **kw, **ckw)
    engines = {
        "dense-continuous": ServeEngine(model, params, max_batch=SLOTS,
                                        mode="continuous", **kw),
        "dense-lockstep": ServeEngine(model, params, max_batch=SLOTS,
                                      mode="lockstep", **kw),
        "paged-continuous": ServeEngine(model, params, max_batch=SLOTS,
                                        kv_layout="paged", block_size=BLOCK,
                                        **kw),
        "dense-pow2": ServeEngine(model, params, max_batch=SLOTS,
                                  bucket="pow2", **kw),
        # 5-position blocks: the 8-position prefix ends inside a chunk
        "paged-bs5": ServeEngine(model, params, max_batch=SLOTS,
                                 kv_layout="paged", block_size=5, **kw),
        "cluster-2x1": cluster(replicas=2, total_slots=2),
        "cluster-2x1-threaded": cluster(replicas=2, total_slots=2,
                                        driver="threaded"),
        # 9 allocatable blocks against up to 4 requests wanting up to 4
        "cluster-2x2-pressure": cluster(replicas=2, total_slots=4,
                                        n_blocks=10),
    }
    return cfg, engines


@pytest.mark.skipif(not HAS_HYPOTHESIS,
                    reason="hypothesis drives the examples; the seeded "
                           "fallback below covers the no-dep environment")
@settings(max_examples=N_VLM_EXAMPLES, deadline=None)
@given(st.integers(0, 2 ** 31 - 1))
@example(PINNED[0])
@example(PINNED[1])
def test_vlm_family_conformance_random_traces(vlm_harness, seed):
    """vlm x {dense continuous, lockstep on uniform lengths, paged at
    block sizes 8 and 5, pow2 buckets, cluster 2x1 sequential and
    threaded, a starved 2x2 cluster}: byte-identical tokens per trace,
    every pool drained."""
    _check_family_conformance(vlm_harness, seed, "vlm", _vlm_rows)


@pytest.mark.skipif(HAS_HYPOTHESIS,
                    reason="hypothesis variant runs the examples")
@pytest.mark.parametrize("seed", FALLBACK)
def test_vlm_family_conformance_fallback(vlm_harness, seed):
    _check_family_conformance(vlm_harness, seed, "vlm", _vlm_rows)


def test_vlm_pressure_cluster_preempts_invisibly(vlm_harness):
    """The starved vlm cluster really preempts (6 requests wanting 4
    blocks each against 9), under overcommit, and the resumed requests
    emit the uncontended streams: each is re-admitted with its own patch
    row."""
    cfg, engines = vlm_harness
    reqs = [Request(list(range(i, i + MAX_PROMPT)), MAX_NEW,
                    temperature=(0.9 if i % 2 else 0.0), rid=i)
            for i in range(6)]
    rows = _vlm_rows(6, 11)
    for eng in engines.values():
        for e in (eng, *getattr(eng, "engines", ())):
            e.extra = rows
    ref = engines["dense-continuous"].generate(reqs, key=(0, 19))
    cl = engines["cluster-2x2-pressure"]
    got = cl.generate(reqs, key=(0, 19))
    assert cl.last_stats.preempted >= 1
    assert [r.tokens for r in got] == [r.tokens for r in ref]
    _assert_drained(cl.pool, "vlm pressure")
