"""The port's ``ServeEngine`` (``repro_torch.serving``) on the paged KV
layout: greedy tokens held against the reference's paged ``ServeEngine`` on
the same fp32 weights, and the reference's serving invariants asserted
again port against port — prefix-cache hits, preemption and re-admission,
a pool that drains clean, and an idle slot whose position runs past its
table.  Every engine here asks for ``kv_layout="paged"`` (the default is
dense, tested in ``test_torch_dense.py``, with sampled streams)."""
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
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro_torch.bridge import params_from_reference
from repro_torch.configs import smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.serving import (FakeClock, PoolPressure, Request,
                                 ServeEngine, Tracer, validate_lifecycle)

CFG = smoke_config("qwen3-0.6b")
BS = 8
LENS = [3, 9, 17, 20, 5]
MARGIN = 1e-3      # above the fp32 logit tolerance of test_torch_model (1e-4)


@pytest.fixture(scope="module")
def weights():
    """The reference's own init, cast to fp32, on both sides."""
    rp = ref_build(ref_smoke("qwen3-0.6b")).init(jax.random.key(0))
    rp = jax.tree.map(lambda a: a.astype(jnp.float32), rp)
    return rp, params_from_reference(jax.tree.map(np.asarray, rp), CFG,
                                     device="cpu")


def _prompts(lens=LENS, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, CFG.vocab_size, n).tolist() for n in lens]


def _requests(prompts, max_new=6):
    return [Request(p, max_new, rid=i) for i, p in enumerate(prompts)]


def _engine(params, **kw):
    kw.setdefault("kv_layout", "paged")
    kw.setdefault("max_batch", 2)
    kw.setdefault("cache_len", 64)
    kw.setdefault("block_size", BS)
    return ServeEngine(build_model(CFG), params, **kw)


def _drained(eng):
    a = eng.allocator
    a.check_integrity()
    return a.n_live == 0 and a.n_reserved == 0 and a.n_free == a.capacity


def _teacher_forced(params, prompt, tokens):
    """The port's logits for each generated position, feeding the given
    stream back (batch-1 paged prefill, then decode)."""
    model = build_model(CFG)
    pc = model.paged_cache_init(batch=1, n_blocks=12, block_size=BS,
                                max_blocks=8, dtype=torch.float32,
                                device="cpu")
    pc["bt"][0] = torch.arange(1, 9, dtype=torch.int32)
    rows = []
    for c in range(-(-len(prompt) // BS)):
        toks = torch.zeros((1, BS), dtype=torch.int32)
        seg = prompt[c * BS:(c + 1) * BS]
        toks[0, :len(seg)] = torch.tensor(seg)
        logits, pc = model.prefill_paged(params, pc, {"tokens": toks}, 0, c,
                                         len(prompt))
    rows.append(logits[0])
    for t in tokens[:-1]:
        logits, pc = model.decode_paged(params, pc,
                                        torch.tensor([[t]], dtype=torch.int32))
        rows.append(logits[0])
    return rows


def test_greedy_tokens_match_reference_engine(weights):
    """Same trace, same fp32 weights, paged layout on both sides: the same
    greedy tokens — up to the first step whose top-2 logit margin is below
    the logit tolerance, where argmax may legitimately flip."""
    rp, params = weights
    prompts = _prompts()
    ref = RefServeEngine(ref_build(ref_smoke("qwen3-0.6b")), rp,
                         max_batch=2, cache_len=64, kv_layout="paged",
                         block_size=BS)
    want = [r.tokens for r in ref.generate(
        [RefRequest(p, 6, rid=i) for i, p in enumerate(prompts)])]
    eng = _engine(params)
    got = [r.tokens for r in eng.generate(_requests(prompts))]
    assert _drained(eng)
    compared = 0
    for p, g, w in zip(prompts, got, want):
        for row, a, b in zip(_teacher_forced(params, p, w), g, w):
            top2 = torch.topk(row, 2).values
            if (top2[0] - top2[1]).item() < MARGIN:
                break               # near-tie: compare no further
            assert a == b, (p, g, w)
            compared += 1
    assert compared >= len(prompts) * 5


def test_prefix_cache_hit_matches_cold_prefill(weights):
    """A prefix-cache hit serves the bytes a cold prefill writes: tokens
    equal a cold engine's, and a fully-covered prompt's recomputed final
    chunk rewrites its registered block bit for bit."""
    _, params = weights
    shared = _prompts([2 * BS])[0]
    prompts = [shared + [5, 6, 7], shared]
    cold = [r.tokens for r in _engine(params).generate(_requests(prompts))]
    eng = _engine(params, prefix_cache=True)
    first = eng.generate(_requests(prompts[:1]))[0].tokens
    blocks = sorted(blk for blk, _ in eng.allocator._index.values())
    assert len(blocks) == 2
    before = (eng._pcache["kp"][:, blocks].clone(),
              eng._pcache["vp"][:, blocks].clone())
    hit = [r.tokens for r in eng.generate(_requests(prompts))]
    assert eng.last_stats.prefix_hits >= 3
    assert [first] + hit[1:] == cold and hit[0] == cold[0]
    assert torch.equal(eng._pcache["kp"][:, blocks], before[0])
    assert torch.equal(eng._pcache["vp"][:, blocks], before[1])
    assert _drained(eng)


def _run_overcommit(eng, reqs):
    """A cluster-style driver over one engine: admit what fits, step, and
    on PoolPressure preempt the policy's victim and requeue it (re-admitted
    only once the pool covers its worst case, so it cannot thrash)."""
    eng.begin_session()
    queue = collections.deque(enumerate(reqs))
    results = {}
    while queue or eng.session_active:
        while queue and eng.session_free_slot() is not None:
            tag, r = queue[0]
            if not eng.session_can_admit(r) or (
                    r.requeues and eng.allocator.n_avail
                    < eng._worst_blocks(r)):
                break
            queue.popleft()
            eng.session_admit(r, tag)
        try:
            for tag, res in eng.session_step():
                results[tag] = res
        except PoolPressure:
            _, victim = min(eng.session_victims(eng.clock.now()))
            queue.append(eng.session_preempt(victim))
    stats = eng.end_session()
    return [results[i].tokens for i in range(len(reqs))], stats


def test_overcommit_preemption_is_invisible(weights):
    """Overcommit on a pool too small for both requests: PoolPressure,
    session_preempt, re-admission with the generated prefix — and the same
    tokens as an uncontended run."""
    _, params = weights
    prompts = _prompts([20, 12])
    want = [r.tokens for r in
            _engine(params).generate(_requests(prompts, 14))]
    eng = _engine(params, admission="overcommit", n_blocks=7)
    got, stats = _run_overcommit(eng, _requests(prompts, 14))
    assert stats.preempted >= 1 and stats.requeued >= 1
    assert got == want
    assert _drained(eng)


def test_pool_drains_after_success_and_failure(weights):
    """Every block and reservation returns after generate, and after a
    generate aborted by PoolPressure (overcommit without a preempting
    driver)."""
    _, params = weights
    eng = _engine(params, prefix_cache=False)
    eng.generate(_requests(_prompts()))
    assert _drained(eng)
    small = _engine(params, admission="overcommit", n_blocks=6)
    with pytest.raises(PoolPressure):
        small.generate(_requests(_prompts([20, 20]), 14))
    assert _drained(small)


def test_idle_slot_past_table_neither_raises_nor_writes(weights):
    """Every row's position advances each decode step, idle rows included,
    until slot_release resets it.  A slot idle for M * bs steps points past
    its table: the step must not raise, and must write nothing anywhere —
    only the live row's one position changes, as in the reference, whose
    out-of-range scatter is dropped."""
    rp, params = weights
    model, rmodel = build_model(CFG), ref_build(ref_smoke("qwen3-0.6b"))
    m = 4
    pc = model.paged_cache_init(batch=2, n_blocks=6, block_size=BS,
                                max_blocks=m, dtype=torch.float32,
                                device="cpu")
    rng = np.random.default_rng(3)
    pc["kp"].copy_(torch.from_numpy(rng.standard_normal(pc["kp"].shape)))
    pc["vp"].copy_(torch.from_numpy(rng.standard_normal(pc["vp"].shape)))
    pc["bt"][0] = torch.tensor([2, 4, 1, 3], dtype=torch.int32)
    pc["pos"].copy_(torch.tensor([13, m * BS + 5], dtype=torch.int32))
    rpc = {k: jnp.array(v.numpy(), copy=True) for k, v in pc.items()}
    before = pc["kp"].clone(), pc["vp"].clone()
    feed = np.array([[7], [9]], np.int32)
    logits, pc = model.decode_paged(params, pc, torch.from_numpy(feed))
    rlogits, rpc = jax.jit(rmodel.decode_paged)(rp, rpc, jnp.asarray(feed))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits),
                               rtol=1e-4, atol=1e-4)
    for new, old, ref in ((pc["kp"], before[0], rpc["kp"]),
                          (pc["vp"], before[1], rpc["vp"])):
        changed = (new != old).nonzero()[:, :4].unique(dim=0).tolist()
        assert changed == [[layer, 4, h, 13 % BS] for layer in range(2)
                           for h in range(CFG.n_kv_heads)]
        np.testing.assert_allclose(new.numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)
    assert pc["pos"].tolist() == [14, m * BS + 6]


def test_tracing_and_policies_change_no_token(weights):
    """The tracer hooks record a well-formed request lifecycle (prefix
    references and copy-on-write included) without changing a token, and
    every scheduling policy, budgets set, emits fifo's tokens."""
    _, params = weights
    shared = _prompts([2 * BS])[0]
    prompts = [shared + [5, 6, 7], shared, shared + [9]]
    want = [r.tokens for r in _engine(params).generate(_requests(prompts))]
    eng = _engine(params, prefix_cache=True)
    names = set()
    for _ in range(2):          # the second session hits the prefix cache
        tracer = Tracer(clock=FakeClock())
        eng.set_tracer(tracer)
        assert [r.tokens for r in eng.generate(_requests(prompts))] == want
        validate_lifecycle(tracer.events())
        names |= {e.name for e in tracer.events()}
    assert {"admit", "prefill", "chunk", "step", "finish", "kv_ref",
            "kv_alloc", "kv_free"} <= names
    for policy in ("priority", "edf", "slo_adaptive"):
        reqs = [Request(p, 6, rid=i, priority=i, slo_ttft_ms=50.0 * (3 - i),
                        slo_tpot_ms=20.0) for i, p in enumerate(prompts)]
        eng = _engine(params, policy=policy)
        assert [r.tokens for r in eng.generate(reqs)] == want
        assert eng.last_stats.slo_ttft_total == len(prompts)
        assert _drained(eng)


def test_stream_and_not_ported_paths(weights):
    """stream() yields every token in order; the dense layout (the
    default), lockstep, bucketing and sampling serve every request, and
    sampling leaves the paged pool clean.  Paged lockstep and the dense
    layout's pool options are refused, as in the reference."""
    _, params = weights
    eng = _engine(params)
    reqs = _requests(_prompts()[:3])
    want = [r.tokens for r in eng.generate(reqs)]
    got = collections.defaultdict(list)
    for ev in eng.stream(reqs):
        assert ev.index == len(got[ev.rid])
        got[ev.rid].append(ev.token)
    assert [got[i] for i in range(3)] == want
    for kw in (dict(kv_layout="dense"), dict(kv_layout="dense",
                                             mode="lockstep"),
               dict(kv_layout="dense", bucket="pow2")):
        e = _engine(params, **kw)
        assert e.kv_layout == "dense"
        out = e.generate(reqs)
        assert [len(r.tokens) for r in out] == [6, 6, 6]
    assert ServeEngine(build_model(CFG), params).kv_layout == "dense"
    sampled = eng.generate([Request([1, 2], 4, temperature=0.7)])
    assert len(sampled[0].tokens) == 4
    assert _drained(eng)
    for kw in (dict(mode="lockstep"),
               dict(kv_layout="dense", prefix_cache=True),
               dict(kv_layout="dense", admission="overcommit")):
        with pytest.raises(ValueError):
            _engine(params, **kw)


def test_serve_cli_on_cpu():
    """The launcher serves paged (prefix cache, metrics) and, by default,
    dense: continuous, lockstep, bucketed and sampled, and with
    ``--attribution`` prints the attribution line beside the same tokens.
    A threaded driver without a cluster and a cluster asked for a
    scheduler stop (``tests/test_torch_cluster.py`` serves the
    cluster)."""
    prompts = ["--prompts", "1 2 3", "4 5 6 7 8 9 10 11 12 13 14 15 16 17 18",
               "--max-new", "4"]
    for flags, want in (
            (["--kv-layout", "paged", "--prefix-cache", "--metrics"],
             "mode=continuous kv=paged"),
            ([], "mode=continuous kv=dense"),
            (["--mode", "lockstep"], "mode=lockstep kv=dense"),
            (["--bucket", "pow2", "--temperature", "0.5"],
             "kv=dense")):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            serve_cli.main(["--smoke", "--device", "cpu", *prompts, *flags])
        text = out.getvalue()
        assert text.count("[serve] rid=") == 2 and want in text, text
        attributed = io.StringIO()
        with contextlib.redirect_stdout(attributed):
            serve_cli.main(["--smoke", "--device", "cpu", *prompts, *flags,
                            "--attribution"])

        def rows(t):
            return [ln.split("tokens=")[1] for ln in t.splitlines()
                    if ln.startswith("[serve] rid=")]
        assert rows(attributed.getvalue()) == rows(text)
        assert "[metrics] attribution fu_utilization=" in \
            attributed.getvalue()
    for flags in (["--replicas", "2", "--mode", "lockstep"],
                  ["--driver", "threaded"], ["--bucket", "x"]):
        err = io.StringIO()
        with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
            serve_cli.main(["--smoke", "--device", "cpu", *flags])
        assert "--" in err.getvalue()
