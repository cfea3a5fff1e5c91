"""The port's utilization attribution (``repro_torch.serving.attribution``
and ``repro_torch.roofline``) held against the reference's
(``repro.serving.attribution``, ``repro.roofline.hlo_cost``):

* the classifier, ``dominant_verdict``, and the registry samples and
  ``roofline`` counter events that ``record_step`` / ``record_prefill``
  write under a ``FakeClock``, fed identical inputs on both sides, over a
  grid that reaches every verdict and both boundaries (the issue share at
  the threshold, the useful intensity at the ridge), and the
  ``EngineStats`` rollup of those registries;
* the port's analytic flops equal to the reference's HLO-derived
  ``phase_cost`` flops for every key the reference records on the same
  smoke traces (qwen3 paged and dense, zamba2 dense, granite-moe,
  qwen3-moe, phi-3-vision (stub patches) and gemma3 paged and dense,
  xlstm dense, also at prompts of one and two mLSTM chunks, whisper dense
  (stub frames), a two-replica cluster), with the same key sets;
* the port's bytes against one case computed by hand;
* the engine, the cluster (one attributor shared by the replicas, under
  both drivers) and ``--attribution`` on the CPU (gemma3, yi and xlstm
  too): tokens unchanged, every
  decode step given a verdict, ``0 < fu_utilization < 1``;
* the engine's card branch, driven on the CPU by fake event spans and a
  fake driver hook: the issue / device / lock-wait split of a decode step
  and the busy samples of every launch.
"""
import contextlib
import io

import jax
import pytest
import torch

from repro.configs import smoke_config as ref_smoke
from repro.models import build_model as ref_build
from repro.serving import Attributor as RefAttributor
from repro.serving import ClusterEngine as RefClusterEngine
from repro.serving import EngineStats as RefEngineStats
from repro.serving import FakeClock as RefFakeClock
from repro.serving import MachineSpec as RefMachineSpec
from repro.serving import MetricsRegistry as RefMetricsRegistry
from repro.serving import PhaseCost as RefPhaseCost
from repro.serving import Request as RefRequest
from repro.serving import ServeEngine as RefServeEngine
from repro.serving import Tracer as RefTracer
from repro.serving import dominant_verdict as ref_dominant_verdict
from repro_torch.configs import get_config, smoke_config
from repro_torch.launch import serve as serve_cli
from repro_torch.models import build_model
from repro_torch.roofline import cost as roofline_cost
from repro_torch.serving import (NULL_ATTR, NULL_TRACER, VERDICTS,
                                 Attributor, ClusterEngine, EngineStats,
                                 FakeClock, MachineSpec, MetricsRegistry,
                                 NullAttributor, PhaseCost, Request,
                                 ServeEngine, Tracer, dominant_verdict)

CACHE_LEN = 48
BLOCK = 8
SLOTS = 3
# ridge 100 / 10 = 10 flops a byte: verdicts are easy to place on either side
SPEC = MachineSpec("synthetic", peak_flops=100.0, mem_bw=10.0)
REF_SPEC = RefMachineSpec("synthetic", peak_flops=100.0, mem_bw=10.0)


@pytest.fixture(scope="module", autouse=True)
def _one_intra_op_thread():
    """The smoke models' ops are tiny: one intra-op thread runs them about
    as fast as many and keeps parallel test workers off each other's
    cores.  The old count comes back after the module."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace(vocab, n=3, max_new=6):
    """Greedy prompts of 4, 5, 6, ... tokens (the reference's trace)."""
    return [[(5 * i + j) % vocab for j in range(4 + i)] for i in range(n)], \
        max_new


def _port_reqs(vocab, n=3, max_new=6):
    prompts, max_new = _trace(vocab, n, max_new)
    return [Request(p, max_new, rid=i) for i, p in enumerate(prompts)]


def _ref_reqs(vocab, n=3, max_new=6):
    prompts, max_new = _trace(vocab, n, max_new)
    return [RefRequest(p, max_new, rid=i)
            for i, p in enumerate(prompts)]


# ---------------------------------------------------------------------------
# Classifier, recording and rollup: the port against the reference on
# identical inputs.
# ---------------------------------------------------------------------------

# (active, width, dispatch_s, device_s, flops, bytes, verdict): every
# verdict, and both boundaries - an issue share of exactly 0.5 is issue, a
# useful intensity of exactly the ridge (10) is compute
CLASSIFY_GRID = [
    (0, 4, 0.1, 0.9, 100.0, 1.0, "idle"),
    (0, 4, 0.9, 0.1, 100.0, 1.0, "idle"),
    (4, 4, 0.6, 0.4, 100.0, 1.0, "issue"),
    (4, 4, 0.5, 0.5, 100.0, 1.0, "issue"),
    (4, 4, 0.4999, 0.5001, 100.0, 1.0, "compute"),
    (4, 4, 0.1, 0.9, 50.0, 10.0, "memory"),
    (4, 4, 0.1, 0.9, 500.0, 10.0, "compute"),
    (4, 4, 0.0, 1.0, 100.0, 10.0, "compute"),
    (4, 4, 0.0, 1.0, 99.0, 10.0, "memory"),
    (2, 4, 0.0, 1.0, 200.0, 10.0, "compute"),
    (1, 4, 0.0, 1.0, 200.0, 10.0, "memory"),
    (3, 4, 0.0, 0.0, 500.0, 10.0, "compute"),
    (1, 1, 0.0, 0.0, 1.0, 10.0, "memory"),
]


@pytest.mark.parametrize("active,width,disp,dev,flops,nbytes,want",
                         CLASSIFY_GRID)
def test_classify_matches_reference(active, width, disp, dev, flops, nbytes,
                                    want):
    kw = dict(active=active, width=width, dispatch_s=disp, device_s=dev)
    got = Attributor(spec=SPEC).classify(
        cost=PhaseCost(flops, nbytes), **kw)
    ref = RefAttributor(spec=REF_SPEC).classify(
        cost=RefPhaseCost(flops, nbytes), **kw)
    assert got == ref == want


@pytest.mark.parametrize("counts", [
    {}, {"memory": 3, "compute": 1}, {"memory": 2, "issue": 2},
    {v: 1 for v in VERDICTS}, {"idle": 5, "compute": 5},
    {"compute": 0, "idle": 1}])
def test_dominant_verdict_matches_reference(counts):
    assert dominant_verdict(counts) == ref_dominant_verdict(counts)


def test_machine_spec_ridge_and_detect(monkeypatch):
    assert SPEC.ridge == pytest.approx(10.0)
    assert PhaseCost(flops=50.0, mem_bytes=2.0).ai == pytest.approx(25.0)
    cpu = MachineSpec.detect("cpu")
    assert (cpu.name, cpu.peak_flops, cpu.mem_bw) == ("cpu-nominal", 50e9,
                                                      25e9)
    assert MachineSpec.detect().peak_flops > 0
    # the card's name picks the H100 SXM's peaks, per dtype
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    bf16 = MachineSpec.detect("cuda", torch.bfloat16)
    fp32 = MachineSpec.detect("cuda", torch.float32)
    assert (bf16.peak_flops, bf16.mem_bw) == (989e12, 3.35e12)
    assert (fp32.peak_flops, fp32.mem_bw) == (67e12, 3.35e12)
    assert bf16.ridge == pytest.approx(295.2, abs=0.1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Other GPU")
    assert MachineSpec.detect("cuda").name == "gpu-nominal"


def test_null_attributor_is_inert():
    at = NULL_ATTR
    assert isinstance(at, NullAttributor) and not at.enabled
    assert at.phase_cost("k", None) is None
    m = MetricsRegistry()
    at.record_step(m, NULL_TRACER, "t", t0=0.0, t_disp=1.0, t1=2.0,
                   active=1, width=1, cost=None)
    at.record_prefill(m, NULL_TRACER, "t", t0=0.0, t1=1.0, cost=None)
    assert m.snapshot() == {}
    assert Attributor(spec=SPEC).device_span("cpu") is None


# per launch: ("step", t0, t_disp, t1, active, flops, bytes) or
# ("prefill", t0, t1, flops, bytes); width 4
RECORD_CASES = {
    "every-verdict": [("step", 0.0, 0.0, 1.0, 4, 50.0, 10.0),
                      ("step", 1.0, 1.0, 2.0, 4, 500.0, 10.0),
                      ("step", 2.0, 2.9, 3.0, 4, 500.0, 10.0),
                      ("step", 3.0, 3.0, 4.0, 0, 500.0, 10.0)],
    "boundaries": [("step", 0.0, 0.5, 1.0, 4, 100.0, 10.0),
                   ("step", 1.0, 1.25, 2.0, 2, 200.0, 10.0),
                   ("step", 2.0, 2.25, 3.0, 1, 200.0, 10.0),
                   ("step", 3.0, 3.0, 3.0, 4, 1.0, 1.0)],
    "prefills": [("prefill", 0.0, 0.5, 50.0, 10.0),
                 ("prefill", 0.5, 1.0, 500.0, 10.0),
                 ("prefill", 1.0, 1.0, 100.0, 10.0),
                 ("step", 1.0, 1.1, 1.6, 3, 60.0, 10.0)],
}


def _replay(at, m, tr, launches, cost_cls):
    for kind, *a in launches:
        if kind == "step":
            t0, t_disp, t1, active, flops, nbytes = a
            at.record_step(m, tr, "replica0", t0=t0, t_disp=t_disp, t1=t1,
                           active=active, width=4,
                           cost=cost_cls(flops, nbytes))
        else:
            t0, t1, flops, nbytes = a
            at.record_prefill(m, tr, "replica0/slot1", t0=t0, t1=t1,
                              cost=cost_cls(flops, nbytes))


def _raw(m):
    return (m.snapshot(),
            {n: list(h.samples) for n, h in m._histograms.items()},
            {n: g.value for n, g in m._gauges.items()},
            {n: c.n for n, c in m._counters.items()})


@pytest.mark.parametrize("case", sorted(RECORD_CASES))
def test_recording_matches_reference(case):
    """The same launches through both attributors under a FakeClock
    tracer: identical counters, raw histogram samples, gauges, counter
    events and EngineStats rollup."""
    launches = RECORD_CASES[case]
    m, rm = MetricsRegistry(), RefMetricsRegistry()
    tr = Tracer(clock=FakeClock(start=0.0, tick=0.25))
    rtr = RefTracer(clock=RefFakeClock(start=0.0, tick=0.25))
    _replay(Attributor(spec=SPEC), m, tr, launches, PhaseCost)
    _replay(RefAttributor(spec=REF_SPEC), rm, rtr, launches, RefPhaseCost)
    assert _raw(m) == _raw(rm)
    got = [(e.ph, e.track, e.name, e.ts, e.args) for e in tr.events()]
    want = [(e.ph, e.track, e.name, e.ts, e.args) for e in rtr.events()]
    assert got == want and len(got) == len(launches)
    s = EngineStats.from_registry(m, mode="continuous", wall_s=4.0)
    rs = RefEngineStats.from_registry(rm, mode="continuous", wall_s=4.0)
    for field in ("fu_utilization", "achieved_flops_per_s",
                  "achieved_bytes_per_s", "decode_ai", "ridge_ai",
                  "bottleneck", "prefill_bottleneck", "verdict_counts"):
        assert getattr(s, field) == getattr(rs, field), field


def test_busy_time_overrides_device_sample():
    """``busy_s`` (the card's event span) is the device-busy sample; the
    verdict still reads the host clock's split."""
    at, m = Attributor(spec=SPEC), MetricsRegistry()
    at.record_step(m, NULL_TRACER, "t", t0=0.0, t_disp=0.8, t1=1.0,
                   active=4, width=4, cost=PhaseCost(500.0, 10.0),
                   busy_s=0.7)
    assert m.counter("attr_verdict_issue").n == 1
    assert m.histogram("attr_device_ms").samples == [700.0]
    assert m.histogram("attr_dispatch_ms").samples == [800.0]
    s = EngineStats.from_registry(m, mode="continuous", wall_s=1.0)
    assert s.achieved_flops_per_s == pytest.approx(500.0 / 0.7)


def test_attr_metrics_merge_losslessly():
    """Two replica registries: the merged rollup equals attribution over
    the union - the cluster's aggregation contract."""
    at = Attributor(spec=SPEC)
    a, b = MetricsRegistry(), MetricsRegistry()
    lo = PhaseCost(flops=50.0, mem_bytes=10.0)
    for reg, n in ((a, 2), (b, 3)):
        for i in range(n):
            at.record_step(reg, NULL_TRACER, "t", t0=float(i),
                           t_disp=float(i), t1=i + 1.0, active=4, width=4,
                           cost=lo)
    a.merge(b)
    s = EngineStats.from_registry(a, mode="continuous", wall_s=5.0)
    assert s.achieved_flops_per_s == pytest.approx(50.0)
    assert s.verdict_counts == {"memory": 5} and s.bottleneck == "memory"


# ---------------------------------------------------------------------------
# The cost layer: flops equal to the reference's HLO count per key.
# ---------------------------------------------------------------------------

STUB_FRAMES = 16   # the serve CLIs' stub frames a request


def _stub_inputs(cfg, xp, dtype):
    """The serve CLI's stub side inputs (zeros, one row for every request)
    as ``extra_inputs=``: a vlm's patches, an encdec's frames; None for
    the other families."""
    if cfg.family == "vlm":
        return {"patches": xp.zeros((1, cfg.n_patches, cfg.patch_embed_dim),
                                    dtype=dtype)}
    if cfg.family == "encdec":
        return {"frames": xp.zeros((1, STUB_FRAMES, cfg.d_model),
                                   dtype=dtype)}
    return None


def _ref_costs(arch, layout, cache_len, replicas=None):
    cfg = ref_smoke(arch)
    model = ref_build(cfg)
    params = model.init(jax.random.key(0))
    at = RefAttributor(spec=REF_SPEC)
    extra = _stub_inputs(cfg, jax.numpy, jax.numpy.bfloat16)
    if replicas:
        eng = RefClusterEngine(model, params, replicas=replicas,
                               total_slots=2 * replicas, cache_len=cache_len,
                               block_size=BLOCK, attribution=at,
                               extra_inputs=extra)
    else:
        kw = dict(block_size=BLOCK) if layout == "paged" else {}
        eng = RefServeEngine(model, params, max_batch=SLOTS,
                             cache_len=cache_len, kv_layout=layout,
                             attribution=at, extra_inputs=extra, **kw)
    eng.generate(_ref_reqs(cfg.vocab_size))
    return {k: c.flops for k, c in at._costs.items()}


def _port_run(arch, layout, cache_len, replicas=None, driver="sequential"):
    cfg = smoke_config(arch)
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    at = Attributor(spec=SPEC)
    extra = _stub_inputs(cfg, torch, torch.float32)
    if replicas:
        eng = ClusterEngine(model, params, replicas=replicas,
                            total_slots=2 * replicas, cache_len=cache_len,
                            block_size=BLOCK, driver=driver,
                            extra_inputs=extra)
    else:
        kw = dict(block_size=BLOCK) if layout == "paged" else {}
        eng = ServeEngine(model, params, max_batch=SLOTS,
                          cache_len=cache_len, kv_layout=layout,
                          extra_inputs=extra, **kw)
    off = [r.tokens for r in eng.generate(_port_reqs(cfg.vocab_size))]
    eng.set_attributor(at)
    on = [r.tokens for r in eng.generate(_port_reqs(cfg.vocab_size))]
    return at, eng, off, on


# the reference's counts on these traces (smoke configs, 3 slots, block 8,
# 3 greedy prompts of 4-6 tokens), read off its HLO
REF_FLOPS = {
    ("qwen3-0.6b", "paged", 48): {
        ("decode", "paged", "qwen3-smoke", 3): 614400,
        ("prefill_chunk", "qwen3-smoke", 8): 1245184},
    ("qwen3-0.6b", "paged", 96): {
        ("decode", "paged", "qwen3-smoke", 3): 688128,
        ("prefill_chunk", "qwen3-smoke", 8): 1245184},
    ("qwen3-0.6b", "dense", 48): {
        ("decode", "dense", "qwen3-smoke", 3): 614400,
        ("prefill", "qwen3-smoke", 4): 630784,
        ("prefill", "qwen3-smoke", 5): 782848,
        ("prefill", "qwen3-smoke", 6): 935936},
    ("granite-moe-1b-a400m", "paged", 48): {
        ("decode", "paged", "granite-moe-smoke", 3): 617472,
        ("prefill_chunk", "granite-moe-smoke", 8): 1253376},
    ("granite-moe-1b-a400m", "dense", 48): {
        ("decode", "dense", "granite-moe-smoke", 3): 617472,
        ("prefill", "granite-moe-smoke", 4): 634880,
        ("prefill", "granite-moe-smoke", 5): 787968,
        ("prefill", "granite-moe-smoke", 6): 942080},
    ("qwen3-moe-235b-a22b", "paged", 48): {
        ("decode", "paged", "qwen3-moe-smoke", 3): 915456,
        ("prefill_chunk", "qwen3-moe-smoke", 8): 2048000},
    ("qwen3-moe-235b-a22b", "dense", 48): {
        ("decode", "dense", "qwen3-moe-smoke", 3): 915456,
        ("prefill", "qwen3-moe-smoke", 4): 1032192,
        ("prefill", "qwen3-moe-smoke", 5): 1284608,
        ("prefill", "qwen3-moe-smoke", 6): 1538048},
    # the 8 patch positions ride in every dense prefill, and the patch
    # projection in every paged chunk
    ("phi-3-vision-4.2b", "paged", 48): {
        ("decode", "paged", "phi-3-vision-smoke", 3): 663552,
        ("prefill_chunk", "phi-3-vision-smoke", 8): 1409024},
    ("phi-3-vision-4.2b", "dense", 48): {
        ("decode", "dense", "phi-3-vision-smoke", 3): 663552,
        ("prefill", "phi-3-vision-smoke", 4): 2105344,
        ("prefill", "phi-3-vision-smoke", 5): 2281984,
        ("prefill", "phi-3-vision-smoke", 6): 2459648},
    # gemma3's windows change no count (a traced window skips no chunk)
    ("gemma3-27b", "paged", 48): {
        ("decode", "paged", "gemma3-smoke", 3): 1646592,
        ("prefill_chunk", "gemma3-smoke", 8): 3670016},
    ("gemma3-27b", "dense", 48): {
        ("decode", "dense", "gemma3-smoke", 3): 1646592,
        ("prefill", "gemma3-smoke", 4): 1826816,
        ("prefill", "gemma3-smoke", 5): 2283008,
        ("prefill", "gemma3-smoke", 6): 2742272},
    ("xlstm-350m", "dense", 48): {
        ("decode", "dense", "xlstm-smoke", 3): 1147392,
        ("prefill", "xlstm-smoke", 4): 1568768,
        ("prefill", "xlstm-smoke", 5): 1957888,
        ("prefill", "xlstm-smoke", 6): 2349056},
    # the encoder over 16 stub frames rides in every prefill, the cross
    # strips' 16 keys in every decode row
    ("whisper-base", "dense", 48): {
        ("decode", "dense", "whisper-smoke", 3): 688128,
        ("prefill", "whisper-smoke", 4): 3481600,
        ("prefill", "whisper-smoke", 5): 3658240,
        ("prefill", "whisper-smoke", 6): 3835904},
    ("zamba2-1.2b", "dense", 48): {
        ("decode", "dense", "zamba2-smoke", 3): 1328640,
        ("prefill", "zamba2-smoke", 4): 1622016,
        ("prefill", "zamba2-smoke", 5): 2029568,
        ("prefill", "zamba2-smoke", 6): 2441216},
}


@pytest.mark.parametrize("arch,layout,cache_len", sorted(REF_FLOPS))
def test_flops_equal_reference_per_key(arch, layout, cache_len):
    """Every key the reference records on the trace, with its flops; the
    port records the same keys with the same flops, and the tokens do not
    move with attribution on."""
    ref = _ref_costs(arch, layout, cache_len)
    assert ref == REF_FLOPS[(arch, layout, cache_len)]
    at, eng, off, on = _port_run(arch, layout, cache_len)
    assert on == off
    assert {k: c.flops for k, c in at._costs.items()} == ref
    assert all(c.mem_bytes > 0 for c in at._costs.values())


@pytest.mark.parametrize("driver", ["sequential", "threaded"])
def test_cluster_shares_one_memo(driver):
    """Two replicas share one attributor: one memo entry per (phase,
    shape), the reference's keys and flops, every replica's steps rolled
    up, and the tokens unchanged."""
    ref = _ref_costs("qwen3-0.6b", "paged", CACHE_LEN, replicas=2)
    at, cl, off, on = _port_run("qwen3-0.6b", "paged", CACHE_LEN,
                                replicas=2, driver=driver)
    assert on == off
    assert all(e.attr is at for e in cl.engines)
    assert {k: c.flops for k, c in at._costs.items()} == ref
    assert set(ref) == {("decode", "paged", "qwen3-smoke", 2),
                        ("prefill_chunk", "qwen3-smoke", BLOCK)}
    s = cl.last_stats
    assert sum(s.verdict_counts.values()) == s.decode_steps > 0
    assert s.achieved_flops_per_s > 0 and s.bottleneck in VERDICTS
    assert sum(r.decode_steps for r in cl.replica_stats) == s.decode_steps
    # the threaded driver samples each step's wait for its dispatch lock
    lock = cl.last_metrics.histogram("attr_contention_ms")
    assert lock.count == (s.decode_steps if driver == "threaded" else 0)
    assert all(v >= 0 for v in lock.samples)


def test_xlstm_chunked_prefill_flops_equal_reference():
    """Prompts of one mLSTM chunk (256) and of two (512): the reference
    counts each chunk's products once a chunk and the sLSTM recurrence
    once a token, and so does the port."""
    cfg = ref_smoke("xlstm-350m")
    model = ref_build(cfg)
    at = RefAttributor(spec=REF_SPEC)
    eng = RefServeEngine(model, model.init(jax.random.key(0)), max_batch=2,
                         cache_len=CACHE_LEN, attribution=at)
    eng.generate([RefRequest(list(range(n)), 2, rid=i)
                  for i, n in enumerate((512, 256))])
    ref = {k: c.flops for k, c in at._costs.items()}
    assert ref == {("prefill", "xlstm-smoke", 512): 328761344,
                   ("prefill", "xlstm-smoke", 256): 164397056,
                   ("decode", "dense", "xlstm-smoke", 2): 764928}
    port = smoke_config("xlstm-350m")
    for key, flops in ref.items():
        assert roofline_cost.phase_cost(port, key,
                                        cache_len=CACHE_LEN).flops == flops


def test_flash_pairs_past_one_chunk():
    """Past 1024 tokens the reference's causal chunks stop at their
    diagonal key chunk."""
    assert roofline_cost.flash_pairs(6) == 36
    assert roofline_cost.flash_pairs(1024) == 1024 * 1024
    assert roofline_cost.flash_pairs(2048) == 1024 * 1024 + 1024 * 2048


def test_bytes_by_hand():
    """qwen3-smoke (2 layers, d 64, 4/2 heads of 16, ff 128, vocab 256,
    an untied LM head), a paged decode step of 3 rows over 48 keys, bf16."""
    weights = (64 * 256                          # the LM head
               + 3 * 64                          # 3 embedding rows gathered
               + 2 * (64 + 64                    # ln1, ln2
                      + 64 * 64 + 2 * 64 * 32 + 64 * 64    # q, k, v, o
                      + 16 + 16                  # q_norm, k_norm
                      + 3 * 64 * 128)            # SwiGLU
               + 64)                             # final norm
    kv = 2 * 2 * 2 * 16 * (48 + 1)   # layers x (K, V) x heads x hd x keys
    want = (2 * weights + 3 * (2 * kv + 4 + 256 * 4))
    c = roofline_cost.phase_cost(smoke_config("qwen3-0.6b"),
                                 ("decode", "paged", "qwen3-smoke", 3),
                                 cache_len=48, block_size=8,
                                 dtype=torch.bfloat16)
    assert c.mem_bytes == want == 222092
    # fp32 doubles every weight and K/V byte; ids and logits stay
    c32 = roofline_cost.phase_cost(smoke_config("qwen3-0.6b"),
                                   ("decode", "paged", "qwen3-smoke", 3),
                                   cache_len=48, block_size=8,
                                   dtype=torch.float32)
    assert c32.mem_bytes == 4 * weights + 3 * (4 * kv + 4 + 256 * 4)
    # a tied table (qwen3-0.6b's) is read whole by the LM head: every
    # parameter once, whatever the rows gathered
    full = get_config("qwen3-0.6b")
    assert roofline_cost.weight_bytes(full, 8) == \
        2 * build_model(full).n_params


# ---------------------------------------------------------------------------
# The engine and the launcher on the CPU.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    cfg = smoke_config("qwen3-0.6b")
    model = build_model(cfg)
    return cfg, model, model.init(0, device="cpu", dtype=torch.float32)


@pytest.mark.parametrize("layout", ["paged", "dense"])
def test_engine_rollup(smoke, layout):
    """Tokens identical on and off; every decode step classified; the
    rollup positive and below the peak; roofline counters on the trace."""
    cfg, model, params = smoke
    kw = dict(block_size=BLOCK) if layout == "paged" else {}
    eng = ServeEngine(model, params, max_batch=SLOTS, cache_len=CACHE_LEN,
                      kv_layout=layout, **kw)
    ref = [r.tokens for r in eng.generate(_port_reqs(cfg.vocab_size, 4))]
    tracer = Tracer()
    eng.set_tracer(tracer)
    eng.set_attributor(Attributor(MachineSpec.detect("cpu")))
    try:
        got = [r.tokens for r in eng.generate(_port_reqs(cfg.vocab_size,
                                                          4))]
    finally:
        eng.set_tracer(None)
        eng.set_attributor(None)
    assert got == ref and eng.attr is NULL_ATTR
    s = eng.last_stats
    assert 0.0 < s.fu_utilization < 1.0
    assert sum(s.verdict_counts.values()) == s.decode_steps > 0
    assert s.achieved_flops_per_s > 0 and s.achieved_bytes_per_s > 0
    assert s.bottleneck in VERDICTS
    assert s.prefill_bottleneck in ("memory", "compute")
    assert s.ridge_ai == pytest.approx(2.0) and s.decode_ai > 0
    roofs = [e for e in tracer.events() if e.name == "roofline"]
    assert roofs and all(e.ph == "C" and e.args["flops_pct"] >= 0
                         for e in roofs)
    # detached: the next run records nothing
    eng.generate(_port_reqs(cfg.vocab_size, 2))
    assert eng.last_stats.verdict_counts == {}
    assert eng.last_stats.fu_utilization == 0.0


def test_lockstep_is_not_attributed(smoke):
    cfg, model, params = smoke
    eng = ServeEngine(model, params, max_batch=SLOTS, cache_len=CACHE_LEN,
                      mode="lockstep", attribution=Attributor(SPEC))
    eng.generate(_port_reqs(cfg.vocab_size))
    assert eng.last_stats.verdict_counts == {} and not eng.attr._costs


def test_cpu_split_reads_the_decode_call_as_device_time(smoke):
    """On the CPU, which computes each op as it is issued, the decode call
    is the step's device time and sampling its issue time: with a clock
    that ticks a second a reading, [t0, t_disp] is one tick, [t_disp, t1]
    two, so every step reads issue-bound and its device sample is one
    tick."""
    cfg, model, params = smoke
    eng = ServeEngine(model, params, max_batch=SLOTS, cache_len=CACHE_LEN,
                      clock=FakeClock(0.0, tick=1.0),
                      attribution=Attributor(SPEC))
    eng.generate(_port_reqs(cfg.vocab_size))
    m = eng.last_metrics
    steps = eng.last_stats.decode_steps
    assert m.counter("attr_verdict_issue").n == steps > 0
    assert m.histogram("attr_device_ms").samples == [1e3] * steps
    assert m.histogram("attr_dispatch_ms").samples == [2e3] * steps


class _FakeSpan:
    """Stands in for the card's ``DeviceSpan``: a fixed busy time, read
    only once stopped."""

    def __init__(self, seconds):
        self._seconds, self.stopped = seconds, False

    def stop(self):
        self.stopped = True

    def seconds(self):
        assert self.stopped
        return self._seconds


class _CardAttributor(Attributor):
    """Drives the engine's card branch on the CPU: every attributed launch
    gets a ``_FakeSpan`` of ``busy`` seconds."""

    def __init__(self, busy):
        super().__init__(SPEC)
        self.busy, self.spans = busy, []

    def device_span(self, device):
        self.spans.append(_FakeSpan(self.busy))
        return self.spans[-1]


# (stream wait, lock wait, verdict) of every decode step under a clock that
# ticks a second a reading: t0, t_disp, t_wait and t1 are one tick apart,
# so issue = 2 - stream - lock and device = 1 + stream.  (0.25, 0.5) is the
# boundary (1.25 each side); at (0.25, 0.75) the step would read issue if
# the lock wait counted as issue time
CARD_SPLITS = [(0.0, None, "issue"), (0.5, 0.25, "memory"),
               (0.25, 0.75, "memory"), (0.25, 0.5, "issue")]


@pytest.mark.parametrize("layout", ["paged", "dense"])
@pytest.mark.parametrize("stream_s,lock_s,want", CARD_SPLITS)
def test_card_split_with_fake_spans(smoke, layout, stream_s, lock_s, want):
    """The card's branch of the engine, driven on the CPU by fake event
    spans and a fake driver hook: the issue time is the host's own
    (neither the stream wait nor the dispatch lock's), the device time the
    waits for the device, the lock wait its own sample, every busy sample
    (decode steps, dense prefills, paged chunks after their read-back) the
    span's, and the prefill's host time sampled apart."""
    cfg, model, params = smoke
    kw = dict(block_size=BLOCK) if layout == "paged" else {}
    eng = ServeEngine(model, params, max_batch=SLOTS, cache_len=CACHE_LEN,
                      kv_layout=layout, clock=FakeClock(0.0, tick=1.0), **kw)
    want_toks = [r.tokens for r in eng.generate(_port_reqs(cfg.vocab_size))]
    at = _CardAttributor(busy=0.125)
    eng.set_attributor(at)
    if lock_s is not None:
        eng.await_device = lambda: (stream_s, lock_s)
    got = [r.tokens for r in eng.generate(_port_reqs(cfg.vocab_size))]
    assert got == want_toks
    m, s = eng.last_metrics, eng.last_stats
    steps = s.decode_steps
    lock = lock_s or 0.0
    issue = 2.0 - stream_s - lock
    assert m.counter(f"attr_verdict_{want}").n == steps > 0
    assert m.histogram("attr_dispatch_ms").samples == [issue * 1e3] * steps
    assert m.histogram("attr_device_ms").samples == [125.0] * steps
    assert m.histogram("attr_contention_ms").samples == (
        [] if lock_s is None else [lock * 1e3] * steps)
    assert all(sp.stopped for sp in at.spans)
    prefills = m.histogram("attr_prefill_ms").count
    assert prefills == len(at.spans) - steps > 0
    assert m.histogram("attr_prefill_ms").samples == [125.0] * prefills
    assert m.histogram("attr_prefill_issue_ms").count == prefills
    assert all(v > 0 for v in m.histogram("attr_prefill_issue_ms").samples)
    busy_s = 0.125 * (steps + prefills)
    useful = (sum(m.histogram("attr_step_flops").samples)
              + sum(m.histogram("attr_prefill_flops").samples))
    assert s.achieved_flops_per_s == pytest.approx(useful / busy_s)


@pytest.mark.parametrize("arch", ["gemma3-27b", "yi-6b", "xlstm-350m"])
def test_cli_attribution_on_the_new_archs(arch):
    """``--attribution`` on gemma3, yi and xlstm: one attribution line,
    and the tokens the same as without it."""
    outs = []
    for extra in ([], ["--attribution"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_cli.main(["--arch", arch, "--smoke", "--device", "cpu",
                            "--max-new", "4", *extra])
        outs.append(buf.getvalue().splitlines())
    attr = [ln for ln in outs[1] if ln.startswith("[metrics] attribution ")]
    assert len(attr) == 1, outs[1]
    fields = dict(kv.split("=", 1) for kv in attr[0].split()[2:]
                  if "=" in kv and not kv.startswith("verdicts"))
    assert 0.0 < float(fields["fu_utilization"]) < 1.0

    def tokens(lines):
        return [ln.split("tokens=")[-1] for ln in lines if "tokens=" in ln]
    assert tokens(outs[0]) == tokens(outs[1]) and tokens(outs[0])


def test_hybrid_engine_attribution():
    cfg = smoke_config("zamba2-1.2b")
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.float32)
    eng = ServeEngine(model, params, max_batch=SLOTS, cache_len=CACHE_LEN,
                      attribution=Attributor(MachineSpec.detect("cpu")))
    eng.generate(_port_reqs(cfg.vocab_size))
    s = eng.last_stats
    assert 0.0 < s.fu_utilization < 1.0
    assert sum(s.verdict_counts.values()) == s.decode_steps > 0
    assert s.prefill_bottleneck in ("memory", "compute")


@pytest.mark.parametrize("extra", [[], ["--kv-layout", "paged"],
                                   ["--replicas", "2", "--driver",
                                    "threaded"]])
def test_cli_prints_the_attribution_line(extra):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_cli.main(["--smoke", "--device", "cpu", "--attribution",
                        "--max-new", "4", *extra])
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("[metrics] attribution ")]
    assert len(lines) == 1, buf.getvalue()
    fields = dict(kv.split("=", 1) for kv in lines[0].split()[2:]
                  if "=" in kv and not kv.startswith("verdicts"))
    assert fields["spec"] == "cpu-nominal"
    assert 0.0 < float(fields["fu_utilization"]) < 1.0
    assert fields["bottleneck"] in VERDICTS
    assert fields["ridge"] == "2.00"

