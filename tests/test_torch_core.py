"""The port's copy of the analytical models (``repro_torch.core``) held
equal to the reference's (``repro.core``), and the ideality entry point
(``repro_torch.launch.ideality``) against ``benchmarks/bench_ideality.py``.

Both packages compute the same closed forms in Python floats, so every
comparison is exact (``==``): the port prints the paper's Fig 4/5 rows to
the last digit of the reference."""
import dataclasses
import pathlib

import pytest
import torch

from repro import core as jcore
from repro_torch import core as tcore
from repro_torch.launch import ideality as tideality

ROOT = pathlib.Path(__file__).resolve().parents[1]
LANES = (2, 4, 8, 16)
VL_BYTES = (32, 64, 128, 256, 512, 1024, 2048, 4096)   # bench_ideality.py:12
WHATIFS = [{}, {"ideal_dispatcher": True}, {"ideal_cache": True},
           {"streamlined": True}, {"barber_pole": True}]


def _engines(lanes):
    return (jcore.VectorEngineConfig(n_lanes=lanes),
            tcore.VectorEngineConfig(n_lanes=lanes))


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("kernel", list(jcore.KERNELS))
def test_ideality_equals_reference(kernel, lanes):
    """Every pool kernel x lanes x vector length of the Fig 5 heatmap."""
    je, te = _engines(lanes)
    for vb in VL_BYTES:
        assert tcore.ideality(kernel, vb, te) == jcore.ideality(kernel, vb, je)


@pytest.mark.parametrize("whatif", WHATIFS, ids=lambda w: "|".join(w) or "base")
def test_kernel_opc_and_whatifs_equal_reference(whatif):
    for kernel in jcore.KERNELS:
        for lanes in LANES:
            je, te = _engines(lanes)
            for vb in VL_BYTES:
                assert tcore.kernel_opc(kernel, vb, te,
                                        tcore.WhatIf(**whatif)) == \
                    jcore.kernel_opc(kernel, vb, je, jcore.WhatIf(**whatif))


def test_kernel_table_and_util_curve_equal_reference():
    assert {k: dataclasses.asdict(s) for k, s in tcore.KERNELS.items()} == \
        {k: dataclasses.asdict(s) for k, s in jcore.KERNELS.items()}
    for kernel in jcore.KERNELS:
        for bpl in (4, 8, 12, 16, 48, 100, 128, 300, 512, 4096):
            assert tcore.util_curve(kernel, bpl) == \
                jcore.util_curve(kernel, bpl)


@pytest.mark.parametrize("n", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("ew_bits", [64, 32])
def test_matmul_model_over_the_fixed_fpu_sweep(n, ew_bits):
    """``matmul_cycles`` / ``matmul_opc`` over every (cores x lanes) split
    of 16 FPUs, with and without the ideal dispatcher."""
    tsweep, jsweep = tcore.fixed_fpu_sweep(16), jcore.fixed_fpu_sweep(16)
    assert [c.describe() for c in tsweep] == [c.describe() for c in jsweep]
    for tc, jc in zip(tsweep, jsweep):
        for ideal in (False, True):
            tw = tcore.WhatIf(ideal_dispatcher=ideal)
            jw = jcore.WhatIf(ideal_dispatcher=ideal)
            assert tcore.matmul_cycles(n, tc, tw, ew_bits) == \
                jcore.matmul_cycles(n, jc, jw, ew_bits)
            assert tcore.matmul_opc(n, tc, tw, ew_bits) == \
                jcore.matmul_opc(n, jc, jw, ew_bits)


def test_multicore_claim_at_32_cubed():
    """The paper's multi-core claim in the port's model: 8 x 2 lanes beat
    1 x 16 lanes by more than 3x on a 32^3 matmul, at ~23.6 DP-FLOP/cycle."""
    opc = {c.describe(): tcore.matmul_opc(32, c)
           for c in tcore.fixed_fpu_sweep(16)}
    assert opc["8x2L"] / opc["1x16L"] > 3.0
    assert opc["8x2L"] == pytest.approx(23.6, rel=0.05)


@pytest.mark.parametrize("lanes", [2, 4])
@pytest.mark.parametrize("dtype", ["fp", "int"])
def test_dotproduct_speedup_vs_scalar_equals_reference(lanes, dtype):
    je, te = _engines(lanes)
    for n in (16, 128, 1024):
        assert tcore.dotproduct_speedup_vs_scalar(n, te, dtype) == \
            jcore.dotproduct_speedup_vs_scalar(n, je, dtype)
    if lanes == 2:      # §8.1: 1.4x (fp), 2.2x (int) at 128 elements
        want = {"fp": 1.4, "int": 2.2}[dtype]
        assert tcore.dotproduct_speedup_vs_scalar(128, te, dtype) == \
            pytest.approx(want, rel=0.1)


@pytest.mark.parametrize("lanes", LANES)
def test_pool_average_ideality_equals_reference(lanes):
    je, te = _engines(lanes)
    for bpl in (8, 32, 64, 128, 256, 512):
        assert tcore.pool_average_ideality(bpl, te) == \
            jcore.pool_average_ideality(bpl, je)
    assert tcore.pool_average_ideality(128, te) >= 0.50


def test_issue_rate_and_reduction_cycles_equal_reference():
    from repro.core import reduction as jred
    for n in (8, 32, 128):
        for ic in (4, 5):
            assert tcore.issue_rate_limit_opc(n, ic) == \
                jcore.issue_rate_limit_opc(n, ic)
    for r in (1, 1.5, 2, 3, 4, 7.25):
        assert tcore.reduction_drain_cycles(r) == \
            jred.reduction_drain_cycles(r)
    for lanes in (1,) + LANES:
        assert tcore.interlane_reduction_cycles(lanes, 4) == \
            jred.interlane_reduction_cycles(lanes, 4)
        for ew in (64, 32, 16):
            assert tcore.vector_reduction_cycles(1000, lanes, ew, 3) == \
                jred.vector_reduction_cycles(1000, lanes, ew, 3)
    for ew in (64, 32, 16):
        assert tcore.simd_reduction_cycles(ew, 3) == \
            jred.simd_reduction_cycles(ew, 3)


def test_machine_model_equals_reference():
    for lanes in LANES:
        je, te = _engines(lanes)
        for prop in ("vlen_bits", "vlen_bytes", "vrf_bytes",
                     "vrf_bytes_per_lane", "n_fpus",
                     "peak_fma_flops_per_cycle", "mem_bytes_per_cycle"):
            assert getattr(te, prop) == getattr(je, prop)
        assert te.max_elements(4, 2) == je.max_elements(4, 2)
        assert te.bytes_per_lane(1000) == je.bytes_per_lane(1000)
    with pytest.raises(ValueError, match="power of two"):
        tcore.VectorEngineConfig(n_lanes=3)
    assert tcore.log2i(64) == 6 and tcore.round_up(13, 8) == 16
    with pytest.raises(ValueError):
        tcore.log2i(12)


def _reference_bench_rows(monkeypatch):
    """The rows ``benchmarks/bench_ideality.py::run`` emits, its kernel
    timings stubbed out (the model rows are what is compared)."""
    monkeypatch.syspath_prepend(str(ROOT))
    from benchmarks import bench_ideality
    rows = []
    monkeypatch.setattr(bench_ideality, "emit",
                        lambda name, us, derived: rows.append(
                            (name, us, derived)))
    monkeypatch.setattr(bench_ideality, "timeit", lambda fn, *a: 1.0)
    bench_ideality.run()
    return rows


def test_model_rows_equal_bench_ideality(monkeypatch):
    """Every fig5 / fig4 row the entry point builds equals the reference
    bench's, name and digits."""
    want = [r for r in _reference_bench_rows(monkeypatch)
            if r[0].startswith("fig")]
    got = tideality.model_rows()
    assert len(got) == len(want) == 11 * 4 + 4
    assert got == want


def _printed(capsys, argv):
    """Rows printed by ``python -m repro_torch.launch.ideality <argv>``,
    by name."""
    tideality.main(argv)
    lines = capsys.readouterr().out.splitlines()
    return [ln.split(",", 2) for ln in lines]


def test_entry_point_prints_the_reference_rows_on_the_cpu(capsys,
                                                          monkeypatch):
    """``--device cpu`` at the reference's sizes: the fig rows are the
    printed lines of ``bench_ideality.run``, then one timed row per
    reference case through the plain versions, and no kernel launch."""
    want = [f"{n},{us:.1f},{d}" for n, us, d in
            _reference_bench_rows(monkeypatch) if n.startswith("fig")]
    rows = _printed(capsys, ["--device", "cpu"])
    assert [",".join(r) for r in rows[:len(want)]] == want
    timed = rows[len(want):-1]
    assert [r[0] for r in timed] == \
        [f"kernel/{c.name}" for c in tideality.REFERENCE]
    assert all(float(us) > 0 for _, us, _ in timed)
    assert rows[-1] == ["launches", "0.0",
                        "matmul=0|dotproduct=0|softmax=0|fft=0|conv2d=0|"
                        "pathfinder=0|jacobi2d=0|dropout=0"]


def test_entry_point_prints_every_bench_kernel_row_in_order(capsys,
                                                            monkeypatch):
    """``--device cpu`` prints the names of every ``kernel/`` row that
    ``bench_ideality.run`` emits, in its order: matmul, dotproduct,
    softmax, fft, conv2d, pathfinder."""
    want = [n for n, _, _ in _reference_bench_rows(monkeypatch)
            if n.startswith("kernel/")]
    rows = _printed(capsys, ["--device", "cpu"])
    assert [r[0] for r in rows if r[0].startswith("kernel/")] == want == [
        "kernel/matmul_512", "kernel/dotproduct_64k",
        "kernel/softmax_256x1024", "kernel/fft_4096",
        "kernel/conv2d_3x128x128", "kernel/pathfinder_64x4096"]


def test_entry_point_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    """Without ``--device`` it runs on ``cuda`` and, with no GPU, raises
    before any row is printed."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    printed = []
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tideality.run(out=printed.append)
    assert printed == []
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        tideality.main([])


def test_work_counts():
    """The bytes and operations each timed row divides by (each input read
    once, each output written once)."""
    by_name = {c.name: c for c in tideality.REFERENCE + tideality.CARD}
    assert by_name["matmul_4096"].work() == (3 * 4096 ** 2 * 4,
                                             2 * 4096 ** 3)
    assert by_name["matmul_4096_bf16"].work()[0] == 3 * 4096 ** 2 * 2
    assert by_name["dotproduct_64m"].work() == (2 ** 29 + 4, 2 ** 27)
    assert by_name["dotproduct_64m_bf16"].work()[0] == 2 ** 28 + 4
    assert by_name["softmax_16384x4096"].work()[0] == 2 * 16384 * 4096 * 4
    nbytes, flops = by_name["conv2d_3x4096x4096"].work()
    assert nbytes == 4 * (3 * 4096 ** 2 + 147 + 4090 ** 2)
    assert flops == 2 * 147 * 4090 ** 2
    # two planes in (x's dtype), two fp32 planes out; 5 n log2 n
    assert by_name["fft_16m"].work() == (16 * 2 ** 24, 5 * 24 * 2 ** 24)
    assert by_name["fft_16m_bf16"].work()[0] == 12 * 2 ** 24
    assert by_name["pathfinder_1024x256k"].work() == (
        4 * 2 ** 28 + 4 * 2 ** 18, 3 * 1023 * 2 ** 18)
    assert by_name["pathfinder_1024x256k_bf16"].work()[0] == \
        2 * 2 ** 28 + 4 * 2 ** 18
    assert by_name["jacobi2d_16384"].work() == (8 * 2 ** 28,
                                                5 * 16382 ** 2)
    assert by_name["jacobi2d_16384_bf16"].work()[0] == 4 * 2 ** 28
    assert by_name["dropout_64m"].work() == (12 * 2 ** 26, 3 * 2 ** 26)
    assert by_name["dropout_64m_bf16"].work()[0] == 8 * 2 ** 26
    # the card-scale bounds at 3.35 TB/s that ROADMAP and PERF.md quote
    ms = {c.name: c.work()[0] / 3.35e12 * 1e3 for c in tideality.CARD}
    assert [round(ms[n], 3) for n in (
        "fft_16m", "fft_16m_bf16", "pathfinder_1024x256k",
        "pathfinder_1024x256k_bf16", "jacobi2d_16384", "jacobi2d_16384_bf16",
        "dropout_64m", "dropout_64m_bf16")] == [
            0.080, 0.060, 0.321, 0.161, 0.641, 0.321, 0.240, 0.160]


def test_card_ladder_is_the_four_kernels_in_both_dtypes():
    """The card-scale cases: matmul 4096^3, dotproduct 2^26, softmax
    16384 x 4096, fft 2^24, conv2d 3 x 4096 x 4096, pathfinder 1024 x
    2^18, jacobi2d 16384^2 and dropout 2^26 at rate 0.1, each in fp32 and
    bf16 (the pool's eight kernels); the reference ladder is
    bench_ideality's six sizes in fp32, in its order."""
    ops = ("matmul", "dotproduct", "softmax", "fft", "conv2d", "pathfinder",
           "jacobi2d", "dropout")
    assert len(tideality.CARD) == 16 and tuple(tideality.POOL) == ops
    assert {(c.op, c.dtype) for c in tideality.CARD} == {
        (op, dt) for op in ops for dt in (torch.float32, torch.bfloat16)}
    assert [(c.op, c.shapes, c.kw) for c in tideality.CARD[-2:]] == [
        ("dropout", ((1 << 26,), (1 << 26,)), (("rate", 0.1),))] * 2
    assert [(c.op, c.shapes) for c in tideality.REFERENCE] == [
        ("matmul", ((512, 512), (512, 512))),
        ("dotproduct", ((1 << 16,), (1 << 16,))),
        ("softmax", ((256, 1024),)),
        ("fft", ((4096,),)),
        ("conv2d", ((3, 128, 128), (3, 7, 7))),
        ("pathfinder", ((64, 4096),))]
    assert {c.dtype for c in tideality.REFERENCE} == {torch.float32}


def test_case_inputs_follow_the_bench():
    """fft's one seeded vector is both planes (``ops.fft(a, a)``, as the
    bench), pathfinder's costs are |normal|, dropout's bits uint32."""
    by_name = {c.name: c for c in tideality.REFERENCE + tideality.CARD}
    gen = torch.Generator().manual_seed(0)
    a, b = by_name["fft_4096"].inputs(gen, torch.device("cpu"))
    assert a is b and a.shape == (4096,) and a.dtype == torch.float32
    (w,) = by_name["pathfinder_64x4096"].inputs(gen, torch.device("cpu"))
    assert w.shape == (64, 4096) and bool((w >= 0).all())
    small = dataclasses.replace(by_name["dropout_64m_bf16"],
                                shapes=((1000,), (1000,)))
    x, bits = small.inputs(gen, torch.device("cpu"))
    assert x.dtype == torch.bfloat16 and bits.dtype == torch.uint32
    assert int(bits.to(torch.int64).max()) >= 1 << 31    # the upper half too


def test_expected_launches_count_kernels_not_calls():
    """What the entry point adds to the counts on the card: (2 warm-up +
    timed) calls a case, times the kernels its module says one call at its
    shapes launches: two a dotproduct, fft's passes (1 at n = 4096, 4 at
    2^24), pathfinder's launches of 64 rows (1 at 64 rows, 16 at 1024),
    one a jacobi2d sweep, one for the others."""
    assert tideality.expected_launches("reference") == {
        "matmul": 102, "dotproduct": 204, "softmax": 102, "fft": 102,
        "conv2d": 102, "pathfinder": 102, "jacobi2d": 0, "dropout": 0}
    assert tideality.expected_launches("card") == {
        "matmul": 44, "dotproduct": 88, "softmax": 44, "fft": 44 * 4,
        "conv2d": 44, "pathfinder": 44 * 16, "jacobi2d": 44, "dropout": 44}
    assert [tideality.POOL[op].kernels_per_call((8, 8))
            for op in ("matmul", "dotproduct", "softmax", "conv2d",
                       "dropout", "jacobi2d")] == [1, 2, 1, 1, 1, 1]
    assert tideality.POOL["jacobi2d"].kernels_per_call((8, 8),
                                                       steps=3) == 3
