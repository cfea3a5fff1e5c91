"""The port's copy of the analytical models and layout helpers
(``repro_torch.core``) held equal to the reference's (``repro.core``), the
ideality entry point (``repro_torch.launch.ideality``) against
``benchmarks/bench_ideality.py``, and the paper-model entry point
(``repro_torch.launch.paper_models``) against ``bench_slide.py``,
``bench_multicore.py``, ``bench_whatif.py`` and ``bench_ppa.py``.

Both packages compute the same closed forms in Python floats, so every
comparison is exact (``==``): the port prints the paper's Fig 4/5 rows to
the last digit of the reference."""
import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro.core import lanes as jlanes
from repro.core import ppa as jppa
from repro_torch import core as tcore
from repro_torch.core import lanes as tlanes
from repro_torch.core import ppa as tppa
from repro_torch.launch import ideality as tideality
from repro_torch.launch import paper_models

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
                        "pathfinder=0|jacobi2d=0|dropout=0|exp=0|dwt=0"]


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
    # one read and one write; 16 operations an element (a multiply, 7
    # FMAs, a multiply) and, for dwt, 2 m at each level of input m
    assert by_name["exp_64m"].work() == (8 * 2 ** 26, 16 * 2 ** 26)
    assert by_name["exp_64m_bf16"].work()[0] == 4 * 2 ** 26
    assert by_name["dwt_64m"].work() == (8 * 2 ** 26,
                                         2 * (2 ** 26 + 2 ** 25 + 2 ** 24))
    assert by_name["dwt_64m_bf16"].work()[0] == 4 * 2 ** 26
    # the card-scale bounds at 3.35 TB/s that ROADMAP and PERF.md quote
    ms = {c.name: c.work()[0] / 3.35e12 * 1e3 for c in tideality.CARD}
    assert [round(ms[n], 3) for n in (
        "fft_16m", "fft_16m_bf16", "pathfinder_1024x256k",
        "pathfinder_1024x256k_bf16", "jacobi2d_16384", "jacobi2d_16384_bf16",
        "dropout_64m", "dropout_64m_bf16", "exp_64m", "exp_64m_bf16",
        "dwt_64m", "dwt_64m_bf16")] == [
            0.080, 0.060, 0.321, 0.161, 0.641, 0.321, 0.240, 0.160, 0.160,
            0.080, 0.160, 0.080]


def test_card_ladder_is_the_four_kernels_in_both_dtypes():
    """The card-scale cases: matmul 4096^3, dotproduct 2^26, softmax
    16384 x 4096, fft 2^24, conv2d 3 x 4096 x 4096, pathfinder 1024 x
    2^18, jacobi2d 16384^2, dropout 2^26 at rate 0.1, exp 2^26 and dwt
    2^26 at 3 levels, each in fp32 and bf16 (the pool's ten kernels); the
    reference ladder is bench_ideality's six sizes in fp32, in its
    order."""
    ops = ("matmul", "dotproduct", "softmax", "fft", "conv2d", "pathfinder",
           "jacobi2d", "dropout", "exp", "dwt")
    assert len(tideality.CARD) == 20 and tuple(tideality.POOL) == ops
    assert {(c.op, c.dtype) for c in tideality.CARD} == {
        (op, dt) for op in ops for dt in (torch.float32, torch.bfloat16)}
    assert [(c.op, c.shapes, c.kw) for c in tideality.CARD[-6:]] == [
        ("dropout", ((1 << 26,), (1 << 26,)), (("rate", 0.1),))] * 2 + [
        ("exp", ((1 << 26,),), ())] * 2 + [
        ("dwt", ((1 << 26,),), (("levels", 3),))] * 2
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
    # exp's x is 4 normal, as tests/test_kernels.py:66 draws it
    small = dataclasses.replace(by_name["exp_64m"], shapes=((100_000,),))
    (x,) = small.inputs(torch.Generator().manual_seed(0), torch.device("cpu"))
    assert 3.9 < float(x.std()) < 4.1


def test_expected_launches_count_kernels_not_calls():
    """What the entry point adds to the counts on the card: (2 warm-up +
    timed) calls a case, times the kernels its module says one call at its
    shapes launches: two a dotproduct, fft's passes (1 at n = 4096, 4 at
    2^24), pathfinder's launches of 64 rows (1 at 64 rows, 16 at 1024),
    one a jacobi2d sweep, one for the others."""
    assert tideality.expected_launches("reference") == {
        "matmul": 102, "dotproduct": 204, "softmax": 102, "fft": 102,
        "conv2d": 102, "pathfinder": 102, "jacobi2d": 0, "dropout": 0,
        "exp": 0, "dwt": 0}
    assert tideality.expected_launches("card") == {
        "matmul": 44, "dotproduct": 88, "softmax": 44, "fft": 44 * 4,
        "conv2d": 44, "pathfinder": 44 * 16, "jacobi2d": 44, "dropout": 44,
        "exp": 44, "dwt": 44}
    assert [tideality.POOL[op].kernels_per_call((8, 8))
            for op in ("matmul", "dotproduct", "softmax", "conv2d",
                       "dropout", "jacobi2d")] == [1, 2, 1, 1, 1, 1]
    assert tideality.POOL["jacobi2d"].kernels_per_call((8, 8),
                                                       steps=3) == 3


# ---------------------------------------------------------------------------
# ppa, slide and lanes: the rest of core.
# ---------------------------------------------------------------------------

ALL_LANES = (2, 4, 8, 16, "16*")
MULTICORE_SIZES = (8, 16, 32, 64, 128, 256)      # bench_multicore.py:13


def test_ppa_tables_equal_reference():
    for name in ("TT_FREQ_GHZ", "SS_FREQ_GHZ", "DIE_AREA_MM2",
                 "CELL_MACRO_AREA_KGE", "ENERGY_EFF_TABLE3", "TABLE4",
                 "AREA_KGE", "CLUSTER_POWER_W"):
        assert getattr(tppa, name) == getattr(jppa, name), name
    assert not hasattr(tppa, "TpuSpec") and not hasattr(tppa, "TPU_V5E")


@pytest.mark.parametrize("lanes", ALL_LANES, ids=str)
def test_ppa_area_and_power_equal_reference(lanes):
    """Table 5's system areas (which both refuse for '16*', whose lane
    count is not a number), the SLDU saving and the cluster power."""
    for sldu in ("new_sldu", "old_sldu"):
        if lanes == "16*":
            for ppa in (tppa, jppa):
                with pytest.raises(TypeError):
                    ppa.system_area_kge(lanes, sldu)
            continue
        assert tppa.system_area_kge(lanes, sldu) == \
            jppa.system_area_kge(lanes, sldu)
    assert tppa.sldu_area_saving(lanes) == jppa.sldu_area_saving(lanes)
    for activity in (0.6, 1.0, 1.3):
        assert tppa.cluster_power_w(lanes, activity) == \
            jppa.cluster_power_w(lanes, activity)


@pytest.mark.parametrize("fpus", [2, 4, 8, 16])
@pytest.mark.parametrize("whatif", [{}, {"ideal_dispatcher": True}],
                         ids=lambda w: "|".join(w) or "base")
def test_throughput_and_efficiency_equal_reference(fpus, whatif):
    """Figs 14/15/17/18 at every (cores x lanes) split of a FPU budget, at
    the multicore bench's sizes."""
    for tc, jc in zip(tcore.fixed_fpu_sweep(fpus),
                      jcore.fixed_fpu_sweep(fpus)):
        assert tppa.system_power_w(tc) == jppa.system_power_w(jc)
        tw, jw = tcore.WhatIf(**whatif), jcore.WhatIf(**whatif)
        for n in MULTICORE_SIZES:
            assert tcore.real_throughput_gflops(n, tc, tw) == \
                jcore.real_throughput_gflops(n, jc, jw)
            assert tcore.energy_efficiency_gflops_w(n, tc, tw, 0.8) == \
                jcore.energy_efficiency_gflops_w(n, jc, jw, 0.8)


@pytest.mark.parametrize("lanes", LANES)
def test_slide_cost_model_equals_reference(lanes):
    """Fig 3: the mux counts of the four interconnects and the saving."""
    for mode in ("all_to_all", "slideP2_tmux", "slideP2", "slide1"):
        assert tcore.mux_count(lanes, mode) == jcore.mux_count(lanes, mode)
    assert tcore.sldu_saving(lanes) == jcore.sldu_saving(lanes)


def test_decompose_pow2_equals_reference():
    for amount in range(-300, 301):
        assert tcore.decompose_pow2(amount) == jcore.decompose_pow2(amount)


@pytest.mark.parametrize("n", [1, 5, 16, 33])
def test_slide_and_rotate_equal_reference(n):
    """vslideup / vslidedown by any amount (zero or another fill, along
    either axis of a 2-D array) and rotations, by their power-of-two
    micro-ops."""
    x = np.arange(1, 3 * n + 1, dtype=np.float32).reshape(3, n)
    jx, tx = jnp.asarray(x), torch.from_numpy(x)
    for amount in range(-n - 2, n + 3):
        for axis, fill in ((1, 0), (1, -7.0), (0, 0)):
            np.testing.assert_array_equal(
                tcore.slide(tx, amount, axis, fill).numpy(),
                np.asarray(jcore.slide(jx, amount, axis, fill)))
        np.testing.assert_array_equal(tcore.rotate(tx, amount, 1).numpy(),
                                      np.asarray(jcore.rotate(jx, amount, 1)))


@pytest.mark.parametrize("lanes", LANES)
def test_stripe_and_reductions_equal_reference(lanes):
    """The lane layout (element i at [i % L, i // L]) and the 3-step
    reduction on it, on integers so both sums are exact."""
    for n in (1, 7, 16, 100):
        x = np.arange(n, dtype=np.int32) * 3 - 50
        got = tlanes.stripe(torch.from_numpy(x), lanes, fill=-1)
        want = jlanes.stripe(jnp.asarray(x), lanes, fill=-1)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(tlanes.unstripe(got, n).numpy(), x)
        assert int(tcore.hierarchical_reduce(torch.from_numpy(x), lanes)) \
            == int(jcore.hierarchical_reduce(jnp.asarray(x), lanes)) \
            == int(x.sum())
        y = np.arange(2 * n, dtype=np.int32).reshape(2, n)
        np.testing.assert_array_equal(
            tcore.simd_tree_reduce(torch.from_numpy(y), axis=1).numpy(),
            np.asarray(jcore.simd_tree_reduce(jnp.asarray(y), axis=1)))


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.uint16])
@pytest.mark.parametrize("lanes", [2, 4, 8])
def test_byte_image_roundtrip_equals_reference(dtype, lanes):
    """The VRF byte image equals the reference's and reads back
    (tests/test_core.py:79)."""
    x = np.arange(16).astype(dtype)
    img = tlanes.stripe_bytes(x, lanes)
    np.testing.assert_array_equal(img, jlanes.stripe_bytes(x, lanes))
    np.testing.assert_array_equal(tlanes.unstripe_bytes(img, dtype, 16), x)


def test_reshuffle_preserves_byte_stream():
    """EW64 -> EW32 re-encode keeps the logical byte stream
    (tests/test_core.py:88), as the reference's reshuffle does."""
    x = np.arange(8).astype(np.float64)
    img = tlanes.stripe_bytes(x, 4)
    img32 = tlanes.reshuffle(img, np.float64, np.float32, 8)
    np.testing.assert_array_equal(
        img32, jlanes.reshuffle(img, np.float64, np.float32, 8))
    back = tlanes.unstripe_bytes(img32, np.float32, 16)
    np.testing.assert_array_equal(back.view(np.float64), x)
    img8 = tlanes.reshuffle(tlanes.stripe_bytes(x.view(np.uint8), 4),
                            np.uint8, np.float64, 64)
    np.testing.assert_array_equal(tlanes.unstripe_bytes(img8, np.float64, 8),
                                  x)


def test_core_exports_the_reference_names():
    """Every name the reference's core exports, but its mesh collectives
    and TPU constants."""
    left_out = {"mesh_slide", "mesh_halo_exchange", "allreduce_hd",
                "allreduce_rs_ag", "reduce_scatter_hd", "allgather_hd",
                "TpuSpec", "TPU_V5E"}
    public = {n for n in dir(jcore) if not n.startswith("_")
              and not isinstance(getattr(jcore, n), type(jcore))}
    missing = {n for n in public - left_out if not hasattr(tcore, n)}
    assert missing == set()
    assert not any(hasattr(tcore, n) for n in left_out)


# ---------------------------------------------------------------------------
# The paper-model entry point.
# ---------------------------------------------------------------------------

PAPER_BENCHES = {"slide": "bench_slide", "multicore": "bench_multicore",
                 "whatif": "bench_whatif", "ppa": "bench_ppa"}


def _bench_rows(monkeypatch, module):
    """The rows ``benchmarks/<module>.py::run`` emits, as printed."""
    monkeypatch.syspath_prepend(str(ROOT))
    import importlib
    bench = importlib.import_module(f"benchmarks.{module}")
    rows = []
    monkeypatch.setattr(bench, "emit", lambda name, us, derived: rows.append(
        f"{name},{us:.1f},{derived}"))
    bench.run()
    return rows


@pytest.mark.parametrize("bench", list(PAPER_BENCHES))
def test_paper_model_rows_equal_the_bench(monkeypatch, bench):
    """Every row of each bench, name and digits, in its order."""
    want = _bench_rows(monkeypatch, PAPER_BENCHES[bench])
    got = []
    rows = paper_models.run(bench, out=got.append)
    assert got == want and len(rows) == len(want) > 10


def test_paper_models_entry_point_prints_every_bench(monkeypatch, capsys):
    """``--bench all`` (the default) prints the four benches in the order
    of benchmarks/run.py, with no device."""
    want = [r for b in PAPER_BENCHES.values()
            for r in _bench_rows(monkeypatch, b)]
    paper_models.main([])
    assert capsys.readouterr().out.splitlines() == want
    paper_models.main(["--bench", "ppa"])
    assert capsys.readouterr().out.splitlines() == \
        _bench_rows(monkeypatch, "bench_ppa")
