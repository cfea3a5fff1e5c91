"""The paper's analytical results from the port's copy of the models: the
slide-unit cost (Fig 3, Table 5), the single- vs multi-core trade-off (Figs
13-18), the what-if attributions (Figs 6-10) and the PPA tables (Tables
3-4).

  PYTHONPATH=src python -m repro_torch.launch.paper_models \
      [--bench slide|multicore|whatif|ppa|all]

The port's counterpart of ``benchmarks/bench_slide.py``,
``bench_multicore.py``, ``bench_whatif.py`` and ``bench_ppa.py``: each
bench's rows in its order, in the reference's ``name,us_per_call,derived``
format (``us_per_call`` is 0.0: these are closed forms, nothing is timed).
``all`` prints the four in the order of ``benchmarks/run.py``.  Pure
Python (:mod:`repro_torch.core`): it needs no device and runs no kernel.
"""
from __future__ import annotations

import argparse

from ..core import (VectorEngineConfig, WhatIf, energy_efficiency_gflops_w,
                    fixed_fpu_sweep, ideality, issue_rate_limit_opc,
                    matmul_opc, mux_count, real_throughput_gflops,
                    sldu_saving)
from ..core import ppa

LANES = (2, 4, 8, 16)
MULTICORE_SIZES = (8, 16, 32, 64, 128, 256)     # bench_multicore.py:13
E16 = VectorEngineConfig(n_lanes=16)
E2 = VectorEngineConfig(n_lanes=2)


def slide_rows():
    """Fig 3's mux counts and Table 5's SLDU and system areas
    (bench_slide.py)."""
    rows = []
    for lanes in LANES:
        a2a = mux_count(lanes, "all_to_all")
        p2 = mux_count(lanes, "slideP2_tmux")
        s1 = mux_count(lanes, "slide1")
        rows.append((f"fig3/muxes_L{lanes}", 0.0,
                     f"a2a={a2a}|slideP2={p2}|slide1={s1}|"
                     f"saving={sldu_saving(lanes):.2%}"))
    for lanes in LANES:
        rows.append((f"table5/sldu_L{lanes}", 0.0,
                     f"old={ppa.AREA_KGE['old_sldu'][lanes]}kGE|"
                     f"new={ppa.AREA_KGE['new_sldu'][lanes]}kGE|"
                     f"saving={ppa.sldu_area_saving(lanes):.2%}"))
    for lanes in LANES:
        rows.append((f"table5/system_L{lanes}", 0.0,
                     f"new_sldu={ppa.system_area_kge(lanes, 'new_sldu'):.0f}kGE|"
                     f"old_sldu={ppa.system_area_kge(lanes, 'old_sldu'):.0f}kGE"))
    return rows


def multicore_rows():
    """Figs 13-18 at fixed FPU budgets (bench_multicore.py)."""
    rows = []
    sweep = fixed_fpu_sweep(16)
    for c in sweep:                        # Fig 13: raw throughput, 16 FPUs
        rows.append((f"fig13/raw_opc/{c.describe()}", 0.0,
                     "|".join(f"{matmul_opc(n, c):.1f}"
                              for n in MULTICORE_SIZES)))
    rows.append(("fig13/issue_limit", 0.0,
                 "|".join(f"{issue_rate_limit_opc(n):.1f}"
                          for n in MULTICORE_SIZES)))
    for c in sweep:                        # Fig 16: the ideal dispatcher
        base = matmul_opc(32, c)
        ideal = matmul_opc(32, c, WhatIf(ideal_dispatcher=True))
        rows.append((f"fig16/{c.describe()}", 0.0,
                     f"base={base:.1f}|ideal_dispatch={ideal:.1f}"))
    for c in sweep:                        # Figs 14/15
        rows.append((f"fig14/gflops/{c.describe()}", 0.0,
                     "|".join(f"{real_throughput_gflops(n, c):.1f}"
                              for n in MULTICORE_SIZES)))
        rows.append((f"fig15/gflops_w/{c.describe()}", 0.0,
                     "|".join(f"{energy_efficiency_gflops_w(n, c):.1f}"
                              for n in MULTICORE_SIZES)))
    for fpus in (2, 4, 8, 16):             # Figs 17/18
        for c in fixed_fpu_sweep(fpus):
            rows.append((f"fig17/{fpus}fpu/{c.describe()}", 0.0,
                         f"gflops@256={real_throughput_gflops(256, c):.1f}|"
                         f"eff@256={energy_efficiency_gflops_w(256, c):.1f}"))
    return rows


def whatif_rows():
    """Figs 8-10: the ideal dispatcher, the ideal cache, the streamlined
    vector unit and the Barber's Pole layout (bench_whatif.py)."""
    rows = []
    for nbytes in (512, 1024, 2048, 8192):
        base = ideality("matmul", nbytes, E16)
        idd = ideality("matmul", nbytes, E16, WhatIf(ideal_dispatcher=True))
        idc = ideality("matmul", nbytes, E16, WhatIf(ideal_cache=True))
        stream = ideality("matmul", nbytes, E16,
                          WhatIf(ideal_dispatcher=True, streamlined=True))
        rows.append((f"fig9/16L_{nbytes}B", 0.0,
                     f"base={base:.3f}|ideal_disp={idd:.3f}|"
                     f"ideal_cache={idc:.3f}|streamlined={stream:.3f}"))
        # Fig 10 decomposition: inefficiency attribution
        rows.append((f"fig10/16L_{nbytes}B", 0.0,
                     f"ara2={max(0., stream - base):.3f}|"
                     f"cache={max(0., idc - base):.3f}|"
                     f"cva6={max(0., idd - idc):.3f}"))
    for nbytes in (64, 128, 256, 512, 2048):
        bp = ideality("matmul", nbytes, E2, WhatIf(barber_pole=True))
        nobp = ideality("matmul", nbytes, E2)
        rows.append((f"fig8/2L_{nbytes}B", 0.0,
                     f"barber={bp:.3f}|plain={nobp:.3f}"))
    return rows


def ppa_rows():
    """Tables 3 and 4 (bench_ppa.py)."""
    rows = []
    for lanes in (*LANES, "16*"):
        eff = ppa.ENERGY_EFF_TABLE3.get(lanes, float("nan"))
        rows.append((f"table3/L{lanes}", 0.0,
                     f"tt_ghz={ppa.TT_FREQ_GHZ[lanes]}|"
                     f"die_mm2={ppa.DIE_AREA_MM2[lanes]}|"
                     f"kge={ppa.CELL_MACRO_AREA_KGE[lanes]}|eff={eff}"))
    for prog, (elems, mw, gops, gopsw) in ppa.TABLE4.items():
        rows.append((f"table4/{prog}", 0.0,
                     f"elems={elems}|mw={mw}|gops={gops}|gops_w={gopsw}"))
    return rows


# the order of benchmarks/run.py
BENCHES = {"slide": slide_rows, "multicore": multicore_rows,
           "whatif": whatif_rows, "ppa": ppa_rows}


def fmt(name, us, derived) -> str:
    """The reference's row (``benchmarks/common.emit``)."""
    return f"{name},{us:.1f},{derived}"


def run(bench="all", out=print):
    """The rows of ``bench`` (or of every bench), each printed through
    ``out``; returns them."""
    rows = []
    for name, fn in BENCHES.items():
        if bench in ("all", name):
            rows += fn()
    for row in rows:
        out(fmt(*row))
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench", choices=(*BENCHES, "all"), default="all",
                    help="which bench's rows (default: all four)")
    run(ap.parse_args(argv).bench)


if __name__ == "__main__":
    main()
