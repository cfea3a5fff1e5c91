"""Ideality entry point of the port: the paper's Figs 4-5 from the port's
copy of the analytical model, and the pool kernels timed on the card.

  PYTHONPATH=src python -m repro_torch.launch.ideality \
      [--device cuda|cpu] [--sizes reference|card]

The port's counterpart of ``benchmarks/bench_ideality.py::run``.  Every
row is ``name,us_per_call,derived``, the reference's format:

* ``fig5/<kernel>/L<lanes>`` - raw-throughput ideality over the vector
  lengths ``VL_BYTES`` (:mod:`repro_torch.core.perf_model`);
* ``fig4/diag_bpl<b>`` - matmul's ideality at b bytes per lane over
  ``LANES``;
* ``kernel/<case>`` - microseconds per call of ``ops.<op>`` on the device,
  with GFLOP/s or GB/s.  ``--sizes reference`` (the default) times every
  kernel row of the reference, at its sizes and in its order (matmul
  512^3, dotproduct 64 k, softmax 256 x 1024, fft 4096, conv2d
  3 x 128 x 128, pathfinder 64 x 4096; fp32); ``card`` times sizes that
  fill an H100, in fp32 and bf16, jacobi2d, dropout, exp and dwt too (no
  entry point of the reference times those four);
* ``launches`` - the pool kernels' launch counts over the run (on the CPU
  the plain versions run and every count stays 0).

The device is ``cuda`` unless ``--device cpu`` is given; with no GPU it
raises.  On the card every kernel row runs the hand-written kernels
through ``ops``; no plain version runs there.  :func:`run` is the one
timer of the pool kernels: ``chip_smoke.py`` takes their times from its
rows.
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import math
import time

import torch

from .. import resolve_device
from ..core import KERNELS, VectorEngineConfig, ideality
from ..kernels import conv2d as k_conv2d
from ..kernels import dotproduct as k_dot
from ..kernels import dropout as k_dropout
from ..kernels import dwt as k_dwt
from ..kernels import expk as k_exp
from ..kernels import fft as k_fft
from ..kernels import jacobi2d as k_jacobi2d
from ..kernels import matmul as k_matmul
from ..kernels import ops
from ..kernels import pathfinder as k_pathfinder
from ..kernels import softmax as k_softmax

VL_BYTES = (32, 64, 128, 256, 512, 1024, 2048, 4096)
LANES = (2, 4, 8, 16)
# each pool kernel's module, by its op's name (also its key in LAUNCHES)
POOL = {"matmul": k_matmul, "dotproduct": k_dot, "softmax": k_softmax,
        "fft": k_fft, "conv2d": k_conv2d, "pathfinder": k_pathfinder,
        "jacobi2d": k_jacobi2d, "dropout": k_dropout, "exp": k_exp,
        "dwt": k_dwt}
# the function of ``ops`` (and ``<function>_cuda`` / ``_plain`` of the
# module) where it is not the op's name
FUNCTION = {"dwt": "dwt_haar"}
WARMUP = 2


@dataclasses.dataclass(frozen=True)
class Case:
    """One timed row: ``op`` of ``repro_torch.kernels.ops`` on seeded
    inputs of ``shapes`` in ``dtype``, with keyword arguments ``kw``
    ((name, value) pairs)."""
    name: str
    op: str
    shapes: tuple
    dtype: torch.dtype = torch.float32
    kw: tuple = ()

    def inputs(self, gen, device):
        """The op's positional arguments: normal values of each shape, as
        the reference's bench draws them; fft's one vector is both planes
        (``ops.fft(a, a)``), pathfinder's costs are |normal|, exp's are
        4 normal (as ``tests/test_kernels.py:66``), and dropout's second
        operand is uint32 bits."""
        if self.op == "dropout":
            (n,), _ = self.shapes
            x = torch.randn(n, generator=gen, device=device).to(self.dtype)
            bits = torch.randint(0, 1 << 32, (n,), generator=gen,
                                 device=device, dtype=torch.int64)
            return [x, bits.to(torch.uint32)]
        ts = [torch.randn(s, generator=gen, device=device)
              for s in self.shapes]
        if self.op == "pathfinder":
            ts = [t.abs() for t in ts]
        if self.op == "exp":
            ts = [4 * t for t in ts]
        ts = [t.to(self.dtype) for t in ts]
        return ts * 2 if self.op == "fft" else ts

    def kernels_per_call(self) -> int:
        """Kernels of the port that one call launches on the card."""
        return POOL[self.op].kernels_per_call(*self.shapes, **dict(self.kw))

    def work(self) -> tuple[int, int]:
        """(bytes, operations) of one call: each input read once, the
        output written once."""
        b = torch.tensor([], dtype=self.dtype).element_size()
        if self.op == "fft":         # two planes in, two fp32 planes out
            n = self.shapes[0][0]
            return 2 * b * n + 8 * n, 5 * n * int(math.log2(n))
        if self.op == "pathfinder":  # an add and two mins a cell
            rows, cols = self.shapes[0]
            return b * rows * cols + 4 * cols, 3 * (rows - 1) * cols
        if self.op == "jacobi2d":    # four adds and a multiply a point
            h, w = self.shapes[0]
            steps = dict(self.kw).get("steps", 1)
            return 2 * b * h * w, 5 * steps * max(h - 2, 0) * max(w - 2, 0)
        if self.op == "dropout":     # x and uint32 bits in, x's dtype out
            n = self.shapes[0][0]
            return 2 * b * n + 4 * n, 3 * n
        if self.op == "exp":         # a multiply, 7 FMAs, a multiply
            n = self.shapes[0][0]
            return 2 * b * n, 16 * n
        if self.op == "dwt":         # an add, a subtract, 2 multiplies a pair
            n = self.shapes[0][0]
            levels = dict(self.kw).get("levels", 1)
            return 2 * b * n, sum(2 * n >> (l - 1)
                                  for l in range(1, levels + 1))
        if self.op == "matmul":
            (m, k), (_, n) = self.shapes
            return b * (m * k + k * n + m * n), 2 * m * n * k
        if self.op == "dotproduct":
            n = self.shapes[0][0]
            return 2 * b * n + 4, 2 * n
        if self.op == "softmax":
            r, c = self.shapes[0]
            return 2 * b * r * c, 5 * r * c    # max, sub, exp, add, divide
        (c, h, w), (_, k, _) = self.shapes
        ho, wo = h - k + 1, w - k + 1
        return b * (c * h * w + c * k * k + ho * wo), 2 * c * k * k * ho * wo


def _both(case: Case):
    """``case`` in fp32 and in bf16."""
    return case, dataclasses.replace(case, name=f"{case.name}_bf16",
                                     dtype=torch.bfloat16)


# every kernel row of the reference's bench, at its sizes and in its order
# (bench_ideality.py:31-50), fp32 as there
REFERENCE = (
    Case("matmul_512", "matmul", ((512, 512), (512, 512))),
    Case("dotproduct_64k", "dotproduct", ((1 << 16,), (1 << 16,))),
    Case("softmax_256x1024", "softmax", ((256, 1024),)),
    Case("fft_4096", "fft", ((4096,),)),
    Case("conv2d_3x128x128", "conv2d", ((3, 128, 128), (3, 7, 7))),
    Case("pathfinder_64x4096", "pathfinder", ((64, 4096),)),
)
# sizes at which each call does real work on an H100 (137 GFLOP, or
# 0.2-2.1 GB moved), each in fp32 and bf16
CARD = (
    *_both(Case("matmul_4096", "matmul", ((4096, 4096), (4096, 4096)))),
    *_both(Case("dotproduct_64m", "dotproduct", ((1 << 26,), (1 << 26,)))),
    *_both(Case("softmax_16384x4096", "softmax", ((16384, 4096),))),
    *_both(Case("fft_16m", "fft", ((1 << 24,),))),
    *_both(Case("conv2d_3x4096x4096", "conv2d",
                ((3, 4096, 4096), (3, 7, 7)))),
    *_both(Case("pathfinder_1024x256k", "pathfinder", ((1024, 1 << 18),))),
    *_both(Case("jacobi2d_16384", "jacobi2d", ((16384, 16384),))),
    *_both(Case("dropout_64m", "dropout", ((1 << 26,), (1 << 26,)),
                kw=(("rate", 0.1),))),
    *_both(Case("exp_64m", "exp", ((1 << 26,),))),
    # three levels, the reference test's deepest (tests/test_kernels.py:107)
    *_both(Case("dwt_64m", "dwt", ((1 << 26,),), kw=(("levels", 3),))),
)
# --sizes: (cases, timed calls of each after WARMUP calls)
SIZES = {"reference": (REFERENCE, 100), "card": (CARD, 20)}


def model_rows():
    """The Fig 5 heatmap and the Fig 4 diagonals, as the reference prints
    them."""
    rows = []
    for kern in KERNELS:
        for lanes in LANES:
            eng = VectorEngineConfig(n_lanes=lanes)
            vals = [f"{ideality(kern, vb, eng):.3f}" for vb in VL_BYTES]
            rows.append((f"fig5/{kern}/L{lanes}", 0.0, "|".join(vals)))
    for bpl in (32, 64, 128, 256):
        vals = [f"{ideality('matmul', bpl * n, VectorEngineConfig(n_lanes=n)):.3f}"
                for n in LANES]
        rows.append((f"fig4/diag_bpl{bpl}", 0.0, "|".join(vals)))
    return rows


def time_us(fn, args, device, iters: int) -> float:
    """Microseconds per call over ``iters`` calls after ``WARMUP`` calls:
    CUDA events on the card, the host clock on the CPU."""
    for _ in range(WARMUP):
        fn(*args)
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / iters * 1e3


def kernel_row(case: Case, device, gen, iters: int):
    args = case.inputs(gen, device)
    fn = functools.partial(getattr(ops, function(case.op)),
                           **dict(case.kw))
    us = time_us(fn, args, device, iters)
    nbytes, flops = case.work()
    rate = (f"gflops={flops / us / 1e3:.2f}"
            if case.op in ("matmul", "conv2d")
            else f"gbps={nbytes / us / 1e3:.2f}")
    return f"kernel/{case.name}", us, rate


def run(device=None, sizes="reference", out=print):
    """The model rows, then one timed row per case of ``SIZES[sizes]``,
    each printed through ``out`` as it comes; returns the rows."""
    dev = resolve_device(device)
    cases, iters = SIZES[sizes]
    rows = model_rows()
    for row in rows:
        out(fmt(*row))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for case in cases:
        rows.append(kernel_row(case, dev, gen, iters))
        out(fmt(*rows[-1]))
    return rows


def function(op: str) -> str:
    """The name of ``op``'s function in ``ops`` and in its module."""
    return FUNCTION.get(op, op)


def launches() -> dict[str, int]:
    return {k: n for mod in POOL.values() for k, n in mod.LAUNCHES.items()}


def expected_launches(sizes="reference") -> dict[str, int]:
    """What :func:`run` at ``sizes`` adds to :func:`launches` on the card:
    each case's calls, warm-up included, times the kernels its module says
    one call at its shapes launches."""
    cases, iters = SIZES[sizes]
    want = dict.fromkeys(POOL, 0)
    for case in cases:
        want[case.op] += (WARMUP + iters) * case.kernels_per_call()
    return want


def fmt(name, us, derived) -> str:
    """The reference's row; a kernel's time to the nanosecond."""
    us = f"{us:.3f}" if name.startswith("kernel/") else f"{us:.1f}"
    return f"{name},{us},{derived}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda; cpu runs the plain "
                         "PyTorch versions)")
    ap.add_argument("--sizes", choices=tuple(SIZES), default="reference",
                    help="the kernel rows' sizes (default: the reference's)")
    args = ap.parse_args(argv)
    for mod in POOL.values():
        mod.reset_launches()
    run(args.device, args.sizes)
    print(fmt("launches", 0.0,
              "|".join(f"{k}={n}" for k, n in launches().items())))


if __name__ == "__main__":
    main()
