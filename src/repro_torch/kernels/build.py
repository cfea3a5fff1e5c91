"""Build the port's CUDA kernels with ``nvcc`` on first use; load with ctypes.

The sources under ``csrc/`` have a plain C interface (no PyTorch headers),
so one ``nvcc`` call per source takes seconds.  Each source compiles into
its own shared library under ``build/repro_torch/`` at the repository root
(listed in ``.gitignore``), named by a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header never
loads a stale library.  ``nvcc``'s ``-Xptxas -v``
report (registers, shared memory, spills per kernel) is kept beside each
library and returned by :func:`ptxas_report`.

Nothing here runs at import (the CPU tests import every module): ``nvcc``
runs only when a kernel is first launched on a CUDA tensor, or when
:func:`build_all` is called.  A failed build raises; there is no fallback
to the plain versions.

Threads may launch kernels at once (the serving cluster's threaded driver
runs a replica a thread, each on its own stream): :func:`library` builds
and loads a source once under that source's lock, and :func:`count` is the
one place a kernel module's launch counts move, under one lock.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO = pathlib.Path(__file__).resolve().parents[3]
BUILD_DIR = REPO / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signature of every entry point, per source
SIGNATURES = {
    "flash_attention.cu": {
        "repro_flash_attention":
            (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
        "repro_flash_attention_mma":
            (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    },
    "ssd_scan.cu": {
        "repro_ssd_scan_simt":
            (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
             _P),
        "repro_ssd_scan_mma":
            (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             _I, _P),
    },
    "matmul.cu": {
        "repro_matmul": (_I, _I, _P, _P, _P, _I, _I, _I, _P),
        "repro_matmul_wgmma": (_I, _I, _P, _P, _P, _I, _I, _I, _P),
    },
    "dotproduct.cu": {"repro_dotproduct": (_I, _P, _P, _P, _P, _L, _I, _P)},
    "softmax.cu": {"repro_softmax": (_I, _P, _P, _L, _I, _P)},
    "conv2d.cu": {"repro_conv2d":
                  (_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P)},
    "fft.cu": {
        "repro_fft_pass": (_I, _I, _P, _P, _P, _P, _L, _I, _P),
        "repro_fft_local": (_I, _P, _P, _P, _P, _I, _P),
    },
    "pathfinder.cu": {
        "repro_pathfinder": (_I, _P, _P, _P, _I, _I, _I, _P),
    },
    "jacobi2d.cu": {"repro_jacobi2d": (_I, _P, _P, _P, _I, _I, _I, _P)},
    "dropout.cu": {"repro_dropout": (_I, _P, _P, _P, _L, _F, _F, _P)},
    "expk.cu": {"repro_exp": (_I, _P, _P, _L, _P)},
    "dwt.cu": {"repro_dwt_haar": (_I, _P, _L, _I, _P, _P, _P)},
    "paged_attention.cu": {
        "repro_paged_attention_simt":
            (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
        "repro_paged_attention_mma":
            (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
             _I, _I, _F, _P),
    },
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in /usr/local/cuda/bin): "
            "the port's CUDA kernels are built from source at first use")
    return path


def _target(source: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{pathlib.Path(source).stem}-{h.hexdigest()[:16]}.so"


def _compile(source: str) -> pathlib.Path:
    """Compile one source unless its hashed library already exists."""
    out = _target(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} (exit "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    out.with_suffix(".ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)      # atomic: a concurrent loader sees all or none
    return out


def build_all() -> dict[str, pathlib.Path]:
    """Compile every source, one ``nvcc`` process each, all at once."""
    with concurrent.futures.ThreadPoolExecutor(len(SIGNATURES)) as ex:
        futs = {s: ex.submit(_compile, s) for s in SIGNATURES}
        return {s: f.result() for s, f in futs.items()}


_LIBS: dict[str, ctypes.CDLL] = {}
# one lock a source, so two threads never run nvcc on one target
_BUILD_LOCKS = {source: threading.Lock() for source in SIGNATURES}
_COUNT_LOCK = threading.Lock()


def library(source: str) -> ctypes.CDLL:
    """The loaded library of one source, its entry points typed; the first
    call builds it, under the source's lock."""
    lib = _LIBS.get(source)
    if lib is not None:
        return lib
    with _BUILD_LOCKS[source]:
        if source in _LIBS:
            return _LIBS[source]
        lib = ctypes.CDLL(str(_compile(source)))
        for name, argtypes in SIGNATURES[source].items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _LIBS[source] = lib
        return lib


def count(launches: dict, name: str, n: int = 1, routes: dict | None = None,
          kind: str | None = None) -> None:
    """Add ``n`` launches of kernel ``name`` to ``launches`` and to
    ``routes[kind]``, under one lock: the counts are exact when threads
    launch at once."""
    with _COUNT_LOCK:
        launches[name] += n
        if routes is not None:
            routes[kind] += n


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def check_operands(what: str, dtypes, **named) -> None:
    """Raise unless every named tensor lies on the first one's CUDA device,
    is contiguous and has one of ``dtypes`` (the pool kernels' common
    input checks; shapes are each wrapper's own)."""
    first = next(iter(named.values()))
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{what}: {name} on {t.device}, expected one "
                             f"CUDA device ({first.device})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.dtype not in dtypes or t.dtype != first.dtype:
            raise TypeError(f"{what}: {name} is {t.dtype}; the kernel takes "
                            f"{' or '.join(map(str, dtypes))}, every operand "
                            "the same")


def ptxas_report(source: str) -> str:
    """``-Xptxas -v`` lines of a built source (build it first)."""
    return _target(source).with_suffix(".ptxas.txt").read_text()
