"""The port stands alone: a fresh interpreter imports every module of
``repro_torch`` and ``chip_smoke`` (as a module: its run sits under
``__main__``) with no JAX, no ``ml_dtypes`` and nothing of the reference
package loaded, and builds nothing."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
from repro_torch.kernels import build
before = sorted(build.BUILD_DIR.glob("*")) if build.BUILD_DIR.exists() else []
mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch.")]
for name in mods:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro"))
print("MODULES", len(mods))
print("BAD", bad)
after = sorted(build.BUILD_DIR.glob("*")) if build.BUILD_DIR.exists() else []
print("BUILT", after != before)
"""


def test_port_imports_no_jax_and_nothing_of_the_reference(tmp_path):
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    lines = dict(line.split(" ", 1) for line in out.stdout.splitlines())
    assert int(lines["MODULES"]) >= 15
    assert lines["BAD"] == "[]"
    assert lines["BUILT"] == "False"


def test_chip_smoke_refuses_without_a_gpu(tmp_path):
    """With no CUDA device visible it exits non-zero and prints no result
    line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
