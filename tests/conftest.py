import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Tests run on the single real CPU device; only the dry-run uses fake
# devices (in subprocesses).  Do NOT set xla_force_host_platform_device_count
# here (dry-run contract).
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (skips without one)")
