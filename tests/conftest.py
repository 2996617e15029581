import os
import sys

# smoke tests and benches see exactly ONE device (the dry-run sets its own
# XLA_FLAGS in subprocesses; never here)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips without one")
