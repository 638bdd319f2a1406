import os
import sys

# Keep smoke tests on 1 device (the dry-run, and ONLY the dry-run, forces 512).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture(autouse=True)
def _reset_kernel_state():
    """Re-arm the one-shot interpret-on-TPU warning and restore default
    tiles between tests: a test that forces interpret mode or installs
    tuned tiles must not leak that state into every later test."""
    yield
    from repro.kernels.autotune import reset_tiles
    from repro.kernels.backend import reset_backend_warnings
    reset_backend_warnings()
    reset_tiles()

try:  # the image may lack hypothesis; fall back to the deterministic stub
    import hypothesis  # noqa: F401
except ImportError:
    sys.path.insert(0, os.path.dirname(__file__))
    import _hypothesis_stub

    sys.modules["hypothesis"] = _hypothesis_stub
    sys.modules["hypothesis.strategies"] = _hypothesis_stub
    _hypothesis_stub.strategies = _hypothesis_stub


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's kernels); skipped "
        "without one")
