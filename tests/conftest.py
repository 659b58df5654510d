"""Shared fixtures. NOTE: device count stays 1 here by design — multi-device
behaviour is tested via subprocesses (tests/helpers.py) so the dry-run's 512
fake devices never leak into smoke tests."""
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

# Kernel tests run in interpret mode on CPU.
os.environ.setdefault("REPRO_GEMM_BACKEND", "xla")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: subprocess tests that boot a fresh interpreter with fake "
        "devices (tests/helpers.py); deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA kernels); "
        "skips with a reason elsewhere")


@pytest.fixture(scope="session")
def rng_key():
    import jax
    return jax.random.PRNGKey(0)
