import os
import sys

# Smoke tests and benches see the single real CPU device — the 512-device
# override belongs exclusively to launch/dryrun.py (see system design note).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))  # benchmarks/

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    # "slow" splits the hypothesis-heavy property suites into their own CI
    # job (ci.yml: tier1 runs -m "not slow", tier1-slow runs -m slow); a bare
    # `pytest` still runs everything — the tier-1 verify command is unchanged.
    config.addinivalue_line(
        "markers", "slow: hypothesis-heavy property suites (separate CI job)")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device (PyTorch port kernels); skips without one")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)
