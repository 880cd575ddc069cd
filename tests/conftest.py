import os

# Run the test suite on a virtual 8-device CPU mesh with float64 enabled so
# golden tests against float64 reference formulas are exact, and multi-device
# sharding tests run without accelerators. JAX_PLATFORMS defaults to cpu; set
# it (e.g. JAX_PLATFORMS=cuda,cpu) to run the `gpu`-marked tests on a card.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

jax.config.update("jax_enable_x64", True)

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def gpu():
    """The first GPU JAX sees; skips the test where there is none. Decided
    here, when the test runs, never while test modules are imported."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU; JAX found none")
    return devs[0]


DATA_DIR = "/root/reference/data"


@pytest.fixture(scope="session")
def sim_data_dir():
    return os.path.join(DATA_DIR, "simulated")
