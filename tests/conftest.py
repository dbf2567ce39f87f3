import os

# Tests run on the single host CPU device (the dry-run and ONLY the
# dry-run forces 512 placeholder devices, inside its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import pytest

jax.config.update("jax_enable_x64", False)


@pytest.fixture(scope="session")
def rng_key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips where there is none")
