"""Test configuration.

The suite runs on the CPU: JAX is held to a simulated 8-device CPU
platform, set in-process before the first backend use, so the sharding and
collective tests have a mesh to run on.

Tests that need the GPU carry the `gpu` marker and take the `gpu_device`
fixture, which skips them where JAX's platform is not `gpu`.  Whether there
is a card is decided inside that fixture, never at import or collection.
On the card, `python chip_smoke.py` runs the same checks.
"""

import os
import sys
import pathlib

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped elsewhere (run "
        "chip_smoke.py on the card for the same checks)")


@pytest.fixture
def gpu_device():
    """The first JAX device if it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's platform here is {dev.platform!r}")
    return dev


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    The full suite jits thousands of programs in one process; without
    eviction the executable caches grow for the whole run.  Per-module
    clearing bounds the growth; the few cross-module recompiles are noise
    next to that."""
    yield
    jax.clear_caches()
