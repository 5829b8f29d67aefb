import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding paths are
# exercised without accelerator hardware.  Tests that need a card carry the
# `gpu` marker and take the `gpu` fixture, which skips unless JAX reports a
# GPU (run them on a machine with a card: JAX_PLATFORMS=cuda pytest -m gpu).
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX reports none."""
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU; JAX reports %r" % dev.platform)
    return dev
