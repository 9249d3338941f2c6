"""Test configuration: run the suite on a virtual 8-device CPU mesh.

Multi-device sharding tests (shard-invariance, cf. SURVEY.md section 4
item 8) run against 8 faked CPU devices. The XLA flag must be set before
JAX initializes its backends.

Tests marked ``gpu`` need the card: they take the ``gpu_device`` fixture,
which skips them on any other platform. On a machine with a GPU run them
with ``JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py``; every
other run stays on the CPU.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_threefry_partitionable", True)


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test anywhere else."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest tests/test_gpu.py")
    return dev
