"""Test harness: run everything on a virtual 8-device CPU mesh.

This is the standard JAX trick for testing sharding and collectives without
several accelerators (SURVEY.md §4). Must set the env BEFORE jax imports.
GRAPHSLAM_TEST_GPU=1 keeps the default platform instead, so that the
`gpu`-marked tests run on the card: `GRAPHSLAM_TEST_GPU=1 python -m pytest
tests/ -m gpu`.
"""

import os

import pytest

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

# Set programmatically (before any backend is initialized) so that the CPU
# platform wins over whatever the environment selects.
if os.environ.get("GRAPHSLAM_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

jax.config.update("jax_threefry_partitionable", True)


@pytest.fixture
def gpu():
    """The first device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a CUDA device (found {dev.platform}); "
                    "run with GRAPHSLAM_TEST_GPU=1 on the card")
    return dev
