"""Test configuration: the CPU with 8 virtual devices, unless
``JAX_PLATFORMS`` names another platform (``JAX_PLATFORMS=cuda`` runs the
``gpu``-marked tests on a card).

Multi-device sharding logic is tested on a virtual CPU mesh (the standard
JAX trick; the reference never needed one — it is single-node CPU-only,
SURVEY.md §4).  XLA tiers compile for the CPU; the Triton driver's
programs run in Pallas interpret mode (ops.driver.triton_interpret).
Tests that need the card carry the ``gpu`` marker and skip here.
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Persistent compilation cache: XLA CPU compiles dominate suite runtime;
# cache across runs (and across xdist workers).
from shared_simd_scan_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def gpu():
    """The card, for tests marked ``gpu``: skips where JAX has none (the
    decision is made here, at run time, never at import)."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip("needs a GPU (run the gpu-marked tests on the card)")
    return devices[0]
