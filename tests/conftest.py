"""Test configuration: run all tests on CPU (native float64, fast jit) with a
virtual 8-device mesh so the sharded path is exercised without several
accelerators.

The platform is forced through both the environment and jax.config before
any backend is initialized, so a machine with a GPU still runs the suite on
the CPU. `python chip_smoke.py` is the run on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")

from fvens_tpu.compile_cache import enable_compile_cache

enable_compile_cache()

import pathlib
import pytest

REFERENCE = pathlib.Path("/root/reference")


def reference_available() -> bool:
    return REFERENCE.is_dir()


@pytest.fixture
def refdir():
    if not reference_available():
        pytest.skip("reference mesh data not available")
    return REFERENCE
