"""Test harness: force an 8-device CPU mesh before JAX initializes.

SURVEY.md section 4 item 4: multi-device collectives logic is validated on
a virtual CPU mesh (xla_force_host_platform_device_count).

The CPU is forced through jax.config.update (which wins over the
JAX_PLATFORMS environment variable), so the suite runs on the CPU even on a
machine with a GPU.  Kernel tests run in Pallas interpret mode; the compiled
kernels are checked on the card by chip_smoke.py, and by the `gpu`-marked
tests when BTBS_TEST_GPU=1 leaves jax its own platform choice:

    BTBS_TEST_GPU=1 python -m pytest tests/ -m gpu
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not os.environ.get("BTBS_TEST_GPU"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when there is none (decided when the test
    runs, never at import, so every xdist worker collects the same tests)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: run with BTBS_TEST_GPU=1 on a machine with one")
