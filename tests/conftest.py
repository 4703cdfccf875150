"""Test configuration: force an 8-device virtual CPU platform.

Must run before jax is imported anywhere: tests exercise multi-device
sharding on a virtual CPU mesh (the standard JAX fake-backend trick, cf.
SURVEY.md §4) and must not take an accelerator.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
