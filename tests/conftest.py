"""Test configuration: run on a virtual 8-device CPU mesh with x64 available.

Mirrors the reference's distributed-testing stance (SURVEY.md section 4):
CTF makes np=1 and np=4096 the same code; here a forced 8-device CPU host
platform lets sharding tests validate the multi-device path without GPUs.
The platform is also pinned through jax.config, in case jax was imported
before this file ran. Tests that need the card live in tests_gpu/.
"""

import os

# XLA_FLAGS is read at backend-init time, which has not happened yet even
# though jax is already imported.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    assert jax.default_backend() == "cpu", jax.default_backend()
    assert len(jax.devices()) == 8, jax.devices()
    config.addinivalue_line(
        "markers", "slow: opt-in long tests (run with -m slow)")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU (tests_gpu/, run on the card)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("-m", default=""):
        return  # explicit -m selection: run what was asked
    skip = pytest.mark.skip(reason="slow: opt-in via -m slow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def rng():
    return np.random.default_rng(0)
