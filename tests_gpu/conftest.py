"""Tests that need an NVIDIA GPU.

They run on the card, in the process of ``python chip_smoke.py`` (phase D)
or alone with ``python -m pytest tests_gpu/``. Anywhere else every test
skips: whether there is a card is decided in a fixture, never while a
module is imported, so every pytest-xdist worker collects the same tests.
"""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped elsewhere")


@pytest.fixture(autouse=True)
def _require_gpu():
    platform = jax.devices()[0].platform
    if platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX platform is {platform})")
