"""Test configuration.

Correctness tests run on the CPU backend (same XLA semantics, no card
needed) — SURVEY.md §4.  `jax_default_device` is pinned to a CPU device and
`jax_num_cpu_devices` raised to 8 for the multi-device sharding tests.
Tests that need a GPU carry the `gpu` marker and take the `gpu_device`
fixture, which skips where there is none.  On a card:
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax

from audio_formats_tpu.utils.compile_cache import enable_compile_cache

# kernel graphs (the QOA encoder scan above all) are expensive to compile
enable_compile_cache()
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_default_device", jax.devices("cpu")[0])

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (gpu_device fixture)")


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def cpu_mesh_devices():
    return jax.devices("cpu")


@pytest.fixture
def gpu_device():
    """The first GPU, made the default device for the test; skips the test
    where JAX has no GPU backend (decided here, never at import)."""
    try:
        dev = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU backend (on a card: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/)")
    with jax.default_device(dev):
        yield dev
