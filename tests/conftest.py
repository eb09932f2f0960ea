"""Test harness: the JAX CPU backend with 8 virtual devices.

Kernels run in the Pallas interpreter (tests pass interpret=True) and the
multi-device sharding paths run over a virtual 8-device CPU mesh. Tests
that need the GPU carry the `gpu` marker and take the `gpu` fixture, which
skips them here; chip_smoke.py runs them on the card.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

# Persistent XLA compilation cache: the suite's cost is dominated by CPU
# XLA compiles of big programs; caching them makes repeat runs mostly
# execution-bound. Keyed on HLO hash, so code changes invalidate exactly
# the affected programs. JAX_COMPILATION_CACHE_DIR, when set, is honoured
# as it stands; otherwise the cache lives in the checkout's .jax_cache/.
from raytracing_tpu.utils.cache import enable_persistent_cache  # noqa: E402

enable_persistent_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA GPU (skips elsewhere; run on the card "
        "with `python -m pytest tests -m gpu`)")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU. Decided here, at run
    time, so every test worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a CUDA GPU")


@pytest.fixture(scope="session")
def teapot_mesh():
    from raytracing_tpu.geometry.scene import teapot_only_mesh

    return teapot_only_mesh()


@pytest.fixture(scope="session")
def default_scene():
    from raytracing_tpu.geometry.scene import build_default_scene

    return build_default_scene(t=0.0)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)
