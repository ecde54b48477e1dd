"""Test harness: forced 8-device CPU mesh.

The reference could never test its parallelism without a GPU; here the
whole suite — including the sharded pipelines and collectives — runs on an
8-virtual-device CPU mesh (SURVEY.md §4), exercising the same code path as
a multi-card mesh, with the kernels in the Pallas interpreter.  Must run
before the first jax import.

The platform defaults to the CPU; on the card, the tests marked ``gpu``
run with ``JAX_PLATFORMS=cuda python -m pytest tests/ -q -m gpu`` (they
decide inside a fixture whether a card is present, and skip otherwise).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import numpy as np
import pytest

if os.environ["JAX_PLATFORMS"] == "cpu":
    assert jax.default_backend() == "cpu" and len(jax.devices()) == 8, (
        jax.default_backend(),
        jax.devices(),
    )


# Smoke tier (`pytest -m quick`, ~2 min): the fast modules that together
# touch every layer — constants/derivations, blockwise ops, all four
# pipelines vs golden, transforms registry, serialization/metrics, I/O.
# The slow modules (scaled/color/dispatch/sharding CLI drives) stay in the
# full ~12-min suite.
_QUICK_MODULES = {
    "test_constants", "test_ops", "test_pipelines", "test_transforms",
    "test_metrics", "test_io", "test_qtables", "test_kernels",
}


def pytest_configure(config):
    config.addinivalue_line("markers", "quick: fast broad-coverage smoke tier")
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def gpu():
    """The card, or a skip: decided when the test runs, never at import."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (JAX found {dev.platform!r})")
    return dev


def pytest_collection_modifyitems(config, items):
    for item in items:
        if getattr(item.module, "__name__", "") in _QUICK_MODULES:
            item.add_marker(pytest.mark.quick)


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def image256(rng):
    """Seeded synthetic image, mirroring the reference benchmark input
    (srand(42); rand()%256 — benchmark_newAppr.cu:46-51)."""
    return rng.integers(0, 256, size=(256, 256)).astype(np.float32)
