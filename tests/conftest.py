"""Test configuration: CPU backend with 8 virtual devices + float64.

Multi-device sharding tests follow the standard JAX pattern of simulating a
device mesh with ``--xla_force_host_platform_device_count`` (SURVEY.md §4
test mapping).  float64 is enabled so solver tolerances match the reference
test suite (which runs in Julia Float64).

Tests run on the CPU unless ``JAX_PLATFORMS`` names another platform: the
``gpu``-marked tests need a CUDA device (``JAX_PLATFORMS=cuda python -m
pytest -m gpu tests/``, which ``chip_smoke.py`` runs on the card) and skip
elsewhere through the ``gpu`` fixture.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first CUDA device; the test skips where there is none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a CUDA GPU (run on the card: python chip_smoke.py)")
    return devices[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop live executables after each test module.

    The full suite accumulates hundreds of compiled shard_map programs on
    the 8-device CPU mesh; past ~200 live executables the XLA CPU
    compiler segfaults on a later (unrelated) LAPACK custom-call compile
    (reproduced deterministically at test_utils' eager ``lstsq`` once the
    parallel tier grew — an upstream XLA bug, not solver state).
    Clearing per module bounds the live-executable count; module-local
    caching (the thing the fixtures rely on) is unaffected."""
    yield
    jax.clear_caches()
