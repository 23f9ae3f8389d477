"""Test harness setup.

Runs the suite on JAX's CPU backend with a virtual 8-device mesh
(``xla_force_host_platform_device_count``) so pjit/shard_map collective
paths are exercised without a multi-card machine (SURVEY.md §4 item 4).
Must run before jax is imported anywhere.

``JAX_PLATFORMS`` defaults to ``cpu``.  Tests marked ``gpu`` need the card:
their ``gpu`` fixture skips them unless JAX has a GPU backend, so run them
on the card with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_chip_smoke.py``
(other test modules may not import on a GPU machine whose environment
lacks matplotlib or has another top-level ``tests`` package installed).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The persistent compilation cache stays off for the CPU backend (see
# ransac_tpu.utils.device.compile_cache_dir); the suite relies on `slow`
# markers for a quick default loop instead; run the full matrix with
# `pytest tests/` (no -m filter).
if REPO_ROOT not in sys.path:
    sys.path.insert(0, REPO_ROOT)

REFERENCE_DIR = "/root/reference"

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    Running the whole suite in one process accumulates hundreds of
    XLA:CPU executables; an earlier jaxlib build then segfaulted inside
    ``backend_compile_and_load`` partway through (position-dependent
    resource exhaustion, not a specific program).  Dropping the caches at
    module boundaries keeps the live-executable count bounded; the cost
    is only cross-module recompiles.
    """
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """The first GPU, as JAX's default device for the test; skips when
    JAX has no GPU backend (decided here, never at import)."""
    try:
        device = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: run with JAX_PLATFORMS=cuda,cpu on the "
                    "card (README, Tests)")
    with jax.default_device(device):
        yield device


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_DIR)
