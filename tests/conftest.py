"""Test harness config: an 8-device virtual CPU mesh.

Multi-device sharding is validated without accelerators by running JAX on the
host platform with 8 virtual devices (the reference has no analog — its
parallelism is a multiprocessing pool, safepy/safe.py:510-514). Must run before
the first jax import. Tests marked ``gpu`` need the card: they skip here and run
with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_minplus.py``
(the module is named because other test modules import matplotlib, which the
card's host need not have).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(12345)


@pytest.fixture
def gpu():
    """The first GPU; skips the test where JAX has none (decided here, at
    run time, never while a module is imported)."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu "
                    "python -m pytest -m gpu tests/test_minplus.py")


# --------------------------------------------------------------------- slow lane
# The heavy equivalence suites (multi-engine bit-identity at n=500-600 over
# the 8-device mesh) dominate the wall clock. The default run skips tests
# MARKED slow so the iteration loop stays ~3 min; the FULL lane —
# `python -m pytest tests/ -q --runslow` — runs everything and must stay
# green (no assertion lives only in a skipped test's shadow: every engine
# keeps at least one fast-lane equivalence pin).

def pytest_addoption(parser):
    parser.addoption("--runslow", action="store_true", default=False,
                     help="also run tests marked slow (the full lane)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: heavy equivalence/scale test; skipped unless "
                   "--runslow (full lane)")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip = pytest.mark.skip(reason="slow lane: pass --runslow")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)
