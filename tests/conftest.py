"""Test configuration: run everything on a virtual 8-device CPU mesh.

Multi-device hardware is not needed: sharded code paths are *executed*
(not just compiled) against ``--xla_force_host_platform_device_count=8``
— fixing the reference's gap of compile-only distributed testing
(SURVEY.md §4).  Tests of code that runs only on a GPU carry the ``gpu``
marker and skip here; run them on a machine with a card with
``python -m pytest tests/ -m gpu`` (``JAX_PLATFORMS`` unset).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from green_marl_tpu.utils import compile_cache  # noqa: E402

# Persistent compilation cache: the suite is dominated by XLA compiles of
# while-loop superstep programs; cache them across runs.
compile_cache.enable(os.path.join(
    os.path.dirname(os.path.abspath(__file__)), ".jax_cache"))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips (inside the `gpu_device` "
        "fixture) where JAX finds none")
    config.addinivalue_line(
        "markers", "slow: long-running; deselected by -m 'not slow'")


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where there is none.  The
    decision is made here, at run time, so every worker collects the
    same tests."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (JAX finds none on this machine)")
    return devs[0]


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)
