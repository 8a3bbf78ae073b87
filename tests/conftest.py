"""Test configuration: run on a virtual 8-device CPU platform.

Must set the env vars before JAX initializes its backends, so this executes at
conftest import time (pytest loads conftest before any test module). An
explicit ``JAX_PLATFORMS`` wins: the card-only tests run on a GPU with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavyweight test (statistical sweeps, multiprocess, fuzz, "
        "250k-iteration clocks) — excluded from `make test-fast`")
    config.addinivalue_line(
        "markers",
        "gpu: needs a GPU (takes the `gpu` fixture, which skips without "
        "one); run with JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")


@pytest.fixture
def gpu():
    """The first GPU device. Decided when the test runs, never at import,
    so every xdist worker collects the same tests."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")
    return devs[0]


@pytest.fixture
def eight_devices():
    """Skip unless JAX sees at least 8 devices (the virtual CPU mesh)."""
    import jax

    if jax.device_count() < 8:
        pytest.skip("needs 8 devices (the virtual CPU mesh)")


def pytest_addoption(parser):
    parser.addoption(
        "--smoke", action="store_true", default=False,
        help="keep only the first two non-slow tests of each module: a "
             "<2-minute tier that still imports and executes every module "
             "(`make test-smoke`)")


def pytest_collection_modifyitems(config, items):
    if not config.getoption("--smoke"):
        return
    kept, dropped, per_module = [], [], {}
    for item in items:
        mod = item.location[0]
        n = per_module.get(mod, 0)
        if n < 2 and item.get_closest_marker("slow") is None:
            per_module[mod] = n + 1
            kept.append(item)
        else:
            dropped.append(item)
    items[:] = kept
    config.hook.pytest_deselected(items=dropped)


@pytest.fixture(autouse=True)
def _reset_code_scale():
    """Keep the process-global code scale clean between tests."""
    import physicl_tpu as phys

    yield
    for u in ("s", "m", "kg", "A", "K", "mol", "cd"):
        phys.reset_code_scale(u)
    phys.light.refresh_constants()
