"""Test harness configuration.

Tests run on a virtual 8-device CPU mesh.  The platform is pinned to the
CPU before any backend initializes (``jax.config.update`` as well as the
environment, so a machine whose JAX would pick an accelerator still runs
the suite on the CPU).  XLA_FLAGS is read at CPU-client creation, so
setting it here (before the first jax op) still works.

Tests that need the GPU carry the ``chip`` marker and skip here; the
``gpu`` fixture (tests/test_chip.py) decides whether a card is present,
at run time.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

if os.environ["JAX_PLATFORMS"] == "cpu":
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu", (
        "tests must run on the virtual CPU mesh, got "
        f"{jax.devices()}")
    assert len(jax.devices()) >= 8, (
        "expected an 8-device virtual CPU mesh, got "
        f"{len(jax.devices())} devices")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs an NVIDIA GPU; skips without one "
        "(run on the card: JAX_PLATFORMS=cuda python -m pytest -m chip)")
