"""The chip_smoke.py phases as chip-marked tests.

They need an NVIDIA GPU and skip without one; the ``gpu`` fixture
decides at run time.  On the card:

    JAX_PLATFORMS=cuda python -m pytest -m chip tests/test_chip.py
"""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke  # noqa: E402


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX finds {jax.devices()[0]}")


@pytest.mark.chip
@pytest.mark.parametrize("phase", ["phase_parity", "phase_headline",
                                   "phase_app", "phase_sizes",
                                   "phase_kernel_timing"])
def test_chip_phase(gpu, phase):
    getattr(chip_smoke, phase)()
