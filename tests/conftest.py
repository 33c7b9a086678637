"""Test configuration.

The suite runs on the CPU, with a virtual 8-device mesh
(xla_force_host_platform_device_count) for the multi-device tests.
Tests marked ``chip`` need the GPU: they skip here and run on the card
through ``python chip_smoke.py``, which sets MPTRAC_CHIP_TESTS=1 so
that the suite keeps JAX's default platform.
"""

import os

ON_CHIP = os.environ.get("MPTRAC_CHIP_TESTS") == "1"

if not ON_CHIP:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not ON_CHIP:
    jax.config.update("jax_platforms", "cpu")

import pathlib  # noqa: E402

import pytest  # noqa: E402

REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture
def chip():
    """Skip unless JAX's default device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs the GPU: run `python chip_smoke.py` on the "
                    "card")


@pytest.fixture(scope="session")
def reference_dir() -> pathlib.Path:
    if not REFERENCE.exists():
        pytest.skip("reference checkout not available")
    return REFERENCE


@pytest.fixture(scope="session")
def era5_utm_fixture(reference_dir) -> pathlib.Path:
    path = reference_dir / "tests" / "data" / "era5_utm32_2025_05_01_00.nc"
    if not path.exists():
        pytest.skip("era5_utm32 fixture not available")
    return path
