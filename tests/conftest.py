"""Test configuration.

Unit tests run JAX on the CPU with 8 virtual devices, so sharding/mesh
tests exercise real multi-device semantics without an accelerator.  An
existing JAX_PLATFORMS wins: `JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/` runs the tests marked `gpu` on the card, and those tests skip
(through the `gpu` fixture) wherever the backend is not a GPU.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402


REFERENCE = "/root/reference"


def reference_available() -> bool:
    return os.path.isdir(REFERENCE)


requires_reference = pytest.mark.skipif(
    not reference_available(), reason="reference repo not mounted")


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips otherwise.  Decided
    here, at test time, so every worker collects the same tests."""
    import jax
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest "
                    "-m gpu tests/")
    return device
