"""Test configuration: the CPU backend with a virtual 8-device mesh (for the
sharding tests) and float64 (for adjoint / finite-difference accuracy).

Must run before jax is imported anywhere.

`gpu`-marked tests need an NVIDIA GPU and skip elsewhere; on the card run
them alone with `JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`.
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

# persistent compile cache: the suite's big scans recompile identically on
# every run; repeat runs (CI, review) skip those compiles
from sep2023_tpu.cli import enable_compile_cache  # noqa: E402

enable_compile_cache()


@pytest.fixture
def gpu_device():
    """The first device when it is an NVIDIA GPU; skips otherwise.  Decided
    here, at test time, so every xdist worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU (found {dev.platform}); run "
                    "`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` on "
                    "the card")
    return dev
