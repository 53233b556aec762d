"""Test configuration: run JAX on CPU with 8 virtual devices so that the
multi-device sharded paths are exercised without an accelerator
(SURVEY.md §4).  Executables compiled here go to a cache outside the
checkout, so CPU code never travels with the tree."""

import os
import tempfile

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault(
    "JAX_COMPILATION_CACHE_DIR",
    os.path.join(tempfile.gettempdir(), "kpop_test_jax_cache"),
)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    import jax

    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run on the card: see README)")
    return devs[0]
