"""Test configuration.

Tests run JAX on the CPU with 8 virtual devices, so that the multi-device
sharding (`svtyper_tpu/parallel`, the engine's shard_map step) is
exercised without a multi-GPU host (SURVEY.md §4.3), and with x64
enabled, so that device math can be checked against the float64 oracle
bit for bit.

Tests that only a GPU can run carry the `gpu` marker and skip elsewhere.
On a GPU host, `python -m pytest -m gpu tests/` leaves JAX on its
default backend and runs just those.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _gpu_run(config) -> bool:
    return (config.getoption("markexpr") or "").strip() == "gpu"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU backend (run with -m gpu)"
    )
    if _gpu_run(config):
        return
    # before any backend initializes: test modules import jax only
    # after this hook has run
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    os.environ["JAX_ENABLE_X64"] = "1"
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    """Skip a `gpu` test unless JAX's default backend is a GPU. Decided
    here, per test, never while modules are imported."""
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU backend (default backend is %s); run "
            "`python -m pytest -m gpu tests/` on a GPU host"
            % jax.default_backend()
        )
