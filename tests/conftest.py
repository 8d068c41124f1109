"""Test configuration.

Every run except the chip run forces JAX onto the CPU backend with 8
virtual devices, before any device is used, so the multi-device sharding
path is exercised without accelerators (mirrors the reference's strategy
of running everything in-process with WebApplicationFactory, SURVEY.md
§4). The chip run (``pytest -m chip``, which chip_smoke.py starts on the
card) leaves the platform to JAX; each chip test checks in a fixture that
it got a GPU and skips otherwise.
"""

import os

import pytest


def pytest_configure(config):
    if (config.option.markexpr or "").strip() == "chip":
        return
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    # jax may already be imported (and JAX_PLATFORMS read) by the time this
    # hook runs; the config knob still applies while no backend exists
    import jax

    jax.config.update("jax_platforms", "cpu")


@pytest.fixture()
def gpu():
    """The first device, when it is a GPU; skips the test otherwise."""
    import jax

    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(f"needs a GPU (JAX platform is {device.platform!r})")
    return device


@pytest.fixture()
def store():
    from omni_recall_tpu.index.store import InMemoryIngestionStore

    return InMemoryIngestionStore()
