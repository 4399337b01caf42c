"""Test configuration.

By default the tests run on an 8-device virtual CPU platform, so sharding
tests exercise real multi-device code paths on any host.  A JAX_PLATFORMS
that is already set is respected: `JAX_PLATFORMS=cuda python -m pytest -m
gpu` runs the card-only tests on the GPU.  Whether a card is present is
decided by the `gpu_device` fixture, never while modules are imported.
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "collective_call_terminate_timeout" not in flags:
    # 8 virtual devices share few host cores: a collective's slowest
    # "device" can miss the default rendezvous deadline under load, and
    # XLA:CPU then ABORTS the process ("Fatal Python error: Aborted",
    # observed on the scene-shard all_gather whenever another process
    # competed for the core).  Ten minutes makes the abort unreachable.
    flags = (flags
             + " --xla_cpu_collective_call_terminate_timeout_seconds=600")
os.environ["XLA_FLAGS"] = flags
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


@pytest.fixture(scope="session")
def gpu_device():
    """The first JAX device when it is a GPU; skips the test otherwise
    (tests marked `gpu` run on the card only)."""
    try:
        dev = jax.devices()[0]
    except RuntimeError as e:
        pytest.skip(f"no GPU: {e}")
    if dev.platform != "gpu":
        pytest.skip(f"no GPU: JAX runs on {dev.platform}")
    return dev
