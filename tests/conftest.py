"""Shared fixtures.  NB: no XLA_FLAGS here — tests see the real device
count (1 on this container); multi-device behaviour is exercised via
subprocesses in test_multidevice.py, and the 512-device dry-run only ever
sets the flag inside repro.launch.dryrun.

Subprocess-spawning multi-device tests carry the ``multidevice`` marker;
they are skipped cleanly when ``XLA_FLAGS=--xla_force_host_platform_
device_count`` cannot produce virtual devices (e.g. a non-CPU backend or
a stripped jaxlib), keeping tier-1 deterministic offline.
"""
import functools
import os
import subprocess
import sys

import jax
import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "multidevice: spawns a subprocess with XLA_FLAGS device-forcing "
        "(skipped when virtual devices are unavailable)",
    )
    config.addinivalue_line(
        "markers",
        "cuda: runs a CUDA kernel of repro_torch on an NVIDIA GPU "
        "(skipped where torch.cuda.is_available() is false)",
    )


@functools.lru_cache(maxsize=1)
def _device_forcing_available() -> bool:
    # Inherit the environment untouched (notably JAX_PLATFORMS: without
    # it jax probes every plugin, which can hang on accelerator-less
    # containers); only the device-forcing flag is added.
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    try:
        proc = subprocess.run(
            [sys.executable, "-c", "import jax; assert jax.device_count() == 2"],
            capture_output=True,
            stdin=subprocess.DEVNULL,  # an inherited pipe stdin can hang jax init
            timeout=240,  # generous: under heavy load jax init can crawl
            env=env,
        )
    except (OSError, subprocess.TimeoutExpired):
        return False
    return proc.returncode == 0


def pytest_collection_modifyitems(config, items):
    for item in items:
        if "multidevice" in item.keywords and not _device_forcing_available():
            item.add_marker(
                pytest.mark.skip(
                    reason="XLA_FLAGS host-platform device-forcing unavailable"
                )
            )


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(0)


@pytest.fixture()
def np_rng():
    return np.random.default_rng(0)
