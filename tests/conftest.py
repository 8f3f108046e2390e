"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding is validated without accelerator hardware on the
virtual CPU devices (SURVEY.md section 4).  `jax.config.update` selects the
CPU backend even when the environment names another platform.

Tests that need the GPU carry the `gpu` marker and decide inside a fixture
whether a card is present (never at import); here they skip.  On the card,
`python chip_smoke.py` runs the same checks.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skips elsewhere (python chip_smoke.py "
        "runs the card checks)")
    config.addinivalue_line("markers", "slow: long-running test")
