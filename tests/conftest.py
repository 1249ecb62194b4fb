"""Test configuration: run on a virtual 8-device CPU mesh with float64 enabled
so the dense oracles are exact.  The GPU runs float32 and float64; tests here
exercise the same code on the CPU backend (SURVEY.md §7, reference test
strategy §4).  Tests that need the GPU carry the ``gpu`` marker and skip here;
``python chip_smoke.py`` runs the GPU checks on the card."""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_ENABLE_X64", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import pytest  # noqa: E402

# Multi-process or many-case modules (minutes each on a small CPU box).
# `-m "not slow"` is the fast core pass.
_SLOW_MODULES = {
    "test_sharding_paths",   # sharded-vs-single steps of every solver path
    "test_multihost",        # 2 real jax.distributed processes
    "test_examples",         # steps all 18 reference example cases
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: multi-process / many-case tests (minutes each); "
        "deselect with -m 'not slow' for the fast core pass")
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips elsewhere (run on the "
        "card by chip_smoke.py)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        mod = item.module.__name__.rsplit(".", 1)[-1]
        if mod in _SLOW_MODULES:
            item.add_marker(pytest.mark.slow)
