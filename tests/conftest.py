"""Test configuration: force an 8-device virtual CPU mesh.

The driver's real-TPU runs use bench.py / __graft_entry__.py; unit tests run
on the XLA CPU backend with 8 virtual devices (SURVEY.md §4: "strictly better
than the reference's fake-device story").
"""

import os

import pytest

TPU_MODE = os.environ.get("PADDLE_TPU_TESTS") == "1"

os.environ.setdefault("JAX_NUM_CPU_DEVICES", "8")
if not TPU_MODE:
    # jax < 0.5 has no jax_num_cpu_devices config option; the XLA flag is
    # the portable spelling and must be set before the CPU client exists
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not TPU_MODE:
    # must happen before the CPU client is instantiated
    try:
        jax.config.update("jax_num_cpu_devices", 8)
    except AttributeError:  # older jax: XLA_FLAGS fallback above applies
        pass
    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:
        pass

import paddle_tpu  # noqa: E402

if not TPU_MODE:
    paddle_tpu.set_device("cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "tpu: hardware smoke test — runs only with PADDLE_TPU_TESTS=1 "
        "(one-command TPU tier: PADDLE_TPU_TESTS=1 pytest -m tpu tests/)")
    config.addinivalue_line(
        "markers",
        "slow: long-running tier-2 test — excluded from the tier-1 "
        "`-m 'not slow'` run")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card, skips without one (on the card: "
        "python -m pytest --noconftest -m cuda tests/test_torch_cuda.py)")


def pytest_collection_modifyitems(config, items):
    for item in items:
        if "tpu" in item.keywords and not TPU_MODE:
            item.add_marker(pytest.mark.skip(
                reason="TPU hardware tier (set PADDLE_TPU_TESTS=1)"))
        elif "tpu" not in item.keywords and TPU_MODE:
            item.add_marker(pytest.mark.skip(
                reason="CPU-mesh test skipped in TPU hardware mode"))
