"""Test harness config: run on CPU with 8 virtual devices.

Multi-chip sharding/collective tests (SURVEY.md §4e) run against a fake
8-device host-platform mesh so psum/all_gather/ppermute paths are exercised
without an accelerator. Tests that need a GPU carry the ``gpu`` marker and
take the ``gpu_card`` fixture, which skips them where ``nvidia-smi`` lists
no GPU; they drive the card from a child process, since this one stays on
the CPU: ``python -m pytest -m gpu tests/`` on a machine with a GPU.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import subprocess  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def gpu_card() -> str:
    """``name, power.limit`` of the first GPU, or a skip where there is none."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        pytest.skip("needs a GPU: no nvidia-smi here")
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        pytest.skip("needs a GPU: nvidia-smi lists none")
    return lines[0].strip()
