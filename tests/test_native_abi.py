"""Native C ABI end-to-end: build libmh_tpu.so + C host, run the demo scene.

Verifies the KernelWrapper-equivalent surface (SURVEY.md C9) from an actual
C program over the wire structs — the same way the reference DLL is
consumed via P/Invoke. Skipped when no C toolchain / embeddable python is
available.
"""

import shutil
import subprocess
from pathlib import Path

import pytest

NATIVE = Path(__file__).resolve().parent.parent / "mh_tpu" / "native"


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_native_abi_smoke():
    build = subprocess.run(
        ["make", "-s"], cwd=NATIVE, capture_output=True, text=True, timeout=300
    )
    if build.returncode != 0:
        pytest.skip(f"native build unavailable: {build.stderr[-500:]}")

    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run(
        ["./test_wrapper"],
        cwd=NATIVE,
        capture_output=True,
        text=True,
        timeout=600,
        env=env,
    )
    assert run.returncode == 0, f"stdout={run.stdout[-800:]}\nstderr={run.stderr[-800:]}"
    assert "native ABI smoke test OK" in run.stdout
    assert "costs: total=" in run.stdout


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain")
def test_reference_abi_drop_in():
    """The exported ``KernelWrapper`` with the reference's EXACT struct
    layouts (Kernel.cu:43-149,873): a C host filling the demo scene exactly
    as ``main()`` does (Kernel.cu:1003-1194) gets layouts + real costs back
    through the reference-shaped structs. Layout pins are _Static_asserts
    in test_ref_compat.c."""
    build = subprocess.run(
        ["make", "-s"], cwd=NATIVE, capture_output=True, text=True, timeout=300
    )
    if build.returncode != 0:
        pytest.skip(f"native build unavailable: {build.stderr[-500:]}")

    import os

    env = dict(os.environ, JAX_PLATFORMS="cpu")
    run = subprocess.run(
        ["./test_ref_compat"], cwd=NATIVE, capture_output=True, text=True,
        timeout=600, env=env,
    )
    assert run.returncode == 0, f"stdout={run.stdout[-800:]}\nstderr={run.stderr[-800:]}"
    assert "reference-ABI drop-in test OK" in run.stdout
