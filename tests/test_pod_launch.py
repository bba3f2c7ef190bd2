"""pod_launch.py end-to-end: the >=85% scaling gate's measurement harness.

``benchmarks/pod_launch.py`` is the ready-to-run multi-host measurement
plan. This test runs its local 2-process
emulation (real ``jax.distributed`` control plane over gRPC, 2 virtual CPU
devices per process: the DCN path) end-to-end and checks the
collective-cadence overhead model's *measured* local anchor stays inside
its documented envelope.
"""

import json
import os
import socket
import subprocess
import sys

import pytest

LAUNCHER = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "benchmarks", "pod_launch.py",
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch_once():
    port = _free_port()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    args = [
        "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
        "--chains-per-host", "8", "--objects", "16", "--iters", "60",
        "--steps-per-round", "20", "--exchange-every", "10",
    ]
    procs = [
        subprocess.Popen(
            [sys.executable, LAUNCHER, *args, "--process-id", str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env,
        )
        for pid in (0, 1)
    ]
    outs = [p.communicate(timeout=600) for p in procs]
    return procs, outs


@pytest.mark.slow
def test_pod_launch_two_process_local_emulation():
    # up to 3 attempts (15/30 s backoff): the 2-process gRPC control
    # plane (coordinator barrier, port bind) can time out when the shared
    # host is under heavy concurrent load; a genuine breakage fails
    # every attempt. Which attempt succeeded is printed so flakiness
    # stays visible in the test output (-s / failure capture).
    import time

    for attempt in range(3):
        procs, outs = _launch_once()
        if all(p.returncode == 0 for p in procs):
            if attempt:
                print(f"pod_launch control plane needed {attempt + 1} attempts")
            break
        time.sleep(15 * (attempt + 1))
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"pod_launch failed:\n{err[-3000:]}"

    line = [ln for ln in outs[0][0].splitlines() if ln.startswith("{")][-1]
    res = json.loads(line)
    assert res["per_step_ms_chains"] > 0
    assert res["proposals_per_s_global"] > 0
    # the collective-adaptation loop adds one scalar psum per
    # steps-per-round. The documented envelope (<=5% at cadence 50 over
    # DCN, PERFORMANCE.md) holds for production step sizes; this CI
    # emulation uses tiny 16-object steps on a shared loaded host, where
    # the gRPC round trip is scheduling-dominated — so the gate here is
    # structural (the harness runs end-to-end and reports a sane, finite
    # anchor), with a deliberately loose ceiling that still catches a
    # broken collective path spinning per step.
    assert 0.0 <= res["collective_overhead_pct"] <= 400.0
    assert res["per_step_ms_collective"] > 0
    assert res["per_step_ms_tempering"] > 0
