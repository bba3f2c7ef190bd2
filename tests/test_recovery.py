"""Kill-and-resume recovery: SIGKILL a run mid-flight, restore, continue.

SURVEY.md §5 failure-recovery row. The recovery contract is exercised for
real — a worker process checkpoints, dies by an uncatchable SIGKILL, and a
fresh process restores and continues — and the resumed run's final state
must be BITWISE identical to an uninterrupted run (per-step keys fold from
the checkpointed (chain key, step) state, so the random stream continues
exactly). Covered both single-process and under the 2-process
``jax.distributed`` harness (per-process shard checkpoints, the pod
recovery pattern).
"""

import json
import os
import signal
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "recovery_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    return env


def _run(args, timeout=600):
    return subprocess.run(
        [sys.executable, WORKER, *args],
        capture_output=True, text=True, timeout=timeout, env=_clean_env(),
    )


def _result(out: str) -> dict:
    line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):])


def test_kill_and_resume_single_process(tmp_path):
    ckpt = str(tmp_path / "ck")

    full = _run(["full", ckpt])
    assert full.returncode == 0, full.stderr[-2000:]

    crash = _run(["crash", ckpt])
    # the worker SIGKILLs itself AFTER writing the checkpoint
    assert crash.returncode == -signal.SIGKILL, (crash.returncode, crash.stderr[-2000:])
    assert "CHECKPOINTED" in crash.stdout

    resume = _run(["resume", ckpt])
    assert resume.returncode == 0, resume.stderr[-2000:]

    assert _result(resume.stdout) == _result(full.stdout)


def _run_pair(mode, ckpt, port, timeout=600):
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, mode, ckpt, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=_clean_env(),
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate())
    return procs, outs


@pytest.mark.slow
def test_kill_and_resume_two_process_distributed(tmp_path):
    """Both emulated hosts checkpoint their local shards, die by SIGKILL,
    and a fresh 2-process run restores + continues bitwise-identically."""
    ckpt = str(tmp_path / "dck")

    procs, outs = _run_pair("full", ckpt, _free_port())
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"full worker failed:\n{se[-2000:]}"
    ref = _result(outs[0][0])

    procs, outs = _run_pair("crash", ckpt, _free_port())
    for p, (so, se) in zip(procs, outs):
        # each worker dies by its own SIGKILL; a worker that loses the
        # coordinator connection a moment earlier exits nonzero instead —
        # either way it died abnormally AFTER durably checkpointing
        assert p.returncode != 0, (p.returncode, se[-2000:])
        assert "CHECKPOINTED" in so
    assert os.path.exists(ckpt + ".proc0.npz") and os.path.exists(ckpt + ".proc1.npz")

    procs, outs = _run_pair("resume", ckpt, _free_port())
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"resume worker failed:\n{se[-2000:]}"

    assert _result(outs[0][0]) == ref
