"""The benchmark harness end to end on the CPU, at tiny shapes.

Each measurement runs in a child process of its own (children inherit
``JAX_PLATFORMS=cpu``); the parent prints one JSON line that names the
device the numbers were taken on.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")


def _run_bench(args=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, BENCH, "--objects", "8", "--chains", "8",
         "--iters", "30", *args],
        env=env, timeout=900, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
    )


def _final_json(proc):
    lines = [l for l in proc.stdout.splitlines() if l.startswith("{")]
    assert lines, f"no JSON line.\nstdout={proc.stdout}\nstderr={proc.stderr}"
    return json.loads(lines[-1])


def test_bench_clean_run_single_attempts():
    proc = _run_bench()
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = _final_json(proc)
    assert out["metric"] == "mh_proposals_per_s_per_chip_8obj_8chains"
    assert out["value"] > 0
    assert out["unit"] == "proposals/s"
    assert out["vs_baseline"] > 0
    assert out["engine"] == "xla_specialized"
    # every line names the device it was measured on
    assert out["platform"] == "cpu"
    assert out["device_kind"]
    assert out["device_count"] >= 1
    assert "card" in out
    assert not [k for k in out if "fused" in k or "flops" in k or "sol" in k]
    assert "healing" not in proc.stderr
