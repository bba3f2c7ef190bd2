"""Scaling studies beyond the headline bench (results: PERF.md).

Three sweeps, all using the linearity-fit methodology of ``bench.py``
(the slope over several scan lengths cancels the fixed per-call cost):

- ``chains``:  throughput vs batched chain count on the current platform
               (BASELINE configs 3/4 — how far one device's utilization
               scales with the chains axis).
- ``objects``: throughput vs scene size N (the reference's scaling pain
               point — its O(N²) terms made "larger sets of objects" slow,
               Readme.md:6; here they are N×N tensor ops).
- ``devices``: weak scaling of ``run_chains_sharded`` over 1..8 virtual CPU
               devices (chains-per-device held fixed). On CPU this measures
               the sharding machinery's overhead, not a real interconnect; it runs in
               subprocesses because device count is fixed at process start.

Usage: ``python benchmarks/scaling.py [chains|objects|devices|all]``
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _best(fn, repeats: int = 3) -> float:
    best = math.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def _per_step(run, short: int = 100, long_: int = 1000, repeats: int = 6) -> float:
    """Per-step seconds as the slope of min wall time over 3 scan lengths.

    The 3-length linearity fit exposes intercept misfits as residuals
    instead of folding them into the slope."""
    lengths = (short, (short + long_) // 2, long_)
    mins = {}
    for it in lengths:
        run(it)  # compile/warm
        mins[it] = math.inf
    for _ in range(repeats):
        for it in lengths:
            t0 = time.perf_counter()
            run(it)
            mins[it] = min(mins[it], time.perf_counter() - t0)
    xs = np.array(lengths, float)
    ys = np.array([mins[it] for it in lengths])
    return max(float(np.polyfit(xs, ys, 1)[0]), 1e-9)


def sweep_chains(n_objs: int = 100) -> None:
    import jax

    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.sampler.mh import run_chains

    spec = demo_scene(n_objs)
    scene = spec.build()
    pose0 = spec.initial_pose()
    key = jax.random.key(0)
    for n_chains in (256, 512, 1024, 2048, 4096):
        def run(iters):
            cfg = SamplerConfig(iterations=iters, n_chains=n_chains)
            states, _ = run_chains(key, pose0, scene, cfg)
            jax.block_until_ready(states)

        per = _per_step(run)
        print(json.dumps({
            "sweep": "chains", "n_objs": n_objs, "n_chains": n_chains,
            "per_step_ms": round(per * 1e3, 4),
            "proposals_per_s": round(n_chains / per, 1),
        }), flush=True)


def sweep_objects(n_chains: int = 1024) -> None:
    import jax

    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.sampler.mh import run_chains

    key = jax.random.key(0)
    for n_objs in (16, 32, 64, 100, 128, 256):
        spec = demo_scene(n_objs)
        scene = spec.build()
        pose0 = spec.initial_pose()

        def run(iters):
            cfg = SamplerConfig(iterations=iters, n_chains=n_chains)
            states, _ = run_chains(key, pose0, scene, cfg)
            jax.block_until_ready(states)

        per = _per_step(run)
        print(json.dumps({
            "sweep": "objects", "n_objs": n_objs, "n_chains": n_chains,
            "per_step_ms": round(per * 1e3, 4),
            "proposals_per_s": round(n_chains / per, 1),
        }), flush=True)


_DEVICE_CHILD = r"""
import json, math, os, sys, time
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
from mh_tpu.config import SamplerConfig
from mh_tpu.models.scene import demo_scene
from mh_tpu.parallel.mesh import chain_mesh
from mh_tpu.parallel.sharded import run_chains_sharded

n_dev = int(sys.argv[1])
chains_per_dev = int(sys.argv[2])
assert len(jax.devices()) == n_dev, (len(jax.devices()), n_dev)
spec = demo_scene(100)
scene = spec.build()
pose0 = spec.initial_pose()
mesh = chain_mesh(n_dev)
key = jax.random.key(0)

def run(iters):
    cfg = SamplerConfig(iterations=iters, n_chains=n_dev * chains_per_dev)
    states = run_chains_sharded(key, pose0, scene, cfg, mesh)
    jax.block_until_ready(states)

def best(fn, r=3):
    b = math.inf
    for _ in range(r):
        t0 = time.perf_counter(); fn(); b = min(b, time.perf_counter() - t0)
    return b

run(5); run(30)
t_s = best(lambda: run(5))
t_l = best(lambda: run(30))
per = max((t_l - t_s) / 25, 1e-9)
print(json.dumps({
    "sweep": "devices", "n_devices": n_dev, "chains_per_device": chains_per_dev,
    "per_step_ms": round(per * 1e3, 4),
    "proposals_per_s": round(n_dev * chains_per_dev / per, 1),
}))
"""


def sweep_devices(chains_per_dev: int = 128) -> None:
    """Weak scaling over virtual CPU device counts (subprocess per count)."""
    results = []
    for n_dev in (1, 2, 4, 8):
        env = dict(os.environ)
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = (
            env.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={n_dev}"
        ).strip()
        out = subprocess.run(
            [sys.executable, "-c", _DEVICE_CHILD, str(n_dev), str(chains_per_dev)],
            env=env, capture_output=True, text=True, cwd=REPO, check=True,
        )
        rec = json.loads(out.stdout.strip().splitlines()[-1])
        results.append(rec)
        print(json.dumps(rec), flush=True)
    base = results[0]["proposals_per_s"]
    for rec in results[1:]:
        eff = rec["proposals_per_s"] / (base * rec["n_devices"])
        print(json.dumps({
            "sweep": "devices", "n_devices": rec["n_devices"],
            "weak_scaling_efficiency": round(eff, 3),
        }), flush=True)


def main() -> None:
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("chains", "all"):
        sweep_chains()
    if which in ("objects", "all"):
        sweep_objects()
    if which in ("devices", "all"):
        sweep_devices()


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    from mh_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
