"""Multi-host launcher: sharded chains + collectives over several hosts.

The ready-to-run measurement plan for the >=85% multi-host scaling gate
(BASELINE.md). One process per host; the coordinator address is host 0.

    # on every host (example: 4 hosts):
    python benchmarks/pod_launch.py \
        --coordinator 10.0.0.2:9876 --num-processes 4 --process-id $HOST_ID \
        --chains-per-host 1024 --objects 100 --iters 2000

    # local 2-process emulation over virtual CPU devices (same code path,
    # gRPC control plane — what tests/test_multihost.py automates):
    XLA_FLAGS=--xla_force_host_platform_device_count=2 JAX_PLATFORMS=cpu \
      python benchmarks/pod_launch.py --coordinator 127.0.0.1:9876 \
        --num-processes 2 --process-id 0 ... &   # and process-id 1

Measures, per configuration, the per-step time by the same multi-length
linearity fit bench.py uses, and prints (from process 0) a JSON line with
weak-scaling efficiency = t_step(1-host equivalent) / t_step(measured).
The chain loop itself has ZERO collectives (chains are independent,
exactly like the reference's grid of CUDA blocks), so the expected
efficiency is ~1.0 until collective-adaptation rounds (one scalar psum
per `--steps-per-round`) or tempering exchanges (one `ppermute` of
replica states per `--exchange-every`) amortize poorly.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

# launched as a script from benchmarks/: make the repo root importable
# even when the dev .pth is absent (fresh environments)
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import numpy as np


def per_step_linfit(run, lengths, repeats: int = 5) -> float:
    mins = {}
    for it in lengths:
        run(it)
        mins[it] = math.inf
    for _ in range(repeats):
        for it in lengths:
            t0 = time.perf_counter()
            run(it)
            mins[it] = min(mins[it], time.perf_counter() - t0)
    xs = np.array(lengths, float)
    ys = np.array([mins[it] for it in lengths])
    return max(float(np.polyfit(xs, ys, 1)[0]), 1e-12)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True, help="host0 addr:port")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--chains-per-host", type=int, default=1024)
    ap.add_argument("--objects", type=int, default=100)
    ap.add_argument("--iters", type=int, default=2000)
    ap.add_argument("--steps-per-round", type=int, default=50,
                    help="steps between collective-adaptation psums")
    ap.add_argument("--exchange-every", type=int, default=25,
                    help="tempering exchange cadence")
    ap.add_argument("--skip-tempering", action="store_true")
    args = ap.parse_args()

    import jax

    from mh_tpu.parallel.multihost import global_chain_mesh, initialize

    initialize(args.coordinator, args.num_processes, args.process_id)
    pid = jax.process_index()

    from jax.experimental import multihost_utils

    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.parallel.sharded import run_chains_collective, run_chains_sharded
    from mh_tpu.sampler.tempering import run_tempered

    mesh = global_chain_mesh()
    n_chains = args.chains_per_host * args.num_processes
    spec = demo_scene(args.objects)
    scene = spec.build()
    pose0 = spec.initial_pose()
    key = jax.random.key(0)
    out = {
        "hosts": args.num_processes,
        "global_devices": jax.device_count(),
        "chains": n_chains,
        "objects": args.objects,
    }

    # 1) independent sharded chains — the weak-scaling workload: each host
    #    runs chains-per-host chains; perfect scaling = same per-step time
    #    as one host running chains-per-host chains alone.
    def run_plain(iters):
        cfg = SamplerConfig(iterations=iters, n_chains=n_chains)
        states = run_chains_sharded(key, pose0, scene, cfg, mesh)
        jax.block_until_ready(states.pose)
        multihost_utils.sync_global_devices(f"plain_{iters}")

    t_plain = per_step_linfit(
        run_plain, (max(args.iters // 10, 1), args.iters // 2, args.iters)
    )
    out["per_step_ms_chains"] = t_plain * 1e3
    out["proposals_per_s_global"] = n_chains / t_plain

    # 2) collective adaptation: one scalar psum per steps-per-round
    def run_coll(rounds):
        cfg = SamplerConfig(iterations=0, n_chains=n_chains, adapt_rate=0.1)
        states, rates, _ = run_chains_collective(
            key, pose0, scene, cfg, mesh,
            rounds=rounds, steps_per_round=args.steps_per_round,
        )
        jax.block_until_ready(states.pose)
        multihost_utils.sync_global_devices(f"coll_{rounds}")

    t_coll = per_step_linfit(run_coll, (2, 6, 10)) / args.steps_per_round
    out["per_step_ms_collective"] = t_coll * 1e3
    out["collective_overhead_pct"] = max(t_coll / t_plain - 1.0, 0.0) * 100

    # 3) tempering: ppermute replica exchange across the host boundary
    if not args.skip_tempering:
        def run_temp(rounds):
            states, _ = run_tempered(
                key, pose0, scene, SamplerConfig(iterations=0), mesh,
                n_replicas=n_chains, exchange_every=args.exchange_every,
                rounds=rounds,
            )
            jax.block_until_ready(states.pose)
            multihost_utils.sync_global_devices(f"temp_{rounds}")

        t_temp = per_step_linfit(run_temp, (2, 5, 8)) / args.exchange_every
        out["per_step_ms_tempering"] = t_temp * 1e3

    # weak-scaling efficiency needs the 1-host anchor: measured here when
    # run with --num-processes 1, otherwise supply externally and divide.
    if args.num_processes == 1:
        out["anchor"] = True

    if pid == 0:
        print(json.dumps(out), flush=True)
    else:
        print(f"# process {pid} done", file=sys.stderr)


if __name__ == "__main__":
    main()
