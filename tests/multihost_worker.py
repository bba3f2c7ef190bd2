"""Worker process for the 2-process distributed tests (test_multihost.py).

Each worker is one emulated "host" with 2 virtual CPU devices; 2 workers
coordinate through ``jax.distributed`` (gRPC/Gloo — the same control plane
a DCN-connected pod uses). Worker 0 prints one JSON line with the gathered
results; the pytest harness compares them bitwise against a single-process
run (device-count AND process-count invariance).

Usage: python multihost_worker.py <process_id> <num_processes> <port>
"""

import json
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np


def main() -> None:
    pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    from mh_tpu.parallel.multihost import global_chain_mesh, initialize

    initialize(f"127.0.0.1:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert jax.local_device_count() == 2
    assert jax.device_count() == 2 * nproc

    from jax.experimental import multihost_utils

    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.parallel.sharded import run_chains_sharded
    from mh_tpu.sampler.smc import run_smc
    from mh_tpu.sampler.tempering import run_tempered

    mesh = global_chain_mesh()
    spec = demo_scene(8)
    scene = spec.build()
    pose0 = spec.initial_pose()
    key = jax.random.key(0)

    out = {}

    # 1) independent sharded chains across both processes
    cfg = SamplerConfig(iterations=20, n_chains=8)
    states = run_chains_sharded(key, pose0, scene, cfg, mesh)
    pose = multihost_utils.process_allgather(states.pose, tiled=True)
    n_acc = multihost_utils.process_allgather(states.n_accept, tiled=True)
    out["chains_pose"] = np.asarray(pose).tolist()
    out["chains_accept"] = np.asarray(n_acc).tolist()

    # 2) parallel tempering with cross-process replica exchange (ppermute
    #    over the global mesh — boundary swaps cross the process boundary)
    tstates, swaps = run_tempered(
        key, pose0, scene, SamplerConfig(iterations=0, n_chains=8), mesh,
        n_replicas=8, exchange_every=2, rounds=4,
    )
    tpose = multihost_utils.process_allgather(tstates.pose, tiled=True)
    out["temper_pose"] = np.asarray(tpose).tolist()
    out["temper_swaps"] = np.asarray(swaps).tolist()

    # 3) annealed SMC with cross-process resampling (all_gather)
    sstates, diag = run_smc(
        key, pose0, scene, SamplerConfig(iterations=0, n_chains=8), mesh,
        n_particles=8, n_stages=3, mutate_steps=2,
    )
    spose = multihost_utils.process_allgather(sstates.pose, tiled=True)
    out["smc_pose"] = np.asarray(spose).tolist()
    out["smc_log_evidence"] = float(np.asarray(diag["log_evidence"]))

    if pid == 0:
        print("RESULT " + json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
