"""Worker for the kill-and-resume recovery tests (test_recovery.py).

Three phases, selected by argv:

- ``full``   — run 2*R rounds of chains uninterrupted, print the digest.
- ``crash``  — run R rounds, checkpoint, then die via SIGKILL (a real
  uncatchable kill: no atexit, no buffers flushed afterwards).
- ``resume`` — restore the checkpoint, run the remaining R rounds, print
  the digest.

The test asserts digest(full) == digest(crash -> resume) BITWISE, which
holds because the per-step key folds from (chain key, step counter), both
carried in the checkpointed MHState.

Single-process usage:   recovery_worker.py <mode> <ckpt_path>
Distributed usage:      recovery_worker.py <mode> <ckpt_path> <pid> <nproc> <port>
(each emulated host owns 2 virtual CPU devices; chains shard over the
global mesh and each process checkpoints only its own rows)
"""

import hashlib
import json
import os
import signal
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=2")

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

ROUNDS = 3  # R rounds before the crash, R after
ROUND_ITERS = 10
N_CHAINS = 8


def digest(pose: np.ndarray, n_accept: np.ndarray, step: np.ndarray) -> dict:
    return {
        "pose_sha": hashlib.sha256(np.ascontiguousarray(pose).tobytes()).hexdigest(),
        "n_accept": np.asarray(n_accept).tolist(),
        "step": np.asarray(step).tolist(),
    }


def main() -> None:
    mode, path = sys.argv[1], sys.argv[2]
    distributed = len(sys.argv) > 3
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)

    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.sampler.mh import continue_chains, run_chains
    from mh_tpu.utils import checkpoint as ckpt

    if distributed:
        pid, nproc, port = int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
        from jax.sharding import PartitionSpec as P

        from mh_tpu.parallel.mesh import CHAINS_AXIS
        from mh_tpu.parallel.multihost import global_chain_mesh, initialize
        from mh_tpu.parallel.sharded import (
            continue_chains_sharded,
            run_chains_sharded,
        )

        initialize(f"127.0.0.1:{port}", nproc, pid)
        mesh = global_chain_mesh()
        spec_p = P(CHAINS_AXIS)
    else:
        pid = 0

    spec = demo_scene(8)
    scene = spec.build()
    pose0 = spec.initial_pose()
    key = jax.random.key(42)
    cfg = SamplerConfig(iterations=ROUND_ITERS, n_chains=N_CHAINS)

    def first_round():
        if distributed:
            return run_chains_sharded(key, pose0, scene, cfg, mesh)
        states, _ = run_chains(key, pose0, scene, cfg)
        return states

    def next_round(states):
        if distributed:
            return continue_chains_sharded(states, scene, cfg, mesh)
        return continue_chains(states, scene, cfg)

    def report(states):
        if distributed:
            from jax.experimental import multihost_utils

            pose = multihost_utils.process_allgather(states.pose, tiled=True)
            acc = multihost_utils.process_allgather(states.n_accept, tiled=True)
            stp = multihost_utils.process_allgather(states.step, tiled=True)
        else:
            pose, acc, stp = states.pose, states.n_accept, states.step
        if pid == 0:
            print("RESULT " + json.dumps(digest(
                np.asarray(pose), np.asarray(acc), np.asarray(stp)
            )), flush=True)

    if mode == "full":
        states = first_round()
        for _ in range(2 * ROUNDS - 1):
            states = next_round(states)
        report(states)
    elif mode == "crash":
        states = first_round()
        for _ in range(ROUNDS - 1):
            states = next_round(states)
        jax.block_until_ready(states.pose)
        if distributed:
            ckpt.save_local_shards(path, states)
            # barrier so every process has durably checkpointed before any
            # of them dies (otherwise the survivor can crash on the dropped
            # coordinator connection mid-save)
            from jax.experimental import multihost_utils

            multihost_utils.sync_global_devices("recovery_ckpt_done")
        else:
            ckpt.save_state(path, states)
        print("CHECKPOINTED", flush=True)
        # a real kill: no python-level cleanup runs after this
        os.kill(os.getpid(), signal.SIGKILL)
    elif mode == "resume":
        template = first_round()  # structure/shapes only; values replaced
        if distributed:
            states = ckpt.restore_local_shards(path, template, mesh, spec_p)
        else:
            states = ckpt.restore_state(path, template)
        for _ in range(ROUNDS):
            states = next_round(states)
        report(states)
    else:
        raise SystemExit(f"unknown mode {mode}")


if __name__ == "__main__":
    main()
