"""Multi-host (multi-process) distributed execution tests.

BASELINE config 5 asks for tempering + SMC with replica exchange across
>=2 hosts. Real hosts aren't available in CI, so these tests emulate them
faithfully: 2 OS processes, each owning 2 virtual CPU devices, coordinated
by ``jax.distributed`` over gRPC/Gloo — the same control plane and
cross-process collective path ("DCN") a multi-host pod uses. The assertion
is strong: every result must be BITWISE identical to a single-process run
on the same global device count (process-count invariance), which holds
because chain/replica keys fold from global indices.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _clean_env() -> dict:
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    return env


@pytest.fixture(scope="module")
def two_process_result():
    port = _free_port()
    env = _clean_env()
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=600))
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate())
    for p, (so, se) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\nstdout:{so}\nstderr:{se[-3000:]}"
    line = next(
        ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT ")
    )
    return json.loads(line[len("RESULT "):])


def _single_process_reference():
    """Same programs on a 4-device single-process mesh (this test process
    has 8 virtual devices; use the first 4 to match the workers' global
    device count)."""
    import jax
    from jax.sharding import Mesh

    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.parallel.mesh import CHAINS_AXIS
    from mh_tpu.parallel.sharded import run_chains_sharded
    from mh_tpu.sampler.smc import run_smc
    from mh_tpu.sampler.tempering import run_tempered

    mesh = Mesh(np.array(jax.devices()[:4]), (CHAINS_AXIS,))
    spec = demo_scene(8)
    scene = spec.build()
    pose0 = spec.initial_pose()
    key = jax.random.key(0)

    states = run_chains_sharded(
        key, pose0, scene, SamplerConfig(iterations=20, n_chains=8), mesh
    )
    tstates, swaps = run_tempered(
        key, pose0, scene, SamplerConfig(iterations=0, n_chains=8), mesh,
        n_replicas=8, exchange_every=2, rounds=4,
    )
    sstates, diag = run_smc(
        key, pose0, scene, SamplerConfig(iterations=0, n_chains=8), mesh,
        n_particles=8, n_stages=3, mutate_steps=2,
    )
    return {
        "chains_pose": np.asarray(states.pose),
        "chains_accept": np.asarray(states.n_accept),
        "temper_pose": np.asarray(tstates.pose),
        "temper_swaps": np.asarray(swaps),
        "smc_pose": np.asarray(sstates.pose),
        "smc_log_evidence": float(np.asarray(diag["log_evidence"])),
    }


def test_two_process_chains_bitwise_match(two_process_result):
    ref = _single_process_reference()
    got = np.asarray(two_process_result["chains_pose"], np.float32)
    np.testing.assert_array_equal(got, ref["chains_pose"])
    np.testing.assert_array_equal(
        np.asarray(two_process_result["chains_accept"]), ref["chains_accept"]
    )


def test_two_process_tempering_bitwise_match(two_process_result):
    ref = _single_process_reference()
    np.testing.assert_array_equal(
        np.asarray(two_process_result["temper_pose"], np.float32),
        ref["temper_pose"],
    )
    np.testing.assert_allclose(
        np.asarray(two_process_result["temper_swaps"]), ref["temper_swaps"]
    )


def test_two_process_smc_bitwise_match(two_process_result):
    ref = _single_process_reference()
    np.testing.assert_array_equal(
        np.asarray(two_process_result["smc_pose"], np.float32), ref["smc_pose"]
    )
    np.testing.assert_allclose(
        two_process_result["smc_log_evidence"], ref["smc_log_evidence"],
        rtol=1e-6,
    )
