"""Multi-host initialization glue (``jax.distributed``) + pod meshes.

The reference is strictly single-process/single-GPU (SURVEY.md §3.5); this
module is the entry point for running the samplers across multiple
processes or hosts: call :func:`initialize` once per process before
any JAX computation, then build meshes over the *global* device set — every
sharded program in :mod:`mh_tpu.parallel` / :mod:`mh_tpu.sampler` already
folds chain keys from global indices, so results are identical at any
host count.

Recovery model (SURVEY.md §5): on failure, restart all processes, call
:func:`initialize` again, and restore the sampler state PyTree with
:mod:`mh_tpu.utils.checkpoint` — chains resume bitwise-deterministically.
"""

from __future__ import annotations

import os

import jax


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> None:
    """Initialize ``jax.distributed`` for multi-host runs.

    With no arguments, relies on the environment (the
    ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
    variables). Safe to call on single-host setups: it is a no-op when no
    coordination info is available.
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None:
        v = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(v) if v else None
    if process_id is None:
        v = os.environ.get("JAX_PROCESS_ID")
        process_id = int(v) if v else None

    if coordinator_address is None and num_processes in (None, 1):
        return  # single-host: nothing to coordinate

    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_chain_mesh(axis: str = "chains") -> jax.sharding.Mesh:
    """Mesh over all global devices (every host's chips), chains sharded.

    Chains ride the device interconnect within a host and the network
    across hosts; the collective traffic of adaptation/tempering/SMC is
    O(scalars) or O(boundary replicas), so network latency is amortized over steps_per_round.
    """
    return jax.make_mesh((jax.device_count(),), (axis,))
