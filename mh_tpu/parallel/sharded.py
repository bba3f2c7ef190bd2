"""Sharded chain execution over the device mesh.

The idiomatic JAX mapping of the reference's grid-of-blocks (SURVEY.md
§2.4): each device runs a vmapped batch of chains; the chains axis is
sharded over the mesh; the scene is replicated. Independent chains are
the single-device program partitioned by XLA; the collective samplers
use ``jax.shard_map``.
Collective acceptance-rate adaptation shares one step-size scale across
*all* chains on all devices via ``psum`` — communication the reference has
no equivalent of (its blocks never talk, ``Kernel.cu:754-871``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mh_tpu.config import SamplerConfig
from mh_tpu.models.scene import Scene
from mh_tpu.sampler.mh import (
    MHState,
    _chains_impl,
    _continue_impl,
    _strip_iterations,
    finalize_costs,
    mh_init,
    mh_step,
)
from mh_tpu.parallel.mesh import CHAINS_AXIS, to_varying as _varying

Array = jax.Array


def _check_divisible(cfg: SamplerConfig, mesh: Mesh) -> None:
    n_dev = mesh.shape[CHAINS_AXIS]
    if cfg.n_chains % n_dev:
        raise ValueError(f"n_chains={cfg.n_chains} not divisible by mesh size {n_dev}")


def _partitioned_chains(mesh: Mesh) -> NamedSharding:
    """Chains split over ``mesh``, on a copy of it whose axes XLA's
    partitioner places (a mesh from ``jax.make_mesh`` has explicit axes)."""
    return NamedSharding(Mesh(mesh.devices, mesh.axis_names), P(CHAINS_AXIS))


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _run_chains_sharded_jit(key, pose0, scene, n_steps, cfg, mesh):
    chains = _partitioned_chains(mesh)
    states, _ = _chains_impl(key, pose0, scene, n_steps, cfg, sharding=chains)
    return jax.lax.with_sharding_constraint(states, chains)


def run_chains_sharded(
    key: Array,
    pose0: Array,
    scene: Scene,
    cfg: SamplerConfig,
    mesh: Mesh,
) -> MHState:
    """``cfg.n_chains`` independent chains sharded over ``mesh``'s chains axis.

    The single-device program (:func:`mh_tpu.sampler.mh.run_chains`) with
    its chains split over the devices by XLA's partitioner: per-chain keys
    fold from the *global* chain index and each device runs the same
    per-chain program, so results are bitwise identical at any device
    count. The iteration count is a runtime value (one compile per shape).
    """
    _check_divisible(cfg, mesh)
    return _run_chains_sharded_jit(
        key, pose0, scene, jnp.int32(cfg.iterations), _strip_iterations(cfg),
        mesh,
    )


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def _continue_chains_sharded_jit(states, scene, n_steps, cfg, mesh):
    chains = _partitioned_chains(mesh)
    states = _continue_impl(states, scene, n_steps, cfg, sharding=chains)
    return jax.lax.with_sharding_constraint(states, chains)


def continue_chains_sharded(
    states: MHState,
    scene: Scene,
    cfg: SamplerConfig,
    mesh: Mesh,
) -> MHState:
    """Continue mesh-sharded chains from an existing (sharded) state.

    The resume half of distributed checkpoint/resume: each device advances
    its local chains ``cfg.iterations`` steps from the restored state.
    Bitwise-identical to an uninterrupted :func:`run_chains_sharded` run of
    the combined length (per-step keys fold from carried state).
    """
    _check_divisible(cfg, mesh)
    return _continue_chains_sharded_jit(
        states, scene, jnp.int32(cfg.iterations), _strip_iterations(cfg), mesh,
    )


@partial(jax.jit, static_argnames=("cfg", "mesh", "rounds", "steps_per_round"))
def run_chains_collective(
    key: Array,
    pose0: Array,
    scene: Scene,
    cfg: SamplerConfig,
    mesh: Mesh,
    rounds: int = 10,
    steps_per_round: int = 10,
):
    """Chains with *collective* step-size adaptation (BASELINE config 4).

    Every round, each chain runs ``steps_per_round`` MH steps; the global
    acceptance rate is reduced with ``psum`` across the sharded chains axis
    and drives one shared Robbins-Monro step-size update applied to every
    chain. Returns ``(final MHState [n_chains,...], accept-rate trace
    f32[rounds], final shared log_scale)``.
    """
    _check_divisible(cfg, mesh)
    n_local = cfg.n_chains // mesh.shape[CHAINS_AXIS]

    def device_fn(scene_rep: Scene, pose0_rep: Array):
        scene_rep, pose0_rep = _varying((scene_rep, pose0_rep))
        dev = jax.lax.axis_index(CHAINS_AXIS)
        chain_ids = dev * n_local + jnp.arange(n_local)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(chain_ids)
        p0 = jnp.broadcast_to(pose0_rep, (n_local, *pose0_rep.shape))
        states = _varying(
            jax.vmap(lambda k, p: mh_init(p, scene_rep, k, cfg.mode))(keys, p0)
        )

        def round_body(carry, _):
            states, log_scale = carry
            states = dataclasses.replace(
                states,
                log_scale=_varying(jnp.full_like(states.log_scale, log_scale)),
            )
            acc_before = states.n_accept

            def steps(s):
                def body(ss, _):
                    return mh_step(ss, scene_rep, cfg), None

                s, _ = jax.lax.scan(body, s, None, length=steps_per_round)
                return s

            states = jax.vmap(steps)(states)
            local_acc = jnp.sum(states.n_accept - acc_before).astype(jnp.float32)
            global_acc = jax.lax.psum(local_acc, CHAINS_AXIS)
            rate = global_acc / (cfg.n_chains * steps_per_round)
            log_scale = log_scale + cfg.adapt_rate * (rate - cfg.target_accept)
            return (states, log_scale), rate

        (states, log_scale), rates = jax.lax.scan(
            round_body, (states, jnp.float32(0.0)), None, length=rounds
        )
        states = jax.vmap(lambda s: finalize_costs(s, scene_rep, cfg))(states)
        return states, rates, log_scale

    sharded = jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=(P(CHAINS_AXIS), P(), P()),
    )
    return sharded(scene, pose0)
