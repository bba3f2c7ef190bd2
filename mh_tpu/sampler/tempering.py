"""Parallel tempering: a replica ladder with ppermute exchange across devices.

A capability the reference lacks entirely (its chains never communicate —
SURVEY.md §2.4): K replicas sample the layout objective at an ascending
inverse-temperature ladder ``betas`` (last entry = target temperature, e.g.
the reference's BETA=2, ``Kernel.cu:33``); every ``exchange_every`` MH steps
neighboring replicas attempt a configuration swap with probability
``min(1, exp((beta_i - beta_j) * (S_j - S_i)))`` — the standard
detailed-balance-preserving exchange for stationary densities
``exp(beta_g * S)``.

The ladder is sharded over the mesh chains axis: each device holds a
contiguous block of replicas, intra-block pairs swap locally, and the two
block-boundary replicas travel between devices via ``jax.lax.ppermute``. Swap
decisions are derived from a key folded with the *global* pair index, so
both sides of a boundary pair compute the identical decision without any
extra synchronization.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mh_tpu.config import SamplerConfig
from mh_tpu.models.scene import Scene
from mh_tpu.parallel.mesh import CHAINS_AXIS, to_varying
from mh_tpu.sampler.mh import finalize_costs, mh_init, mh_step

Array = jax.Array


def geometric_ladder(n: int, beta_min: float, beta_max: float) -> Array:
    """Geometric inverse-temperature ladder, ascending to the target beta."""
    return jnp.asarray(
        beta_min * (beta_max / beta_min) ** (jnp.arange(n) / max(n - 1, 1)),
        jnp.float32,
    )


@partial(jax.jit, static_argnames=(
    "cfg", "mesh", "n_replicas", "exchange_every", "rounds", "adapt_ladder"
))
def run_tempered(
    key: Array,
    pose0: Array,
    scene: Scene,
    cfg: SamplerConfig,
    mesh: Mesh,
    n_replicas: int,
    betas: Array | None = None,
    exchange_every: int = 5,
    rounds: int = 20,
    adapt_ladder: bool = False,
    target_swap: float = 0.234,
):
    """Run a sharded parallel-tempering ensemble (BASELINE config 5).

    Returns ``(states [n_replicas,...], swap_rate_trace f32[rounds])``; with
    ``adapt_ladder=True``, ``(states, swap_rate_trace, betas f32[K])``. The
    target-temperature sample is the last replica (``betas[-1]``).

    ``adapt_ladder``: stochastic-approximation ladder adaptation in the
    style of Miasojedow–Moulines–Vihola (arXiv:1205.1076): the top
    (target) beta stays pinned, and each log-beta gap ``g_k`` drifts by
    ``gamma_t * (accept_k - target_swap)`` toward the uniform-swap-rate
    ladder (``target_swap`` = 0.234, their asymptotically optimal rate).
    Per-pair accept indicators are ``psum``-shared so every device updates
    the identical replicated ladder — no extra synchronization.
    """
    n_dev = mesh.shape[CHAINS_AXIS]
    if n_replicas % n_dev:
        raise ValueError(f"n_replicas={n_replicas} not divisible by mesh {n_dev}")
    n_local = n_replicas // n_dev
    if betas is None:
        betas = geometric_ladder(n_replicas, 0.1, cfg.beta)
    betas = jnp.asarray(betas, jnp.float32)

    right_perm = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    left_perm = [(i, (i - 1) % n_dev) for i in range(n_dev)]

    def device_fn(scene_rep: Scene, pose0_rep: Array, betas_rep: Array):
        # ladder math stays on the replicated input so the adapted betas
        # output is statically known replicated (rho0 -> rho -> betas_now
        # only ever mixes with psum'd values and the round counter)
        log_bmax = jnp.log(betas_rep[-1])
        rho0 = jnp.log(jnp.diff(jnp.log(betas_rep)))  # [K-1] log gaps
        scene_rep, pose0_rep, betas_rep = to_varying(
            (scene_rep, pose0_rep, betas_rep)
        )
        dev = jax.lax.axis_index(CHAINS_AXIS)
        offset = dev * n_local
        gids = offset + jnp.arange(n_local)
        keys = jax.vmap(lambda g: jax.random.fold_in(key, g))(gids)
        p0 = jnp.broadcast_to(pose0_rep, (n_local, *pose0_rep.shape))
        states = to_varying(
            jax.vmap(lambda k, p: mh_init(p, scene_rep, k, cfg.mode))(keys, p0)
        )

        def mh_sweep(states, local_betas):
            def one(s, b):
                def body(ss, _):
                    return mh_step(ss, scene_rep, cfg, beta=b), None

                s, _ = jax.lax.scan(body, s, None, length=exchange_every)
                return s

            return jax.vmap(one)(states, local_betas)

        def exchange(states, rnd, betas_now):
            """Alternating even/odd neighbor swaps; boundaries cross devices."""
            phase = rnd % 2
            poses = states.pose  # [L,N,6]
            cvec = states.costs.as_vector()  # [L,8]

            # boundary transport: my last replica -> right neighbor,
            # my first replica -> left neighbor (cyclic; validity by gid).
            send_right = (poses[-1], cvec[-1])
            send_left = (poses[0], cvec[0])
            left_last = jax.tree.map(
                lambda x: jax.lax.ppermute(x, CHAINS_AXIS, right_perm), send_right
            )
            right_first = jax.tree.map(
                lambda x: jax.lax.ppermute(x, CHAINS_AXIS, left_perm), send_left
            )

            # extended arrays: index l+1 == local replica l
            poses_ext = jnp.concatenate(
                [left_last[0][None], poses, right_first[0][None]], axis=0
            )
            cvec_ext = jnp.concatenate(
                [left_last[1][None], cvec, right_first[1][None]], axis=0
            )

            lids = jnp.arange(n_local)
            g = offset + lids
            is_lower = (g % 2) == phase  # pair (g, g+1), I'm the lower half
            partner_g = jnp.where(is_lower, g + 1, g - 1)
            partner_ext = jnp.where(is_lower, lids + 2, lids)  # ext indexing
            valid = (partner_g >= 0) & (partner_g < n_replicas)
            partner_ext = jnp.clip(partner_ext, 0, n_local + 1)

            my_s = cvec[:, 0]
            their_s = cvec_ext[partner_ext, 0]
            my_b = betas_now[gids]
            their_b = betas_now[jnp.clip(partner_g, 0, n_replicas - 1)]

            pair_id = jnp.minimum(g, partner_g)
            u = jax.vmap(
                lambda pid: jax.random.uniform(
                    jax.random.fold_in(jax.random.fold_in(key, 0x7E3), rnd * n_replicas + pid)
                )
            )(pair_id)
            log_ratio = (my_b - their_b) * (their_s - my_s)
            accept = valid & (u < jnp.exp(jnp.minimum(log_ratio, 0.0)))

            new_poses = jnp.where(accept[:, None, None], poses_ext[partner_ext], poses)
            new_cvec = jnp.where(accept[:, None], cvec_ext[partner_ext], cvec)

            costs = dataclasses.replace(
                states.costs,
                total=new_cvec[:, 0],
                pair_wise=new_cvec[:, 1],
                visual_balance=new_cvec[:, 2],
                focal_point=new_cvec[:, 3],
                symmetry=new_cvec[:, 4],
                clearance=new_cvec[:, 5],
                off_limits=new_cvec[:, 6],
                surface_area=new_cvec[:, 7],
            )
            states = dataclasses.replace(states, pose=new_poses, costs=costs)
            # count each accepted pair once (lower member)
            own_pair = valid & is_lower
            n_swapped = jnp.sum((accept & own_pair).astype(jnp.float32))
            n_attempts = jnp.sum(own_pair.astype(jnp.float32))
            if adapt_ladder:
                # per-pair indicators, scattered into [K-1] by pair id g
                pair_oh = (
                    g[:, None] == jnp.arange(n_replicas - 1)[None, :]
                ).astype(jnp.float32)
                acc_vec = jnp.sum(
                    pair_oh * (accept & own_pair).astype(jnp.float32)[:, None],
                    axis=0,
                )
                att_vec = jnp.sum(
                    pair_oh * own_pair.astype(jnp.float32)[:, None], axis=0
                )
            else:
                acc_vec = att_vec = jnp.zeros((), jnp.float32)
            return states, n_swapped, n_attempts, acc_vec, att_vec

        def betas_from_rho(rho):
            # suffix-sum the positive gaps down from the pinned target beta
            gaps = jnp.exp(rho)
            suffix = jnp.cumsum(gaps[::-1])[::-1]
            return jnp.exp(
                jnp.concatenate([log_bmax - suffix, log_bmax[None]])
            )

        def round_body(carry, rnd):
            states, rho = carry
            betas_now = betas_from_rho(rho) if adapt_ladder else betas_rep
            states = mh_sweep(states, betas_now[gids])
            states, n_sw, n_at, acc_vec, att_vec = exchange(
                states, rnd, betas_now
            )
            g_sw = jax.lax.psum(n_sw, CHAINS_AXIS)
            g_at = jax.lax.psum(n_at, CHAINS_AXIS)
            if adapt_ladder:
                acc_g = jax.lax.psum(acc_vec, CHAINS_AXIS)
                att_g = jax.lax.psum(att_vec, CHAINS_AXIS)
                # Robbins-Monro on the log gaps: attempted pairs drift
                # toward the target swap rate (unattempted terms are 0)
                gamma = 0.5 / (1.0 + rnd.astype(jnp.float32)) ** 0.6
                rho = rho + gamma * (acc_g - target_swap * att_g)
            return (states, rho), g_sw / jnp.maximum(g_at, 1.0)

        (states, rho), swap_rates = jax.lax.scan(
            round_body, (states, rho0), jnp.arange(rounds)
        )
        states = jax.vmap(lambda s: finalize_costs(s, scene_rep, cfg))(states)
        if adapt_ladder:
            return states, swap_rates, betas_from_rho(rho)
        return states, swap_rates

    out_specs = (
        (P(CHAINS_AXIS), P(), P()) if adapt_ladder else (P(CHAINS_AXIS), P())
    )
    sharded = jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=out_specs,
    )
    return sharded(scene, pose0, betas)
