"""Incremental-cost MH: exact delta evaluation of the O(N^2) symmetry term.

The idiomatic version of the optimization the reference gestures at with
its intra-block parallelism (SURVEY.md §7.1 "incremental-cost
optimization"): a single-object move touches one row and one column of the
symmetry val matrix (``Kernel.cu:283-318``), so the chain carries the
matrix and per-row *group maxima* and updates only what changed:

- state: ``A f32[N,N]`` (val matrix for the current pose), ``gmax
  f32[N,G]`` (per-row max over G column groups of width N/G);
- per move (<= 2 objects): recompute rows {k1,k2} and columns {k1,k2} of A
  (O(N) each), re-reduce the <= 2 affected group slabs (O(N * N/G)) and the
  <= 2 affected gmax rows, then ``rowbest_i = max_g gmax[i,g]`` (O(N*G));
- total per step: O(N^1.5) at G ~ sqrt(N) instead of O(N^2).

Every stored entry is *recomputed from the current pose* when written —
never accumulated — so the state is exact at all times (verified against
the full evaluation in tests). Cheap terms (pairwise/visual/focal/
clearance/surface, all O(N) or smaller) are recomputed fully each step.

PARITY-mode semantics only for the accept total (OffLimits never enters
it); FIXED mode falls back to the full path.

Cost of this scheme: the carried ``[chains, N, N]`` matrix turns into
per-step scatter/select traffic over the whole matrix in device memory,
which at layout-scale N can exceed the O(N^2) arithmetic it saves. Its
speed on the GPU is not measured. The delta math here is exact and
test-validated — the reference for an O(N) kernel that keeps the state
on-chip, and for research use at small chain counts.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from mh_tpu.config import CostMode, SamplerConfig
from mh_tpu.models.scene import Scene
from mh_tpu.ops import costs as C
from mh_tpu.sampler.mh import boltzmann_accept
from mh_tpu.sampler.proposal import (
    _NEG_HUGE,
    _apply_swap,
    _rank_pick,
    _unfrozen_ranks,
    translation_sigmas,
    uniforms_per_move,
)
from mh_tpu.ops.geometry import wrap_angle_once

Array = jax.Array


# --- symmetry val-matrix pieces --------------------------------------------


def _refl(pose: Array, scene: Scene, pi: float):
    """Per-object reflection across the symmetry axis (``Kernel.cu:290-299``)."""
    x, y, rot = pose[:, 0], pose[:, 1], pose[:, 4]
    ux = jnp.cos(scene.focal_rot)
    uy = jnp.sin(scene.focal_rot)
    s = 2.0 * (scene.focal[0] * ux + scene.focal[1] * uy - (x * ux + y * uy))
    rx = x + s * ux
    ry = y + s * uy
    rrot = 2.0 * scene.focal_rot - rot
    rrot = jnp.where(rrot < -pi, rrot + 2 * pi, rrot)
    return rx, ry, rrot


def _val(rx_i, ry_i, rrot_i, xj, yj, rotj, maskj, pi):
    """val[i,j] = 5 - sqrt(dist(pos_j, refl_i)) - 0.4|wrap(rot_j - rrot_i)|."""
    dp = jnp.sqrt(jnp.square(xj - rx_i) + jnp.square(yj - ry_i))
    dt = rotj - rrot_i
    dt = jnp.where(dt > pi, dt - 2 * pi, dt)
    v = 5.0 - jnp.sqrt(dp) - 0.4 * jnp.abs(dt)
    return jnp.where(maskj > 0, v, _NEG_HUGE)


def full_val_matrix(pose: Array, scene: Scene, pi: float) -> Array:
    rx, ry, rrot = _refl(pose, scene, pi)
    return _val(
        rx[:, None], ry[:, None], rrot[:, None],
        pose[None, :, 0], pose[None, :, 1], pose[None, :, 4],
        scene.obj_mask[None, :], pi,
    )


def _group_max(a: Array, n_groups: int) -> Array:
    n = a.shape[-1]
    return jnp.max(a.reshape(*a.shape[:-1], n_groups, n // n_groups), axis=-1)


def _sym_from_gmax(gmax: Array, scene: Scene) -> Array:
    best = jnp.maximum(jnp.max(gmax, axis=1), 0.0)
    return -jnp.sum(best * scene.obj_mask)


# --- incremental chain state -----------------------------------------------


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class IncState:
    pose: Array  # f32[N,6]
    a_mat: Array  # f32[N,N] symmetry val matrix of the current pose
    gmax: Array  # f32[N,G]
    total: Array  # current accept total (parity)
    key: Array
    step: Array
    n_accept: Array


def _cheap_total(pose: Array, scene: Scene, mode: CostMode, sym_raw: Array) -> Array:
    """Total (parity) from the cheap terms + a given raw symmetry value."""
    pw = C.pair_wise_costs(pose, scene)
    pwa = C.pair_wise_angle_costs(pose, scene, mode)
    pair = scene.w_pairwise * (pw * pwa)
    vb = scene.w_visual_balance * C.visual_balance_costs(pose, scene)
    fp = scene.w_focal * C.focal_point_costs(pose, scene, mode)
    clr = scene.w_clearance * C.clearance_costs(pose, scene, mode)
    sa = scene.w_surface_area * C.surface_area_costs(pose, scene, mode)
    return pair + vb + fp + scene.w_symmetry * sym_raw + clr + sa


def inc_init(pose: Array, scene: Scene, key: Array, n_groups: int) -> IncState:
    pi = CostMode.PARITY.pi
    a = full_val_matrix(pose, scene, pi)
    gmax = _group_max(a, n_groups)
    total = _cheap_total(pose, scene, CostMode.PARITY, _sym_from_gmax(gmax, scene))
    return IncState(
        pose=pose, a_mat=a, gmax=gmax, total=total, key=key,
        step=jnp.int32(0), n_accept=jnp.int32(0),
    )


def _propose_with_info(u: Array, pose: Array, scene: Scene, cfg: SamplerConfig):
    """Single move + the (k1, k2) indices it touches (k2 == k1 unless swap)."""
    n = scene.n_pad_objs
    eps = 1e-7
    move = jnp.minimum((u[0] * 3.0).astype(jnp.int32), 2)
    r1 = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u[2], eps)))
    r2 = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u[4], eps)))
    two_pi = 2.0 * jnp.pi
    nrm0 = r1 * jnp.cos(two_pi * u[3])
    nrm1 = r1 * jnp.sin(two_pi * u[3])
    nrm2 = r2 * jnp.cos(two_pi * u[5])

    ok, rank, n_unf = _unfrozen_ranks(scene)
    sel1 = _rank_pick(u[6], ok, rank, n_unf)
    sel2 = _rank_pick(u[7], ok, rank, n_unf)
    idx = jnp.arange(n)
    i1 = jnp.argmax(sel1)
    i2 = jnp.argmax(sel2)

    x, y, rot = pose[:, 0], pose[:, 1], pose[:, 4]
    mnx, mny, mxx, mxy = scene.surface_bounds()
    sx, sy = translation_sigmas(scene, cfg)
    is_t = (move == 0).astype(jnp.float32)
    is_r = (move == 1).astype(jnp.float32)
    is_s = move == 2
    w_t = is_t * sel1
    new_x = x + w_t * (jnp.clip(x + nrm0 * sx, mnx, mxx) - x)
    new_y = y + w_t * (jnp.clip(y + nrm1 * sy, mny, mxy) - y)
    wrapped = wrap_angle_once(rot + nrm2 * cfg.sigma_t, cfg.mode.pi)
    new_rot = rot + (is_r * sel1) * (wrapped - rot)
    star = pose.at[:, 0].set(new_x).at[:, 1].set(new_y).at[:, 4].set(new_rot)
    star = _apply_swap(star, scene, is_s, sel1, sel2)
    star = jnp.where(n_unf > 0, star, pose)
    k2 = jnp.where(is_s, i2, i1)
    return star, i1, k2


def inc_step(
    state: IncState, scene: Scene, cfg: SamplerConfig, n_groups: int
) -> IncState:
    pi = CostMode.PARITY.pi
    n = scene.n_pad_objs
    w = n // n_groups
    key_step = jax.random.fold_in(state.key, state.step)
    k_prop, k_acc = jax.random.split(key_step)
    u = jax.random.uniform(k_prop, (uniforms_per_move(),))
    star, k1, k2 = _propose_with_info(u, state.pose, scene, cfg)

    # --- delta-update the symmetry matrix for the candidate ---------------
    rx, ry, rrot = _refl(star, scene, pi)
    xj, yj, rotj = star[:, 0], star[:, 1], star[:, 4]

    def touched_row(k):
        return _val(rx[k], ry[k], rrot[k], xj, yj, rotj, scene.obj_mask, pi)

    def touched_col(k):
        return _val(rx, ry, rrot, xj[k], yj[k], rotj[k], scene.obj_mask[k], pi)

    a = state.a_mat
    a = jax.lax.dynamic_update_slice(a, touched_row(k1)[None, :], (k1, 0))
    a = jax.lax.dynamic_update_slice(a, touched_row(k2)[None, :], (k2, 0))
    a = jax.lax.dynamic_update_slice(a, touched_col(k1)[:, None], (0, k1))
    a = jax.lax.dynamic_update_slice(a, touched_col(k2)[:, None], (0, k2))
    # corners: row formulas win (identical values; rewrite for exactness)
    a = a.at[k1, k1].set(_val(rx[k1], ry[k1], rrot[k1], xj[k1], yj[k1],
                              rotj[k1], scene.obj_mask[k1], pi))
    a = a.at[k1, k2].set(_val(rx[k1], ry[k1], rrot[k1], xj[k2], yj[k2],
                              rotj[k2], scene.obj_mask[k2], pi))
    a = a.at[k2, k1].set(_val(rx[k2], ry[k2], rrot[k2], xj[k1], yj[k1],
                              rotj[k1], scene.obj_mask[k1], pi))
    a = a.at[k2, k2].set(_val(rx[k2], ry[k2], rrot[k2], xj[k2], yj[k2],
                              rotj[k2], scene.obj_mask[k2], pi))

    # group maxima: re-reduce the two touched column slabs + two touched rows
    gmax = state.gmax
    g1 = k1 // w
    g2 = k2 // w

    def slab_max(g):
        slab = jax.lax.dynamic_slice(a, (0, g * w), (n, w))
        return jnp.max(slab, axis=1)

    gmax = jax.lax.dynamic_update_slice(gmax, slab_max(g1)[:, None], (0, g1))
    gmax = jax.lax.dynamic_update_slice(gmax, slab_max(g2)[:, None], (0, g2))
    row_g1 = _group_max(jax.lax.dynamic_slice(a, (k1, 0), (1, n)), n_groups)
    row_g2 = _group_max(jax.lax.dynamic_slice(a, (k2, 0), (1, n)), n_groups)
    gmax = jax.lax.dynamic_update_slice(gmax, row_g1, (k1, 0))
    gmax = jax.lax.dynamic_update_slice(gmax, row_g2, (k2, 0))

    total_star = _cheap_total(star, scene, cfg.mode, _sym_from_gmax(gmax, scene))
    acc = boltzmann_accept(k_acc, total_star, state.total, cfg.beta)

    return IncState(
        pose=jnp.where(acc, star, state.pose),
        a_mat=jnp.where(acc, a, state.a_mat),
        gmax=jnp.where(acc, gmax, state.gmax),
        total=jnp.where(acc, total_star, state.total),
        key=state.key,
        step=state.step + 1,
        n_accept=state.n_accept + acc.astype(jnp.int32),
    )


@partial(jax.jit, static_argnames=("cfg", "n_groups", "trace_costs"))
def run_chains_incremental(
    key: Array,
    pose0: Array,
    scene: Scene,
    cfg: SamplerConfig,
    n_groups: int = 8,
    trace_costs: bool = False,
):
    """Vmapped incremental-symmetry chains (PARITY mode, single-move steps).

    Returns ``(IncState batch, cost trace | None)``. Statistically
    equivalent to :func:`mh_tpu.sampler.mh.run_chains` (same proposal and
    accept distributions; same threefry stream layout).
    """
    if cfg.mode is not CostMode.PARITY:
        raise ValueError("incremental path implements PARITY mode only")
    if cfg.n_moves_per_step != 1:
        raise ValueError("incremental path is single-move per step")
    if scene.n_pad_objs % n_groups:
        raise ValueError("padded object count must be divisible by n_groups")

    def one_chain(k, p):
        state = inc_init(p, scene, k, n_groups)

        def body(s, _):
            s = inc_step(s, scene, cfg, n_groups)
            return s, (s.total if trace_costs else None)

        return jax.lax.scan(body, state, None, length=cfg.iterations)

    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(cfg.n_chains))
    if pose0.ndim == 2:
        pose0 = jnp.broadcast_to(pose0, (cfg.n_chains, *pose0.shape))
    return jax.vmap(one_chain)(keys, pose0)
