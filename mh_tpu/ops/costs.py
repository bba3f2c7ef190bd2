"""The layout objective: seven masked, vectorized cost terms + aggregator.

Vectorized re-design of the reference cost library (SURVEY.md C4/C5,
``Kernel.cu:191-564``). Each term is a pure function of
``(pose f32[N,6], Scene)`` returning the *raw* (unweighted) error <= 0,
written as masked tensor expressions: the O(N^2) terms (symmetry,
off-limits) evaluate full N x N matrices via broadcasting so XLA fuses the
whole objective into a handful of elementwise kernels — no per-object loops, no
dynamic shapes, trivially batchable over chains with ``vmap``.

``cost_terms`` applies the Surface weights and aggregates exactly like the
reference ``Costs`` (``Kernel.cu:516-550``), including its parity quirks
(PairWise x PairWiseAngle product ``:518``; OffLimits weighted but excluded
from the total ``:547``) — see :class:`mh_tpu.config.CostMode`.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp

# Debug-only term ablation for the XLA engines:
# MH_XLA_SKIP=sym,rel,... zeroes those terms at trace time so
# benchmarks/xla_ablation.py can price each term's share of the step.
# NEVER set in production — totals become wrong by construction.
_XLA_SKIP = os.environ.get("MH_XLA_SKIP", "")

from mh_tpu.config import CostMode
from mh_tpu.models.scene import Scene
from mh_tpu.ops import geometry as geo

Array = jax.Array

_NEG_HUGE = -1e30


def _static_zero(v) -> bool:
    """True iff ``v`` is a trace-time constant equal to 0.0."""
    try:
        return abs(float(v)) == 0.0
    except Exception:  # noqa: BLE001 — tracers refuse concretization
        return False


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CostBreakdown:
    """Weighted per-term costs + total (mirrors ``resultCosts``, Kernel.cu:134-144).

    Unlike the reference — whose per-chain cost writeback is commented out so
    the API returns garbage (``Kernel.cu:852-861``) — these are real values
    returned to the caller.
    """

    total: Array
    pair_wise: Array
    visual_balance: Array
    focal_point: Array
    symmetry: Array
    clearance: Array
    off_limits: Array
    surface_area: Array

    def as_vector(self) -> Array:
        return jnp.stack(
            [
                self.total,
                self.pair_wise,
                self.visual_balance,
                self.focal_point,
                self.symmetry,
                self.clearance,
                self.off_limits,
                self.surface_area,
            ],
            axis=-1,
        )


def pair_wise_costs(pose: Array, scene: Scene) -> Array:
    """Distance-relationship penalty (``Kernel.cu:210-233``).

    d < lo: -(d/lo)^2; d > hi: -(hi/d)^2; in range: 0.
    """
    sx, sy = pose[scene.rel_src, 0], pose[scene.rel_src, 1]
    tx, ty = pose[scene.rel_tgt, 0], pose[scene.rel_tgt, 1]
    d = geo.distance(sx, sy, tx, ty)
    lo = jnp.where(scene.rel_lo > 0, scene.rel_lo, 1.0)
    d_safe = jnp.where(d > 0, d, 1.0)
    near = -jnp.square(d / lo)
    far = -jnp.square(scene.rel_hi / d_safe)
    pen = jnp.where(d < scene.rel_lo, near, jnp.where(d > scene.rel_hi, far, 0.0))
    return jnp.sum(pen * scene.rel_mask)


def pair_wise_angle_costs(pose: Array, scene: Scene, mode: CostMode) -> Array:
    """Angle-relationship penalty (``Kernel.cu:236-263``).

    theta = bearing source->target re-oriented by the *target*'s rotY
    (``Kernel.cu:243``). Two regimes:

    - zero-crossing range (amin > amax, ``:245-250``): penalize when
      ``fmod(amin + theta, 2*pi) > amax`` with norm (amin - amax)/2;
    - plain range (``:251-254``): the reference's outside-range test uses
      ``||`` (amin < theta OR theta < amax) which is almost always true —
      parity mode keeps that; fixed mode penalizes only genuinely outside
      [amin, amax].
    """
    pi = mode.pi
    sx, sy = pose[scene.ang_src, 0], pose[scene.ang_src, 1]
    tx, ty = pose[scene.ang_tgt, 0], pose[scene.ang_tgt, 1]
    trot = pose[scene.ang_tgt, 4]
    th = geo.theta(sx, sy, tx, ty, trot, pi)

    amin, amax = scene.ang_min, scene.ang_max
    dev = jnp.minimum(jnp.abs(th - amin), jnp.abs(th - amax))

    wrap_case = amin > amax
    norm_wrap = jnp.where(wrap_case, (amin - amax) / 2.0, 1.0)
    cond_wrap = jnp.mod(amin + th, 2 * pi) > amax

    norm_plain_raw = (2 * pi - (amax - amin)) / 2.0
    norm_plain = jnp.where(norm_plain_raw != 0, norm_plain_raw, 1.0)
    if mode is CostMode.PARITY:
        cond_plain = (amin < th) | (th < amax)  # Kernel.cu:251 — quirky OR
    else:
        cond_plain = (th < amin) | (th > amax)

    pen = jnp.where(
        wrap_case,
        jnp.where(cond_wrap, -dev / norm_wrap, 0.0),
        jnp.where(cond_plain, -dev / norm_plain, 0.0),
    )
    return jnp.sum(pen * scene.ang_mask)


def visual_balance_costs(pose: Array, scene: Scene) -> Array:
    """Area-weighted centroid vs half-centroid (``Kernel.cu:191-207``)."""
    area = scene.sizes[:, 0] * scene.sizes[:, 1] * scene.obj_mask
    denom = jnp.sum(area)
    denom = jnp.where(denom > 0, denom, 1.0)
    nx = jnp.sum(area * pose[:, 0]) / denom
    ny = jnp.sum(area * pose[:, 1]) / denom
    return -geo.distance(nx, ny, scene.centroid[0] / 2.0, scene.centroid[1] / 2.0)


def focal_point_costs(pose: Array, scene: Scene, mode: CostMode) -> Array:
    """Sum of -cos(phi) toward the focal point (``Kernel.cu:266-281``)."""
    ph = geo.phi(
        scene.focal[0], scene.focal[1], pose[:, 0], pose[:, 1], pose[:, 4], mode.pi
    )
    return jnp.sum(-jnp.cos(ph) * scene.obj_mask)


def symmetry_costs(pose: Array, scene: Scene, mode: CostMode) -> Array:
    """Best-match reflection symmetry score (``Kernel.cu:283-318``).

    Each object i is reflected across the axis through the focal point with
    direction (cos focal_rot, sin focal_rot); its best match over j maximizes
    ``5 - sqrt(dist) - 0.4*|drot|`` with a floor at 0 (maxVal initialized to
    0, ``Kernel.cu:288``); the term is -sum of best matches. Vectorized as
    one N x N matrix with padded j rows masked to -inf before the row max.
    """
    pi = mode.pi
    x, y, rot = pose[:, 0], pose[:, 1], pose[:, 4]
    ux = jnp.cos(scene.focal_rot)
    uy = jnp.sin(scene.focal_rot)
    s = 2.0 * (scene.focal[0] * ux + scene.focal[1] * uy - (x * ux + y * uy))
    rx = x + s * ux
    ry = y + s * uy
    rrot = 2.0 * scene.focal_rot - rot
    rrot = jnp.where(rrot < -pi, rrot + 2 * pi, rrot)

    # [i, j] matrices: reflection of i vs candidate j
    dp = geo.distance(x[None, :], y[None, :], rx[:, None], ry[:, None])
    dt = rot[None, :] - rrot[:, None]
    dt = jnp.where(dt > pi, dt - 2 * pi, dt)
    val = 5.0 - jnp.sqrt(dp) - 0.4 * jnp.abs(dt)
    val = jnp.where(scene.obj_mask[None, :] > 0, val, _NEG_HUGE)
    best = jnp.maximum(jnp.max(val, axis=1), 0.0)
    return -jnp.sum(best * scene.obj_mask)


def _obj_aabbs(pose: Array, scene: Scene, mode: CostMode):
    """Per-object off-limits AABBs translated by each object's position."""
    return scene.off_rects.aabb(pose[:, 0], pose[:, 1], mode)


def clearance_costs(pose: Array, scene: Scene, mode: CostMode) -> Array:
    """Clearance-vs-off-limits overlap (``Kernel.cu:404-434``).

    Clearance rect c is translated by its *source object*'s position
    (``clearances[i].SourceIndex``, ``Kernel.cu:414-415``); compared against
    every object's off-limits AABB as a C x N area matrix.
    """
    cmnx, cmny, cmxx, cmxy = scene.clr_rects.aabb(
        pose[scene.clr_src, 0], pose[scene.clr_src, 1], mode
    )
    omnx, omny, omxx, omxy = _obj_aabbs(pose, scene, mode)
    area = geo.intersection_area(
        cmnx[:, None], cmny[:, None], cmxx[:, None], cmxy[:, None],
        omnx[None, :], omny[None, :], omxx[None, :], omxy[None, :],
    )
    return -jnp.sum(area * scene.clr_mask[:, None] * scene.obj_mask[None, :])


def off_limits_costs(pose: Array, scene: Scene, mode: CostMode) -> Array:
    """Pairwise (i < j) off-limits AABB overlap (``Kernel.cu:485-514``)."""
    mnx, mny, mxx, mxy = _obj_aabbs(pose, scene, mode)
    area = geo.intersection_area(
        mnx[:, None], mny[:, None], mxx[:, None], mxy[:, None],
        mnx[None, :], mny[None, :], mxx[None, :], mxy[None, :],
    )
    n = pose.shape[0]
    upper = jnp.triu(jnp.ones((n, n), area.dtype), k=1)
    return -jnp.sum(area * upper * scene.obj_mask[:, None] * scene.obj_mask[None, :])


def surface_area_costs(pose: Array, scene: Scene, mode: CostMode) -> Array:
    """Out-of-surface area of clearance + off-limits rects (``Kernel.cu:437-483``).

    Parity quirk: clearance rect i is translated by ``cfg[i]`` — the *loop
    index*, not its SourceIndex (``Kernel.cu:456``), inconsistent with
    ClearanceCosts; fixed mode uses SourceIndex.
    """
    smnx, smny, smxx, smxy = scene.surface_bounds()
    if mode is CostMode.PARITY:
        n = scene.n_pad_objs
        idx = jnp.minimum(jnp.arange(scene.clr_src.shape[0]), n - 1)
    else:
        idx = scene.clr_src
    cmnx, cmny, cmxx, cmxy = scene.clr_rects.aabb(pose[idx, 0], pose[idx, 1], mode)
    clr_out = geo.outside_surface_area(cmnx, cmny, cmxx, cmxy, smnx, smny, smxx, smxy)

    omnx, omny, omxx, omxy = _obj_aabbs(pose, scene, mode)
    obj_out = geo.outside_surface_area(omnx, omny, omxx, omxy, smnx, smny, smxx, smxy)

    return -(
        jnp.sum(clr_out * scene.clr_mask) + jnp.sum(obj_out * scene.obj_mask)
    )


def cost_terms(
    pose: Array,
    scene: Scene,
    mode: CostMode = CostMode.PARITY,
    skip_unused_offlimits: bool = False,
) -> CostBreakdown:
    """Weighted breakdown + total — the ``Costs`` aggregator (``Kernel.cu:516-550``).

    Parity: weighted pair term = w_pairwise * (PairWise * PairWiseAngle)
    (product, ``:518``); total excludes OffLimits (``:547``).
    Fixed: pair term = w_pairwise * (PairWise + PairWiseAngle); total
    includes OffLimits.

    ``skip_unused_offlimits``: in PARITY mode OffLimits never enters the
    total, so the MH hot loop can skip its O(N^2) matrix entirely (the
    breakdown then reports 0 for it; callers recompute it once on the final
    pose for faithful reporting). No-op in FIXED mode.
    """
    zero = jnp.float32(0.0)
    if "rel" in _XLA_SKIP:
        pair = zero
    else:
        pw = pair_wise_costs(pose, scene)
        pwa = pair_wise_angle_costs(pose, scene, mode)
        if mode is CostMode.PARITY:
            pair = scene.w_pairwise * (pw * pwa)
        else:
            pair = scene.w_pairwise * (pw + pwa)
    vb = (
        zero if "vb" in _XLA_SKIP
        else scene.w_visual_balance * visual_balance_costs(pose, scene)
    )
    fp = (
        zero if "fp" in _XLA_SKIP
        else scene.w_focal * focal_point_costs(pose, scene, mode)
    )
    sym = (
        zero if "sym" in _XLA_SKIP
        else scene.w_symmetry * symmetry_costs(pose, scene, mode)
    )
    if (
        (skip_unused_offlimits and mode is CostMode.PARITY)
        or ("off" in _XLA_SKIP)
        or (skip_unused_offlimits and _static_zero(scene.w_offlimits))
    ):
        # Third case: FIXED mode with a PROVABLY zero off-limits weight
        # (only decidable when the scene is a trace-time constant — the
        # scene-specialized scan; traced scenes keep the term). The
        # weighted term is identically 0, so skipping the O(N^2) matrix
        # is exact.
        off = zero
    else:
        off = scene.w_offlimits * off_limits_costs(pose, scene, mode)
    clr = (
        zero if "clr" in _XLA_SKIP
        else scene.w_clearance * clearance_costs(pose, scene, mode)
    )
    sa = (
        zero if "sa" in _XLA_SKIP
        else scene.w_surface_area * surface_area_costs(pose, scene, mode)
    )
    total = pair + vb + fp + sym + clr + sa
    if mode is CostMode.FIXED:
        total = total + off
    return CostBreakdown(
        total=total,
        pair_wise=pair,
        visual_balance=vb,
        focal_point=fp,
        symmetry=sym,
        clearance=clr,
        off_limits=off,
        surface_area=sa,
    )


def total_cost(pose: Array, scene: Scene, mode: CostMode = CostMode.PARITY) -> Array:
    """Scalar objective — the quantity the Boltzmann rule compares (``Kernel.cu:712``)."""
    return cost_terms(pose, scene, mode).total
