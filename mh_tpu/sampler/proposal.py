"""Proposal moves: translate / rotate / swap (SURVEY.md C6, ``Kernel.cu:576-704``).

Functional re-design of the reference `propose`:

- Move type drawn uniformly from {translate, rotate, swap} (``Kernel.cu:582``).
- Translate: one random unfrozen object, per-axis N(0, (extent/16)^2) step
  (``Kernel.cu:590-591``), clamped to the surface bounds (the reference's
  snap-to-edge if/else chain ``:613-630`` is exactly a clamp).
- Rotate: rotY += N(0, S_SIGMA_T^2), wrapped once into [0, 2*pi]
  (``Kernel.cu:641-651``).
- Swap: two random unfrozen objects exchange their full pose (x,y,z,rotX,
  rotY,rotZ — sizes/frozen stay put, ``Kernel.cu:674-700``); no-op when the
  scene has < 2 objects (``:657``); the pair may coincide (``:660``).

Batched formulation: the whole proposal is **branch-free and
scatter-free** — object selection is an exact rank-pick over the masked
unfrozen set (one uniform; replaces the reference's potentially unbounded
re-draw spin, ``Kernel.cu:600-602``), translate/rotate are one-hot
arithmetic on the pose columns, and a swap reads its two rows with an
exact index gather and writes them with a select. This keeps the
per-step program a handful of fused elementwise ops, which is what makes
thousands of vmapped chains fast.

Compound block proposals — the deterministic equivalent of the reference's
64-threads-each-mutating-shared-state per iteration (``Kernel.cu:798``) —
apply K single-object moves sequentially via ``lax.scan``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mh_tpu.config import SamplerConfig
from mh_tpu.models.scene import Scene
from mh_tpu.ops.geometry import wrap_angle_once

Array = jax.Array

_NEG_HUGE = -1e30


def _unfrozen_logits(scene: Scene) -> Array:
    ok = scene.obj_mask * (1.0 - scene.frozen.astype(jnp.float32))
    return jnp.where(ok > 0, 0.0, _NEG_HUGE)


def pick_unfrozen(key: Array, scene: Scene) -> Array:
    """Uniform index over valid & unfrozen objects via Gumbel-argmax."""
    g = jax.random.gumbel(key, (scene.n_pad_objs,))
    return jnp.argmax(g + _unfrozen_logits(scene))


def _unfrozen_ranks(scene: Scene) -> tuple[Array, Array, Array]:
    """(ok f32[N], rank f32[N], n_unfrozen f32): 1-based rank of each
    unfrozen object among the unfrozen set. Scene-static — XLA hoists it
    out of the chain scan."""
    ok = scene.obj_mask * (1.0 - scene.frozen.astype(jnp.float32))
    rank = jnp.cumsum(ok)
    return ok, rank, rank[-1]


def _rank_pick(u: Array, ok: Array, rank: Array, n_unf: Array) -> Array:
    """One-hot uniform pick over the unfrozen set from ONE uniform.

    Distribution-identical to Gumbel-argmax but needs 1 uniform instead of
    N — at N=128 lanes this removes ~95% of the per-step threefry volume,
    the dominant non-objective cost of an MH step. ``target`` is the
    1-based rank of the chosen object; float equality on small integers is
    exact. All-zero when the scene has no unfrozen object (callers gate).
    """
    target = jnp.minimum(jnp.floor(u * n_unf), n_unf - 1.0) + 1.0
    return ok * (rank == target).astype(jnp.float32)


def translation_sigmas(scene: Scene, cfg: SamplerConfig) -> tuple[Array, Array]:
    """Per-axis proposal std = surface extent / 16 (``Kernel.cu:587-591``)."""
    mnx, mny, mxx, mxy = scene.surface_bounds()
    if cfg.sigma_xy_override > 0:
        s = jnp.float32(cfg.sigma_xy_override)
        return s, s
    return (mxx - mnx) / 16.0, (mxy - mny) / 16.0


def _apply_move(
    pose: Array,
    scene: Scene,
    cfg: SamplerConfig,
    scale: Array,
    move: Array,
    sel1: Array,
    sel2: Array,
    nrm: Array,
) -> Array:
    """Apply one move of type ``move`` in one-hot form (no scatter/gather).

    ``sel1``/``sel2``: f32[N] one-hot object selectors; ``nrm``: f32[3]
    standard normals for (dx, dy, dRot).
    """
    x, y, rot = pose[:, 0], pose[:, 1], pose[:, 4]
    mnx, mny, mxx, mxy = scene.surface_bounds()
    sx, sy = translation_sigmas(scene, cfg)

    is_t = (move == 0).astype(jnp.float32)
    is_r = (move == 1).astype(jnp.float32)
    is_s = move == 2

    # translate (clamp == the reference's snap-to-edge, Kernel.cu:613-630)
    dx = nrm[0] * sx * scale
    dy = nrm[1] * sy * scale
    w_t = is_t * sel1
    new_x = x + w_t * (jnp.clip(x + dx, mnx, mxx) - x)
    new_y = y + w_t * (jnp.clip(y + dy, mny, mxy) - y)

    # rotate (single conditional wrap, Kernel.cu:648-651)
    drot = nrm[2] * cfg.sigma_t * scale
    new_rot = rot + (is_r * sel1) * (wrap_angle_once(rot + drot, cfg.mode.pi) - rot)

    pose = pose.at[:, 0].set(new_x).at[:, 1].set(new_y).at[:, 4].set(new_rot)
    return _apply_swap(pose, scene, is_s, sel1, sel2)


def select_row(sel: Array, pose: Array) -> Array:
    """``pose[argmax(sel)]``: the row a one-hot ``sel`` f32[N] selects.

    An index gather, not a ``sel @ pose`` product: a matrix product may
    run at reduced precision (TF32 on GPUs, bf16 passes on other
    accelerators) and round the gathered coordinates. The gather is exact,
    and the fastest of the exact forms on the GPU (PERF.md). An all-zero
    ``sel`` selects row 0; callers mask such picks out.
    """
    return pose[jnp.argmax(sel)]


def _apply_swap(pose: Array, scene: Scene, is_s: Array, sel1: Array,
                sel2: Array) -> Array:
    """Swap (``Kernel.cu:674-700``): rows ``sel1`` and ``sel2`` exchange.

    A select, not ``pose + (row2 - row1)``: ``a + (b - a)`` rounds, and a
    swapped object must land exactly on the other object's coordinates.
    """
    row1 = select_row(sel1, pose)
    row2 = select_row(sel2, pose)
    can_swap = is_s & (scene.n_objs >= 2)
    at1 = can_swap & (sel1[:, None] > 0)
    at2 = can_swap & (sel2[:, None] > 0)
    return jnp.where(at1, row2[None, :], jnp.where(at2, row1[None, :], pose))


UNIFORMS_PER_MOVE = 8


def uniforms_per_move() -> int:
    """Length of the uniform plane one move consumes (see
    ``propose_from_uniforms``): independent of the object count since the
    rank-pick needs one uniform per object draw."""
    return UNIFORMS_PER_MOVE


def propose_from_uniforms(
    u: Array, pose: Array, scene: Scene, cfg: SamplerConfig, scale: Array
) -> Array:
    """One move driven by a pre-drawn uniform plane ``u`` (f32[8]).

    Deriving every random quantity from a single threefry sweep keeps the
    per-step RNG to one fused kernel instead of ~5 separate draws. Object
    picks use the rank trick (one uniform each, see ``_rank_pick``) rather
    than Gumbel-argmax (N uniforms each) — at 100 objects that removes
    ~95% of the per-step random-bit volume, previously the dominant
    non-objective cost. Layout: u[0] move type; u[1] reserved for the
    caller's accept draw; u[2:6] Box-Muller inputs; u[6:8] object picks.
    """
    eps = 1e-7
    move = jnp.minimum((u[0] * 3.0).astype(jnp.int32), 2)

    # Box-Muller: 3 standard normals (dx, dy, dRot) from 4 uniforms
    r1 = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u[2], eps)))
    r2 = jnp.sqrt(-2.0 * jnp.log(jnp.maximum(u[4], eps)))
    two_pi = 2.0 * jnp.pi
    nrm = jnp.stack(
        [
            r1 * jnp.cos(two_pi * u[3]),
            r1 * jnp.sin(two_pi * u[3]),
            r2 * jnp.cos(two_pi * u[5]),
        ]
    )

    ok, rank, n_unf = _unfrozen_ranks(scene)
    sel1 = _rank_pick(u[6], ok, rank, n_unf)
    sel2 = _rank_pick(u[7], ok, rank, n_unf)

    new_pose = _apply_move(pose, scene, cfg, scale, move, sel1, sel2, nrm)
    return jnp.where(n_unf > 0, new_pose, pose)


def propose(
    key: Array, pose: Array, scene: Scene, cfg: SamplerConfig, scale: Array
) -> Array:
    """One single-object move, type uniform over {0,1,2} (``Kernel.cu:582``)."""
    u = jax.random.uniform(key, (uniforms_per_move(),))
    return propose_from_uniforms(u, pose, scene, cfg, scale)


# --- single-move reference-shaped wrappers (used by tests/diagnostics) ------


def translate_move(
    key: Array, pose: Array, scene: Scene, cfg: SamplerConfig, scale: Array
) -> Array:
    k_obj, k_nrm = jax.random.split(key)
    sel = (jnp.arange(scene.n_pad_objs) == pick_unfrozen(k_obj, scene)).astype(
        jnp.float32
    )
    nrm = jax.random.normal(k_nrm, (3,))
    return _apply_move(pose, scene, cfg, scale, jnp.int32(0), sel, sel, nrm)


def rotate_move(
    key: Array, pose: Array, scene: Scene, cfg: SamplerConfig, scale: Array
) -> Array:
    k_obj, k_nrm = jax.random.split(key)
    sel = (jnp.arange(scene.n_pad_objs) == pick_unfrozen(k_obj, scene)).astype(
        jnp.float32
    )
    nrm = jax.random.normal(k_nrm, (3,))
    return _apply_move(pose, scene, cfg, scale, jnp.int32(1), sel, sel, nrm)


def swap_move(key: Array, pose: Array, scene: Scene) -> Array:
    k1, k2 = jax.random.split(key)
    idx = jnp.arange(scene.n_pad_objs)
    sel1 = (idx == pick_unfrozen(k1, scene)).astype(jnp.float32)
    sel2 = (idx == pick_unfrozen(k2, scene)).astype(jnp.float32)
    cfg = SamplerConfig()
    return _apply_move(
        pose, scene, cfg, jnp.float32(1.0), jnp.int32(2), sel1, sel2,
        jnp.zeros((3,), jnp.float32),
    )


def block_propose_from_uniforms(
    u: Array, pose: Array, scene: Scene, cfg: SamplerConfig, scale: Array
) -> Array:
    """K sequential single-object moves from a pre-drawn ``u`` f32[K, 8].

    One deterministic compound proposal — capability-equivalent to the
    reference's per-thread simultaneous proposals on shared memory
    (``Kernel.cu:798``), without the races.
    """
    if u.shape[0] == 1:
        return propose_from_uniforms(u[0], pose, scene, cfg, scale)

    def body(p, u_row):
        return propose_from_uniforms(u_row, p, scene, cfg, scale), None

    out, _ = jax.lax.scan(body, pose, u)
    return out


def block_propose(
    key: Array, pose: Array, scene: Scene, cfg: SamplerConfig, scale: Array
) -> Array:
    """``block_propose_from_uniforms`` drawing its own uniform sweep."""
    u = jax.random.uniform(
        key, (cfg.n_moves_per_step, uniforms_per_move())
    )
    return block_propose_from_uniforms(u, pose, scene, cfg, scale)
