"""Object-axis sharded cost evaluation — model parallelism for huge scenes.

The reference's scaling wall is the O(N^2) symmetry/off-limits terms
(``Readme.md:6``: "performance issues for larger sets of objects";
SURVEY.md §5 long-context). For scenes too large for one core's comfort,
this module shards the *row* axis of the N x N cost matrices over a mesh
axis: every device holds the full pose (replicated — it is only O(N)) but
computes an N/D-row slice of each pairwise matrix; scalar partial sums are
reduced with ``psum``. This is the architectural cousin of blockwise/ring
attention applied to layout costs: compute is partitioned, the reduction
rides the device interconnect.

O(N) and O(R)/O(C) terms are evaluated redundantly on every device (they
are negligible); the result is bitwise-consistent with the unsharded
:func:`mh_tpu.ops.costs.cost_terms` up to f32 reduction order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from mh_tpu.config import CostMode
from mh_tpu.models.scene import Scene
from mh_tpu.ops import geometry as geo
from mh_tpu.ops.costs import CostBreakdown, cost_terms, _obj_aabbs, _NEG_HUGE

Array = jax.Array

OBJS_AXIS = "objs"


def _row_slice(a: Array, dev: Array, rows: int) -> Array:
    return jax.lax.dynamic_slice_in_dim(a, dev * rows, rows)


def _symmetry_rows(pose, scene, mode, dev, rows):
    """Rows [dev*rows, dev*rows+rows) of the symmetry best-match sum."""
    pi = mode.pi
    x, y, rot = pose[:, 0], pose[:, 1], pose[:, 4]
    ux = jnp.cos(scene.focal_rot)
    uy = jnp.sin(scene.focal_rot)
    xs = _row_slice(x, dev, rows)
    ys = _row_slice(y, dev, rows)
    rs = _row_slice(rot, dev, rows)
    ms = _row_slice(scene.obj_mask, dev, rows)
    s = 2.0 * (scene.focal[0] * ux + scene.focal[1] * uy - (xs * ux + ys * uy))
    rx = xs + s * ux
    ry = ys + s * uy
    rrot = 2.0 * scene.focal_rot - rs
    rrot = jnp.where(rrot < -pi, rrot + 2 * pi, rrot)
    dp = geo.distance(x[None, :], y[None, :], rx[:, None], ry[:, None])
    dt = rot[None, :] - rrot[:, None]
    dt = jnp.where(dt > pi, dt - 2 * pi, dt)
    val = 5.0 - jnp.sqrt(dp) - 0.4 * jnp.abs(dt)
    val = jnp.where(scene.obj_mask[None, :] > 0, val, _NEG_HUGE)
    best = jnp.maximum(jnp.max(val, axis=1), 0.0)
    return -jnp.sum(best * ms)


def _off_limits_rows(pose, scene, mode, dev, rows):
    mnx, mny, mxx, mxy = _obj_aabbs(pose, scene, mode)
    rmnx = _row_slice(mnx, dev, rows)
    rmny = _row_slice(mny, dev, rows)
    rmxx = _row_slice(mxx, dev, rows)
    rmxy = _row_slice(mxy, dev, rows)
    ms = _row_slice(scene.obj_mask, dev, rows)
    area = geo.intersection_area(
        rmnx[:, None], rmny[:, None], rmxx[:, None], rmxy[:, None],
        mnx[None, :], mny[None, :], mxx[None, :], mxy[None, :],
    )
    n = pose.shape[0]
    gid = dev * rows + jnp.arange(rows)
    upper = (jnp.arange(n)[None, :] > gid[:, None]).astype(area.dtype)
    return -jnp.sum(area * upper * ms[:, None] * scene.obj_mask[None, :])


def rowsharded_breakdown(
    pose: Array, scene: Scene, mode: CostMode, rows: int,
    cheap_pose: Array | None = None, cheap_scene: Scene | None = None,
) -> CostBreakdown:
    """Cost breakdown with the O(N^2) terms row-sliced over ``OBJS_AXIS``.

    Must execute inside a ``shard_map`` whose mesh has ``OBJS_AXIS``: this
    device evaluates only its ``rows``-row slice of the symmetry (and, in
    FIXED mode, off-limits) matrices; the scalar partials psum over the
    axis. O(N)/O(R)/O(C) terms are evaluated redundantly on every device
    (``cheap_pose``/``cheap_scene`` let callers feed replicated copies so
    a replicated output stays provably replicated).
    """
    dev = jax.lax.axis_index(OBJS_AXIS)
    sym = jax.lax.psum(
        _symmetry_rows(pose, scene, mode, dev, rows), OBJS_AXIS
    )
    if mode is CostMode.FIXED:
        off = jax.lax.psum(
            _off_limits_rows(pose, scene, mode, dev, rows), OBJS_AXIS
        )
    else:
        off = jnp.float32(0.0)  # excluded from the parity total; 0-report

    cp = pose if cheap_pose is None else cheap_pose
    cs = scene if cheap_scene is None else cheap_scene
    from mh_tpu.ops import costs as C

    pw = C.pair_wise_costs(cp, cs)
    pwa = C.pair_wise_angle_costs(cp, cs, mode)
    pair = (
        cs.w_pairwise * (pw * pwa)
        if mode is CostMode.PARITY
        else cs.w_pairwise * (pw + pwa)
    )
    vb = cs.w_visual_balance * C.visual_balance_costs(cp, cs)
    fp = cs.w_focal * C.focal_point_costs(cp, cs, mode)
    clr = cs.w_clearance * C.clearance_costs(cp, cs, mode)
    sa = cs.w_surface_area * C.surface_area_costs(cp, cs, mode)
    sym_w = cs.w_symmetry * sym
    off_w = cs.w_offlimits * off
    total = pair + vb + fp + sym_w + clr + sa
    if mode is CostMode.FIXED:
        total = total + off_w
    return CostBreakdown(
        total=total, pair_wise=pair, visual_balance=vb, focal_point=fp,
        symmetry=sym_w, clearance=clr, off_limits=off_w, surface_area=sa,
    )


@partial(jax.jit, static_argnames=("mode", "mesh"))
def cost_terms_sharded(
    pose: Array, scene: Scene, mesh: Mesh, mode: CostMode = CostMode.PARITY
) -> CostBreakdown:
    """Cost breakdown with the O(N^2) terms sharded over ``mesh``'s objs axis.

    Requires the padded object count to be divisible by the mesh size.
    """
    n_dev = mesh.shape[OBJS_AXIS]
    n = scene.n_pad_objs
    if n % n_dev:
        raise ValueError(f"padded object count {n} not divisible by mesh {n_dev}")
    rows = n // n_dev

    def device_fn(pose_rep: Array, scene_rep: Scene) -> CostBreakdown:
        # varying copies for the row-sliced quadratic parts; the replicated
        # originals feed the cheap terms so the output stays invariant
        pose_v, scene_v = jax.tree.map(
            lambda a: jax.lax.pcast(a, (OBJS_AXIS,), to="varying"),
            (pose_rep, scene_rep),
        )
        return rowsharded_breakdown(
            pose_v, scene_v, mode, rows,
            cheap_pose=pose_rep, cheap_scene=scene_rep,
        )

    sharded = jax.shard_map(
        device_fn, mesh=mesh, in_specs=(P(), P()), out_specs=P()
    )
    return sharded(pose, scene)


def obj_mesh(n_devices: int | None = None) -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return jax.make_mesh((len(devices),), (OBJS_AXIS,), devices=devices)


def chain_obj_mesh(n_chain_devs: int, n_obj_devs: int) -> Mesh:
    """2-D (chains x objs) mesh: chains data-parallel on one axis, the
    O(N^2) objective row-sharded on the other."""
    from mh_tpu.parallel.mesh import CHAINS_AXIS

    devices = jax.devices()[: n_chain_devs * n_obj_devs]
    return jax.make_mesh(
        (n_chain_devs, n_obj_devs), (CHAINS_AXIS, OBJS_AXIS), devices=devices
    )


@partial(jax.jit, static_argnames=("cfg", "mesh"))
def run_chains_objsharded(
    key: Array,
    pose0: Array,
    scene: Scene,
    cfg: SamplerConfig,
    mesh: Mesh,
):
    """MH chains on a 2-D (chains x objs) mesh — huge-scene sampling.

    The answer to the reference's scaling complaint
    (``/root/reference/Readme.md:6``; O(N^2) terms ``Kernel.cu:283-318,
    485-514``) beyond what one chip holds: chains shard over
    ``CHAINS_AXIS`` exactly as :func:`run_chains_sharded`; *within* each
    chain, every OBJS_AXIS device keeps a full pose replica (O(N), cheap)
    but evaluates only its row slice of the N x N symmetry/off-limits
    matrices, reduced with ``psum`` across devices each step
    (:func:`rowsharded_breakdown`).

    Lockstep correctness: proposals and accept draws are keyed from the
    global chain id and step counter — identical on every OBJS device —
    and psum returns bitwise-identical sums on all participants, so the
    pose replicas can never diverge. (``check_vma=False`` because the
    replication of the output across OBJS_AXIS is by this argument, not
    by types the checker can see.)

    Returns the final per-chain :class:`MHState` (off-limits term filled
    on the final pose like the unsharded path).
    """
    from mh_tpu.config import CostMode
    from mh_tpu.parallel.mesh import CHAINS_AXIS, to_varying
    from mh_tpu.sampler.mh import MHState, finalize_costs, mh_step

    n_cdev = mesh.shape[CHAINS_AXIS]
    n_odev = mesh.shape[OBJS_AXIS]
    n = scene.n_pad_objs
    if cfg.n_chains % n_cdev:
        raise ValueError(
            f"n_chains={cfg.n_chains} not divisible by chains mesh {n_cdev}"
        )
    if n % n_odev:
        raise ValueError(f"padded object count {n} not divisible by mesh {n_odev}")
    n_local = cfg.n_chains // n_cdev
    rows = n // n_odev

    def device_fn(scene_rep: Scene, pose0_rep: Array):
        scene_v, pose0_v = jax.tree.map(
            lambda a: jax.lax.pcast(
                a, (CHAINS_AXIS, OBJS_AXIS), to="varying"
            ),
            (scene_rep, pose0_rep),
        )
        cdev = jax.lax.axis_index(CHAINS_AXIS)
        chain_ids = cdev * n_local + jnp.arange(n_local)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(chain_ids)
        keys = to_varying(to_varying(keys, CHAINS_AXIS), OBJS_AXIS)
        p0 = jnp.broadcast_to(pose0_v, (n_local, *pose0_v.shape))

        def cost_fn(pose):
            # hot loop: PARITY's off term skipped inside (excluded from the
            # accept total), exactly like the unsharded skip_unused path
            return rowsharded_breakdown(pose, scene_v, cfg.mode, rows)

        def one_chain(k, p):
            state = MHState(
                pose=p,
                costs=cost_fn(p),
                key=k,
                step=jnp.int32(0),
                n_accept=jnp.int32(0),
                log_scale=jnp.float32(0.0),
            )

            def body(s, _):
                return mh_step(s, scene_v, cfg, cost_fn=cost_fn), None

            state, _ = jax.lax.scan(body, state, None, length=cfg.iterations)
            return finalize_costs(state, scene_v, cfg)

        return jax.vmap(one_chain)(keys, p0)

    sharded = jax.shard_map(
        device_fn,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(CHAINS_AXIS),
        check_vma=False,
    )
    return sharded(scene, pose0)
