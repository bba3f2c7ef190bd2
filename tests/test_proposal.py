"""Proposal semantics tests (SURVEY.md C6 — clamp/wrap/swap/frozen)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mh_tpu.config import CostMode, SamplerConfig
from mh_tpu.models.scene import demo_scene
from mh_tpu.sampler import proposal as P

CFG = SamplerConfig(iterations=10)


def _scene_and_pose(n=8, frozen_idx=()):
    spec = demo_scene(n)
    frozen = np.zeros(n, bool)
    for i in frozen_idx:
        frozen[i] = True
    spec.frozen = frozen
    return spec, spec.build(), spec.initial_pose()


def test_translate_clamps_to_surface():
    spec, scene, pose = _scene_and_pose()
    # exaggerate the step so clamping triggers often
    cfg = SamplerConfig(sigma_xy_override=50.0)
    for s in range(50):
        pose = P.translate_move(jax.random.key(s), pose, scene, cfg, jnp.float32(1.0))
    xy = np.asarray(pose)[:, :2]
    assert np.all(xy >= 0.0 - 1e-6) and np.all(xy <= 10.0 + 1e-6)


def test_rotate_wraps():
    spec, scene, pose = _scene_and_pose()
    for s in range(100):
        pose = P.rotate_move(jax.random.key(s), pose, scene, CFG, jnp.float32(1.0))
    rot = np.asarray(pose)[:, 4]
    assert np.all(rot >= 0.0) and np.all(rot <= 2 * CostMode.PARITY.pi + 1e-6)


def test_swap_preserves_pose_multiset():
    spec, scene, pose = _scene_and_pose()
    before = np.sort(np.asarray(pose), axis=0)
    for s in range(20):
        pose = P.swap_move(jax.random.key(s), pose, scene)
    after = np.sort(np.asarray(pose), axis=0)
    np.testing.assert_allclose(after, before)


def test_frozen_objects_never_move():
    spec, scene, pose = _scene_and_pose(frozen_idx=(2, 5))
    orig = np.asarray(pose).copy()
    for s in range(200):
        pose = P.propose(jax.random.key(s), pose, scene, CFG, jnp.float32(1.0))
    out = np.asarray(pose)
    np.testing.assert_allclose(out[2], orig[2])
    np.testing.assert_allclose(out[5], orig[5])


def test_all_frozen_is_noop_not_hang():
    """The reference spins forever here (``Kernel.cu:600-602``); we no-op."""
    spec, scene, pose = _scene_and_pose(n=4, frozen_idx=(0, 1, 2, 3))
    out = P.propose(jax.random.key(0), pose, scene, CFG, jnp.float32(1.0))
    np.testing.assert_allclose(np.asarray(out), np.asarray(pose))


def test_pick_unfrozen_uniform():
    spec, scene, _ = _scene_and_pose(n=6, frozen_idx=(1, 4))
    keys = jax.random.split(jax.random.key(0), 3000)
    picks = np.asarray(jax.vmap(lambda k: P.pick_unfrozen(k, scene))(keys))
    counts = np.bincount(picks, minlength=scene.n_pad_objs)
    assert counts[1] == 0 and counts[4] == 0
    live = counts[[0, 2, 3, 5]]
    assert live.min() > 0.5 * live.mean()  # roughly uniform


def test_block_propose_moves_multiple_objects():
    spec, scene, pose = _scene_and_pose(n=16)
    cfg = SamplerConfig(n_moves_per_step=8)
    out = P.block_propose(jax.random.key(1), pose, scene, cfg, jnp.float32(1.0))
    changed = np.any(np.asarray(out) != np.asarray(pose), axis=1).sum()
    assert changed >= 2  # K=8 moves should touch several objects


def test_rank_pick_exact_uniform_and_edges():
    """_rank_pick: exact one-hot, exactly uniform over unfrozen, edge-safe.

    Covers the rank-plane edge cases: frozen lanes share a cumsum rank with
    their predecessor, padded lanes hold rank 0 — neither may ever be
    selected; u -> 1.0 must clamp to the last unfrozen object, u = 0 picks
    the first.
    """
    spec, scene, _ = _scene_and_pose(n=6, frozen_idx=(1, 4))
    ok, rank, n_unf = P._unfrozen_ranks(scene)
    n_unf_i = int(n_unf)
    assert n_unf_i == 4

    # dense u grid: each unfrozen object owns an equal u-interval, so an
    # interval-midpoint grid hits each exactly grid/n_unf times
    grid = 400
    us = (np.arange(grid) + 0.5) / grid
    sels = np.asarray(
        jax.vmap(lambda u: P._rank_pick(jnp.float32(u), ok, rank, n_unf))(
            jnp.asarray(us, jnp.float32)
        )
    )
    # every draw is an exact one-hot
    np.testing.assert_array_equal(sels.sum(axis=1), np.ones(grid))
    counts = sels.sum(axis=0)
    unfrozen = [i for i in range(scene.n_pad_objs) if float(ok[i]) > 0]
    frozen_or_pad = [i for i in range(scene.n_pad_objs) if float(ok[i]) == 0]
    assert all(counts[i] == grid // n_unf_i for i in unfrozen)
    assert all(counts[i] == 0 for i in frozen_or_pad)

    # edges: u = 0 -> first unfrozen; u = 1.0 exactly -> clamped to last
    lo = np.asarray(P._rank_pick(jnp.float32(0.0), ok, rank, n_unf))
    hi = np.asarray(P._rank_pick(jnp.float32(1.0), ok, rank, n_unf))
    assert lo.argmax() == unfrozen[0] and lo.sum() == 1
    assert hi.argmax() == unfrozen[-1] and hi.sum() == 1

    # all-frozen scene: all-zero selector (callers gate on n_unf > 0)
    _, scene_f, _ = _scene_and_pose(n=4, frozen_idx=(0, 1, 2, 3))
    ok_f, rank_f, n_unf_f = P._unfrozen_ranks(scene_f)
    sel_f = np.asarray(P._rank_pick(jnp.float32(0.5), ok_f, rank_f, n_unf_f))
    assert sel_f.sum() == 0


def _ref_int_in_range(u: np.ndarray, hi: int, lo: int) -> np.ndarray:
    """The reference's u -> int mapping (``generateRandomIntInRange``,
    ``Kernel.cu:566-574``): p = u*(max-min+0.999999)+min, truncated.
    ``curand_uniform`` draws u in (0, 1]."""
    p = u.astype(np.float32) * np.float32(hi - lo + 0.999999) + np.float32(lo)
    return np.trunc(p).astype(np.int64)


def test_move_type_and_object_pick_distribution_equivalence():
    """Pin the claimed distribution equivalence of the u -> int mappings.

    The reference draws move types via ``generateRandomIntInRange(st, 2, 0)``
    (``Kernel.cu:582``) and object picks via ``(st, nObjs-1, 0)``
    (``Kernel.cu:598``); our engines use ``min(floor(u*3), 2)`` for the move
    type and the rank-pick ``min(floor(u*n_unf), n_unf-1)`` for objects.
    Both pairs must induce the same distribution up to the reference's
    ~1e-7 truncation-constant bias (0.999999 instead of 1).
    """
    # analytic total-variation distance of the reference move-type mapping
    # from exact uniform thirds: the cell boundaries sit at k/2.999999
    # instead of k/3, so |P(k) - 1/3| <= |1/2.999999 - 1/3| ~ 3.7e-8
    cells = np.diff(np.concatenate([[0.0], np.arange(1, 3) / 2.999999, [1.0]]))
    tvd_move = 0.5 * np.abs(cells - 1.0 / 3.0).sum()
    assert tvd_move < 5e-7, tvd_move

    # object pick over n objects: boundaries at k/(n-0.000001) vs k/n
    for n in (10, 100):
        bounds = np.concatenate([[0.0], np.arange(1, n) / (n - 1 + 0.999999), [1.0]])
        cells = np.diff(bounds)
        tvd_pick = 0.5 * np.abs(cells - 1.0 / n).sum()
        assert tvd_pick < 2e-6, (n, tvd_pick)

    # empirical agreement on one dense, shared u grid (grid midpoints so no
    # draw lands exactly on a cell boundary of either mapping)
    grid = 3_000_000
    u = (np.arange(grid, dtype=np.float64) + 0.5) / grid
    ref_moves = _ref_int_in_range(u, 2, 0)
    ours_moves = np.minimum(np.floor(u * 3.0).astype(np.int64), 2)
    ref_c = np.bincount(ref_moves, minlength=3) / grid
    our_c = np.bincount(ours_moves, minlength=3) / grid
    assert 0.5 * np.abs(ref_c - our_c).sum() < 1e-6, (ref_c, our_c)

    n = 100
    ref_picks = _ref_int_in_range(u, n - 1, 0)
    ours_picks = np.minimum(np.floor(u * n), n - 1).astype(np.int64)
    ref_c = np.bincount(ref_picks, minlength=n) / grid
    our_c = np.bincount(ours_picks, minlength=n) / grid
    assert ref_picks.min() == 0 and ref_picks.max() == n - 1
    assert 0.5 * np.abs(ref_c - our_c).sum() < 2e-5, (
        0.5 * np.abs(ref_c - our_c).sum()
    )


def _hard_pose(n: int) -> np.ndarray:
    """Coordinates with full 24-bit mantissas (a TF32 product keeps 10)."""
    base = 1.2345678 + 0.0123456789 * np.arange(n * 6, dtype=np.float64)
    return np.asarray(base.reshape(n, 6) * (1 + np.arange(n)[:, None]), np.float32)


@pytest.mark.parametrize("path", ["apply_move", "incremental"])
@pytest.mark.parametrize("n", [2, 8, 100])
def test_swap_is_exact_row_permutation(n, path):
    """A swap leaves the pose rows an exact permutation of the input rows
    (bitwise), for every object pair, through both proposal paths."""
    from mh_tpu.sampler import incremental

    scene = demo_scene(n).build()
    pose = _hard_pose(scene.n_pad_objs)
    rng = np.random.default_rng(n)
    cfg = SamplerConfig()
    if path == "apply_move":
        i1 = rng.integers(0, n, 64)
        i2 = rng.integers(0, n, 64)
        eye = np.eye(scene.n_pad_objs, dtype=np.float32)
        got = jax.vmap(lambda s1, s2: P._apply_move(
            jnp.asarray(pose), scene, cfg, jnp.float32(1.0), jnp.int32(2),
            s1, s2, jnp.zeros((3,), jnp.float32),
        ))(eye[i1], eye[i2])
    else:
        u = rng.uniform(0.0, 1.0, (64, 8)).astype(np.float32)
        u[:, 0] = 0.9  # move type 2: swap
        got, i1, i2 = jax.vmap(lambda uu: incremental._propose_with_info(
            uu, jnp.asarray(pose), scene, cfg))(jnp.asarray(u))
        i1, i2 = np.asarray(i1), np.asarray(i2)
    want = np.repeat(pose[None], 64, axis=0)
    rows = np.arange(64)
    want[rows, i1], want[rows, i2] = pose[i2], pose[i1]
    np.testing.assert_array_equal(np.asarray(got), want)
    if n > 2:
        assert np.any(i1 != i2)


def test_select_row_matches_onehot_product_on_cpu():
    """The index gather equals the one-hot product it replaced, bitwise,
    where that product is exact (the CPU)."""
    pose = jnp.asarray(_hard_pose(16))
    eye = jnp.eye(16, dtype=jnp.float32)
    got = jax.vmap(lambda s: P.select_row(s, pose))(eye)
    want = jax.vmap(lambda s: s @ pose)(eye)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(pose))
