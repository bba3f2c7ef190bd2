"""Object-axis sharded cost evaluation vs the unsharded breakdown."""

import numpy as np
import pytest

from mh_tpu.config import CostMode
from mh_tpu.ops.costs import cost_terms
from mh_tpu.parallel.objshard import cost_terms_sharded, obj_mesh

from test_costs import random_spec


@pytest.mark.parametrize("mode", [CostMode.PARITY, CostMode.FIXED])
def test_sharded_costs_match_unsharded(mode):
    rng = np.random.default_rng(11)
    spec = random_spec(rng, n=13, r=4, c=3)
    scene = spec.build(pad_objs=16)  # 16 rows over 8 devices -> 2 rows each
    pose = spec.initial_pose(pad_objs=16)
    want = cost_terms(pose, scene, mode)
    got = cost_terms_sharded(pose, scene, obj_mesh(8), mode)
    for f in ("total", "pair_wise", "visual_balance", "focal_point",
              "symmetry", "clearance", "surface_area"):
        np.testing.assert_allclose(
            float(getattr(got, f)), float(getattr(want, f)),
            rtol=1e-5, atol=1e-4, err_msg=f,
        )
    if mode is CostMode.FIXED:
        np.testing.assert_allclose(
            float(got.off_limits), float(want.off_limits), rtol=1e-5, atol=1e-4
        )


def test_sharded_costs_bad_divisibility():
    rng = np.random.default_rng(1)
    spec = random_spec(rng, n=9)
    with pytest.raises(ValueError, match="divisible"):
        cost_terms_sharded(
            spec.initial_pose(), spec.build(), obj_mesh(8), CostMode.PARITY
        )


def test_objsharded_chains_match_unsharded():
    """MH chains on a 2-D (chains x objs) mesh follow the unsharded
    trajectory: proposals/accepts key from global chain ids (identical on
    every objs-device) and only the psum reduction order differs."""
    import jax

    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.parallel.objshard import chain_obj_mesh, run_chains_objsharded
    from mh_tpu.sampler.mh import run_chains

    spec = demo_scene(16)
    scene = spec.build()
    cfg = SamplerConfig(iterations=30, n_chains=4)
    key = jax.random.key(5)
    got = run_chains_objsharded(
        key, spec.initial_pose(), scene, cfg, chain_obj_mesh(2, 4)
    )
    want, _ = run_chains(key, spec.initial_pose(), scene, cfg)
    np.testing.assert_array_equal(
        np.asarray(got.n_accept), np.asarray(want.n_accept)
    )
    np.testing.assert_allclose(
        np.asarray(got.pose), np.asarray(want.pose), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(got.costs.total), np.asarray(want.costs.total),
        rtol=1e-4, atol=1e-3,
    )


def test_objsharded_mesh_shape_invariance():
    """(2 chains x 4 objs) and (4 chains x 2 objs) meshes agree."""
    import jax

    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.parallel.objshard import chain_obj_mesh, run_chains_objsharded

    spec = demo_scene(16)
    scene = spec.build()
    cfg = SamplerConfig(iterations=25, n_chains=4)
    key = jax.random.key(7)
    a = run_chains_objsharded(
        key, spec.initial_pose(), scene, cfg, chain_obj_mesh(2, 4)
    )
    b = run_chains_objsharded(
        key, spec.initial_pose(), scene, cfg, chain_obj_mesh(4, 2)
    )
    np.testing.assert_array_equal(np.asarray(a.n_accept), np.asarray(b.n_accept))
    np.testing.assert_allclose(
        np.asarray(a.pose), np.asarray(b.pose), rtol=1e-4, atol=1e-4
    )


def test_objsharded_huge_scene_samples():
    """A 2048-object scene — large enough that one device's
    N x N terms are worth splitting — actually runs MH steps on the (1 x 8) objs mesh."""
    import jax

    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.ops.costs import cost_terms
    from mh_tpu.parallel.objshard import chain_obj_mesh, run_chains_objsharded

    spec = demo_scene(2048)
    scene = spec.build()
    cfg = SamplerConfig(iterations=3, n_chains=2)
    states = run_chains_objsharded(
        jax.random.key(1), spec.initial_pose(), scene, cfg, chain_obj_mesh(1, 8)
    )
    pose = np.asarray(states.pose)
    assert pose.shape == (2, 2048, 6)
    assert np.isfinite(pose).all()
    assert np.asarray(states.step).tolist() == [3, 3]
    # final reported total agrees with the unsharded objective on the pose
    want = cost_terms(jax.numpy.asarray(pose[0]), scene, cfg.mode)
    got_total = float(np.asarray(states.costs.total)[0])
    np.testing.assert_allclose(got_total, float(want.total), rtol=1e-4, atol=1e-2)
