"""End-to-end API test: the KernelWrapper-equivalent surface (SURVEY.md C9).

Runs the reference demo scene (``Kernel.cu:1003-1194``) through
``suggest_layouts`` and cross-checks the returned cost breakdowns against
the NumPy oracle evaluated on the returned poses — proving the breakdowns
are real (the reference returns garbage here, ``Kernel.cu:852-861``).
"""

import numpy as np

import pytest

from mh_tpu.api import suggest_layouts
from mh_tpu.config import CostMode, SamplerConfig
from mh_tpu.models.scene import demo_scene
from mh_tpu.parallel.mesh import chain_mesh

import oracle
from test_costs import random_spec


def test_suggest_layouts_demo_scene():
    spec = demo_scene(32)
    cfg = SamplerConfig(iterations=100, n_chains=4)
    res = suggest_layouts(spec, cfg, key=0)

    assert res.points.shape == (4, 32, 6)
    assert res.costs.shape == (4, 8)
    assert np.isfinite(res.points).all()
    assert np.isfinite(res.costs).all()
    assert np.all(res.accept_rate > 0)

    # Cost breakdowns must be *real*: re-evaluate each returned pose with the
    # float64 oracle and compare every component.
    for c in range(4):
        pose = np.zeros((32, 6))
        pose[:, :] = res.points[c]
        want = oracle.breakdown(spec, pose, parity=True)
        got = dict(zip(type(res).COST_FIELDS, res.costs[c]))
        for k in type(res).COST_FIELDS:
            np.testing.assert_allclose(
                got[k], want[k], rtol=1e-3, atol=5e-3, err_msg=f"chain {c} {k}"
            )

    # NOTE: no on-surface assertion — like the reference harness, initial
    # poses start far off the 10x10 surface (objects at (2i, 2i)); only
    # translated objects get clamped (Kernel.cu:613-630), the rest are merely
    # penalized by the surface-area term.


@pytest.mark.parametrize("engine", ["cuda", "fused"])
def test_unknown_engine_rejected(engine):
    """Only the XLA engines exist; the former fused-kernel name is unknown."""
    with pytest.raises(ValueError, match="unknown engine"):
        suggest_layouts(
            demo_scene(4), SamplerConfig(iterations=1, n_chains=8),
            engine=engine,
        )


@pytest.mark.parametrize(
    "cfg",
    [
        SamplerConfig(iterations=2, n_chains=8, adapt=True),
        SamplerConfig(iterations=2, n_chains=8, n_moves_per_step=4),
    ],
    ids=["adapt", "block4"],
)
def test_auto_engine_handles_every_config(cfg):
    """auto serves adaptive and block-proposal configs."""
    res = suggest_layouts(demo_scene(8), cfg, key=0, engine="auto")
    assert res.points.shape == (8, 8, 6)
    assert np.isfinite(res.points).all()
    assert np.isfinite(res.costs).all()


def test_suggest_layouts_mesh_sharding_invariant():
    """suggest_layouts shards chains over a mesh with bitwise-identical
    results to the single-device path (keys fold from global chain ids),
    and guards the unsupported combinations."""
    import pytest

    from mh_tpu.api import suggest_layouts
    from mh_tpu.config import SamplerConfig
    from mh_tpu.models.scene import demo_scene
    from mh_tpu.parallel.mesh import chain_mesh

    spec = demo_scene(8)
    cfg = SamplerConfig(iterations=20, n_chains=16)
    r1 = suggest_layouts(spec, cfg, key=3, mesh=chain_mesh(1))
    r8 = suggest_layouts(spec, cfg, key=3, mesh=chain_mesh(8))
    np.testing.assert_array_equal(r1.points, r8.points)
    np.testing.assert_array_equal(r1.costs, r8.costs)
    np.testing.assert_array_equal(r1.accept_rate, r8.accept_rate)

    with pytest.raises(ValueError, match="mesh"):
        suggest_layouts(spec, cfg, key=3, engine="xla_specialized",
                        mesh=chain_mesh(8))
    per_chain_pose0 = np.repeat(
        np.asarray(spec.initial_pose())[None], 16, axis=0
    )
    with pytest.raises(ValueError, match="pose0"):
        suggest_layouts(spec, cfg, key=3, pose0=per_chain_pose0,
                        mesh=chain_mesh(8))


def test_suggest_layouts_objsharded_huge_scene():
    """Huge-scene model parallelism is reachable from the public API: a
    2048-object scene sampled via objs_devices= (2-D chains x objs mesh)
    without importing mh_tpu.parallel.objshard directly, matching the
    library-level path bitwise."""
    import pytest

    from mh_tpu.parallel.objshard import chain_obj_mesh

    spec = demo_scene(2048)
    cfg = SamplerConfig(iterations=3, n_chains=2)
    res = suggest_layouts(spec, cfg, key=1, objs_devices=4)
    assert res.points.shape == (2, 2048, 6)
    assert np.isfinite(res.points).all()
    assert np.isfinite(res.costs).all()

    # explicit 2-D mesh dispatch, same results (proposals keyed from global
    # chain ids — objs-axis split cannot change the stream)
    res2 = suggest_layouts(spec, cfg, key=1, mesh=chain_obj_mesh(2, 2))
    np.testing.assert_array_equal(res.points, res2.points)

    with pytest.raises(ValueError, match="XLA engine"):
        suggest_layouts(spec, cfg, key=1, objs_devices=4,
                        engine="xla_specialized")
    with pytest.raises(ValueError, match="divide"):
        suggest_layouts(spec, cfg, key=1, objs_devices=3)


@pytest.mark.parametrize(
    "serve,single_device,want",
    [
        (False, True, "xla"),
        (False, False, "xla"),
        (True, True, "xla_specialized"),
        (True, False, "xla"),
    ],
)
def test_auto_engine_dispatch_table(serve, single_device, want):
    """Pin the auto-engine decision across {1, >1} devices x {one-shot,
    serve} (docs/API.md "Auto dispatch")."""
    from mh_tpu.api import auto_engine

    assert auto_engine(serve=serve, single_device=single_device) == want


def _unsharded(spec, cfg, key):
    """The plain unsharded ``run_chains`` result, as suggest_layouts
    returns it."""
    import jax

    from mh_tpu.api import _result_from_state
    from mh_tpu.sampler.mh import run_chains

    state, _ = run_chains(jax.random.key(key), spec.initial_pose(),
                          spec.build(), cfg)
    return _result_from_state(spec.build(), state)


def test_auto_serve_on_many_devices_shards_the_generic_scan():
    """serve=True with 8 visible devices keeps the sharded ``xla`` engine,
    which equals the unsharded run bitwise."""
    import io
    import json

    spec = demo_scene(8)
    cfg = SamplerConfig(iterations=10, n_chains=16)
    log = io.StringIO()
    res = suggest_layouts(spec, cfg, key=2, serve=True, log=log)
    engines = {json.loads(l).get("engine") for l in log.getvalue().splitlines()}
    assert engines - {None} == {"xla"}
    ref = _unsharded(spec, cfg, 2)
    np.testing.assert_array_equal(res.points, ref.points)
    np.testing.assert_array_equal(res.costs, ref.costs)


@pytest.mark.parametrize("engine", ["xla", "xla_specialized"])
@pytest.mark.parametrize("mode", [CostMode.PARITY, CostMode.FIXED])
@pytest.mark.parametrize("seed", [11, 23])
def test_random_scene_costs_match_oracle(seed, mode, engine):
    """Randomized geometry, relationships in both angle regimes,
    clearances and a weighted off-limits term through the public engines:
    every reported term agrees with the float64 oracle on the final poses."""
    spec = random_spec(np.random.default_rng(seed))
    cfg = SamplerConfig(iterations=50, n_chains=8, mode=mode)
    res = suggest_layouts(spec, cfg, key=seed, engine=engine)
    assert np.isfinite(res.points).all()
    for c in range(cfg.n_chains):
        want = oracle.breakdown(spec, np.asarray(res.points[c], np.float64),
                                parity=mode is CostMode.PARITY)
        for i, k in enumerate(type(res).COST_FIELDS):
            np.testing.assert_allclose(
                res.costs[c, i], want[k], rtol=2e-4, atol=2e-3,
                err_msg=f"chain {c} {k}",
            )


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_chain_sharding_device_count_invariant(n_dev):
    """The XLA engine sharded over 1/2/4/8 devices equals the unsharded
    run bitwise."""
    spec = demo_scene(8)
    cfg = SamplerConfig(iterations=20, n_chains=16)
    got = suggest_layouts(spec, cfg, key=7, mesh=chain_mesh(n_dev))
    ref = _unsharded(spec, cfg, 7)
    for f in ("points", "costs", "accept_rate", "step_scale"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
