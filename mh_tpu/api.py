"""Public API: scene in -> layout suggestions + real cost breakdowns out.

The equivalent of the reference's exported ``KernelWrapper`` C ABI
(SURVEY.md C9, ``Kernel.cu:873-984``): the caller hands over a scene and a
launch config, gets back one suggested layout per chain. Two fixes over the
reference by design:

- per-suggestion cost breakdowns are *real* (the reference's device
  writeback is commented out, ``Kernel.cu:852-861``, so its ``resultCosts``
  are garbage);
- nothing leaks (the reference frees only 5 of its 12 device buffers,
  ``Kernel.cu:963-967``) — JAX owns all buffers.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np

from mh_tpu.config import SamplerConfig
from mh_tpu.models.scene import Scene, SceneSpec
from mh_tpu.sampler.mh import compile_chains, run_chains

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class LayoutResult:
    """One suggestion per chain (replaces ``result``/``point``, Kernel.cu:129-149)."""

    points: np.ndarray  # f32[n_chains, n_objs, 6] — (x,y,z,rotX,rotY,rotZ)
    costs: np.ndarray  # f32[n_chains, 8] — (total, pairwise, visual, focal,
    #                     symmetry, clearance, offlimits, surface), real values
    accept_rate: np.ndarray  # f32[n_chains]
    step_scale: np.ndarray  # f32[n_chains] — final adapted step-size scale

    COST_FIELDS = (
        "total",
        "pair_wise",
        "visual_balance",
        "focal_point",
        "symmetry",
        "clearance",
        "off_limits",
        "surface_area",
    )


def suggest_layouts(
    scene: Scene | SceneSpec,
    cfg: SamplerConfig,
    key: Array | int = 0,
    pose0: Array | None = None,
    engine: str = "auto",
    mesh=None,
    serve: bool = False,
    objs_devices: int | None = None,
    log=None,
    log_every: int = 0,
) -> LayoutResult:
    """Run ``cfg.n_chains`` MH chains and return their final layouts.

    Accepts either a built :class:`Scene` (with ``pose0``) or a
    :class:`SceneSpec` (initial poses taken from the spec, like the
    reference's input ``cfg`` array).

    ``engine``:

    - ``"auto"`` (default): ``"xla_specialized"`` when ``serve=True`` on a
      single device (the scene will be sampled repeatedly, so a per-scene
      compile amortizes), ``"xla"`` otherwise.
    - ``"xla"``: the XLA chain loop (``run_chains``), one compiled program
      for every scene of a padded size.
    - ``"xla_specialized"``: the same loop compiled with the scene embedded
      as constants — one fresh compile per scene, bitwise-identical
      results to ``"xla"``. Use when serving one scene repeatedly.

    Any other name raises ``ValueError``.

    ``mesh``: a ``jax.sharding.Mesh`` with a chains axis to shard the
    chains over (``"xla"`` engine). Defaults to a mesh over all visible
    devices whenever more than one device is present and ``cfg.n_chains``
    divides evenly — chains are device-count invariant (keys fold from
    global chain ids), so results are bitwise identical to the
    single-device path.

    ``objs_devices``: shard the O(N^2) objective *within* each chain over
    this many devices (huge-scene model parallelism — the answer to the
    reference's N^2 scaling complaint, ``Readme.md:6``; the symmetry /
    off-limits matrices ``Kernel.cu:283-318,485-514`` are row-sharded and
    psum-reduced across devices each step). Builds a 2-D (chains x objs)
    mesh from the visible devices; pass a 2-D ``mesh`` (with chains and
    objs axes) instead for explicit placement. Implies the XLA engine.

    ``log``: a file path / file-like / :class:`~mh_tpu.utils.runlog.RunLogger`
    — emits a structured JSONL event stream (``run_config`` + ``result``;
    SURVEY.md §5 observability). With ``log_every > 0`` and the plain
    unsharded ``"xla"`` engine, the run additionally executes in
    ``log_every``-step rounds (bitwise-identical to one shot — the resume
    path is exact) and emits per-round ``round`` events: accept-rate,
    step-scale, and cost-quantile statistics.
    """
    from mh_tpu.utils.runlog import RunLogger, as_logger

    logger = as_logger(log)
    try:
        res, engine_used = _dispatch_layouts(
            scene, cfg, key, pose0, engine, mesh, serve, objs_devices,
            logger, log_every,
        )
        if logger is not None:
            logger.log_result(res, engine=engine_used)
        return res
    finally:
        if logger is not None and not isinstance(log, RunLogger):
            logger.close()


def _dispatch_layouts(
    scene, cfg, key, pose0, engine, mesh, serve, objs_devices, logger,
    log_every,
) -> tuple[LayoutResult, str]:
    if isinstance(scene, SceneSpec):
        spec = scene
        scene = spec.build()
        if pose0 is None:
            pose0 = spec.initial_pose()
    if pose0 is None:
        raise ValueError("pose0 is required when passing a built Scene")

    def log_cfg(eng: str) -> None:
        if logger is not None:
            logger.log_config(
                cfg, engine=eng,
                n_objs=int(np.sum(np.asarray(scene.obj_mask) > 0)),
                n_chains=cfg.n_chains,
            )

    # 2-D (chains x objs) dispatch: either requested by count or implied by
    # a mesh that carries the objs axis
    from mh_tpu.parallel.objshard import OBJS_AXIS

    if mesh is not None and OBJS_AXIS in mesh.shape and mesh.shape[OBJS_AXIS] > 1:
        log_cfg("xla_objsharded")
        return _run_objsharded(scene, cfg, key, pose0, mesh, engine), "xla_objsharded"
    if objs_devices and objs_devices > 1:
        from mh_tpu.parallel.objshard import chain_obj_mesh

        n_dev = jax.device_count()
        if mesh is not None:
            raise ValueError("pass either objs_devices or a 2-D mesh, not both")
        if n_dev % objs_devices:
            raise ValueError(
                f"objs_devices={objs_devices} does not divide the "
                f"{n_dev} visible devices"
            )
        mesh2d = chain_obj_mesh(n_dev // objs_devices, objs_devices)
        log_cfg("xla_objsharded")
        return _run_objsharded(scene, cfg, key, pose0, mesh2d, engine), "xla_objsharded"

    if engine == "auto":
        engine = auto_engine(serve=serve, single_device=(
            mesh is None and jax.device_count() == 1
        ))
    if engine not in ("xla", "xla_specialized"):
        raise ValueError(
            f"unknown engine {engine!r} (use 'auto', 'xla' or 'xla_specialized')"
        )
    log_cfg(engine)
    if logger is not None and log_every > 0 and engine == "xla" and mesh is None:
        # per-round logging runs the unsharded chain runner in
        # ``log_every``-step rounds — results are bitwise identical to the
        # one-shot (and to the sharded) path: chains are device-count
        # invariant and the resume fold is exact (test_recovery.py)
        return _run_xla_logged(scene, cfg, key, pose0, logger, log_every), engine
    return _run_xla(scene, cfg, key, pose0, engine, mesh), engine


def auto_engine(*, serve: bool, single_device: bool) -> str:
    """The ``engine="auto"`` decision, as a pure function of the context.

    ``serve=True`` declares that the scene will be sampled repeatedly, so
    a per-scene compile amortizes: on a single device auto then serves
    ``xla_specialized``. Everything else — one-shot calls and any
    multi-device mesh, which only the generic scan shards — gets ``xla``.
    """
    return "xla_specialized" if serve and single_device else "xla"


def _run_objsharded(scene, cfg, key, pose0, mesh2d, engine) -> LayoutResult:
    """Huge-scene 2-D (chains x objs) mesh dispatch (model parallelism)."""
    if engine not in ("auto", "xla"):
        raise ValueError(
            f"objs-sharded sampling uses the XLA engine (got {engine!r})"
        )
    if np.ndim(pose0) != 2:
        raise ValueError("objs-sharded sampling needs one shared pose0 f32[N,6]")
    from mh_tpu.parallel.objshard import run_chains_objsharded

    if isinstance(key, int):
        key = jax.random.key(key)
    state = run_chains_objsharded(key, pose0, scene, cfg, mesh2d)
    return _result_from_state(scene, state)


def _result_from_state(scene, state) -> LayoutResult:
    n_real = int(np.sum(np.asarray(scene.obj_mask) > 0))
    return LayoutResult(
        points=np.asarray(state.pose)[:, :n_real, :],
        costs=np.asarray(state.costs.as_vector()),
        accept_rate=np.asarray(state.accept_rate),
        step_scale=np.exp(np.asarray(state.log_scale)),
    )


def _run_xla_logged(scene, cfg, key, pose0, logger, log_every) -> LayoutResult:
    """The plain XLA engine in ``log_every``-step rounds with ``round``
    events after each — bitwise identical to the one-shot run (the resume
    fold consumes exactly the stream the uninterrupted run would)."""
    import dataclasses as dc

    from mh_tpu.sampler.mh import continue_chains

    if isinstance(key, int):
        key = jax.random.key(key)
    total = cfg.iterations
    first = min(log_every, total)
    states, _ = run_chains(key, pose0, scene, dc.replace(cfg, iterations=first))
    step = first
    logger.log_round(0, step, states)
    rnd = 1
    while step < total:
        n = min(log_every, total - step)
        states = continue_chains(states, scene, dc.replace(cfg, iterations=n))
        step += n
        logger.log_round(rnd, step, states)
        rnd += 1
    return _result_from_state(scene, states)


def _run_xla(scene, cfg, key, pose0, engine, mesh) -> LayoutResult:
    """Dispatch to the XLA scan engines (sharded when >1 device)."""
    if isinstance(key, int):
        key = jax.random.key(key)

    if mesh is not None and engine == "xla_specialized":
        raise ValueError("mesh sharding applies to engine='xla' only")
    if mesh is not None and np.ndim(pose0) != 2:
        raise ValueError(
            "mesh sharding supports one shared pose0 (f32[N,6]); per-chain "
            "starts need the unsharded engine='xla'"
        )
    if engine == "xla" and mesh is None and jax.device_count() > 1 and (
        cfg.n_chains % jax.device_count() == 0 and np.ndim(pose0) == 2
    ):
        from mh_tpu.parallel.mesh import chain_mesh

        mesh = chain_mesh()

    if engine == "xla_specialized":
        state, _ = compile_chains(scene, cfg)(key, pose0)
    elif mesh is not None:
        from mh_tpu.parallel.sharded import run_chains_sharded

        state = run_chains_sharded(key, pose0, scene, cfg, mesh)
    else:
        state, _ = run_chains(key, pose0, scene, cfg)
    return _result_from_state(scene, state)
