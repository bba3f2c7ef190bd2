"""The Metropolis-Hastings chain: accept rule, step, scan loop, vmapped chains.

Functional re-design of the reference chain kernel (SURVEY.md C7/C8,
``Kernel.cu:706-871``): one chain = one functional ``lax.scan`` program over
a ``(pose, costs, rng)`` PyTree; many chains = ``vmap`` over a leading chains
axis (the reference's grid of CUDA blocks, ``Kernel.cu:951``), ready to be
sharded over a device mesh by :mod:`mh_tpu.parallel`.

RNG is counter-based threefry: keys are ``fold_in``-derived per chain and
per step — deterministic and reproducible regardless of chain count or
sharding (replaces per-thread cuRAND XORWOW states seeded with
``time(NULL)+tid``, ``Kernel.cu:152-160,943``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from mh_tpu.config import CostMode, SamplerConfig
from mh_tpu.models.scene import Scene
from mh_tpu.ops.costs import CostBreakdown, cost_terms
from mh_tpu.sampler.proposal import (
    block_propose_from_uniforms,
    uniforms_per_move,
)

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MHState:
    """Per-chain sampler state (checkpointable PyTree)."""

    pose: Array  # f32[N,6]
    costs: CostBreakdown  # weighted breakdown of the current pose
    key: Array  # chain PRNG key
    step: Array  # i32 — global step counter
    n_accept: Array  # i32 — accepted proposals so far
    log_scale: Array  # f32 — log step-size scale (adaptation; 0 == reference)

    @property
    def accept_rate(self) -> Array:
        return self.n_accept / jnp.maximum(self.step, 1)


def boltzmann_accept(key: Array, cost_star: Array, cost_cur: Array, beta: float) -> Array:
    """u < min(1, exp(beta * (cost_star - cost_cur))) (``Kernel.cu:706-713``).

    Note the positive sign: higher total cost is better (terms are errors
    <= 0 scaled by mostly negative weights — SURVEY.md §2.3).
    """
    u = jax.random.uniform(key)
    ratio = jnp.exp(jnp.minimum(beta * (cost_star - cost_cur), 0.0))
    return u < ratio


def mh_init(pose: Array, scene: Scene, key: Array,
            mode: CostMode = CostMode.PARITY) -> MHState:
    return MHState(
        pose=pose,
        costs=cost_terms(pose, scene, mode, skip_unused_offlimits=True),
        key=key,
        step=jnp.int32(0),
        n_accept=jnp.int32(0),
        log_scale=jnp.float32(0.0),
    )


def finalize_costs(state: MHState, scene: Scene, cfg: SamplerConfig) -> MHState:
    """Fill in the OffLimits term skipped during the hot loop (PARITY mode).

    The hot loop omits the O(N^2) OffLimits matrix because the reference
    excludes it from the accept total (``Kernel.cu:547``); for faithful
    reporting (``resultCosts.OffLimitsCosts``, ``Kernel.cu:142``) it is
    recomputed once here on the final pose.
    """
    if cfg.mode is not CostMode.PARITY:
        return state
    from mh_tpu.ops.costs import off_limits_costs  # local to avoid cycle noise

    off = scene.w_offlimits * off_limits_costs(state.pose, scene, cfg.mode)
    return dataclasses.replace(
        state, costs=dataclasses.replace(state.costs, off_limits=off)
    )


def mh_step(
    state: MHState, scene: Scene, cfg: SamplerConfig, beta: Array | None = None,
    cost_fn=None,
) -> MHState:
    """One MH iteration: propose -> cost -> accept (``Kernel.cu:785-828``).

    ``beta`` optionally overrides ``cfg.beta`` with a traced value — used by
    parallel tempering where each replica samples at its own temperature.
    ``cost_fn`` optionally replaces the objective evaluation
    (``pose -> CostBreakdown``) — used by the object-axis-sharded runner,
    whose quadratic terms are row-sliced over a mesh axis and psum-reduced.
    """
    # ONE threefry sweep per step covers the whole move block AND the
    # accept draw (u[0, 1] is the reserved accept slot — see
    # propose_from_uniforms); no split, no second scalar draw.
    key_step = jax.random.fold_in(state.key, state.step)
    u = jax.random.uniform(
        key_step, (cfg.n_moves_per_step, uniforms_per_move())
    )
    scale = jnp.exp(state.log_scale)
    star = block_propose_from_uniforms(u, state.pose, scene, cfg, scale)
    if cost_fn is None:
        star_costs = cost_terms(star, scene, cfg.mode, skip_unused_offlimits=True)
    else:
        star_costs = cost_fn(star)
    b = cfg.beta if beta is None else beta
    ratio = jnp.exp(jnp.minimum(b * (star_costs.total - state.costs.total), 0.0))
    if cfg.accept_draws == 1:
        u_acc = u[0, 1]
    else:
        # K independent accept draws on one shared candidate: accept iff
        # ANY accepts == min of K uniforms < ratio. Deterministic, race-free
        # emulation of the reference's per-thread divergent Accept
        # (``Kernel.cu:819``; effective acceptance 1-(1-p)^K).
        u_acc = jnp.min(
            jax.random.uniform(
                jax.random.fold_in(key_step, 1), (cfg.accept_draws,)
            )
        )
    acc = u_acc < ratio

    pose = jnp.where(acc, star, state.pose)
    costs = jax.tree.map(lambda s, c: jnp.where(acc, s, c), star_costs, state.costs)

    log_scale = state.log_scale
    if cfg.adapt:
        # Robbins-Monro drift toward the target acceptance rate.
        log_scale = log_scale + cfg.adapt_rate * (
            acc.astype(jnp.float32) - cfg.target_accept
        )

    return MHState(
        pose=pose,
        costs=costs,
        key=state.key,
        step=state.step + 1,
        n_accept=state.n_accept + acc.astype(jnp.int32),
        log_scale=log_scale,
    )


def _run_chain_impl(
    key: Array,
    pose0: Array,
    scene: Scene,
    cfg: SamplerConfig,
    trace_costs: bool = False,
    trace_poses: bool = False,
    thin: int = 1,
    n_steps: Array | None = None,
):
    """One chain. ``n_steps`` (traced scalar) replaces ``cfg.iterations``
    on the trace-free path so one compiled program serves every chain
    length; traces need a static scan length and keep ``cfg.iterations``.
    """
    if thin < 1 or cfg.iterations % thin:
        raise ValueError(
            f"thin={thin} must be >= 1 and divide iterations={cfg.iterations}"
        )
    state = mh_init(pose0, scene, key, cfg.mode)

    if not (trace_costs or trace_poses) and thin == 1:
        state = jax.lax.fori_loop(
            0,
            cfg.iterations if n_steps is None else n_steps,
            lambda _, s: mh_step(s, scene, cfg),
            state,
        )
        return finalize_costs(state, scene, cfg), None

    def body(s, _):
        if thin == 1:
            s = mh_step(s, scene, cfg)
        else:
            # thin > 1: run `thin` steps per scan slot so the trace is
            # O(T/thin) memory — posterior runs at 1e5+ iterations no
            # longer materialize every pose
            s = jax.lax.fori_loop(
                0, thin, lambda _, ss: mh_step(ss, scene, cfg), s
            )
        out = None
        if trace_costs and trace_poses:
            out = (s.costs.total, s.pose)
        elif trace_costs:
            out = s.costs.total
        elif trace_poses:
            out = s.pose
        return s, out

    state, trace = jax.lax.scan(body, state, None, length=cfg.iterations // thin)
    return finalize_costs(state, scene, cfg), trace


def _strip_iterations(cfg: SamplerConfig) -> SamplerConfig:
    """The jit-static config with the (dynamic) iteration count removed —
    every chain length then shares one compiled executable."""
    return dataclasses.replace(cfg, iterations=0)


def _validate_thin(thin: int, iterations: int) -> None:
    """The thin/iterations contract, enforced on every public path.

    Trace-free paths force ``thin=1`` into the jitted impl (thin only
    affects traces, results are bitwise identical), which would silently
    skip the impl's own divisibility check — so the wrappers validate
    before stripping (round-3 advisor finding)."""
    if thin < 1 or iterations % thin:
        raise ValueError(
            f"thin={thin} must be >= 1 and divide iterations={iterations}"
        )


@partial(jax.jit, static_argnames=("cfg", "trace_costs", "trace_poses", "thin"))
def _run_chain_jit(key, pose0, scene, n_steps, cfg, trace_costs, trace_poses,
                   thin):
    return _run_chain_impl(
        key, pose0, scene, cfg, trace_costs, trace_poses, thin,
        n_steps=n_steps,
    )


def run_chain(
    key: Array,
    pose0: Array,
    scene: Scene,
    cfg: SamplerConfig,
    trace_costs: bool = False,
    trace_poses: bool = False,
    thin: int = 1,
):
    """Run one chain for ``cfg.iterations`` steps (``Kernel.cu:785``).

    Returns the final :class:`MHState` and a trace: ``trace_costs`` yields
    the f32[iterations//thin] accepted-total trace; ``trace_poses``
    additionally yields f32[iterations//thin, N, 6] pose samples. ``thin``
    keeps every ``thin``-th step only (must divide ``iterations``) — for
    posterior moments at large iteration counts prefer
    :func:`run_chains_streaming`, which needs no trace memory at all.

    Trace-free runs treat the iteration count as a runtime value: calls
    that differ only in ``cfg.iterations`` share one compiled program.
    """
    _validate_thin(thin, cfg.iterations)
    if trace_costs or trace_poses:
        return _run_chain_jit(
            key, pose0, scene, None, cfg, trace_costs, trace_poses, thin
        )
    return _run_chain_jit(
        key, pose0, scene, jnp.int32(cfg.iterations), _strip_iterations(cfg),
        False, False, 1,
    )


def _chains_impl(key, pose0, scene, n_steps, cfg, trace_costs=False,
                 trace_poses=False, thin=1, sharding=None):
    """``cfg.n_chains`` vmapped chains; keys fold from global chain ids.

    ``sharding`` (a chains-leading ``NamedSharding``) splits the chains
    over devices: XLA partitions this same program, so each device runs
    the single-device program on its slice of chains.
    """
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(cfg.n_chains)
    )
    if pose0.ndim == 2:
        pose0 = jnp.broadcast_to(pose0, (cfg.n_chains, *pose0.shape))
    if sharding is not None:
        keys, pose0 = jax.lax.with_sharding_constraint((keys, pose0), sharding)
    # vmap the unjitted impl: a nested jit under vmap becomes an XLA
    # subcomputation boundary that blocks cross-step fusion.
    return jax.vmap(
        lambda k, p: _run_chain_impl(
            k, p, scene, cfg, trace_costs, trace_poses, thin,
            n_steps=n_steps,
        )
    )(keys, pose0)


_run_chains_jit = partial(
    jax.jit, static_argnames=("cfg", "trace_costs", "trace_poses", "thin")
)(_chains_impl)


def run_chains(
    key: Array,
    pose0: Array,
    scene: Scene,
    cfg: SamplerConfig,
    trace_costs: bool = False,
    trace_poses: bool = False,
    thin: int = 1,
):
    """Run ``cfg.n_chains`` independent chains via ``vmap``.

    ``pose0`` is either ``f32[N,6]`` (every chain starts from the same
    config, like the reference's grid of blocks over one input ``cfg``) or
    ``f32[n_chains,N,6]`` for per-chain starts.

    Trace-free runs treat the iteration count as a runtime value: calls
    that differ only in ``cfg.iterations`` share one compiled program
    (bitwise-identical results either way).
    """
    _validate_thin(thin, cfg.iterations)
    if trace_costs or trace_poses:
        return _run_chains_jit(
            key, pose0, scene, None, cfg, trace_costs, trace_poses, thin
        )
    return _run_chains_jit(
        key, pose0, scene, jnp.int32(cfg.iterations), _strip_iterations(cfg),
        False, False, 1,
    )


def _continue_impl(states: MHState, scene: Scene, n_steps,
                   cfg: SamplerConfig, sharding=None) -> MHState:
    """Advance vmapped chains ``n_steps``; ``sharding`` as in
    :func:`_chains_impl`."""
    if sharding is not None:
        states = jax.lax.with_sharding_constraint(states, sharding)

    def one(s):
        s = jax.lax.fori_loop(
            0, n_steps, lambda _, ss: mh_step(ss, scene, cfg), s
        )
        return finalize_costs(s, scene, cfg)

    return jax.vmap(one)(states)


_continue_chains_jit = partial(jax.jit, static_argnames=("cfg",))(_continue_impl)


def continue_chains(states: MHState, scene: Scene, cfg: SamplerConfig) -> MHState:
    """Continue vmapped chains from an existing state for ``cfg.iterations``
    more steps — the resume half of checkpoint/resume (SURVEY.md §5).

    Bitwise-identical to an uninterrupted run: the per-step key is folded
    from ``(state.key, state.step)``, both carried in the state, so a
    restored chain consumes exactly the random stream the interrupted one
    would have.
    """
    return _continue_chains_jit(
        states, scene, jnp.int32(cfg.iterations), _strip_iterations(cfg)
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StreamingMoments:
    """In-scan Welford accumulators for posterior moments.

    O(N*6) state instead of an O(T*N*6) pose trace, so posterior-moment
    runs scale to arbitrary iteration counts (BASELINE posterior gate).
    """

    n: Array  # f32[] — samples folded in so far
    pose_mean: Array  # f32[N,6]
    pose_m2: Array  # f32[N,6] — sum of squared deviations
    cost_mean: Array  # f32[]
    cost_m2: Array  # f32[]

    @property
    def pose_var(self) -> Array:
        # n broadcasts over the trailing [N, 6] pose axes (and any leading
        # chains batch axis from vmap)
        n = jnp.asarray(self.n)[..., None, None]
        return self.pose_m2 / jnp.maximum(n - 1.0, 1.0)

    @property
    def cost_var(self) -> Array:
        return self.cost_m2 / jnp.maximum(self.n - 1.0, 1.0)


def _moments_update(m: StreamingMoments, pose: Array, cost: Array, w: Array):
    """Gated Welford update (w = 0 skips, w = 1 folds the sample in)."""
    n = m.n + w
    n_safe = jnp.maximum(n, 1.0)
    d_pose = pose - m.pose_mean
    pose_mean = m.pose_mean + w * d_pose / n_safe
    pose_m2 = m.pose_m2 + w * d_pose * (pose - pose_mean)
    d_cost = cost - m.cost_mean
    cost_mean = m.cost_mean + w * d_cost / n_safe
    cost_m2 = m.cost_m2 + w * d_cost * (cost - cost_mean)
    return StreamingMoments(n, pose_mean, pose_m2, cost_mean, cost_m2)


@partial(jax.jit, static_argnames=("cfg", "burn"))
def run_chains_streaming(
    key: Array,
    pose0: Array,
    scene: Scene,
    cfg: SamplerConfig,
    burn: int = 0,
):
    """Chains with streaming posterior statistics instead of a pose trace.

    Returns ``(states, moments)`` where ``moments`` is a per-chain
    :class:`StreamingMoments` over the post-``burn`` samples: running
    mean/variance of every pose coordinate and of the accepted total cost,
    accumulated in-scan (numerically stable Welford recurrence) — constant
    memory at any iteration count, unlike ``trace_poses``.
    """
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(
        jnp.arange(cfg.n_chains)
    )
    if pose0.ndim == 2:
        pose0 = jnp.broadcast_to(pose0, (cfg.n_chains, *pose0.shape))

    def one_chain(k, p):
        state = mh_init(p, scene, k, cfg.mode)
        mom = StreamingMoments(
            n=jnp.float32(0.0),
            pose_mean=jnp.zeros_like(p),
            pose_m2=jnp.zeros_like(p),
            cost_mean=jnp.float32(0.0),
            cost_m2=jnp.float32(0.0),
        )

        def body(carry, _):
            s, m = carry
            s = mh_step(s, scene, cfg)
            w = (s.step > burn).astype(jnp.float32)
            m = _moments_update(m, s.pose, s.costs.total, w)
            return (s, m), None

        (state, mom), _ = jax.lax.scan(
            body, (state, mom), None, length=cfg.iterations
        )
        return finalize_costs(state, scene, cfg), mom

    return jax.vmap(one_chain)(keys, pose0)


def compile_chains(
    scene: Scene,
    cfg: SamplerConfig,
    trace_costs: bool = False,
    trace_poses: bool = False,
    thin: int = 1,
):
    """Compile a chain runner **specialized to one scene**.

    Returns ``runner(key, pose0) -> (states, trace)`` with the semantics of
    :func:`run_chains`, but with the scene arrays embedded as XLA constants
    instead of traced arguments. Constant scene tensors let XLA fold the
    scene-static subgraphs (masks, ranks, one-hot gathers, surface bounds)
    through the loop body (its speed on the GPU against ``run_chains``
    is in PERF.md). The trade: one fresh compile per scene, so
    use this for production serving of a fixed scene; use ``run_chains``
    when iterating over many scenes with one compiled program.

    Bitwise-identical results to ``run_chains`` (same key folding, same
    program semantics) — pinned by ``test_compile_chains_matches_run_chains``.

    Trace-free runners take an optional ``iterations=`` override per call
    (a runtime value — no recompile when the budget changes).
    """
    traced = trace_costs or trace_poses
    _validate_thin(thin, cfg.iterations)
    # trace-free runners force thin=1 into the impl: thin only affects
    # traces (results are bitwise identical), and the impl's thin>1 branch
    # scans the STATIC cfg.iterations length, which would silently ignore
    # the runtime ``iterations=`` override (round-3 advisor finding)
    impl_thin = thin if traced else 1

    @jax.jit
    def _runner(key: Array, pose0: Array, n_steps):
        return _chains_impl(key, pose0, scene, n_steps, cfg, trace_costs,
                            trace_poses, impl_thin)

    def runner(key: Array, pose0: Array, iterations: int | None = None):
        if traced:
            if iterations is not None:
                raise ValueError(
                    "iterations override needs a trace-free runner "
                    "(traces fix the scan length at compile time)"
                )
            return _runner(key, pose0, None)
        its = cfg.iterations if iterations is None else iterations
        _validate_thin(thin, its)
        return _runner(key, pose0, jnp.int32(its))

    return runner
