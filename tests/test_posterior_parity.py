"""Posterior-moment parity: JAX sampler vs the NumPy reference-math chain.

BASELINE correctness gate: "posterior moments of layout parameters ...
match the reference implementation within Monte-Carlo error". The oracle
chain (tests/oracle_mh.py) reproduces the reference sampling process in
float64 NumPy with an independent RNG; agreement of the stationary cost
distribution is strong evidence both samplers target the same posterior.
"""

import numpy as np
import pytest

import oracle_mh
from mh_tpu.config import SamplerConfig
from mh_tpu.models.scene import demo_scene
from mh_tpu.sampler.mh import run_chains


@pytest.mark.slow
def test_posterior_cost_moments_match_oracle():
    spec = demo_scene(6)
    scene = spec.build()
    steps, burn = 1500, 500

    # oracle: 4 independent float64 chains
    otraces = np.stack(
        [oracle_mh.run_chain(spec, steps, seed=100 + s) for s in range(4)]
    )
    o_samples = otraces[:, burn:].reshape(-1)

    # ours: 16 vmapped chains
    cfg = SamplerConfig(iterations=steps, n_chains=16)
    import jax

    _, traces = run_chains(
        jax.random.key(0), spec.initial_pose(), scene, cfg, trace_costs=True
    )
    m_samples = np.asarray(traces)[:, burn:].reshape(-1)

    o_mean, o_std = o_samples.mean(), o_samples.std()
    m_mean, m_std = m_samples.mean(), m_samples.std()

    # autocorrelated chains: compare with generous MC-error bands
    assert abs(m_mean - o_mean) < 0.25 * o_std, (m_mean, o_mean, o_std)
    assert 0.5 < m_std / o_std < 2.0, (m_std, o_std)


@pytest.mark.slow
def test_posterior_pose_moments_match_oracle():
    """Layout-parameter posterior means (mean x, y over objects) agree.

    Runs on the *streaming* Welford statistics (``run_chains_streaming``)
    instead of an O(T*N*6) pose trace, so the same gate scales to 1e5+
    iteration posterior runs.
    """
    import jax

    from mh_tpu.sampler.mh import run_chains_streaming

    spec = demo_scene(6)
    scene = spec.build()
    steps, burn = 1500, 500

    otr, oposes = oracle_mh.run_chain(spec, steps, seed=7, collect_poses=True)
    o_xy = oposes[burn:, :, :2]  # [T, N, 2]

    cfg = SamplerConfig(iterations=steps, n_chains=8)
    _, mom = run_chains_streaming(
        jax.random.key(3), spec.initial_pose(), scene, cfg, burn=burn
    )
    m_mean_xy = np.asarray(mom.pose_mean)[:, :, :2]  # [chains, N, 2]
    m_var_xy = np.asarray(mom.pose_var)[:, :, :2]

    # posterior mean position of each object, within loose MC bands (the
    # scene is symmetric under object swaps so object identity mixes; use
    # the scene-level mean and spread instead of per-object comparison)
    o_mean = o_xy.mean(axis=(0, 1))
    m_mean = m_mean_xy.mean(axis=(0, 1))
    o_spread = o_xy.std()
    np.testing.assert_allclose(m_mean, o_mean, atol=0.35 * o_spread)
    # within-chain + between-chain variance recombines the total spread
    m_total_var = m_var_xy.mean() + m_mean_xy.var(axis=0).mean()
    assert 0.25 < m_total_var / o_spread**2 < 4.0


def test_streaming_moments_match_trace():
    """The in-scan Welford moments must equal the trace-computed moments."""
    import jax

    from mh_tpu.sampler.mh import run_chains_streaming

    spec = demo_scene(6)
    scene = spec.build()
    burn = 50
    cfg = SamplerConfig(iterations=200, n_chains=4)
    key = jax.random.key(9)
    _, trace = run_chains(
        key, spec.initial_pose(), scene, cfg, trace_costs=True,
        trace_poses=True,
    )
    _, mom = run_chains_streaming(
        key, spec.initial_pose(), scene, cfg, burn=burn
    )
    costs, poses = np.asarray(trace[0]), np.asarray(trace[1])
    assert np.all(np.asarray(mom.n) == cfg.iterations - burn)
    np.testing.assert_allclose(
        np.asarray(mom.pose_mean), poses[:, burn:].mean(axis=1),
        rtol=1e-5, atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(mom.pose_var), poses[:, burn:].var(axis=1, ddof=1),
        rtol=2e-4, atol=1e-4,
    )
    np.testing.assert_allclose(
        np.asarray(mom.cost_mean), costs[:, burn:].mean(axis=1), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(mom.cost_var), costs[:, burn:].var(axis=1, ddof=1),
        rtol=2e-3,
    )


def test_thinned_trace_matches_full_trace():
    """thin=k keeps exactly every k-th step of the full trace (same chains)."""
    import jax

    spec = demo_scene(6)
    scene = spec.build()
    cfg = SamplerConfig(iterations=120, n_chains=3)
    key = jax.random.key(11)
    sf, full = run_chains(
        key, spec.initial_pose(), scene, cfg, trace_poses=True
    )
    st, thin = run_chains(
        key, spec.initial_pose(), scene, cfg, trace_poses=True, thin=4
    )
    full_p, thin_p = np.asarray(full), np.asarray(thin)
    assert thin_p.shape[1] == 30
    np.testing.assert_array_equal(thin_p, full_p[:, 3::4])
    np.testing.assert_array_equal(np.asarray(sf.pose), np.asarray(st.pose))


def test_posterior_cost_moments_match_oracle_block_proposals():
    """Compound K-move proposals (the deterministic reading of the
    reference's 64-threads-per-iteration scheme, ``Kernel.cu:798``) must
    track the same transient cost process as the K-move float64 oracle.

    Calibration note: the PARITY target is improper (negative weights
    reward violations without bound), so the windowed cost mean behaves
    like a drifting random walk — measured oracle-vs-oracle spread across
    seed sets is ~0.5 sigma of the marginal std (means 452-547 for 4-chain
    pools at these settings). The gate uses a 12-chain oracle pool and a
    0.5 sigma band: tight enough to catch dynamics bugs (a wrong move mix
    or broken composition shifts the drift rate well past that), honest
    about the statistic's seed variance.
    """
    spec = demo_scene(6)
    scene = spec.build()
    steps, burn, K = 1200, 400, 4

    otraces = np.stack([
        oracle_mh.run_chain(spec, steps, seed=200 + s, moves_per_step=K)
        for s in range(12)
    ])
    o_samples = otraces[:, burn:].reshape(-1)

    cfg = SamplerConfig(iterations=steps, n_chains=16, n_moves_per_step=K)
    import jax

    _, traces = run_chains(
        jax.random.key(1), spec.initial_pose(), scene, cfg, trace_costs=True
    )
    m_samples = np.asarray(traces)[:, burn:].reshape(-1)

    o_mean, o_std = o_samples.mean(), o_samples.std()
    m_mean, m_std = m_samples.mean(), m_samples.std()
    assert abs(m_mean - o_mean) < 0.5 * o_std, (m_mean, o_mean, o_std)
    assert 0.5 < m_std / o_std < 2.0, (m_std, o_std)


def test_reference_default_config_accept_draws():
    """Behavioral parity of the reference's DEFAULT launch configuration:
    32 objects, 1 block x 64 threads, 100 iterations (``Kernel.cu:1189-1194``).

    Each of the 64 threads injects a move into the shared candidate AND
    draws an *independent* accept decision on it (``Kernel.cu:798,819``), so
    the compound proposal's effective acceptance is 1-(1-p)^64.
    ``accept_draws=64`` reproduces that marginal deterministically (accept
    iff min of 64 uniforms < ratio); the float64 oracle emulates the same
    semantics. The transient cost process over the 100 reference iterations
    must track the oracle's within Monte-Carlo bands.
    """
    import jax

    spec = demo_scene(32)
    scene = spec.build()
    steps, K = 100, 64

    otraces = np.stack([
        oracle_mh.run_chain(
            spec, steps, seed=300 + s, moves_per_step=K, accept_draws=K
        )
        for s in range(6)
    ])

    cfg = SamplerConfig(
        iterations=steps, n_chains=16, n_moves_per_step=K, accept_draws=K
    )
    states, traces = run_chains(
        jax.random.key(2), spec.initial_pose(), scene, cfg, trace_costs=True
    )
    m = np.asarray(traces)  # [16, steps]

    # K independent draws on one candidate lift acceptance ~3 orders of
    # magnitude above the single-draw joint rate (~1.6e-5 at K=64, round 1
    # measurement); the oracle emulation lands at ~1% on this config.
    # Binomial bands: 16 chains x 100 steps at p~0.01 -> se(mean) ~ 0.25%.
    acc = np.asarray(states.accept_rate)
    o_acc = np.mean(otraces[:, 1:] != otraces[:, :-1])  # lower bound on rate
    assert 0.001 < acc.mean() < 0.05, acc.mean()
    assert abs(acc.mean() - 0.01) < 0.01, (acc.mean(), o_acc)

    # drift parity: at ~1 accepted compound move per chain the trajectory is
    # a rare-jump process; compare total drift over the run, banded by the
    # oracle's cross-chain spread of the same statistic.
    o_drift = otraces[:, -1] - otraces[:, 0]
    m_drift = m[:, -1] - m[:, 0]
    band = 3.0 * o_drift.std() / np.sqrt(16) + 3.0 * o_drift.std() / np.sqrt(6)
    assert abs(m_drift.mean() - o_drift.mean()) < band, (
        m_drift.mean(), o_drift.mean(), band
    )


def test_accept_draws_transient_tracks_oracle():
    """accept_draws=K at a config with visible dynamics (K=8, 6 objects):
    the stationary-window cost moments must track the K-draw oracle.

    Band calibration (same reasoning as the block-proposal test above): the
    improper PARITY target drifts, and measured 8-chain oracle pools at
    these settings span means 376-409 (std 50-79) across seed sets — so the
    mean gate uses a 12-chain pool and a 0.75 sigma band; the acceptance
    rate (where the K-draw emulation would actually break) gets a tight
    +-0.05 gate against the oracle's ~0.085.
    """
    import jax

    spec = demo_scene(6)
    scene = spec.build()
    steps, K = 800, 8

    otraces = np.stack([
        oracle_mh.run_chain(
            spec, steps, seed=400 + s, moves_per_step=K, accept_draws=K
        )
        for s in range(12)
    ])

    cfg = SamplerConfig(
        iterations=steps, n_chains=16, n_moves_per_step=K, accept_draws=K
    )
    states, traces = run_chains(
        jax.random.key(4), spec.initial_pose(), scene, cfg, trace_costs=True
    )
    m = np.asarray(traces)

    # acceptance rates agree (K draws boost both sides identically)
    o_acc = np.mean(otraces[:, 1:] != otraces[:, :-1])
    acc = float(np.asarray(states.accept_rate).mean())
    assert abs(acc - o_acc) < 0.05, (acc, o_acc)

    burn = 300
    o_s, m_s = otraces[:, burn:].reshape(-1), m[:, burn:].reshape(-1)
    o_mean, o_std = o_s.mean(), o_s.std()
    assert abs(m_s.mean() - o_mean) < 0.75 * o_std, (m_s.mean(), o_mean, o_std)
    assert 0.5 < m_s.std() / o_std < 2.0, (m_s.std(), o_std)
