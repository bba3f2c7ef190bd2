"""Advanced sampling demo: collective adaptation, tempering, SMC, HMC, NUTS, VI.

Runs every sampler family in the framework on the reference demo scene over
a device mesh (all local devices; on CPU, set
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` for a virtual mesh).

Usage: python examples/advanced_sampling.py [--objects 16] [--replicas 16]
"""

from __future__ import annotations

# script-launch robustness: make the repo root importable even when the
# dev .pth is absent (fresh environments)
import os as _os, sys as _sys
_ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
if _ROOT not in _sys.path:
    _sys.path.insert(0, _ROOT)

import argparse

import jax
import numpy as np

from mh_tpu.config import SamplerConfig
from mh_tpu.models.scene import demo_scene
from mh_tpu.parallel.mesh import chain_mesh, device_report
from mh_tpu.parallel.sharded import run_chains_collective
from mh_tpu.sampler.generic import layout_logdensity, theta_from_pose
from mh_tpu.sampler.hmc import hmc_sample
from mh_tpu.sampler.smc import run_smc
from mh_tpu.sampler.tempering import run_tempered
from mh_tpu.sampler.vi import meanfield_vi
from mh_tpu.utils.compile_cache import enable_compile_cache


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--objects", type=int, default=16)
    ap.add_argument("--replicas", type=int, default=16)
    args = ap.parse_args()

    enable_compile_cache()
    print(device_report())
    mesh = chain_mesh()
    n_dev = len(jax.devices())
    spec = demo_scene(args.objects)
    scene = spec.build()
    pose0 = spec.initial_pose()
    key = jax.random.key(0)

    n_chains = max(args.replicas, n_dev) // n_dev * n_dev

    print("\n== collective acceptance-rate adaptation (psum) ==")
    cfg = SamplerConfig(iterations=0, n_chains=n_chains, adapt_rate=0.2,
                        target_accept=0.35)
    states, rates, log_scale = run_chains_collective(
        key, pose0, scene, cfg, mesh, rounds=10, steps_per_round=10
    )
    print(f"accept-rate trace: {np.round(np.asarray(rates), 3)}")
    print(f"shared step-size scale: {float(np.exp(log_scale)):.3f}")

    print("\n== parallel tempering (ppermute replica exchange) ==")
    states, swap_rates = run_tempered(
        key, pose0, scene, SamplerConfig(iterations=0), mesh,
        n_replicas=n_chains, exchange_every=5, rounds=10,
    )
    print(f"swap-rate trace: {np.round(np.asarray(swap_rates), 3)}")
    print(f"target-replica total cost: {np.asarray(states.costs.total)[-1]:.2f}")

    print("\n== parallel tempering with swap-rate-adaptive ladder ==")
    states, swap_rates, betas_adapted = run_tempered(
        key, pose0, scene, SamplerConfig(iterations=0), mesh,
        n_replicas=n_chains, exchange_every=5, rounds=10, adapt_ladder=True,
    )
    print(f"adapted ladder: {np.round(np.asarray(betas_adapted), 4)}")
    print(f"swap-rate trace: {np.round(np.asarray(swap_rates), 3)}")

    print("\n== annealed SMC (all_gather resampling) ==")
    states, diag = run_smc(
        key, pose0, scene, SamplerConfig(iterations=0), mesh,
        n_particles=n_chains, n_stages=8, mutate_steps=3,
    )
    print(f"ESS trace: {np.round(np.asarray(diag['ess']), 1)}")
    print(f"resampled at stages: {np.where(np.asarray(diag['resampled']))[0].tolist()}")
    print(f"log evidence: {float(diag['log_evidence']):.2f}")

    print("\n== adaptive-tempered SMC from the beta=0 prior ==")
    states, diag = run_smc(
        key, pose0, scene, SamplerConfig(iterations=0), mesh,
        n_particles=n_chains, n_stages=8, mutate_steps=3,
        adaptive=True, init="prior",
    )
    print(f"beta schedule: {np.round(np.asarray(diag['betas']), 4)}")
    print(f"ESS trace: {np.round(np.asarray(diag['ess']), 1)}")
    print(f"log evidence: {float(diag['log_evidence']):.2f}")

    # Gradient-based samplers need a *proper* target: the reference's parity
    # semantics (negative weights + reward-higher-total accept) make the
    # density improper — violations increase the score without bound, and
    # HMC/VI will faithfully follow that gradient to infinity. Use FIXED
    # mode with positive penalty weights: total <= 0, density integrable.
    import dataclasses

    from mh_tpu.config import CostMode

    sane = dataclasses.replace(
        spec,
        w_pairwise=2.0, w_visual_balance=1.0, w_focal=2.0, w_symmetry=2.0,
        w_clearance=2.0, w_offlimits=1.0, w_surface_area=2.0,
    )
    sane_scene = sane.build()
    target = layout_logdensity(sane_scene, pose0, beta=2.0, mode=CostMode.FIXED)

    print("\n== HMC on the (proper, FIXED-mode) layout log-density ==")
    samples, final = hmc_sample(
        jax.random.key(1), target, theta_from_pose(pose0), n_samples=100,
        n_warmup=100, n_leapfrog=8, n_chains=2,
    )
    print(f"accept: {np.asarray(final.n_accept) / 100}")
    print(f"final log-density: {np.round(np.asarray(final.logprob), 2)}")

    print("\n== NUTS (adaptive trajectory length) on the same target ==")
    from mh_tpu.sampler.nuts import nuts_sample

    samples, nfinal = nuts_sample(
        jax.random.key(3), target, theta_from_pose(pose0), n_samples=50,
        n_warmup=50, max_depth=6, n_chains=2,
    )
    print(f"mean tree depth: {np.asarray(nfinal.sum_depth) / 50}")
    print(f"divergences: {np.asarray(nfinal.n_divergent)}")
    print(f"final log-density: {np.round(np.asarray(nfinal.logprob), 2)}")

    print("\n== mean-field VI ==")
    mu, sigma, trace = meanfield_vi(
        jax.random.key(2), target, theta_from_pose(pose0), n_steps=300, n_mc=8
    )
    t = np.asarray(trace)
    print(f"ELBO: start {t[:20].mean():.1f} -> end {t[-20:].mean():.1f}")


if __name__ == "__main__":
    main()
