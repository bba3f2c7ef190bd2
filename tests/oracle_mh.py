"""Reference-math MH chain in pure NumPy — the posterior-parity oracle.

An independent, loop-based implementation of the full reference sampling
process (propose -> cost -> Boltzmann accept, ``Kernel.cu:576-828``) on top
of the float64 cost oracle, with NumPy RNG. Used to check that the JAX
sampler targets the same stationary distribution (posterior moments agree
within Monte-Carlo error) — the BASELINE correctness gate.
"""

from __future__ import annotations

import math

import numpy as np

import oracle
from mh_tpu.models.scene import SceneSpec

REF_SIGMA_T = 15.0 / 90.0 * oracle.REF_PI  # Kernel.cu:39


def surface_bounds(spec: SceneSpec):
    q = np.asarray(spec.surface_quad, np.float64)
    return q[:, 0].min(), q[:, 1].min(), q[:, 0].max(), q[:, 1].max()


def propose(rng: np.random.Generator, pose: np.ndarray, spec: SceneSpec) -> np.ndarray:
    """One reference move (``Kernel.cu:576-704``); frozen assumed absent."""
    n = spec.n_objs
    star = pose.copy()
    mnx, mny, mxx, mxy = surface_bounds(spec)
    move = rng.integers(3)
    if move == 0:
        obj = rng.integers(n)
        dx = rng.normal() * (mxx - mnx) / 16.0
        dy = rng.normal() * (mxy - mny) / 16.0
        star[obj, 0] = min(max(star[obj, 0] + dx, mnx), mxx)
        star[obj, 1] = min(max(star[obj, 1] + dy, mny), mxy)
    elif move == 1:
        obj = rng.integers(n)
        r = star[obj, 4] + rng.normal() * REF_SIGMA_T
        if r < 0:
            r += 2 * oracle.REF_PI
        elif r > 2 * oracle.REF_PI:
            r -= 2 * oracle.REF_PI
        star[obj, 4] = r
    else:
        if n >= 2:
            i, j = rng.integers(n), rng.integers(n)
            star[[i, j]] = star[[j, i]]
    return star


def run_chain(
    spec: SceneSpec,
    n_steps: int,
    seed: int,
    beta: float = 2.0,
    collect_poses: bool = False,
    moves_per_step: int = 1,
    accept_draws: int = 1,
):
    """f64[n_steps] trace of accepted total costs (parity mode).

    With ``collect_poses``, also returns the f64[n_steps, N, 6] pose trace.
    ``moves_per_step`` composes K single-object moves into one compound
    proposal before the accept decision — the deterministic reading of the
    reference's blockDim-threads-per-iteration scheme (``Kernel.cu:798``).
    ``accept_draws`` emulates the reference's per-thread divergent accept
    (``Kernel.cu:819``): each of blockxDim threads draws an independent
    accept decision on the shared candidate, so the compound proposal is
    accepted with probability 1-(1-p)^K — equivalently, iff the min of K
    uniforms is below the ratio.
    """
    rng = np.random.default_rng(seed)
    pose = np.asarray(spec.positions, np.float64).copy()
    cur = oracle.breakdown(spec, pose, parity=True)["total"]
    trace = np.empty(n_steps)
    poses = np.empty((n_steps, *pose.shape)) if collect_poses else None
    for t in range(n_steps):
        star = propose(rng, pose, spec)
        for _ in range(moves_per_step - 1):
            star = propose(rng, star, spec)
        s = oracle.breakdown(spec, star, parity=True)["total"]
        u = rng.random(accept_draws).min()
        if u < min(1.0, math.exp(min(beta * (s - cur), 0.0))):
            pose, cur = star, s
        trace[t] = cur
        if collect_poses:
            poses[t] = pose
    return (trace, poses) if collect_poses else trace
