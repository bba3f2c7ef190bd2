"""No-U-Turn Sampler (NUTS) on the generic log-density abstraction.

North-star scope (no reference counterpart — the reference's only kernel is
random-walk MH, ``Kernel.cu:706-713``): multinomial NUTS (Hoffman & Gelman
2014; Betancourt 2017 multinomial variant) with dual-averaging step-size
warmup, sharing the ``logdensity_fn`` interface of :mod:`mh_tpu.sampler.hmc`
and :mod:`mh_tpu.sampler.generic`.

Static-shape design notes
-------------------------
The classic recursive tree build is replaced by a **stored-subtree** scheme
that is jit/vmap-friendly with fully static shapes:

- The doubling loop is unrolled over ``max_depth`` Python iterations, each
  guarded by ``lax.cond`` on the termination flag. Doubling ``j`` runs one
  ``lax.scan`` of static length ``2**j`` leapfrog steps and keeps the whole
  subtree (positions, momenta, grads, log-probs) as arrays.
- Sub-U-turn checks — exactly the set the recursive algorithm performs at
  each internal merge node — become level-wise reshapes over the stored
  subtree: for level ``l``, segments are ``reshape(m // 2**l, 2**l, D)`` and
  the check reads the two endpoint rows. No recursion, no dynamic shapes.
- In-subtree multinomial sampling is a single Gumbel-argmax over the stored
  log-weights; across doublings, biased progressive sampling keeps one
  proposal (Stan's scheme), so memory stays O(2**max_depth · D) per chain.

Under ``vmap`` both ``cond`` branches execute, so a batched chain always
pays the full ``2**max_depth - 1`` leapfrog gradients per draw; that is the
standard static-shape trade-off on an accelerator and is what keeps the program a
single fused XLA computation.

Leapfrog with a negated step retraces the trajectory with identical physical
momenta (time-reversibility), so backward expansion reuses the same scan
with ``eps * v``; U-turn dot products are sign-corrected by ``v``.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp

Array = jax.Array
LogDensity = Callable[[Array], Array]

_DIVERGENCE_THRESHOLD = 1000.0  # energy error that flags a divergent transition


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NUTSState:
    theta: Array
    logprob: Array
    grad: Array
    n_divergent: Array  # int32: divergent transitions seen so far
    sum_depth: Array  # int32: accumulated tree depth (for mean-depth diagnostics)
    # dual-averaging state (Hoffman & Gelman 2014, Alg. 6)
    log_eps: Array
    log_eps_avg: Array
    h_avg: Array


def nuts_init(logdensity_fn: LogDensity, theta0: Array, step_size: float) -> NUTSState:
    lp, g = jax.value_and_grad(logdensity_fn)(theta0)
    return NUTSState(
        theta=theta0,
        logprob=lp,
        grad=g,
        n_divergent=jnp.int32(0),
        sum_depth=jnp.int32(0),
        log_eps=jnp.log(jnp.float32(step_size)),
        log_eps_avg=jnp.log(jnp.float32(step_size)),
        h_avg=jnp.float32(0.0),
    )


def _leapfrog_trajectory(logdensity_fn, theta, p, grad, eps, n_steps):
    """Run ``n_steps`` leapfrog steps; return every visited state as arrays."""

    def body(carry, _):
        theta, p, grad = carry
        p_half = p + 0.5 * eps * grad
        theta = theta + eps * p_half
        lp, grad = jax.value_and_grad(logdensity_fn)(theta)
        p = p_half + 0.5 * eps * grad
        return (theta, p, grad), (theta, p, grad, lp)

    _, (thetas, ps, grads, lps) = jax.lax.scan(
        body, (theta, p, grad), None, length=n_steps
    )
    return thetas, ps, grads, lps


def _subtree_uturn(thetas: Array, ps: Array, v: Array) -> Array:
    """Sub-U-turn check over a stored subtree (traversal order, m = 2**j).

    Checks every aligned segment of length ``2**l`` for ``l = 1..j`` — the
    same internal merge nodes the recursive build tests. ``v`` corrects for
    temporal orientation when the subtree grew backward.
    """
    m = thetas.shape[0]
    uturn = jnp.bool_(False)
    level = 2
    while level <= m:
        seg_t = thetas.reshape(m // level, level, -1)
        seg_p = ps.reshape(m // level, level, -1)
        d = seg_t[:, -1] - seg_t[:, 0]  # traversal-order span per segment
        lo = jnp.sum(d * seg_p[:, 0], axis=-1) * v
        hi = jnp.sum(d * seg_p[:, -1], axis=-1) * v
        uturn |= jnp.any((lo < 0.0) | (hi < 0.0))
        level *= 2
    return uturn


def nuts_step(
    key: Array,
    state: NUTSState,
    logdensity_fn: LogDensity,
    max_depth: int,
    step: Array,
    adapt: bool = True,
    target_accept: float = 0.8,
    t0: float = 10.0,
    gamma: float = 0.05,
    kappa: float = 0.75,
) -> NUTSState:
    """One NUTS transition (tree doubling up to ``max_depth``)."""
    k_mom, k_loop = jax.random.split(key)
    eps = jnp.exp(state.log_eps)
    p0 = jax.random.normal(k_mom, state.theta.shape)
    h0 = state.logprob - 0.5 * jnp.sum(jnp.square(p0))

    carry = {
        # temporal trajectory edges
        "theta_minus": state.theta, "p_minus": p0, "grad_minus": state.grad,
        "theta_plus": state.theta, "p_plus": p0, "grad_plus": state.grad,
        # current proposal (initial point has log-weight 0 relative to h0)
        "theta": state.theta, "logprob": state.logprob, "grad": state.grad,
        "log_sum_w": jnp.float32(0.0),
        "done": jnp.bool_(False),
        "divergent": jnp.bool_(False),
        "depth": jnp.int32(0),
        "alpha_sum": jnp.float32(0.0),
        "n_alpha": jnp.float32(0.0),
    }

    def expand(j, c):
        m = 1 << j
        kj = jax.random.fold_in(k_loop, j)
        k_dir, k_gum, k_take = jax.random.split(kj, 3)
        v = jnp.where(jax.random.uniform(k_dir) < 0.5, -1.0, 1.0).astype(jnp.float32)

        edge_theta = jnp.where(v > 0, c["theta_plus"], c["theta_minus"])
        edge_p = jnp.where(v > 0, c["p_plus"], c["p_minus"])
        edge_grad = jnp.where(v > 0, c["grad_plus"], c["grad_minus"])

        thetas, ps, grads, lps = _leapfrog_trajectory(
            logdensity_fn, edge_theta, edge_p, edge_grad, eps * v, m
        )
        ws = lps - 0.5 * jnp.sum(jnp.square(ps), axis=-1) - h0  # log-weights [m]
        ws = jnp.where(jnp.isfinite(ws), ws, -jnp.inf)
        div = jnp.any(ws < -_DIVERGENCE_THRESHOLD)
        alpha_sum = c["alpha_sum"] + jnp.sum(jnp.exp(jnp.minimum(ws, 0.0)))
        n_alpha = c["n_alpha"] + jnp.float32(m)

        internal_ut = _subtree_uturn(thetas, ps, v) if m > 1 else jnp.bool_(False)
        subtree_ok = ~(div | internal_ut)

        # multinomial draw within the subtree (Gumbel-argmax over log-weights)
        gumbel = -jnp.log(-jnp.log(jax.random.uniform(k_gum, (m,)) + 1e-38) + 1e-38)
        idx = jnp.argmax(ws + gumbel)
        log_sum_w_new = jax.scipy.special.logsumexp(ws)

        # biased progressive sampling across doublings (Stan)
        take = subtree_ok & (
            jnp.log(jax.random.uniform(k_take) + 1e-38)
            < log_sum_w_new - c["log_sum_w"]
        )
        theta_p = jnp.where(take, thetas[idx], c["theta"])
        lp_p = jnp.where(take, lps[idx], c["logprob"])
        grad_p = jnp.where(take, grads[idx], c["grad"])
        log_sum_w = jnp.where(
            subtree_ok, jnp.logaddexp(c["log_sum_w"], log_sum_w_new), c["log_sum_w"]
        )

        # extend the temporal edge that grew (only if the subtree is kept)
        grow_plus = subtree_ok & (v > 0)
        grow_minus = subtree_ok & (v <= 0)
        theta_plus = jnp.where(grow_plus, thetas[-1], c["theta_plus"])
        p_plus = jnp.where(grow_plus, ps[-1], c["p_plus"])
        grad_plus = jnp.where(grow_plus, grads[-1], c["grad_plus"])
        theta_minus = jnp.where(grow_minus, thetas[-1], c["theta_minus"])
        p_minus = jnp.where(grow_minus, ps[-1], c["p_minus"])
        grad_minus = jnp.where(grow_minus, grads[-1], c["grad_minus"])

        d = theta_plus - theta_minus
        full_ut = (jnp.sum(d * p_minus) < 0.0) | (jnp.sum(d * p_plus) < 0.0)

        return {
            "theta_minus": theta_minus, "p_minus": p_minus, "grad_minus": grad_minus,
            "theta_plus": theta_plus, "p_plus": p_plus, "grad_plus": grad_plus,
            "theta": theta_p, "logprob": lp_p, "grad": grad_p,
            "log_sum_w": log_sum_w,
            "done": ~subtree_ok | full_ut,
            "divergent": c["divergent"] | div,
            "depth": jnp.where(subtree_ok, jnp.int32(j + 1), c["depth"]),
            "alpha_sum": alpha_sum,
            "n_alpha": n_alpha,
        }

    for j in range(max_depth):
        carry = jax.lax.cond(carry["done"], lambda c: c, partial(expand, j), carry)

    accept_prob = carry["alpha_sum"] / jnp.maximum(carry["n_alpha"], 1.0)

    log_eps, log_eps_avg, h_avg = state.log_eps, state.log_eps_avg, state.h_avg
    if adapt:
        m_t = step.astype(jnp.float32) + 1.0
        eta = 1.0 / (m_t + t0)
        h_avg = (1.0 - eta) * h_avg + eta * (target_accept - accept_prob)
        mu = jnp.log(10.0) + state.log_eps_avg
        log_eps = mu - jnp.sqrt(m_t) / gamma * h_avg
        w = m_t ** (-kappa)
        log_eps_avg = w * log_eps + (1.0 - w) * log_eps_avg

    return NUTSState(
        theta=carry["theta"],
        logprob=carry["logprob"],
        grad=carry["grad"],
        n_divergent=state.n_divergent + carry["divergent"].astype(jnp.int32),
        sum_depth=state.sum_depth + carry["depth"],
        log_eps=log_eps,
        log_eps_avg=log_eps_avg,
        h_avg=h_avg,
    )


@partial(
    jax.jit,
    static_argnames=("logdensity_fn", "n_samples", "n_warmup", "max_depth", "n_chains"),
)
def nuts_sample(
    key: Array,
    logdensity_fn: LogDensity,
    theta0: Array,
    n_samples: int,
    n_warmup: int = 200,
    max_depth: int = 8,
    step_size: float = 0.1,
    n_chains: int = 1,
    target_accept: float = 0.8,
):
    """Adaptive NUTS: dual-averaging warmup, then fixed-step sampling.

    Returns ``(samples f32[n_chains, n_samples, D], final NUTSState batch)``.
    Diagnostics on the final state: ``n_divergent`` (sampling phase only) and
    ``sum_depth / n_samples`` (mean tree depth).
    """
    if theta0.ndim == 1:
        theta0 = jnp.broadcast_to(theta0, (n_chains, *theta0.shape))

    def one_chain(ck, t0_theta):
        state = nuts_init(logdensity_fn, t0_theta, step_size)

        def warm(s, i):
            s = nuts_step(
                jax.random.fold_in(ck, i), s, logdensity_fn, max_depth, i,
                adapt=True, target_accept=target_accept,
            )
            return s, None

        state, _ = jax.lax.scan(warm, state, jnp.arange(n_warmup))
        # freeze at the averaged step size; reset diagnostics for sampling
        state = dataclasses.replace(
            state,
            log_eps=state.log_eps_avg,
            n_divergent=jnp.int32(0),
            sum_depth=jnp.int32(0),
        )

        def draw(s, i):
            s = nuts_step(
                jax.random.fold_in(ck, n_warmup + i), s, logdensity_fn,
                max_depth, i, adapt=False,
            )
            return s, s.theta

        state, samples = jax.lax.scan(draw, state, jnp.arange(n_samples))
        return samples, state

    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n_chains))
    return jax.vmap(one_chain)(keys, theta0)
