"""Monte-Carlo pi estimator (SURVEY.md B10).

A JAX re-creation of the NVIDIA ``MC_EstimatePiInlineP`` sample whose
project shell the reference repurposed (``MC_EstimatePiInlineP/readme.txt:4-9``;
sources absent from the repo): draw uniform points in the unit square, the
fraction inside the quarter disc estimates pi/4. Runs on the same
counter-based threefry RNG substrate as the layout sampler and is
CPU-runnable — BASELINE.md measurement config 1.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

Array = jax.Array


@partial(jax.jit, static_argnames=("n_samples", "batch"))
def estimate_pi(key: Array, n_samples: int = 1 << 20, batch: int = 1 << 16) -> Array:
    """Estimate pi with ``n_samples`` points, evaluated in fixed-size batches.

    Batching keeps peak memory flat for very large sample counts while the
    ``lax.scan`` stays a single compiled program.
    """
    n_batches = -(-n_samples // batch)
    total = n_batches * batch

    def body(carry, i):
        k = jax.random.fold_in(key, i)
        pts = jax.random.uniform(k, (batch, 2))
        inside = jnp.sum(jnp.square(pts), axis=1) <= 1.0
        return carry + jnp.sum(inside.astype(jnp.float64 if jax.config.x64_enabled else jnp.float32)), None

    hits, _ = jax.lax.scan(body, jnp.float32(0.0), jnp.arange(n_batches))
    return 4.0 * hits / total
