"""Vectorized geometry primitives.

Vectorized equivalents of the reference device helpers (SURVEY.md C3):
``Distance`` (``Kernel.cu:162``), ``theta`` (``:170``), ``phi`` (``:185``),
``calculateIntersectionArea`` (``:321``), ``createComplementRectangle``
(``:343``). All functions are elementwise over arbitrary batch shapes so the
cost terms can evaluate whole N x N / C x N matrices in one fused expression.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from mh_tpu.config import BIG

Array = jax.Array


def distance(xi: Array, yi: Array, xj: Array, yj: Array) -> Array:
    """Euclidean distance (``Kernel.cu:162-167``)."""
    dx = xi - xj
    dy = yi - yj
    return jnp.sqrt(dx * dx + dy * dy)


def theta(xi: Array, yi: Array, xj: Array, yj: Array, ti: Array, pi: float) -> Array:
    """Bearing of i as seen looking from i to j, re-oriented by ``ti``.

    ``Kernel.cu:170-182``: atan2 mapped to [0, 2*pi), minus the target
    rotation, wrapped once back into [0, 2*pi). ``pi`` is the mode's PI
    constant (3.1416 in parity mode — ``Kernel.cu:31``).
    """
    t = jnp.arctan2(yi - yj, xi - xj)
    t = jnp.where(t < 0, 2 * pi + t, t)
    t = t - ti
    return jnp.where(t < 0, 2 * pi + t, t)


def phi(xi: Array, yi: Array, xj: Array, yj: Array, tj: Array, pi: float) -> Array:
    """Facing angle of object j toward point i (``Kernel.cu:185-188``)."""
    return jnp.arctan2(yi - yj, xi - xj) - tj + pi / 2.0


def intersection_area(
    a_min_x: Array,
    a_min_y: Array,
    a_max_x: Array,
    a_max_y: Array,
    b_min_x: Array,
    b_min_y: Array,
    b_max_x: Array,
    b_max_y: Array,
) -> Array:
    """Overlap area of two AABBs; 0 when degenerate (``Kernel.cu:321-340``).

    Matches the reference's strict check: touching edges (x5 == x6) count as
    no intersection.
    """
    x5 = jnp.maximum(a_min_x, b_min_x)
    y5 = jnp.maximum(a_min_y, b_min_y)
    x6 = jnp.minimum(a_max_x, b_max_x)
    y6 = jnp.minimum(a_max_y, b_max_y)
    empty = (x5 >= x6) | (y5 >= y6)
    return jnp.where(empty, 0.0, (x6 - x5) * (y6 - y5))


def outside_surface_area(
    r_min_x: Array,
    r_min_y: Array,
    r_max_x: Array,
    r_max_y: Array,
    s_min_x: Array,
    s_min_y: Array,
    s_max_x: Array,
    s_max_y: Array,
) -> Array:
    """Area of an AABB lying outside the surface rectangle.

    The reference decomposes the complement of the surface into 4 half-plane
    rectangles with DBL_MAX extents (``createComplementRectangle``,
    ``Kernel.cu:343-364``) and sums 4 intersection areas
    (``Kernel.cu:463-466``). Same decomposition here with a finite ``BIG``
    sentinel (only compared, never multiplied — degenerate overlaps zero out
    before the area product).
    """
    # rect 1: full-width strip below the surface (Kernel.cu:345-348)
    a1 = intersection_area(
        r_min_x, r_min_y, r_max_x, r_max_y, -BIG, -BIG, BIG, s_min_y
    )
    # rect 2: left strip at surface height (Kernel.cu:350-353)
    a2 = intersection_area(
        r_min_x, r_min_y, r_max_x, r_max_y, -BIG, s_min_y, s_min_x, s_max_y
    )
    # rect 3: full-width strip above (Kernel.cu:355-358)
    a3 = intersection_area(r_min_x, r_min_y, r_max_x, r_max_y, -BIG, s_max_y, BIG, BIG)
    # rect 4: right strip at surface height (Kernel.cu:360-363)
    a4 = intersection_area(
        r_min_x, r_min_y, r_max_x, r_max_y, s_max_x, s_min_y, BIG, s_max_y
    )
    return a1 + a2 + a3 + a4


def wrap_angle_once(a: Array, pi: float) -> Array:
    """Single conditional wrap into [0, 2*pi] (``Kernel.cu:648-651``).

    The reference wraps at most once per proposal (if < 0 add 2*pi, else if
    > 2*pi subtract), which is sufficient because increments are bounded.
    """
    a = jnp.where(a < 0, a + 2 * pi, a)
    return jnp.where(a > 2 * pi, a - 2 * pi, a)
