"""Scene data model: static-shaped, masked PyTrees.

Static-shape re-design of the reference wire structs (``Kernel.cu:43-149``):
``vertex``/``rectangle``/``positionAndRotation``/``relationshipStruct``/
``relationshipAngleStruct``/``Surface``. Instead of pointer-chased AoS
structs, the scene is a struct-of-arrays PyTree with *static* shapes
(padded + masked) so one jitted program serves any scene up to the padded
sizes — no recompilation per scene, no dynamic shapes in the hot loop.

A key simplification the reference's AABB semantics allow: rectangles never
rotate (``minValue``/``maxValue`` ignore rotation, ``Kernel.cu:366-401``), so
each rect's local AABB is *constant* and is precomputed **once** here instead
of being re-reduced from 4 vertices at every cost evaluation (the reference
re-reduces per term per iteration, e.g. ``Kernel.cu:414-423``).

To preserve the reference's ``minValue`` parity quirk — the first x-candidate
is assigned *untranslated* (``Kernel.cu:371``) — we keep two precomputed
values per rect: the first vertex's x (``v0x``) and the min over the other
three translated xs (``tail_min_x``); see :meth:`RectSet.aabb`.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from mh_tpu.config import CostMode

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class RectSet:
    """Precomputed local AABBs for a set of M axis-aligned rectangles.

    Fields are ``f32[M]``. ``v0x`` / ``tail_min_x`` support the parity-mode
    min-x quirk (``Kernel.cu:371``); ``min_x`` is the corrected value.
    """

    v0x: Array
    tail_min_x: Array
    min_x: Array
    min_y: Array
    max_x: Array
    max_y: Array

    def aabb(self, tx: Array, ty: Array, mode: CostMode):
        """AABB (min_x, min_y, max_x, max_y) after translating by (tx, ty).

        Parity: min_x = min(v0x, tail_min_x + tx) — first vertex untranslated,
        exactly the reference reduction order (``Kernel.cu:371-374``; min is
        commutative so the 4-way chain collapses to this two-way min).
        """
        if mode is CostMode.PARITY:
            mnx = jnp.minimum(self.v0x, self.tail_min_x + tx)
        else:
            mnx = self.min_x + tx
        return mnx, self.min_y + ty, self.max_x + tx, self.max_y + ty


def rects_from_vertices(vertices: np.ndarray, start_indices: Sequence[int]) -> RectSet:
    """Build a :class:`RectSet` from a flat vertex array + per-rect start index.

    Mirrors the reference convention: each rectangle is 4 *consecutive*
    vertices beginning at ``point1Index`` (``rectangle.point2Index..4`` exist
    but are never read — ``Kernel.cu:366-401``, callers ``Kernel.cu:414``).
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    idx = np.asarray(start_indices, dtype=np.int64)
    quads = np.stack([vertices[idx + k] for k in range(4)], axis=1)  # [M,4,>=2]
    xs, ys = quads[..., 0], quads[..., 1]
    return RectSet(
        v0x=jnp.asarray(xs[:, 0], jnp.float32),
        tail_min_x=jnp.asarray(xs[:, 1:].min(axis=1), jnp.float32),
        min_x=jnp.asarray(xs.min(axis=1), jnp.float32),
        min_y=jnp.asarray(ys.min(axis=1), jnp.float32),
        max_x=jnp.asarray(xs.max(axis=1), jnp.float32),
        max_y=jnp.asarray(ys.max(axis=1), jnp.float32),
    )


def _pad_rects(r: RectSet, n: int) -> RectSet:
    def pad(a):
        a = jnp.asarray(a)
        return jnp.pad(a, (0, n - a.shape[0]))

    return RectSet(*[pad(getattr(r, f.name)) for f in dataclasses.fields(RectSet)])


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Scene:
    """The static scene: everything except the mutable object poses.

    Replaces the reference's ``Surface`` + relationship/clearance/off-limits
    arrays (``Kernel.cu:79-117``). All arrays are padded to static maxima
    with 0/1 masks; the pose itself lives in the sampler state.
    """

    # objects ---------------------------------------------------------------
    obj_mask: Array  # f32[N] — 1 for real objects, 0 for padding
    frozen: Array  # bool[N] — frozen objects are never proposed (Kernel.cu:601)
    sizes: Array  # f32[N,2] — (length, width) for visual balance (Kernel.cu:199)
    off_rects: RectSet  # per-object off-limits local AABBs (len N)
    # surface ---------------------------------------------------------------
    surface: RectSet  # len 1 — the surface rectangle (Kernel.cu:448-449)
    centroid: Array  # f32[2] — Surface.centroidX/Y (Kernel.cu:110-111)
    focal: Array  # f32[2] — focal point (Kernel.cu:114-115)
    focal_rot: Array  # f32[] — symmetry-axis direction (Kernel.cu:116)
    # weights (Surface.Weight*, Kernel.cu:101-107) --------------------------
    w_pairwise: Array
    w_visual_balance: Array
    w_focal: Array
    w_symmetry: Array
    w_clearance: Array
    w_offlimits: Array
    w_surface_area: Array
    # distance relationships (relationshipStruct, Kernel.cu:79-85) ----------
    rel_src: Array  # i32[R]
    rel_tgt: Array  # i32[R]
    rel_lo: Array  # f32[R] — targetRangeStart
    rel_hi: Array  # f32[R] — targetRangeEnd
    rel_mask: Array  # f32[R]
    # angle relationships (relationshipAngleStruct, Kernel.cu:87-92) --------
    ang_src: Array  # i32[A]
    ang_tgt: Array  # i32[A]
    ang_min: Array  # f32[A]
    ang_max: Array  # f32[A]
    ang_mask: Array  # f32[A]
    # clearances (rectangle + SourceIndex, Kernel.cu:50-57) -----------------
    clr_rects: RectSet  # len C
    clr_src: Array  # i32[C] — SourceIndex whose pose translates the rect
    clr_mask: Array  # f32[C]

    @property
    def n_pad_objs(self) -> int:
        return self.obj_mask.shape[0]

    @property
    def n_objs(self) -> Array:
        return jnp.sum(self.obj_mask).astype(jnp.int32)

    def surface_bounds(self):
        """(min_x, min_y, max_x, max_y) of the surface rectangle.

        The reference computes these untranslated (``Kernel.cu:448-449,
        585-586``), so the parity quirk is inert (tx = 0); use fixed math.
        """
        mnx, mny, mxx, mxy = self.surface.aabb(
            jnp.float32(0.0), jnp.float32(0.0), CostMode.FIXED
        )
        return mnx[0], mny[0], mxx[0], mxy[0]


@dataclasses.dataclass
class SceneSpec:
    """Host-side (NumPy) scene builder; :meth:`build` pads into a :class:`Scene`.

    This is the ergonomic equivalent of hand-filling the reference wire
    structs in ``main()`` (``Kernel.cu:1007-1194``).
    """

    # per-object
    positions: np.ndarray  # [n,6] (x,y,z,rotX,rotY,rotZ) — initial poses
    sizes: np.ndarray  # [n,2] (length,width)
    frozen: np.ndarray  # [n] bool
    offlimit_quads: np.ndarray  # [n,4,2] local off-limits rect vertices
    # surface
    surface_quad: np.ndarray  # [4,2]
    centroid: tuple[float, float] = (0.0, 0.0)
    focal: tuple[float, float] = (0.0, 0.0)
    focal_rot: float = 0.0
    # weights
    w_pairwise: float = 0.0
    w_visual_balance: float = 0.0
    w_focal: float = 0.0
    w_symmetry: float = 0.0
    w_clearance: float = 0.0
    w_offlimits: float = 0.0
    w_surface_area: float = 0.0
    # relationships: (src, tgt, lo, hi)
    relationships: Sequence[tuple[int, int, float, float]] = ()
    # angle relationships: (src, tgt, amin, amax)
    angle_relationships: Sequence[tuple[int, int, float, float]] = ()
    # clearances: (quad [4,2], source_index)
    clearances: Sequence[tuple[np.ndarray, int]] = ()

    @property
    def n_objs(self) -> int:
        return int(np.asarray(self.positions).shape[0])

    def build(
        self,
        pad_objs: int | None = None,
        pad_rels: int | None = None,
        pad_clearances: int | None = None,
    ) -> Scene:
        n = self.n_objs
        pn = pad_objs or max(n, 1)
        r = len(self.relationships)
        a = len(self.angle_relationships)
        pr = pad_rels or max(r, a, 1)
        c = len(self.clearances)
        pc = pad_clearances or max(c, 1)
        if pn < n or pr < max(r, a) or pc < c:
            raise ValueError("padding smaller than actual counts")

        def quad_rects(quads: np.ndarray) -> RectSet:
            quads = np.asarray(quads, dtype=np.float64).reshape(-1, 4, 2)
            flat = quads.reshape(-1, 2)
            starts = np.arange(quads.shape[0]) * 4
            return rects_from_vertices(flat, starts)

        def padf(vals, width, dtype=np.float32):
            out = np.zeros(width, dtype=dtype)
            out[: len(vals)] = vals
            return jnp.asarray(out)

        rel = np.asarray([list(t) for t in self.relationships], np.float64).reshape(
            r, 4
        )
        ang = np.asarray(
            [list(t) for t in self.angle_relationships], np.float64
        ).reshape(a, 4)
        clr_quads = (
            np.stack([np.asarray(q, np.float64) for q, _ in self.clearances])
            if c
            else np.zeros((0, 4, 2))
        )
        clr_src = np.asarray([s for _, s in self.clearances], np.int64)

        return Scene(
            obj_mask=padf(np.ones(n), pn),
            frozen=padf(np.asarray(self.frozen, bool), pn, dtype=bool),
            sizes=jnp.asarray(
                np.pad(np.asarray(self.sizes, np.float32), ((0, pn - n), (0, 0)))
            ),
            off_rects=_pad_rects(quad_rects(self.offlimit_quads), pn),
            surface=quad_rects(np.asarray(self.surface_quad).reshape(1, 4, 2)),
            centroid=jnp.asarray(self.centroid, jnp.float32),
            focal=jnp.asarray(self.focal, jnp.float32),
            focal_rot=jnp.float32(self.focal_rot),
            w_pairwise=jnp.float32(self.w_pairwise),
            w_visual_balance=jnp.float32(self.w_visual_balance),
            w_focal=jnp.float32(self.w_focal),
            w_symmetry=jnp.float32(self.w_symmetry),
            w_clearance=jnp.float32(self.w_clearance),
            w_offlimits=jnp.float32(self.w_offlimits),
            w_surface_area=jnp.float32(self.w_surface_area),
            rel_src=padf(rel[:, 0], pr, np.int32),
            rel_tgt=padf(rel[:, 1], pr, np.int32),
            rel_lo=padf(rel[:, 2], pr),
            rel_hi=padf(rel[:, 3], pr),
            rel_mask=padf(np.ones(r), pr),
            ang_src=padf(ang[:, 0], pr, np.int32),
            ang_tgt=padf(ang[:, 1], pr, np.int32),
            ang_min=padf(ang[:, 2], pr),
            ang_max=padf(ang[:, 3], pr),
            ang_mask=padf(np.ones(a), pr),
            clr_rects=_pad_rects(quad_rects(clr_quads), pc)
            if c
            else _pad_rects(quad_rects(np.zeros((1, 4, 2))), pc),
            clr_src=padf(clr_src, pc, np.int32),
            clr_mask=padf(np.ones(c), pc),
        )

    def initial_pose(self, pad_objs: int | None = None) -> jax.Array:
        pn = pad_objs or max(self.n_objs, 1)
        pose = np.zeros((pn, 6), np.float32)
        pose[: self.n_objs] = np.asarray(self.positions, np.float32)
        return jnp.asarray(pose)


def _unit_quad(w: float, h: float, x0: float = 0.0, y0: float = 0.0) -> np.ndarray:
    """Axis-aligned quad in the reference's clockwise-from-top-right order."""
    return np.array(
        [[x0 + w, y0 + h], [x0 + w, y0], [x0, y0], [x0, y0 + h]], np.float64
    )


def demo_scene(n_objs: int = 32) -> SceneSpec:
    """The reference demo harness scene (``Kernel.cu:1003-1194``).

    N objects on a 10x10 surface placed along the diagonal at (2i, 2i), one
    distance relationship (0->1, range [2,4]) and one angle relationship
    (0->1, [pi/4, 5pi/8]); two clearance rects anchored to objects 0 and 1;
    alternating 2x2 / offset-2x2 off-limits rects; the harness weight vector
    (``Kernel.cu:1014-1019``; ``WeightOffLimits`` is uninitialized there — we
    default it to 0, which also matches its exclusion from the total).
    """
    n = n_objs
    positions = np.zeros((n, 6))
    positions[:, 0] = np.arange(n) * 2.0
    positions[:, 1] = np.arange(n) * 2.0
    offquads = np.stack(
        [_unit_quad(2, 2) if i % 2 == 0 else _unit_quad(2, 2, x0=1.0) for i in range(n)]
    )
    return SceneSpec(
        positions=positions,
        sizes=np.ones((n, 2)),
        frozen=np.zeros(n, bool),
        offlimit_quads=offquads,
        surface_quad=_unit_quad(10, 10),
        centroid=(0.0, 0.0),
        focal=(5.0, 5.0),
        focal_rot=0.0,
        w_pairwise=-2.0,
        w_visual_balance=1.5,
        w_focal=-2.0,
        w_symmetry=-2.0,
        w_clearance=-2.0,
        w_offlimits=0.0,
        w_surface_area=-2.0,
        relationships=[(0, 1, 2.0, 4.0)],
        angle_relationships=[(0, 1, 3.1416 / 4, 5 * 3.1416 / 8)],
        clearances=[(_unit_quad(2, 2), 0), (_unit_quad(2, 2, x0=1.0), 1)],
    )
