"""Batched 2D geometry kernels in JAX.

Batched replacement for the reference's NumPy geometry helpers
(``/root/reference/gymnasium_planar_robotics/utils/geometry_2D_utils.py``).

Semantics are intentionally identical to the reference (including the
documented epsilon behavior and the known limitation that
``check_rectangles_intersect`` tests only edge crossings, so one rectangle
fully containing another — without any edge crossings — reports False; the
reference's callers rely on prefilters that make this unreachable, and so do
ours).

Everything is pure ``jnp``, branch-free, shape-polymorphic over leading batch
dimensions, and safe under ``vmap``/``jit``.  The orientation determinants
are expanded to closed-form 2D cross products instead of 3x3
``np.linalg.det`` calls — same values, pure elementwise arithmetic.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from gymnasium_planar_robotics_tpu.ops import rotations

_EPS = 1e-7


def check_line_segments_intersect(
    p1: jnp.ndarray, p2: jnp.ndarray, q1: jnp.ndarray, q2: jnp.ndarray
) -> jnp.ndarray:
    """Whether line segments (p1,p2) and (q1,q2) intersect; batched over leading dims.

    Inputs are ``[..., 2]`` point coordinates; the output is boolean ``[...]``.
    Mirrors reference geometry_2D_utils.py:9-69 exactly:

    - orientation test with a ``sign(det_a*det_b) <= 0`` rule plus an epsilon
      band ``|det_a*det_b| < 1e-7`` treated as intersecting;
    - a bounding-box separation override (strictly separated AABBs are never
      intersecting, with its own epsilon exception);
    - segments sharing an endpoint (within 1e-7 per coordinate) always
      intersect.
    """
    p1 = jnp.asarray(p1)
    p2 = jnp.asarray(p2)
    q1 = jnp.asarray(q1)
    q2 = jnp.asarray(q2)

    def _pts_eq(a, b):
        return jnp.sum((jnp.abs(a - b) < _EPS).astype(jnp.int32), axis=-1) == 2

    mask_points_equal = (
        _pts_eq(p1, q1) | _pts_eq(p1, q2) | _pts_eq(p2, q1) | _pts_eq(p2, q2)
    )

    min_xy_p = jnp.minimum(p1, p2)
    min_xy_q = jnp.minimum(q1, q2)
    max_xy_p = jnp.maximum(p1, p2)
    max_xy_q = jnp.maximum(q1, q2)

    # reference: mask_pq * (1 - (|max_p - min_q| < eps)) + mask_qp * (...)
    mask_pq = (max_xy_p < min_xy_q) & ~(jnp.abs(max_xy_p - min_xy_q) < _EPS)
    mask_qp = (max_xy_q < min_xy_p) & ~(jnp.abs(max_xy_q - min_xy_p) < _EPS)
    mask_minmax = jnp.sum((mask_pq | mask_qp).astype(jnp.int32), axis=-1) >= 1

    def _orient(a, b, c):
        # det([[ax, ay, 1], [bx, by, 1], [cx, cy, 1]]) — the 2D orientation
        # predicate; equals the reference's 3x3 determinant of homogeneous
        # points (geometry_2D_utils.py:47-60).
        return (b[..., 0] - a[..., 0]) * (c[..., 1] - a[..., 1]) - (
            b[..., 1] - a[..., 1]
        ) * (c[..., 0] - a[..., 0])

    det_ppq1 = _orient(p1, p2, q1)
    det_ppq2 = _orient(p1, p2, q2)
    det_qqp1 = _orient(q1, q2, p1)
    det_qqp2 = _orient(q1, q2, p2)

    prod_p = det_ppq1 * det_ppq2
    prod_q = det_qqp1 * det_qqp2
    mask_orientation = ((jnp.sign(prod_p) <= 0) | (jnp.abs(prod_p) < _EPS)) & (
        (jnp.sign(prod_q) <= 0) | (jnp.abs(prod_q) < _EPS)
    )

    # reference ordering: orientation sets True, minmax overrides to False,
    # shared endpoints override to True (geometry_2D_utils.py:66-68)
    out = mask_orientation
    out = jnp.where(mask_minmax, False, out)
    out = jnp.where(mask_points_equal, True, out)
    return out


def get_2D_rect_vertices(qpos: jnp.ndarray, size: jnp.ndarray) -> jnp.ndarray:
    """(x,y) vertices of rotated rectangles w.r.t. the base frame.

    ``qpos`` is ``[..., 7]`` (x,y,z, qw,qx,qy,qz), ``size`` is ``[..., 2]``
    half-extents.  Returns ``[..., 2, 4]`` vertex coordinates in the same
    (counter-clockwise from (-sx,-sy)) order as reference
    geometry_2D_utils.py:72-104.
    """
    qpos = jnp.asarray(qpos)
    size = jnp.asarray(size)
    quats = rotations.unit_vector(qpos[..., 3:7])
    rot = rotations.quat2mat(quats)  # [..., 3, 3]

    sx = size[..., 0]
    sy = size[..., 1]
    zeros = jnp.zeros_like(sx)
    # local-frame vertices, shape [..., 3, 4]
    vx = jnp.stack([-sx, -sx, sx, sx], axis=-1)
    vy = jnp.stack([-sy, sy, sy, -sy], axis=-1)
    vz = jnp.stack([zeros, zeros, zeros, zeros], axis=-1)
    verts_l = jnp.stack([vx, vy, vz], axis=-2)

    # full float32: XLA's default precision on GPUs (TF32, ~3 decimal digits)
    # would move vertices by up to ~1e-4 m and flip wall/collision decisions
    verts_b = jnp.matmul(rot, verts_l, precision=jax.lax.Precision.HIGHEST)[..., :2, :]
    return verts_b + qpos[..., :2, None]


def rect_edges(vertices: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Edge start/end points from ``[..., 2, 4]`` vertices: returns two ``[..., 4, 2]`` arrays."""
    starts = jnp.swapaxes(vertices, -1, -2)  # [..., 4, 2]
    ends = jnp.roll(starts, shift=-1, axis=-2)
    return starts, ends


def check_rectangles_intersect(
    qpos_r1: jnp.ndarray,
    qpos_r2: jnp.ndarray,
    size_r1: jnp.ndarray,
    size_r2: jnp.ndarray,
) -> jnp.ndarray:
    """Whether two rotated rectangles intersect (edge-crossing test, 16 segment pairs).

    Batched over leading dims; mirrors reference geometry_2D_utils.py:107-138
    including its containment limitation (see module docstring).
    """
    v1 = get_2D_rect_vertices(qpos_r1, size_r1)  # [..., 2, 4]
    v2 = get_2D_rect_vertices(qpos_r2, size_r2)
    return rect_vertices_intersect(v1, v2)


def rect_vertices_intersect(v1: jnp.ndarray, v2: jnp.ndarray) -> jnp.ndarray:
    """Edge-crossing intersection test given precomputed ``[..., 2, 4]`` vertices."""
    s1, e1 = rect_edges(v1)  # [..., 4, 2]
    s2, e2 = rect_edges(v2)
    # all 4x4 edge pairs: p edges vary on axis -3, q edges on axis -2
    p1 = s1[..., :, None, :]
    p2 = e1[..., :, None, :]
    q1 = s2[..., None, :, :]
    q2 = e2[..., None, :, :]
    p1, p2, q1, q2 = jnp.broadcast_arrays(p1, p2, q1, q2)
    hits = check_line_segments_intersect(p1, p2, q1, q2)  # [..., 4, 4]
    return jnp.sum(hits.astype(jnp.int32), axis=(-1, -2)) >= 1
