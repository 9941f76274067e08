"""Batched rotation utilities in JAX.

Batched replacement for the reference's NumPy rotation helpers
(``/root/reference/gymnasium_planar_robotics/utils/rotations_utils.py``).
Conventions match MuJoCo: quaternions are (w, x, y, z), Euler angles are
relative 'xyz'.  Everything here is pure ``jnp``, shape-polymorphic over
leading batch dimensions, and safe to ``vmap``/``jit``.

Unlike the reference (which falls back to a per-item ``np.nditer`` loop for
``mat2quat``, see rotations_utils.py:216-226), every function here is fully
vectorized: ``mat2quat`` uses the branch-free Shepperd/Sarabandi selection
computed with ``jnp.where`` instead of an eigen-decomposition, which maps to
pure elementwise code under XLA.
"""

from __future__ import annotations

import jax.numpy as jnp

_FLOAT_EPS = float(jnp.finfo(jnp.float64).eps)
_EPS4 = _FLOAT_EPS * 4.0


def euler2mat(euler: jnp.ndarray) -> jnp.ndarray:
    """Convert 'xyz' relative Euler angles ``[..., 3]`` to rotation matrices ``[..., 3, 3]``.

    Matches reference rotations_utils.py:116-140.
    """
    euler = jnp.asarray(euler)
    ai, aj, ak = -euler[..., 2], -euler[..., 1], -euler[..., 0]
    si, sj, sk = jnp.sin(ai), jnp.sin(aj), jnp.sin(ak)
    ci, cj, ck = jnp.cos(ai), jnp.cos(aj), jnp.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk

    row0 = jnp.stack([cj * ci, cj * si, -sj], axis=-1)
    row1 = jnp.stack([sj * cs - sc, sj * ss + cc, cj * sk], axis=-1)
    row2 = jnp.stack([sj * cc + ss, sj * sc - cs, cj * ck], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)


def euler2quat(euler: jnp.ndarray) -> jnp.ndarray:
    """Convert 'xyz' relative Euler angles ``[..., 3]`` to quaternions ``[..., 4]`` (w,x,y,z).

    Matches reference rotations_utils.py:143-162.
    """
    euler = jnp.asarray(euler)
    ai, aj, ak = euler[..., 2] / 2, -euler[..., 1] / 2, euler[..., 0] / 2
    si, sj, sk = jnp.sin(ai), jnp.sin(aj), jnp.sin(ak)
    ci, cj, ck = jnp.cos(ai), jnp.cos(aj), jnp.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk

    w = cj * cc + sj * ss
    x = cj * cs - sj * sc
    y = -(cj * ss + sj * cc)
    z = cj * sc - sj * cs
    return jnp.stack([w, x, y, z], axis=-1)


def mat2euler(mat: jnp.ndarray) -> jnp.ndarray:
    """Convert rotation matrices ``[..., 3, 3]`` to 'xyz' Euler angles ``[..., 3]``.

    Matches reference rotations_utils.py:165-187.
    """
    mat = jnp.asarray(mat)
    cy = jnp.sqrt(mat[..., 2, 2] * mat[..., 2, 2] + mat[..., 1, 2] * mat[..., 1, 2])
    condition = cy > _EPS4
    e2 = jnp.where(
        condition,
        -jnp.arctan2(mat[..., 0, 1], mat[..., 0, 0]),
        -jnp.arctan2(-mat[..., 1, 0], mat[..., 1, 1]),
    )
    e1 = -jnp.arctan2(-mat[..., 0, 2], cy)
    e0 = jnp.where(condition, -jnp.arctan2(mat[..., 1, 2], mat[..., 2, 2]), 0.0)
    return jnp.stack([e0, e1, e2], axis=-1)


def quat2mat(quat: jnp.ndarray) -> jnp.ndarray:
    """Convert quaternions ``[..., 4]`` (w,x,y,z) to rotation matrices ``[..., 3, 3]``.

    Matches reference rotations_utils.py:248-274 (including the ``Nq`` guard
    that returns identity for near-zero quaternions).
    """
    quat = jnp.asarray(quat)
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    nq = jnp.sum(quat * quat, axis=-1)
    s = 2.0 / jnp.where(nq > _FLOAT_EPS, nq, 1.0)
    X, Y, Z = x * s, y * s, z * s
    wX, wY, wZ = w * X, w * Y, w * Z
    xX, xY, xZ = x * X, x * Y, x * Z
    yY, yZ, zZ = y * Y, y * Z, z * Z

    row0 = jnp.stack([1.0 - (yY + zZ), xY - wZ, xZ + wY], axis=-1)
    row1 = jnp.stack([xY + wZ, 1.0 - (xX + zZ), yZ - wX], axis=-1)
    row2 = jnp.stack([xZ - wY, yZ + wX, 1.0 - (xX + yY)], axis=-1)
    mat = jnp.stack([row0, row1, row2], axis=-2)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=mat.dtype), mat.shape)
    return jnp.where((nq > _FLOAT_EPS)[..., None, None], mat, eye)


def mat2quat(mat: jnp.ndarray) -> jnp.ndarray:
    """Convert rotation matrices ``[..., 3, 3]`` to quaternions ``[..., 4]`` (w,x,y,z).

    The reference (rotations_utils.py:190-227) uses a per-item eigenvector
    method inside an ``np.nditer`` loop.  Here we use the classic branch-free
    four-candidate construction selected by the largest diagonal combination
    — numerically stable, fully vectorized, and identical up to sign
    convention (w >= 0 is enforced like the reference).
    """
    mat = jnp.asarray(mat)
    m00, m01, m02 = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
    m10, m11, m12 = mat[..., 1, 0], mat[..., 1, 1], mat[..., 1, 2]
    m20, m21, m22 = mat[..., 2, 0], mat[..., 2, 1], mat[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate 4*q_k^2 values; pick the largest for stability.
    tw = 1.0 + tr
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    def _safe_sqrt(v):
        return jnp.sqrt(jnp.maximum(v, 0.0))

    # candidate built from w
    sw = _safe_sqrt(tw) * 2.0  # 4w
    qw_w = 0.25 * sw
    qx_w = (m21 - m12) / jnp.where(sw == 0, 1.0, sw)
    qy_w = (m02 - m20) / jnp.where(sw == 0, 1.0, sw)
    qz_w = (m10 - m01) / jnp.where(sw == 0, 1.0, sw)

    sx = _safe_sqrt(tx) * 2.0
    qw_x = (m21 - m12) / jnp.where(sx == 0, 1.0, sx)
    qx_x = 0.25 * sx
    qy_x = (m01 + m10) / jnp.where(sx == 0, 1.0, sx)
    qz_x = (m02 + m20) / jnp.where(sx == 0, 1.0, sx)

    sy = _safe_sqrt(ty) * 2.0
    qw_y = (m02 - m20) / jnp.where(sy == 0, 1.0, sy)
    qx_y = (m01 + m10) / jnp.where(sy == 0, 1.0, sy)
    qy_y = 0.25 * sy
    qz_y = (m12 + m21) / jnp.where(sy == 0, 1.0, sy)

    sz = _safe_sqrt(tz) * 2.0
    qw_z = (m10 - m01) / jnp.where(sz == 0, 1.0, sz)
    qx_z = (m02 + m20) / jnp.where(sz == 0, 1.0, sz)
    qy_z = (m12 + m21) / jnp.where(sz == 0, 1.0, sz)
    qz_z = 0.25 * sz

    q_w = jnp.stack([qw_w, qx_w, qy_w, qz_w], axis=-1)
    q_x = jnp.stack([qw_x, qx_x, qy_x, qz_x], axis=-1)
    q_y = jnp.stack([qw_y, qx_y, qy_y, qz_y], axis=-1)
    q_z = jnp.stack([qw_z, qx_z, qy_z, qz_z], axis=-1)

    cands = jnp.stack([tw, tx, ty, tz], axis=-1)
    best = jnp.argmax(cands, axis=-1)
    q = jnp.where(
        (best == 0)[..., None],
        q_w,
        jnp.where((best == 1)[..., None], q_x, jnp.where((best == 2)[..., None], q_y, q_z)),
    )
    # normalize + prefer positive w (reference rotations_utils.py:222-225)
    q = q / jnp.linalg.norm(q, axis=-1, keepdims=True)
    return jnp.where((q[..., 0] < 0)[..., None], -q, q)


def quat2euler(quat: jnp.ndarray) -> jnp.ndarray:
    """Quaternion -> Euler angles, via the rotation matrix (reference rotations_utils.py:230-235)."""
    return mat2euler(quat2mat(quat))


def quat_conjugate(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion conjugate (reference rotations_utils.py:277-280)."""
    q = jnp.asarray(q)
    return q * jnp.asarray([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_mul(q0: jnp.ndarray, q1: jnp.ndarray) -> jnp.ndarray:
    """Hamilton product of two (w,x,y,z) quaternions (reference rotations_utils.py:283-306)."""
    w0, x0, y0, z0 = q0[..., 0], q0[..., 1], q0[..., 2], q0[..., 3]
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w = w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1
    x = w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1
    y = w0 * y1 + y0 * w1 + z0 * x1 - x0 * z1
    z = w0 * z1 + z0 * w1 + x0 * y1 - y0 * x1
    return jnp.stack([w, x, y, z], axis=-1)


def quat_rot_vec(q: jnp.ndarray, v0: jnp.ndarray) -> jnp.ndarray:
    """Rotate vector(s) ``v0 [..., 3]`` by quaternion(s) ``q [..., 4]``.

    Uses the expanded 15-mul formula instead of two quaternion products
    (reference rotations_utils.py:309-313) — same result, fewer ops.
    """
    q = jnp.asarray(q)
    v0 = jnp.asarray(v0)
    w = q[..., :1]
    u = q[..., 1:]
    uv = jnp.cross(u, v0)
    uuv = jnp.cross(u, uv)
    return v0 + 2.0 * (w * uv + uuv)


def quat_identity(dtype=jnp.float32) -> jnp.ndarray:
    """Identity quaternion (w,x,y,z) = (1,0,0,0)."""
    return jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype)


def quat2axisangle(quat: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Quaternion -> (axis ``[..., 3]``, angle ``[...]``).

    Branch-free version of reference rotations_utils.py:320-330: for
    ``|sin(theta/2)| <= 1e-4`` returns axis (0,0,1) and angle 0, matching the
    reference's small-angle cutoff exactly.
    """
    quat = jnp.asarray(quat)
    sin_theta = jnp.linalg.norm(quat[..., 1:], axis=-1)
    big = sin_theta > 1e-4
    theta = 2.0 * jnp.arcsin(jnp.clip(sin_theta, 0.0, 1.0))
    theta = jnp.where(quat[..., 0] >= 0, theta, -theta)
    theta = jnp.where(big, theta, 0.0)
    default_axis = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 1.0], dtype=quat.dtype), quat[..., 1:].shape
    )
    axis = jnp.where(
        big[..., None], quat[..., 1:] / jnp.where(big, sin_theta, 1.0)[..., None], default_axis
    )
    return axis, theta


def normalize_angles(angles: jnp.ndarray) -> jnp.ndarray:
    """Wrap angles into [-pi, pi] (reference rotations_utils.py:382-388)."""
    return (angles + jnp.pi) % (2 * jnp.pi) - jnp.pi


def subtract_euler(e1: jnp.ndarray, e2: jnp.ndarray) -> jnp.ndarray:
    """Relative rotation e1 ∘ e2^-1 expressed as Euler angles (reference rotations_utils.py:238-245)."""
    q1 = euler2quat(e1)
    q2 = euler2quat(e2)
    return quat2euler(quat_mul(q1, quat_conjugate(q2)))


def unit_vector(data: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Normalize along ``axis`` (reference rotations_utils.py:414-461, simplified to the used path)."""
    data = jnp.asarray(data)
    length = jnp.sqrt(jnp.sum(data * data, axis=axis, keepdims=True))
    return data / length


def quat_slerp(q0: jnp.ndarray, q1: jnp.ndarray, fraction: jnp.ndarray, shortestpath: bool = True) -> jnp.ndarray:
    """Spherical linear interpolation between two quaternions (reference rotations_utils.py:464-509).

    Branch-free jit-compatible version: degenerate cases (fraction 0/1,
    parallel quaternions, tiny angle) resolve via ``jnp.where``.
    """
    q0 = unit_vector(jnp.asarray(q0))
    q1 = unit_vector(jnp.asarray(q1))
    d = jnp.sum(q0 * q1, axis=-1)
    if shortestpath:
        q1 = jnp.where((d < 0.0)[..., None], -q1, q1)
        d = jnp.abs(d)
    d = jnp.clip(d, -1.0, 1.0)
    angle = jnp.arccos(d)
    small = jnp.abs(angle) < _EPS4
    safe_angle = jnp.where(small, 1.0, angle)
    isin = 1.0 / jnp.sin(safe_angle)
    w0 = jnp.sin((1.0 - fraction) * safe_angle) * isin
    w1 = jnp.sin(fraction * safe_angle) * isin
    out = w0[..., None] * q0 + w1[..., None] * q1
    out = jnp.where(small[..., None], q0, out)
    out = jnp.where((jnp.asarray(fraction) == 0.0)[..., None], q0, out)
    out = jnp.where((jnp.asarray(fraction) == 1.0)[..., None], q1, out)
    return out


def euler2point_euler(euler: jnp.ndarray) -> jnp.ndarray:
    """Euler angles → point representation ``[sin(e), cos(e)]``
    (reference rotations_utils.py:333-341); batched, last axis 3 → 6."""
    euler = jnp.asarray(euler)
    return jnp.concatenate([jnp.sin(euler), jnp.cos(euler)], axis=-1)


def point_euler2euler(pe: jnp.ndarray) -> jnp.ndarray:
    """Point representation → Euler angles (reference rotations_utils.py:343-351).

    Keeps the reference's exact branch semantics: ``arctan(s/c)`` plus π
    wherever ``c < 0`` (NOT ``arctan2`` — ranges differ in quadrant III)."""
    pe = jnp.asarray(pe)
    s, c = pe[..., :3], pe[..., 3:]
    return jnp.arctan(s / c) + jnp.pi * (c < 0)


def quat2point_quat(quat: jnp.ndarray) -> jnp.ndarray:
    """Quaternion (wxyz) → 5-vector ``[sin θ, cos θ, axis·1]`` point form
    (reference rotations_utils.py:354-364); axis left unscaled when
    ``|sin(θ/2)| < 1e-5`` exactly like the reference's masked divide."""
    quat = jnp.asarray(quat)
    angle = jnp.arccos(jnp.clip(quat[..., :1], -1.0, 1.0)) * 2.0
    half_sin = jnp.sin(angle / 2.0)
    safe = jnp.abs(half_sin) >= 1e-5
    xyz = quat[..., 1:]
    xyz = jnp.where(safe, xyz / jnp.where(safe, half_sin, 1.0), xyz)
    return jnp.concatenate([jnp.sin(angle), jnp.cos(angle), xyz], axis=-1)


def point_quat2quat(pq: jnp.ndarray) -> jnp.ndarray:
    """Inverse of :func:`quat2point_quat` (reference rotations_utils.py:367-379)."""
    pq = jnp.asarray(pq)
    angle = jnp.arctan(pq[..., :1] / pq[..., 1:2])
    half_sin = jnp.sin(angle / 2.0)
    safe = jnp.abs(half_sin) >= 1e-5
    qxyz = pq[..., 2:]
    qxyz = jnp.where(safe, qxyz * half_sin, qxyz)
    return jnp.concatenate([jnp.cos(angle / 2.0), qxyz], axis=-1)


def round_to_straight_angles(angles: jnp.ndarray) -> jnp.ndarray:
    """Snap every angle to the nearest multiple of 90° and normalize to
    [-π, π] (reference rotations_utils.py:392-395)."""
    half_pi = jnp.pi / 2.0
    return normalize_angles(jnp.round(jnp.asarray(angles) / half_pi) * half_pi)


def get_parallel_rotations():
    """The 24 canonical axis-aligned (cube-symmetry) orientations as Euler
    triples (reference rotations_utils.py:397-411).

    Host-side enumeration (config-time helper, not a kernel): walk all
    4³ products of 90° multiples, canonicalize each through
    mat2euler(euler2mat(·)), snap to the ±{0,1,2}·π/2 lattice with −π → π,
    and deduplicate."""
    import itertools

    import numpy as np

    mult90 = [0.0, np.pi / 2, -np.pi / 2, np.pi]
    seen: list[np.ndarray] = []
    for e in itertools.product(mult90, repeat=3):
        canon = np.asarray(mat2euler(euler2mat(jnp.asarray(e, jnp.float64))), np.float64)
        canon = np.round(canon / (np.pi / 2))
        canon[0] = 2.0 if canon[0] == -2 else canon[0]
        canon[2] = 2.0 if canon[2] == -2 else canon[2]
        canon *= np.pi / 2
        if not any(np.array_equal(canon, r) for r in seen):
            seen.append(canon)
    assert len(seen) == 24
    return seen
