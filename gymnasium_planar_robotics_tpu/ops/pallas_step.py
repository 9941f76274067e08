"""Fused one-mover autoreset step kernel for NVIDIA GPUs (Pallas, Triton route).

The XLA step (``models/planning.step`` and ``models/pushing.step``) runs the
40-cycle control loop as a ``lax.scan`` of a handful of small fused kernels
per iteration, so a batched step is launch-bound rather than FLOP-bound.
This kernel runs ``K`` whole autoreset env steps in one launch (clamp chain
-> integrate -> [contact ->] sensor noise -> wall check -> collision latch,
x num_cycles, then termination, in-place restart and both observations):

- one env per GPU thread: state is structure-of-arrays ``[B]`` vectors, the
  grid is 1-D over blocks of a power-of-two number of envs, and masked loads
  and stores handle a batch that the block does not divide;
- the tile layout is baked in at trace time: the per-cell wall tests are
  generated by a static Python loop over the grid, so cells with a full 3x3
  neighbourhood contribute a single "covered => valid" term and missing cells
  prune to nothing;
- sensor noise and reset draws come from a counter-based generator written
  into the kernel (``uniform``: a 32-bit integer hash of (stream, step,
  draw), where the per-env stream id encodes (seed, global env index)),
  turned Gaussian by Box-Muller.  Results therefore depend neither on the
  block size nor on sharding.  The stream differs from the XLA step's
  threefry stream; determinism per seed holds;
- the early-exit ``break`` is the same latched mask as the XLA path.

Scope: 1 mover, circle or box collision shape, acceleration or jerk
actuation, float32, both reward modes.  Other configurations use the XLA
step.  The kernel compiles for the GPU only; ``interpret=True`` runs it on
the CPU for tests.  Cross-checked against the XLA path at ``std_noise=0``
(tests/test_pallas_step.py).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu
from jax.sharding import PartitionSpec as P

_TWO_PI = 2.0 * np.pi
_GOLDEN = 0x9E3779B9


# ---------------------------------------------------------------------------
# counter-based generator (pure jnp: shared by the kernel and the tests)
# ---------------------------------------------------------------------------


def _mix32(x):
    """Bijective avalanche hash of uint32 values (lowbias32, C. Wellons)."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x21F0AAAD)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x735A2D97)
    return x ^ (x >> 15)


def _u32(x):
    return jnp.asarray(x).astype(jnp.uint32)


def env_streams(seed, env_index):
    """Per-env stream ids ``[B]`` uint32 of a rollout seeded with ``seed``:
    the generator's (seed, global env index) part of the key."""
    return _mix32(_mix32(_u32(seed) + jnp.uint32(_GOLDEN)) ^ _u32(env_index))


def step_key(stream, step):
    """Key of one env step: the stream id combined with the global step index."""
    return _mix32(stream ^ _mix32(_u32(step) * jnp.uint32(_GOLDEN) + jnp.uint32(1)))


def uniform(key, draw):
    """Draw number ``draw`` of a step key: uniform on [0, 1) with 24 random bits."""
    bits = _mix32(key + _u32(draw) * jnp.uint32(_GOLDEN))
    return (bits >> 8).astype(jnp.float32) * np.float32(2.0**-24)


def normal_pair(u1, u2):
    """Two iid standard normals from two uniforms (Box-Muller); ``1 - u1`` is in
    (0, 1], which keeps the log finite."""
    r = jnp.sqrt(-2.0 * jnp.log(1.0 - u1))
    return r * jnp.cos(_TWO_PI * u2), r * jnp.sin(_TWO_PI * u2)


class _Draws:
    """Sequential draws of one env step: draw ``start``, ``start + 1``, ...
    of ``key``.  ``start`` may be traced (the cycle index times the draws per
    cycle); ``count`` is the static number of uniforms taken."""

    def __init__(self, key, start=0):
        self.key = key
        self.start = start
        self.count = 0

    def uniform(self):
        u = uniform(self.key, self.start + self.count)
        self.count += 1
        return u

    def normal_pair(self):
        u1 = self.uniform()
        return normal_pair(u1, self.uniform())

    def uniform_in(self, lo, hi):
        return lo + self.uniform() * (hi - lo)


# ---------------------------------------------------------------------------
# statically specialised geometry
# ---------------------------------------------------------------------------


def _clamp_norm2(x, y, max_val):
    """L2-ball clamp of the 2-vector field (x, y); bit-matches
    ensure_max_dyn_val's arithmetic (inclusive >=, max*v/norm order)."""
    norm = jnp.sqrt(x * x + y * y)
    clamp = norm >= max_val
    safe = jnp.where(norm > 0, norm, 1.0)
    cx = max_val * x / safe
    cy = max_val * y / safe
    return jnp.where(clamp, cx, x), jnp.where(clamp, cy, y), clamp


def _full_layout_bounds(grid_np: dict):
    """(outer rect, interior fast rect or None) of a fully-populated layout."""
    tile_x, tile_y = grid_np['tile_x'], grid_np['tile_y']
    tsx, tsy = grid_np['tsx'], grid_np['tsy']
    tx, ty = grid_np['layout'].shape
    outer = (
        float(tile_x[0, 0] - tsx), float(tile_x[tx - 1, ty - 1] + tsx),
        float(tile_y[0, 0] - tsy), float(tile_y[tx - 1, ty - 1] + tsy),
    )
    if tx >= 3 and ty >= 3:
        fast = (
            float(tile_x[1, 1] - tsx), float(tile_x[tx - 2, ty - 2] + tsx),
            float(tile_y[1, 1] - tsy), float(tile_y[tx - 2, ty - 2] + tsy),
        )
    else:
        fast = None
    return outer, fast


def _make_wall_valid(grid_np: dict):
    """Build the statically-specialized circle wall-validity function.

    Returns ``valid(px, py, c)`` evaluating the dense rule of
    ``ops/walls.qpos_is_valid`` with every grid cell unrolled at trace time
    (missing-cell and full-3x3 cells simplify away).

    FULLY-POPULATED layouts collapse further: validity = center above the
    table AND the inflated circle strictly inside the union rectangle, OR
    center above an interior (complete-3x3) cell — ~12 ops instead of
    O(cells).  Exactness vs the general per-cell rule is fuzz-pinned in
    tests/test_pallas_step.py (the per-cell rescues for cells that exist on
    all sides compose to exactly the union-rectangle test; collision sizes
    are validated <= tile size, so the one unreachable asymmetry — a vertex
    more than a tile away from its center — cannot occur)."""
    if grid_np['layout'].all():
        (x0, x1, y0, y1), fast_rect = _full_layout_bounds(grid_np)

        def valid(px, py, c):
            above = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
            inside = (px - c > x0) & (px + c < x1) & (py - c > y0) & (py + c < y1)
            res = above & inside
            if fast_rect is not None:
                fx0, fx1, fy0, fy1 = fast_rect
                res = ((px >= fx0) & (px <= fx1) & (py >= fy0) & (py <= fy1)) | res
            return res

        return valid
    return _make_wall_valid_general(grid_np)


def _make_wall_valid_general(grid_np: dict):
    """General (holed-layout) circle validity — see ``_make_wall_valid``."""
    layout = grid_np['layout']
    tile_x = grid_np['tile_x']
    tile_y = grid_np['tile_y']
    tsx, tsy = grid_np['tsx'], grid_np['tsy']
    complete = grid_np['complete3x3']
    tx, ty = layout.shape

    pad = np.pad(layout, 1)

    def nb(i, j, dx, dy):
        return bool(pad[1 + i + dx, 1 + j + dy])

    def valid(px, py, c):
        any_above = None
        fast = None
        all_careful = None
        for i in range(tx):
            for j in range(ty):
                cx, cy = tile_x[i, j], tile_y[i, j]
                above = (
                    (px >= cx - tsx) & (px <= cx + tsx) & (py >= cy - tsy) & (py <= cy + tsy)
                )
                any_above = above if any_above is None else (any_above | above)
                if complete[i, j]:
                    fast = above if fast is None else (fast | above)
                    continue  # covered-by-complete-tile => globally valid
                if not layout[i, j]:
                    # covering a missing cell can never be valid
                    term = ~above
                else:
                    m1 = px - c > cx - tsx
                    m2 = px + c < cx + tsx
                    m3 = py - c > cy - tsy
                    m4 = py + c < cy + tsy
                    cell = m1 & m2 & m3 & m4
                    if nb(i, j, -1, 0):
                        resc = m3 & m4
                        if nb(i, j, 0, -1) and nb(i, j, -1, -1):
                            resc = resc | ~m3
                        if nb(i, j, 0, 1) and nb(i, j, -1, 1):
                            resc = resc | ~m4
                        cell = cell | (~m1 & resc)
                    if nb(i, j, 1, 0):
                        resc = m3 & m4
                        if nb(i, j, 0, -1) and nb(i, j, 1, -1):
                            resc = resc | ~m3
                        if nb(i, j, 0, 1) and nb(i, j, 1, 1):
                            resc = resc | ~m4
                        cell = cell | (~m2 & resc)
                    if nb(i, j, 0, -1):
                        cell = cell | (~m3 & m1 & m2)
                    if nb(i, j, 0, 1):
                        cell = cell | (~m4 & m1 & m2)
                    term = ~above | cell
                all_careful = term if all_careful is None else (all_careful & term)
        careful = any_above if all_careful is None else (any_above & all_careful)
        return careful if fast is None else (fast | careful)

    return valid


_SEG_EPS = 1e-7  # ops/geometry epsilon semantics (reference geometry_2D_utils.py)


def _seg_intersect(p1x, p1y, p2x, p2y, q1x, q1y, q2x, q2y):
    """Elementwise mirror of ``ops/geometry.check_line_segments_intersect``
    (orientation products with the epsilon band, AABB separation override,
    shared-endpoint override)."""

    def pts_eq(ax, ay, bx, by):
        return (jnp.abs(ax - bx) < _SEG_EPS) & (jnp.abs(ay - by) < _SEG_EPS)

    eq = (
        pts_eq(p1x, p1y, q1x, q1y) | pts_eq(p1x, p1y, q2x, q2y)
        | pts_eq(p2x, p2y, q1x, q1y) | pts_eq(p2x, p2y, q2x, q2y)
    )

    def sep(pa, pb, qa, qb):
        mx_p, mn_q = jnp.maximum(pa, pb), jnp.minimum(qa, qb)
        mx_q, mn_p = jnp.maximum(qa, qb), jnp.minimum(pa, pb)
        pq = (mx_p < mn_q) & ~(jnp.abs(mx_p - mn_q) < _SEG_EPS)
        qp = (mx_q < mn_p) & ~(jnp.abs(mx_q - mn_p) < _SEG_EPS)
        return pq | qp

    minmax = sep(p1x, p2x, q1x, q2x) | sep(p1y, p2y, q1y, q2y)

    def orient(ax, ay, bx, by, cx, cy):
        return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax)

    prod_p = orient(p1x, p1y, p2x, p2y, q1x, q1y) * orient(p1x, p1y, p2x, p2y, q2x, q2y)
    prod_q = orient(q1x, q1y, q2x, q2y, p1x, p1y) * orient(q1x, q1y, q2x, q2y, p2x, p2y)
    mask_o = ((prod_p <= 0) | (jnp.abs(prod_p) < _SEG_EPS)) & (
        (prod_q <= 0) | (jnp.abs(prod_q) < _SEG_EPS)
    )
    return eq | (mask_o & ~minmax)


def _quat_to_R2(qw, qx, qy, qz):
    """2D block of the rotation matrix from a raw (w,x,y,z) quaternion —
    normalize then the transforms3d construction (ops/rotations.quat2mat
    after unit_vector; the near-zero guard is unreachable for identity+noise)."""
    inv = 1.0 / jnp.sqrt(qw * qw + qx * qx + qy * qy + qz * qz)
    w, x, y, z = qw * inv, qx * inv, qy * inv, qz * inv
    nq = w * w + x * x + y * y + z * z
    s = 2.0 / nq
    X, Y, Z = x * s, y * s, z * s
    R00 = 1.0 - (y * Y + z * Z)
    R01 = x * Y - w * Z
    R10 = x * Y + w * Z
    R11 = 1.0 - (x * X + z * Z)
    return R00, R01, R10, R11


def _make_wall_valid_box(grid_np: dict):
    """Statically-specialized BOX wall validity: all four (possibly rotated)
    rectangle vertices must pass the per-cell edge/rescue tests (zero margin),
    and at missing-diagonal-corner sites the rectangle must not intersect the
    missing tile's rectangle (reference basic_envs.py:652-783; dense rule of
    ``ops/walls.qpos_is_valid`` for collision_shape='box').

    Returns ``valid(px, py, R00, R01, R10, R11, chx, chy)`` with chx/chy the
    (inflated) half-extents as static floats and R the traced 2D rotation.

    FULLY-POPULATED layouts collapse to: center above the table AND all four
    rotated vertices strictly inside the union rectangle, OR center above an
    interior complete cell (~30 ops instead of the per-cell 4-vertex rescue
    machinery).  Exactness is fuzz-pinned vs the general rule in
    tests/test_pallas_step.py."""
    if grid_np['layout'].all():
        (x0, x1, y0, y1), fast_rect = _full_layout_bounds(grid_np)

        def valid(px, py, R00, R01, R10, R11, chx, chy):
            above = (px >= x0) & (px <= x1) & (py >= y0) & (py <= y1)
            ok = None
            for lx, ly in zip((-chx, -chx, chx, chx), (-chy, chy, chy, -chy)):
                wx = px + R00 * lx + R01 * ly
                wy = py + R10 * lx + R11 * ly
                v_ok = (wx > x0) & (wx < x1) & (wy > y0) & (wy < y1)
                ok = v_ok if ok is None else (ok & v_ok)
            res = above & ok
            if fast_rect is not None:
                fx0, fx1, fy0, fy1 = fast_rect
                res = ((px >= fx0) & (px <= fx1) & (py >= fy0) & (py <= fy1)) | res
            return res

        return valid
    return _make_wall_valid_box_general(grid_np)


def _make_wall_valid_box_general(grid_np: dict):
    """General (holed-layout) box validity — see ``_make_wall_valid_box``."""
    layout = grid_np['layout']
    tile_x = grid_np['tile_x']
    tile_y = grid_np['tile_y']
    tsx, tsy = grid_np['tsx'], grid_np['tsy']
    complete = grid_np['complete3x3']
    corner_xy = grid_np['corner_xy']  # [C, 2]
    corner_onehot = grid_np['corner_onehot']  # [C, Tx, Ty]
    tx, ty = layout.shape

    pad = np.pad(layout, 1)

    def nb(i, j, dx, dy):
        return bool(pad[1 + i + dx, 1 + j + dy])

    corners_by_cell: dict = {}
    for c in range(corner_xy.shape[0]):
        (ci, cj) = np.argwhere(corner_onehot[c])[0]
        corners_by_cell.setdefault((int(ci), int(cj)), []).append(
            (float(corner_xy[c, 0]), float(corner_xy[c, 1]))
        )

    def valid(px, py, R00, R01, R10, R11, chx, chy):
        # rectangle vertices in the reference order (geometry_2D_utils.py:72-104)
        lxs = (-chx, -chx, chx, chx)
        lys = (-chy, chy, chy, -chy)
        vx = [px + R00 * lx + R01 * ly for lx, ly in zip(lxs, lys)]
        vy = [py + R10 * lx + R11 * ly for lx, ly in zip(lxs, lys)]

        def rect_hits_tile(ccx, ccy):
            # mover edges (k -> k+1 cyclic) vs the missing tile's 4 edges
            tvx = (ccx - tsx, ccx - tsx, ccx + tsx, ccx + tsx)
            tvy = (ccy - tsy, ccy + tsy, ccy + tsy, ccy - tsy)
            hit = None
            for k in range(4):
                k2 = (k + 1) % 4
                for e in range(4):
                    e2 = (e + 1) % 4
                    h = _seg_intersect(
                        vx[k], vy[k], vx[k2], vy[k2],
                        tvx[e], tvy[e], tvx[e2], tvy[e2],
                    )
                    hit = h if hit is None else (hit | h)
            return hit

        any_above = None
        fast = None
        all_careful = None
        for i in range(tx):
            for j in range(ty):
                cx, cy = tile_x[i, j], tile_y[i, j]
                above = (
                    (px >= cx - tsx) & (px <= cx + tsx) & (py >= cy - tsy) & (py <= cy + tsy)
                )
                any_above = above if any_above is None else (any_above | above)
                if complete[i, j]:
                    fast = above if fast is None else (fast | above)
                    continue
                if not layout[i, j]:
                    term = ~above
                else:
                    cellv = None
                    for k in range(4):
                        m1 = vx[k] > cx - tsx
                        m2 = vx[k] < cx + tsx
                        m3 = vy[k] > cy - tsy
                        m4 = vy[k] < cy + tsy
                        vvalid = m1 & m2 & m3 & m4
                        if nb(i, j, -1, 0):
                            resc = m3 & m4
                            if nb(i, j, 0, -1) and nb(i, j, -1, -1):
                                resc = resc | ~m3
                            if nb(i, j, 0, 1) and nb(i, j, -1, 1):
                                resc = resc | ~m4
                            vvalid = vvalid | (~m1 & resc)
                        if nb(i, j, 1, 0):
                            resc = m3 & m4
                            if nb(i, j, 0, -1) and nb(i, j, 1, -1):
                                resc = resc | ~m3
                            if nb(i, j, 0, 1) and nb(i, j, 1, 1):
                                resc = resc | ~m4
                            vvalid = vvalid | (~m2 & resc)
                        if nb(i, j, 0, -1):
                            vvalid = vvalid | (~m3 & m1 & m2)
                        if nb(i, j, 0, 1):
                            vvalid = vvalid | (~m4 & m1 & m2)
                        cellv = vvalid if cellv is None else (cellv & vvalid)
                    for ccx, ccy in corners_by_cell.get((i, j), []):
                        cellv = cellv & ~rect_hits_tile(ccx, ccy)
                    term = ~above | cellv
                all_careful = term if all_careful is None else (all_careful & term)
        careful = any_above if all_careful is None else (any_above & all_careful)
        return careful if fast is None else (fast | careful)

    return valid


def _make_wall_checker(grid_np: dict, box: bool, std_pos: float):
    """Per-cycle noisy wall check closure: draws the pose noise (xy for
    circle; xy + 4 quaternion components for box, matching the XLA path's
    6-dim pose-noise rows) and evaluates the statically-specialized validity.
    ``size`` is a float radius (circle) or (chx, chy) half-extents (box)."""
    if box:
        valid_fn = _make_wall_valid_box(grid_np)

        def check(draws, px, py, size):
            nx, ny = draws.normal_pair()
            q1, q2 = draws.normal_pair()
            q3, q4 = draws.normal_pair()
            R00, R01, R10, R11 = _quat_to_R2(
                1.0 + q1 * std_pos, q2 * std_pos, q3 * std_pos, q4 * std_pos
            )
            return valid_fn(px + nx * std_pos, py + ny * std_pos, R00, R01, R10, R11, size[0], size[1])

        def sample_valid_at(sx, sy, size):
            # reset-time acceptance uses the identity orientation
            # (models/planning.reset accept_start, quat=ident)
            return valid_fn(sx, sy, 1.0, 0.0, 0.0, 1.0, size[0], size[1])

    else:
        valid_fn = _make_wall_valid(grid_np)

        def check(draws, px, py, size):
            nx, ny = draws.normal_pair()
            return valid_fn(px + nx * std_pos, py + ny * std_pos, size)

        def sample_valid_at(sx, sy, size):
            return valid_fn(sx, sy, size)

    check.sample_valid_at = sample_valid_at
    return check


def _cycle_draws(box: bool) -> int:
    """Uniforms one control cycle consumes: one velocity-noise normal pair +
    the wall-check pose draw (1 pair for circle, 3 for box)."""
    return 2 + 2 * (3 if box else 1)


def _cycle_loop(key, box: bool, num_cycles: int, body, carry):
    """The per-step cycle loop: cycle ``i`` takes draws ``i * per_cycle ...``
    of the step key; returns the carry and the first free draw index."""
    per_cycle = _cycle_draws(box)

    def wrapped(i, c):
        draws = _Draws(key, i * per_cycle)
        out = body(draws, c)
        assert draws.count == per_cycle, (draws.count, per_cycle)
        return out

    return jax.lax.fori_loop(0, num_cycles, wrapped, carry), per_cycle * num_cycles


def _integrate_mover(draws, learn_jerk, v_max, a_max, dt, std_vel, ux, uy, vx, vy, ax, ay, scale=1.0):
    """One mover's clamp chain + integration for one cycle: returns the new
    (act_x, act_y, vel_x, vel_y).  In jerk mode ``ax/ay`` is the integrator
    activation state (``actearly`` ordering); in acceleration mode it is
    unused on entry.  Bit-matches ``ops/dynamics`` (the XLA path).

    ``scale`` is the static accel_scale (gain-mass / total-body-mass, < 1
    for bumpered mesh movers): the clamp chain reads the MEASURED
    qacc == scale·act (dynamics.jerk_cycle), act integrates in control
    space, and the body accelerates at scale·act — so the returned values
    stay control-space (act/cmd) while velocities integrate the real qacc.
    At scale == 1.0 the trace is literally unchanged (bit-exact paths)."""
    nvx, nvy = draws.normal_pair()
    vmx = vx + nvx * std_vel
    vmy = vy + nvy * std_vel

    if learn_jerk:
        # measured acceleration (scale*act == qacc; dynamics.jerk_cycle:115)
        amx, amy = (ax, ay) if scale == 1.0 else (scale * ax, scale * ay)
        # candidate acceleration from the commanded jerk, clamped to a_max
        cax0, cay0 = amx + dt * ux, amy + dt * uy
        cax, cay, aclamp = _clamp_norm2(cax0, cay0, a_max)
        j1x = jnp.where(aclamp, (cax - amx) / dt, ux)
        j1y = jnp.where(aclamp, (cay - amy) / dt, uy)
        # velocity clamp; re-derive the jerk if it changed the acceleration
        nx, ny = vmx + dt * cax, vmy + dt * cay
        cnx, cny, vclamp = _clamp_norm2(nx, ny, v_max)
        fax = jnp.where(vclamp, (cnx - vmx) / dt, cax)
        fay = jnp.where(vclamp, (cny - vmy) / dt, cay)
        diff = (fax != cax) | (fay != cay)
        jx = jnp.where(diff, (fax - amx) / dt, j1x)
        jy = jnp.where(diff, (fay - amy) / dt, j1y)
        # integrator actuator with actearly: act += dt*jerk, then qacc = scale*act
        nax = ax + dt * jx
        nay = ay + dt * jy
    else:
        nx, ny = vmx + dt * ux, vmy + dt * uy
        cnx, cny, vclamp = _clamp_norm2(nx, ny, v_max)
        # bit-match ensure_max_dyn_val: the unclamped branch applies the
        # raw action, not the round-tripped (v' - v)/dt
        nax = jnp.where(vclamp, (cnx - vmx) / dt, ux)
        nay = jnp.where(vclamp, (cny - vmy) / dt, uy)

    qx, qy = (nax, nay) if scale == 1.0 else (scale * nax, scale * nay)
    return nax, nay, vx + dt * qx, vy + dt * qy


def _flag(x):
    """A mask as float32 0/1 (explicit dtype: Python-scalar branches would
    widen to float64 under ``jax_enable_x64``)."""
    return jnp.where(x, np.float32(1.0), np.float32(0.0))


# ---------------------------------------------------------------------------
# planning: one autoreset env step for a block of envs
# ---------------------------------------------------------------------------

#: planning state vectors: pos x/y, vel x/y, act x/y (control space), goal x/y, steps
PLANNING_STATE = ('px', 'py', 'vx', 'vy', 'ax', 'ay', 'gx', 'gy', 'steps')
#: per-env outputs of the LAST step of a launch: post-reset observation,
#: pre-reset ('final') observation, flags
PLANNING_LAST = ('s_vx', 's_vy', 's_agx', 's_agy', 'f_vx', 'f_vy', 'f_agx', 'f_agy',
                 'f_ax', 'f_ay', 'wall', 'reached', 'stalled', 'trials')


def _planning_step(key, st, ux, uy, *, c: dict):
    """One full planning autoreset env step: cycles + termination + reward +
    in-kernel start/goal resampling + both observations.

    Returns ``(new_state, (reward, terminated, truncated), last)`` with
    ``last`` ordered as ``PLANNING_LAST``."""
    px, py, vx, vy, ax, ay, gx, gy, steps = st
    wall_check = c['wall_check']
    std_pos, std_vel = c['std_pos'], c['std_vel']
    zero = jnp.zeros_like(px)

    def cycle(draws, carry):
        px, py, vx, vy, ax, ay, wall_f, done_f = carry
        done = done_f > 0.0
        nax, nay, nvx_t, nvy_t = _integrate_mover(
            draws, c['learn_jerk'], c['v_max'], c['a_max'], c['dt'], std_vel,
            ux, uy, vx, vy, ax, ay, scale=c['accel_scale'],
        )
        npx = px + c['dt'] * nvx_t
        npy = py + c['dt'] * nvy_t
        new_wall_f = 1.0 - _flag(wall_check(draws, npx, npy, c['wall_size']))
        px = jnp.where(done, px, npx)
        py = jnp.where(done, py, npy)
        vx = jnp.where(done, vx, nvx_t)
        vy = jnp.where(done, vy, nvy_t)
        ax = jnp.where(done, ax, nax)
        ay = jnp.where(done, ay, nay)
        wall_f = jnp.where(done, wall_f, new_wall_f)
        done_f = jnp.maximum(done_f, wall_f)
        return px, py, vx, vy, ax, ay, wall_f, done_f

    (px, py, vx, vy, ax, ay, wall_f, _), n0 = _cycle_loop(
        key, c['box'], c['num_cycles'], cycle, (px, py, vx, vy, ax, ay, zero, zero)
    )
    draws = _Draws(key, n0)
    f_ax, f_ay = ax, ay  # pre-reset activation (jerk-mode final obs)

    # pre-reset observation, termination and reward (reference: +50 all goals
    # reached, -50 on collision, else -#unreached (sparse) or -distance (dense))
    n1, n2 = draws.normal_pair()
    n3, n4 = draws.normal_pair()
    f_agx = px + n1 * std_pos
    f_agy = py + n2 * std_pos
    f_vx = vx + n3 * std_vel
    f_vy = vy + n4 * std_vel
    ddx, ddy = f_agx - gx, f_agy - gy
    dist = jnp.sqrt(ddx * ddx + ddy * ddy)
    reached = dist <= c['threshold']
    wall = wall_f > 0.0
    miss = -dist if c['dense'] else zero - 1.0
    reward = jnp.where(wall, -50.0, jnp.where(reached, 50.0, miss))
    term = wall | reached
    new_steps = steps + 1.0
    trunc = new_steps >= c['max_episode_steps']
    done = term | trunc

    # in-kernel reset: first-accepted-of-K wall-valid start and goal draws
    # (M=1: no mover-pair or goal-separation constraints)
    def sample_valid(size):
        sx = draws.uniform_in(c['min_x'], c['max_x'])
        sy = draws.uniform_in(c['min_y'], c['max_y'])
        found = _flag(wall_check.sample_valid_at(sx, sy, size))
        trials = jnp.ones_like(px)
        for _ in range(c['cand_k'] - 1):
            cx_ = draws.uniform_in(c['min_x'], c['max_x'])
            cy_ = draws.uniform_in(c['min_y'], c['max_y'])
            ok = wall_check.sample_valid_at(cx_, cy_, size)
            take = ok & (found == 0.0)
            trials = trials + (1.0 - found)
            sx = jnp.where(take, cx_, sx)
            sy = jnp.where(take, cy_, sy)
            found = jnp.maximum(found, _flag(ok))
        return sx, sy, found, trials

    rsx, rsy, s_found, s_trials = sample_valid(c['sample_size'])
    rgx, rgy, g_found, g_trials = sample_valid(c['sample_size'])

    # a stalled draw (no wall-valid candidate in cand_k tries) does NOT
    # restart the env: state and step counter carry over, `done` re-fires
    # next step and the sampler retries with fresh draws (vs. the reference's
    # unbounded rejection loop, benchmark_planning_env.py:369-413)
    found = (s_found > 0.0) & (g_found > 0.0)
    stalled_f = _flag(done & ~found)
    do_reset = done & found

    px = jnp.where(do_reset, rsx, px)
    py = jnp.where(do_reset, rsy, py)
    vx = jnp.where(do_reset, zero, vx)
    vy = jnp.where(do_reset, zero, vy)
    ax = jnp.where(do_reset, zero, ax)
    ay = jnp.where(do_reset, zero, ay)
    gx = jnp.where(do_reset, rgx, gx)
    gy = jnp.where(do_reset, rgy, gy)
    steps = jnp.where(do_reset, 0.0, new_steps)

    m1, m2 = draws.normal_pair()
    m3, m4 = draws.normal_pair()
    s_agx = jnp.where(do_reset, px + m1 * std_pos, f_agx)
    s_agy = jnp.where(do_reset, py + m2 * std_pos, f_agy)
    s_vx = jnp.where(do_reset, vx + m3 * std_vel, f_vx)
    s_vy = jnp.where(do_reset, vy + m4 * std_vel, f_vy)

    last = (s_vx, s_vy, s_agx, s_agy, f_vx, f_vy, f_agx, f_agy, f_ax, f_ay,
            wall_f, _flag(reached), stalled_f, jnp.where(done, s_trials + g_trials, 0.0))
    return (px, py, vx, vy, ax, ay, gx, gy, steps), (reward, _flag(term), _flag(trunc)), last


# ---------------------------------------------------------------------------
# pushing: one autoreset env step for a block of envs
# ---------------------------------------------------------------------------

#: pushing state vectors: mover pos/vel/qacc/act x/y, object pos/vel x/y,
#: object yaw/omega, mover z/vz, goal x/y, steps
PUSHING_STATE = ('px', 'py', 'vx', 'vy', 'ax', 'ay', 'kx', 'ky', 'ox', 'oy', 'wvx', 'wvy',
                 'oyaw', 'ow', 'mz', 'mvz', 'gx', 'gy', 'steps')
PUSHING_LAST = ('s_mpx', 's_mpy', 's_mvx', 's_mvy', 's_agx', 's_agy',
                'f_mpx', 'f_mpy', 'f_mvx', 'f_mvy', 'f_agx', 'f_agy', 'f_qax', 'f_qay',
                'wall', 'reached', 'stalled', 'trials')


def _pushing_cycles(key, st, ux, uy, c: dict):
    """The pushing cycle loop: contact is the corner-aware v2 model of
    ``ops/contact.box_push_contact_v2`` in elementwise form plus the
    quasi-3D mover z DOF (impedance vs f_z lift; models/pushing._step_core),
    matched to the XLA path.  Returns the 16 physics values + wall flag and
    the first free draw index."""
    wall_check = c['wall_check']
    dt = c['dt']

    def cycle(draws, carry):
        px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz, caxis, wall_f, done_f = carry
        done = done_f > 0.0
        nvx, nvy = draws.normal_pair()
        vmx = vx + nvx * c['std_vel']
        vmy = vy + nvy * c['std_vel']

        if c['learn_jerk']:
            # the acceleration reading is the full qacc incl. contact reaction
            cax0, cay0 = ax + dt * ux, ay + dt * uy
            cax, cay, aclamp = _clamp_norm2(cax0, cay0, c['a_max'])
            j1x = jnp.where(aclamp, (cax - ax) / dt, ux)
            j1y = jnp.where(aclamp, (cay - ay) / dt, uy)
            nx, ny = vmx + dt * cax, vmy + dt * cay
            cnx, cny, vclamp = _clamp_norm2(nx, ny, c['v_max'])
            fax = jnp.where(vclamp, (cnx - vmx) / dt, cax)
            fay = jnp.where(vclamp, (cny - vmy) / dt, cay)
            diff = (fax != cax) | (fay != cay)
            jx = jnp.where(diff, (fax - ax) / dt, j1x)
            jy = jnp.where(diff, (fay - ay) / dt, j1y)
            nkx = kx + dt * jx
            nky = ky + dt * jy
            ctrl_x, ctrl_y = nkx, nky
        else:
            nx, ny = vmx + dt * ux, vmy + dt * uy
            cnx, cny, vclamp = _clamp_norm2(nx, ny, c['v_max'])
            ctrl_x = jnp.where(vclamp, (cnx - vmx) / dt, ux)
            ctrl_y = jnp.where(vclamp, (cny - vmy) / dt, uy)
            nkx, nky = kx, ky

        # corner-aware penalty contact from the pre-integration state
        # (ops/contact.box_push_contact_v2, elementwise form)
        cos_y = jnp.cos(oyaw)
        sin_y = jnp.sin(oyaw)
        rx = jnp.abs(cos_y) * c['obj_hx'] + jnp.abs(sin_y) * c['obj_hy']
        ry = jnp.abs(sin_y) * c['obj_hx'] + jnp.abs(cos_y) * c['obj_hy']
        dx_, dy_ = ox - px, oy - py
        olx = (c['mover_hx'] + rx) - jnp.abs(dx_)
        oly = (c['mover_hy'] + ry) - jnp.abs(dy_)
        in_contact = (olx > 0) & (oly > 0)
        olx_c = jnp.maximum(olx, 0.0)
        oly_c = jnp.maximum(oly, 0.0)
        sx_ = jnp.where(dx_ == 0, 1.0, jnp.sign(dx_))
        sy_ = jnp.where(dy_ == 0, 1.0, jnp.sign(dy_))
        # minimum-translation FACE normal with HYSTERESIS (see
        # contact.box_push_contact_v2 for the MuJoCo measurements): the
        # carried axis persists while its overlap lasts
        axis_x = olx_c <= oly_c
        keep_x = (caxis == 0.0) & (olx > 0)
        keep_y = (caxis == 1.0) & (oly > 0)
        axis_x = keep_x | (axis_x & ~keep_y)  # keep_x/keep_y are exclusive
        n_x = jnp.where(axis_x, sx_, 0.0)
        n_y = jnp.where(axis_x, 0.0, sy_)
        pen = jnp.where(axis_x, olx_c, oly_c)
        new_caxis = jnp.where(in_contact, 1.0 - _flag(axis_x), -1.0)

        lo_x = jnp.maximum(px - c['mover_hx'], ox - rx)
        hi_x = jnp.minimum(px + c['mover_hx'], ox + rx)
        lo_y = jnp.maximum(py - c['mover_hy'], oy - ry)
        hi_y = jnp.minimum(py + c['mover_hy'], oy + ry)
        cpx = 0.5 * (lo_x + hi_x)
        cpy = 0.5 * (lo_y + hi_y)
        r_ox = cpx - ox
        r_oy = cpy - oy
        v_obj_cx = wvx - ow * r_oy
        v_obj_cy = wvy + ow * r_ox
        vrx = v_obj_cx - vx
        vry = v_obj_cy - vy
        vn = vrx * n_x + vry * n_y
        fn_mag = jnp.maximum(0.0, c['contact_k'] * pen - c['contact_b'] * vn)
        t_x = -n_y
        t_y = n_x
        vt = vrx * t_x + vry * t_y
        # slip-gated vertical friction share (cone budget + plow + climb
        # driver; ops/contact.box_push_contact_v2)
        f_imp_r = jnp.minimum(jnp.maximum(0.0, -c['contact_b'] * vn), fn_mag)
        avt = jnp.abs(vt)
        slip = jnp.minimum(avt / c['cone_vt'], 1.0) * jnp.clip(
            (c['cone_vt_off'] - avt) / (c['cone_vt_off'] - c['cone_vt_hi']), 0.0, 1.0
        )
        # wedge-capped share with positive feedback in the accumulated mover
        # lift (ops/contact.box_push_contact_v2 + the dynamic cap of
        # models/pushing._step_core)
        fz_cap = c['fz_cap0'] + c['fz_slope'] * jnp.maximum(mz - c['z0'], 0.0)
        f_z = jnp.minimum(c['cone_zeta'] * fn_mag * slip, fz_cap)
        budget = c['contact_mu'] * fn_mag
        cap = jnp.where(f_z > 0, jnp.sqrt(jnp.maximum(budget * budget - f_z * f_z, 0.0)), budget)
        ft_mag = jnp.clip(-c['contact_bt'] * vt, -cap, cap)
        cmask = _flag(in_contact)
        # quasi-3D z-overlap scaling + mover z dynamics (impedance vs the
        # f_z lift) — mirrors models/pushing._step_core
        zf = jnp.clip(
            (jnp.minimum(mz + c['mover_height'], c['obj_height']) - mz) / c['mover_height'], 0.0, 1.0
        )
        f_obj_x = (fn_mag * n_x + ft_mag * t_x) * cmask * zf
        f_obj_y = (fn_mag * n_y + ft_mag * t_y) * cmask * zf
        torque = r_ox * f_obj_y - r_oy * f_obj_x
        f_z_c = f_z * cmask * zf
        zacc = (c['imp_k'] * (c['z0'] - mz) - c['imp_d'] * mvz + f_z_c) / c['total_mass']
        new_mvz = mvz + dt * zacc
        new_mz = jnp.maximum(mz + dt * new_mvz, 0.0)

        # gain-mass-scaled command + contact reaction over the TOTAL body
        # mass (mover + bumper); scale == 1 multiplies exactly (IEEE)
        qacc_x = c['accel_scale'] * ctrl_x + (-f_obj_x) / c['total_mass']
        qacc_y = c['accel_scale'] * ctrl_y + (-f_obj_y) / c['total_mass']
        nvx_t = vx + dt * qacc_x
        nvy_t = vy + dt * qacc_y
        npx = px + dt * nvx_t
        npy = py + dt * nvy_t

        # floor friction under the PLOW LOAD (ops/contact, models/pushing):
        # impact part of the normal force presses the object down, capped
        fimp = f_imp_r * cmask * zf
        load = (1.0 + jnp.minimum(c['plow_unit'] * fimp, c['plow_cap'])
                + jnp.minimum(c['conez_unit'] * f_z_c, c['conez_cap']))
        # object: implicit joint damping then exact discrete Coulomb
        damp = 1.0 + dt * c['obj_damping'] / c['obj_mass']
        ovx_t = (wvx + dt * (f_obj_x / c['obj_mass'])) / damp
        ovy_t = (wvy + dt * (f_obj_y / c['obj_mass'])) / damp
        speed = jnp.sqrt(ovx_t * ovx_t + ovy_t * ovy_t)
        scale = jnp.maximum(0.0, 1.0 - c['mu_g_dt'] * load / jnp.maximum(speed, 1e-12))
        ovx_t = ovx_t * scale
        ovy_t = ovy_t * scale
        nox = ox + dt * ovx_t
        noy = oy + dt * ovy_t
        # yaw: contact torque, implicit damping, torsional Coulomb floor
        damp_w = 1.0 + dt * c['obj_damping'] / c['obj_inertia']
        ow_t = (ow + dt * torque / c['obj_inertia']) / damp_w
        ow_t = jnp.sign(ow_t) * jnp.maximum(0.0, jnp.abs(ow_t) - c['mu_spin'] * dt * load)
        noyaw = oyaw + dt * ow_t

        new_wall_f = 1.0 - _flag(wall_check(draws, npx, npy, c['wall_size']))

        px = jnp.where(done, px, npx)
        py = jnp.where(done, py, npy)
        vx = jnp.where(done, vx, nvx_t)
        vy = jnp.where(done, vy, nvy_t)
        ax = jnp.where(done, ax, qacc_x)
        ay = jnp.where(done, ay, qacc_y)
        kx = jnp.where(done, kx, nkx)
        ky = jnp.where(done, ky, nky)
        ox = jnp.where(done, ox, nox)
        oy = jnp.where(done, oy, noy)
        wvx = jnp.where(done, wvx, ovx_t)
        wvy = jnp.where(done, wvy, ovy_t)
        oyaw = jnp.where(done, oyaw, noyaw)
        ow = jnp.where(done, ow, ow_t)
        mz = jnp.where(done, mz, new_mz)
        mvz = jnp.where(done, mvz, new_mvz)
        # the carried axis dies when the climb breaks contact (zf == 0)
        caxis = jnp.where(done, caxis, jnp.where(zf > 0, new_caxis, -1.0))
        wall_f = jnp.where(done, wall_f, new_wall_f)
        done_f = jnp.maximum(done_f, wall_f)
        return px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz, caxis, wall_f, done_f

    zero = jnp.zeros_like(st[0])
    out, n0 = _cycle_loop(
        key, c['box'], c['num_cycles'], cycle, tuple(st) + (zero - 1.0, zero, zero)
    )
    return out[:16] + (out[17],), n0  # drop the axis carry + done_f


def _pushing_step(key, st, ux, uy, *, c: dict):
    """One full pushing autoreset env step: cycles + termination + reward +
    in-kernel episode restart + pre/post-reset observations.  Returns
    ``(new_state, (reward, terminated, truncated), last)`` with ``last``
    ordered as ``PUSHING_LAST``."""
    gx, gy, steps = st[16:]
    phys, n0 = _pushing_cycles(key, st[:16], ux, uy, c)
    px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz, wall_f = phys
    draws = _Draws(key, n0)
    zero = jnp.zeros_like(px)
    f_qax, f_qay = ax, ay  # pre-reset qacc (jerk-mode final obs)

    # pre-reset ('final') observation
    n1, n2 = draws.normal_pair()
    n3, n4 = draws.normal_pair()
    n5, n6 = draws.normal_pair()
    f_mpx = px + n1 * c['std_pos']
    f_mpy = py + n2 * c['std_pos']
    f_mvx = vx + n3 * c['std_vel']
    f_mvy = vy + n4 * c['std_vel']
    f_agx = ox + n5 * c['object_noise']
    f_agy = oy + n6 * c['object_noise']

    # reference scoring: noisy achieved object position vs the OLD goal
    # (benchmark_pushing_env.py:499-527): 0 at the goal, -1 per step, -50 on
    # a wall collision; the dense mode is models/pushing._step_core's shaping
    ddx_g, ddy_g = f_agx - gx, f_agy - gy
    reached = jnp.sqrt(ddx_g * ddx_g + ddy_g * ddy_g) <= c['threshold']
    wall = wall_f > 0.0
    if c['dense']:
        dgx, dgy = ox - gx, oy - gy
        dmx, dmy = px - ox, py - oy
        d_og = jnp.sqrt(dgx * dgx + dgy * dgy)
        d_mo = jnp.sqrt(dmx * dmx + dmy * dmy)
        approach = -0.3 * jnp.maximum(d_mo - 0.105, 0.0)
        retreat = 0.5 * jnp.minimum(d_mo, 0.15)
        shaped = -d_og + jnp.where(d_og <= c['threshold'], retreat, approach)
        reward = jnp.where(wall, -50.0, shaped)
    else:
        reward = jnp.where(wall, -50.0, jnp.where(reached, 0.0, zero - 1.0))
    new_steps = steps + 1.0
    trunc = new_steps >= c['max_episode_steps']
    done = wall | trunc

    # in-kernel reset (reference semantics: mover uniform with NO validity
    # check, benchmark_pushing_env.py:384-391; object = first-accepted of
    # iid draws at distance > min_mo from the NEW mover; goal uniform)
    rmx = draws.uniform_in(c['min_x'], c['max_x'])
    rmy = draws.uniform_in(c['min_y'], c['max_y'])
    rox = draws.uniform_in(c['obj_min_x'], c['obj_max_x'])
    roy = draws.uniform_in(c['obj_min_y'], c['obj_max_y'])
    d0x, d0y = rox - rmx, roy - rmy
    found = _flag(jnp.sqrt(d0x * d0x + d0y * d0y) > c['min_mo'])
    trials = jnp.ones_like(px)
    for _ in range(c['cand_k'] - 1):
        cx_ = draws.uniform_in(c['obj_min_x'], c['obj_max_x'])
        cy_ = draws.uniform_in(c['obj_min_y'], c['obj_max_y'])
        ddx, ddy = cx_ - rmx, cy_ - rmy
        ok = jnp.sqrt(ddx * ddx + ddy * ddy) > c['min_mo']
        take = ok & (found == 0.0)
        trials = trials + (1.0 - found)
        rox = jnp.where(take, cx_, rox)
        roy = jnp.where(take, cy_, roy)
        found = jnp.maximum(found, _flag(ok))
    rgx = draws.uniform_in(c['obj_min_x'], c['obj_max_x'])
    rgy = draws.uniform_in(c['obj_min_y'], c['obj_max_y'])

    # stalled sampling => do NOT restart this env: keep the post-cycle state
    # and step counter, so `done` re-fires next step and the reset retries
    # with fresh draws (the reference would spin in its unbounded rejection
    # loop, warning every 100 trials — benchmark_pushing_env.py:394-407)
    stalled_f = _flag(done & (found == 0.0))
    do_reset = done & (found > 0.0)

    px = jnp.where(do_reset, rmx, px)
    py = jnp.where(do_reset, rmy, py)
    vx = jnp.where(do_reset, zero, vx)
    vy = jnp.where(do_reset, zero, vy)
    ax = jnp.where(do_reset, zero, ax)
    ay = jnp.where(do_reset, zero, ay)
    kx = jnp.where(do_reset, zero, kx)
    ky = jnp.where(do_reset, zero, ky)
    ox = jnp.where(do_reset, rox, ox)
    oy = jnp.where(do_reset, roy, oy)
    wvx = jnp.where(do_reset, zero, wvx)
    wvy = jnp.where(do_reset, zero, wvy)
    oyaw = jnp.where(do_reset, zero, oyaw)
    ow = jnp.where(do_reset, zero, ow)
    mz = jnp.where(do_reset, zero + c['z0'], mz)
    mvz = jnp.where(do_reset, zero, mvz)
    gx = jnp.where(do_reset, rgx, gx)
    gy = jnp.where(do_reset, rgy, gy)
    steps = jnp.where(do_reset, 0.0, new_steps)

    # post-reset observation for restarted envs, fresh draws
    m1, m2 = draws.normal_pair()
    m3, m4 = draws.normal_pair()
    m5, m6 = draws.normal_pair()
    s_mpx = jnp.where(do_reset, px + m1 * c['std_pos'], f_mpx)
    s_mpy = jnp.where(do_reset, py + m2 * c['std_pos'], f_mpy)
    s_mvx = jnp.where(do_reset, vx + m3 * c['std_vel'], f_mvx)
    s_mvy = jnp.where(do_reset, vy + m4 * c['std_vel'], f_mvy)
    s_agx = jnp.where(do_reset, ox + m5 * c['object_noise'], f_agx)
    s_agy = jnp.where(do_reset, oy + m6 * c['object_noise'], f_agy)

    new_st = (px, py, vx, vy, ax, ay, kx, ky, ox, oy, wvx, wvy, oyaw, ow, mz, mvz, gx, gy, steps)
    last = (s_mpx, s_mpy, s_mvx, s_mvy, s_agx, s_agy,
            f_mpx, f_mpy, f_mvx, f_mvy, f_agx, f_agy, f_qax, f_qay,
            wall_f, _flag(reached), stalled_f, jnp.where(done, trials, 0.0))
    return new_st, (reward, _flag(wall), _flag(trunc)), last


# ---------------------------------------------------------------------------
# the kernel and its launch
# ---------------------------------------------------------------------------


# The launch rule, one env per thread: 32 envs in one warp per program spreads
# a 4096-env batch over 128 programs, about one per SM of an H100 (132 SMs).
# Swept on an H100 over {32, 64, 128} envs x {1, 2, 4} warps at 256 and 4096
# envs (``tools/kernel_vs_xla.py``): every setting with one env per thread
# (32/1, 64/2, 128/4) ran within 5% of the others, every setting with more
# envs than threads 1.7-7x slower; at these widths a launch is bound by one
# thread's serial chain of cycles, so 32/1, which also spreads small batches
# widest, is the rule.
ENVS_PER_PROGRAM = 32
NUM_WARPS = 1


def _kernel(stream_ref, step0_ref, *refs, step_fn, n_state: int, n_last: int,
            num_steps: int, block: int):
    """``num_steps`` autoreset env steps for the ``block`` envs of this program."""
    n_in = n_state + 2
    st_refs, (ux_ref, uy_ref) = refs[:n_state], refs[n_state:n_in]
    out_st, out_step, out_last = (
        refs[n_in:n_in + n_state], refs[n_in + n_state:n_in + n_state + 3], refs[n_in + n_state + 3:]
    )
    b = stream_ref.shape[0]
    first = pl.program_id(0).astype(jnp.int32) * block
    envs = pl.ds(first, block)
    mask = first + jnp.arange(block, dtype=jnp.int32) < b
    stream = plgpu.load(stream_ref.at[envs], mask=mask, other=0)
    st0 = tuple(plgpu.load(r.at[envs], mask=mask, other=0.0) for r in st_refs)
    step0 = step0_ref[0]

    def body(t, carry):
        st, _ = carry
        t = t.astype(jnp.int32)  # the loop index widens to int64 under jax_enable_x64
        ux = plgpu.load(ux_ref.at[t, envs], mask=mask, other=0.0)
        uy = plgpu.load(uy_ref.at[t, envs], mask=mask, other=0.0)
        new_st, per_step, last = step_fn(step_key(stream, step0 + t), st, ux, uy)
        for ref, val in zip(out_step, per_step):
            plgpu.store(ref.at[t, envs], val, mask=mask)
        return tuple(new_st), tuple(last)

    zeros = jnp.zeros((block,), jnp.float32)
    st, last = jax.lax.fori_loop(0, num_steps, body, (st0, (zeros,) * n_last))
    for ref, val in zip(out_st + out_last, st + last):
        plgpu.store(ref.at[envs], val, mask=mask)


def _check_platform(interpret: bool) -> None:
    if not interpret and jax.default_backend() != 'gpu':
        raise RuntimeError(
            'the fused step kernel compiles for NVIDIA GPUs only (Pallas Triton route); '
            f'the default backend is {jax.default_backend()!r} — use the XLA step '
            '(models.*.step_autoreset) there, or interpret=True in tests'
        )


def _make_run(step_fn, state_names, last_names, num_steps, name, interpret, block, num_warps):
    """``run(streams [B] uint32, step0, state, (ux [K, B], uy [K, B])) ->
    (state, (reward, terminated, truncated) [K, B], last)``; state and last
    are dicts of ``[B]`` float32 vectors keyed by ``state_names`` /
    ``last_names``."""
    _check_platform(interpret)
    n_state, n_last = len(state_names), len(last_names)

    def run(streams, step0, state, actions):
        b = streams.shape[0]
        blk = block or ENVS_PER_PROGRAM
        warps = num_warps or NUM_WARPS
        vec = jax.ShapeDtypeStruct((b,), jnp.float32)
        per_step = jax.ShapeDtypeStruct((num_steps, b), jnp.float32)
        call = pl.pallas_call(
            partial(_kernel, step_fn=step_fn, n_state=n_state, n_last=n_last,
                    num_steps=num_steps, block=blk),
            out_shape=[vec] * n_state + [per_step] * 3 + [vec] * n_last,
            grid=(pl.cdiv(b, blk),),
            backend='triton',
            compiler_params=plgpu.CompilerParams(num_warps=warps, num_stages=1),
            interpret=interpret,
            name=name,
        )
        outs = call(
            jnp.asarray(streams, jnp.uint32), jnp.asarray(step0, jnp.int32).reshape(1),
            *(jnp.asarray(state[k], jnp.float32) for k in state_names),
            *(jnp.asarray(a, jnp.float32) for a in actions),
        )
        new_state = dict(zip(state_names, outs[:n_state]))
        signals = tuple(outs[n_state:n_state + 3])
        return new_state, signals, dict(zip(last_names, outs[n_state + 3:]))

    return run


def supports(config, params) -> bool:
    """Whether the fused kernel covers this configuration (one mover, circle
    or box collision shape, acceleration or jerk actuation, float32)."""
    return (
        config.num_movers == 1
        and config.collision_shape in ('circle', 'box')
        and np.asarray(params.v_max).dtype == np.float32
    )


def use_kernel(config, params) -> bool:
    """The one place that chooses the execution path: the fused kernel where
    it covers the configuration on a GPU, the XLA step everywhere else."""
    return jax.default_backend() == 'gpu' and supports(config, params)


def shard_step(fused, mesh, axis_name: str = 'data'):
    """A batched kernel step under ``jax.shard_map`` over the data mesh: each
    device runs the kernel on its local ``[B/D, ...]`` rows."""
    spec = P(axis_name)
    # check_vma=False: the kernel's out_shapes carry no varying-mesh-axis
    # metadata; the step is per-env local (no collectives), so the check adds
    # nothing here
    return jax.shard_map(fused, mesh=mesh, in_specs=(spec, spec), out_specs=spec, check_vma=False)


def batched_autoreset_step(model, config, params, mesh=None, axis_name: str = 'data'):
    """The batched autoreset step ``step(state, action) -> (state, obs,
    reward, terminated, truncated, info)`` of an env family (``models.planning``
    or ``models.pushing``) on the path ``use_kernel`` chooses: the fused
    kernel on a GPU for the configurations it covers (per device under
    ``shard_map`` when ``mesh`` is given), the vmapped XLA ``step_autoreset``
    everywhere else.  ``step.uses_kernel`` says which."""
    if use_kernel(config, params):
        fused = model.make_fused_step_autoreset(config, params)
        if mesh is not None:
            fused = shard_step(fused, mesh, axis_name)

        def step(state, action):
            return fused(state, action)

        step.uses_kernel = True
        return step

    batched = jax.vmap(model.step_autoreset, in_axes=(None, None, 0, 0))

    def step(state, action):
        return batched(config, params, state, action)

    step.uses_kernel = False
    return step


def _grid_np(params) -> dict:
    """Static numpy snapshot of the tile grid for trace-time specialization."""
    g = params.grid
    return {
        'layout': np.asarray(g.layout),
        'tile_x': np.asarray(g.tile_x, np.float64),
        'tile_y': np.asarray(g.tile_y, np.float64),
        'tsx': float(np.asarray(g.tile_size)[0]),
        'tsy': float(np.asarray(g.tile_size)[1]),
        'complete3x3': np.asarray(g.complete3x3),
        'corner_xy': np.asarray(g.corner_xy, np.float64),
        'corner_onehot': np.asarray(g.corner_onehot),
    }


def _wall_sizes(config, params):
    """(step_size, sample_size): the wall-check size during cycles
    (c + offset_wall) and during reset sampling (c + offset + offset_wall);
    a float radius for 'circle', an (hx, hy) tuple for 'box'
    (reference basic_envs.py:485-489)."""
    off = float(np.asarray(params.c_offset))
    offw = float(np.asarray(params.c_offset_wall))
    if config.collision_shape == 'box':
        c = np.asarray(params.c_size, np.float64).reshape(-1, 2)[0]
        return (
            (float(c[0]) + offw, float(c[1]) + offw),
            (float(c[0]) + off + offw, float(c[1]) + off + offw),
        )
    c = float(np.asarray(params.c_size).reshape(-1)[0])
    return c + offw, c + off + offw


def _f(x) -> float:
    return float(np.asarray(x).reshape(-1)[0])


def _common_consts(config, params, cand_k: int) -> dict:
    box = config.collision_shape == 'box'
    wall_size, sample_size = _wall_sizes(config, params)
    std_pos = float(np.asarray(params.std_noise)[0])
    return dict(
        wall_check=_make_wall_checker(_grid_np(params), box, std_pos),
        box=box, wall_size=wall_size, sample_size=sample_size,
        num_cycles=config.num_cycles, learn_jerk=config.learn_jerk,
        dense=config.reward_mode == 'dense', cand_k=cand_k,
        max_episode_steps=float(config.max_episode_steps),
        v_max=_f(params.v_max), a_max=_f(params.a_max), dt=_f(params.dt),
        std_pos=std_pos, std_vel=float(np.asarray(params.std_noise)[1]),
        accel_scale=_f(params.accel_scale), threshold=_f(params.threshold_pos),
        min_x=float(np.asarray(params.min_xy)[0]), min_y=float(np.asarray(params.min_xy)[1]),
        max_x=float(np.asarray(params.max_xy)[0]), max_y=float(np.asarray(params.max_xy)[1]),
    )


def _require(config, params):
    if not supports(config, params):
        raise ValueError(
            'the fused kernel covers one mover, circle or box collision shapes and '
            f'float32 only; got {config} — use the XLA step'
        )


def planning_kernel(config, params, num_steps: int, *, cand_k: int = 16,
                    interpret: bool = False, block: int | None = None,
                    num_warps: int | None = None):
    """``num_steps`` planning autoreset steps (1 mover) in one launch; see
    ``_make_run`` for the call signature and ``PLANNING_STATE`` /
    ``PLANNING_LAST`` for the vector names.  ``block`` / ``num_warps``
    override the launch rule (``ENVS_PER_PROGRAM`` / ``NUM_WARPS``)."""
    _require(config, params)
    c = _common_consts(config, params, cand_k)
    return _make_run(partial(_planning_step, c=c), PLANNING_STATE, PLANNING_LAST,
                     num_steps, 'planning_autoreset', interpret, block, num_warps)


def pushing_kernel(config, params, num_steps: int, *, cand_k: int = 32,
                   interpret: bool = False, block: int | None = None,
                   num_warps: int | None = None):
    """``num_steps`` pushing autoreset steps in one launch; see
    ``planning_kernel``, ``PUSHING_STATE`` and ``PUSHING_LAST``."""
    _require(config, params)
    c = _common_consts(config, params, cand_k)
    g = lambda name: _f(getattr(params, name))  # noqa: E731
    m_g = g('object_mass') * g('gravity')
    c.update(
        object_noise=g('object_noise'),
        obj_min_x=float(np.asarray(params.obj_min_xy)[0]),
        obj_min_y=float(np.asarray(params.obj_min_xy)[1]),
        obj_max_x=float(np.asarray(params.obj_max_xy)[0]),
        obj_max_y=float(np.asarray(params.obj_max_xy)[1]),
        min_mo=g('min_mo_dist'),
        total_mass=g('total_mass'),
        mover_hx=float(np.asarray(params.mover_half)[0]),
        mover_hy=float(np.asarray(params.mover_half)[1]),
        obj_hx=float(np.asarray(params.object_half)[0]),
        obj_hy=float(np.asarray(params.object_half)[1]),
        obj_mass=g('object_mass'), obj_damping=g('object_damping'),
        contact_k=g('contact_k'), contact_b=g('contact_b'), contact_bt=g('contact_bt'),
        contact_mu=g('contact_mu'), mu_g_dt=g('floor_mu') * g('gravity') * g('dt'),
        obj_inertia=g('obj_inertia'), mu_spin=g('mu_spin'),
        plow_unit=g('plow_kappa') / m_g, plow_cap=g('plow_cap'),
        cone_zeta=g('cone_zeta'), cone_vt=g('cone_vt'), cone_vt_hi=g('cone_vt_hi'),
        cone_vt_off=g('cone_vt_off'), conez_unit=g('cone_plow') / m_g,
        conez_cap=g('cone_plow_cap'), mover_height=g('mover_height'),
        obj_height=g('object_height'), imp_k=g('imp_k'), imp_d=g('imp_d'),
        z0=g('initial_zpos'), fz_cap0=g('cone_fz_cap'), fz_slope=g('cone_fz_slope'),
    )
    return _make_run(partial(_pushing_step, c=c), PUSHING_STATE, PUSHING_LAST,
                     num_steps, 'pushing_autoreset', interpret, block, num_warps)
