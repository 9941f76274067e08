"""Wall-validity kernel: is a mover position clear of all imaginary tile-edge walls?

Branch-free, batched re-design of the reference's ``qpos_is_valid``
(``/root/reference/gymnasium_planar_robotics/envs/basic_envs.py:459-788``).
The reference gathers the (qpos, covering-tile) pairs with ``np.where`` and
applies a chain of scatter-style index updates; here the same decision
procedure is evaluated *densely* over the full ``[Q, Tx, Ty]`` cube of
(position, grid-cell) pairs with ``where``-masks — a direct elementwise mapping with
no data-dependent shapes, identical results.

Semantics (kept bit-for-bit with the reference, including its quirks):

- a position "covers" every grid cell whose footprint contains it, with
  *inclusive* bounds (basic_envs.py:508-513) — missing-tile cells included;
- fast path: covering any tile whose full 3x3 neighborhood exists makes the
  position valid regardless of collision size (basic_envs.py:528-540);
- otherwise the position must be valid w.r.t. *every* covering cell
  (basic_envs.py:785-786): inside that cell's edges by a strict margin, where
  a violated edge (or edge pair, via the diagonal terms) is excused when the
  adjacent (or diagonal) tiles exist (basic_envs.py:545-648);
- for box collision shapes all four rectangle vertices must pass the
  edge tests (basic_envs.py:655) and, additionally, at "missing diagonal
  corner" sites the mover rectangle must not intersect the missing tile's
  rectangle (basic_envs.py:657-783);
- a position covering no grid cell at all is invalid (the reference raises —
  basic_envs.py:514-517; here it is reported as invalid so the check stays
  jittable; use ``models`` layer validation for the loud version).
"""

from __future__ import annotations

import jax.numpy as jnp

from gymnasium_planar_robotics_tpu.ops import geometry
from gymnasium_planar_robotics_tpu.ops.grid import TileGrid


def _neighbor(layout: jnp.ndarray, dx: int, dy: int) -> jnp.ndarray:
    """[Tx, Ty] bool: tile exists at (i+dx, j+dy) (False out of bounds)."""
    tx, ty = layout.shape
    pad = jnp.pad(layout, 1, mode='constant', constant_values=0)
    return pad[1 + dx : 1 + dx + tx, 1 + dy : 1 + dy + ty] == 1


def _edge_and_rescue_valid(
    grid: TileGrid,
    px: jnp.ndarray,  # [..., V] per-vertex (or V=1 point) x coords, broadcast over grid dims below
    py: jnp.ndarray,
    cx: jnp.ndarray,  # [..., V] per-vertex safety margins in x (0 for box vertices)
    cy: jnp.ndarray,
) -> jnp.ndarray:
    """Per-(qpos, cell) edge validity with neighbor rescues.

    ``px/py/cx/cy`` have shape [Q, V]; returns [Q, Tx, Ty] bool (all V vertices
    valid).  Mirrors the sum-of-products at basic_envs.py:580-655; the
    reference asserts the sum is 0/1, so logical OR is identical.
    """
    layout = grid.layout
    L = layout == 1  # [Tx, Ty]
    tile_x = grid.tile_x  # [Tx, Ty]
    tile_y = grid.tile_y
    tsx = grid.tile_size[0]
    tsy = grid.tile_size[1]

    # broadcast to [Q, V, Tx, Ty]
    px = px[..., :, None, None]
    py = py[..., :, None, None]
    cx = cx[..., :, None, None]
    cy = cy[..., :, None, None]
    min_x = (tile_x - tsx)[None, None]
    max_x = (tile_x + tsx)[None, None]
    min_y = (tile_y - tsy)[None, None]
    max_y = (tile_y + tsy)[None, None]
    Lb = L[None, None]

    # strict-margin edge tests gated on the tile existing (basic_envs.py:545-572)
    m_minx = Lb & (min_x < px - cx)
    m_maxx = Lb & (px + cx < max_x)
    m_miny = Lb & (min_y < py - cy)
    m_maxy = Lb & (py + cy < max_y)

    # neighbor-existence excuses (basic_envs.py:583-648); in-bounds gating via
    # the zero padding in _neighbor matches mask_idx_{x,y}_{lmin,smax}
    ex_minx = (L & _neighbor(layout, -1, 0))[None, None]
    ex_maxx = (L & _neighbor(layout, 1, 0))[None, None]
    ex_miny = (L & _neighbor(layout, 0, -1))[None, None]
    ex_maxy = (L & _neighbor(layout, 0, 1))[None, None]
    ex_minx_miny = (L & _neighbor(layout, 0, -1) & _neighbor(layout, -1, -1))[None, None]
    ex_minx_maxy = (L & _neighbor(layout, 0, 1) & _neighbor(layout, -1, 1))[None, None]
    ex_maxx_miny = (L & _neighbor(layout, 0, -1) & _neighbor(layout, 1, -1))[None, None]
    ex_maxx_maxy = (L & _neighbor(layout, 0, 1) & _neighbor(layout, 1, 1))[None, None]

    u_minx = ~m_minx & ex_minx
    u_maxx = ~m_maxx & ex_maxx

    valid = m_minx & m_maxx & m_miny & m_maxy
    valid |= u_minx & ((m_miny & m_maxy) | (~m_miny & ex_minx_miny) | (~m_maxy & ex_minx_maxy))
    valid |= u_maxx & ((m_miny & m_maxy) | (~m_miny & ex_maxx_miny) | (~m_maxy & ex_maxx_maxy))
    valid |= (~m_miny & ex_miny) & m_minx & m_maxx
    valid |= (~m_maxy & ex_maxy) & m_minx & m_maxx

    return valid.all(axis=-3)  # all vertices -> [Q, Tx, Ty]


def qpos_is_valid(
    grid: TileGrid,
    xy: jnp.ndarray,
    c_size: jnp.ndarray,
    quat: jnp.ndarray | None = None,
    collision_shape: str = 'circle',
) -> jnp.ndarray:
    """Whether each (x, y) position is wall-collision-free.

    :param xy: [Q, 2] positions
    :param c_size: collision size *including* any safety offsets the caller
        wants (the reference adds ``offset_wall`` always and ``offset``
        optionally at basic_envs.py:487 — do that at the call site):
        [Q] radii for 'circle', [Q, 2] half-extents for 'box'
    :param quat: [Q, 4] (w,x,y,z) orientations, required for 'box'
    :return: [Q] bool, True = valid (no wall collision)
    """
    xy = jnp.asarray(xy)
    q = xy.shape[0]
    x = xy[:, 0]
    y = xy[:, 1]

    tsx = grid.tile_size[0]
    tsy = grid.tile_size[1]
    # inclusive covering test over every grid cell (basic_envs.py:508-513)
    above = (
        (grid.tile_x[None] - tsx <= x[:, None, None])
        & (x[:, None, None] <= grid.tile_x[None] + tsx)
        & (grid.tile_y[None] - tsy <= y[:, None, None])
        & (y[:, None, None] <= grid.tile_y[None] + tsy)
    )  # [Q, Tx, Ty]

    if collision_shape == 'circle':
        c = jnp.asarray(c_size).reshape(q)
        valid_cell = _edge_and_rescue_valid(grid, x[:, None], y[:, None], c[:, None], c[:, None])
    elif collision_shape == 'box':
        assert quat is not None, "collision_shape 'box' requires quaternions"
        c = jnp.asarray(c_size).reshape(q, 2)
        qpos7 = jnp.concatenate([xy, jnp.zeros((q, 1), xy.dtype), quat], axis=-1)
        verts = geometry.get_2D_rect_vertices(qpos7, c)  # [Q, 2, 4]
        zeros = jnp.zeros((q, 4), xy.dtype)
        valid_cell = _edge_and_rescue_valid(grid, verts[:, 0, :], verts[:, 1, :], zeros, zeros)

        # missing-diagonal-corner checks (basic_envs.py:657-783): at each
        # corner site, the mover rect must not reach into the missing tile
        num_corners = grid.corner_onehot.shape[0]
        if num_corners:
            corner_qpos = jnp.concatenate(
                [grid.corner_xy, jnp.zeros((num_corners, 1), xy.dtype)]
                + [jnp.tile(jnp.asarray([[1.0, 0.0, 0.0, 0.0]], xy.dtype), (num_corners, 1))],
                axis=-1,
            )  # [C, 7]
            tile_half = jnp.tile(grid.tile_size[None, :2], (num_corners, 1))  # [C, 2]
            hit = geometry.check_rectangles_intersect(
                qpos7[:, None, :], corner_qpos[None, :, :], c[:, None, :], tile_half[None, :, :]
            )  # [Q, C]
            # fail the covering cell that owns corner c whenever the rect reaches in
            fail = (hit[:, :, None, None] & grid.corner_onehot[None]).any(axis=1)  # [Q, Tx, Ty]
            valid_cell &= ~fail
    else:
        raise ValueError(f'unknown collision shape: {collision_shape!r}')

    fast = (above & grid.complete3x3[None]).any(axis=(-1, -2))
    careful = (~above | valid_cell).all(axis=(-1, -2)) & above.any(axis=(-1, -2))
    return fast | careful
