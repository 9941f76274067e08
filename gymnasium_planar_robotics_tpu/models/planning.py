"""BenchmarkPlanningEnv: pure-functional batched motion planning.

Re-design of ``/root/reference/gymnasium_planar_robotics/envs/planning/
benchmark_planning_env.py`` (collision-free multi-mover goal reaching with
jerk- or acceleration-limited actuation).  Instead of the reference's
XML-rebuild-per-reset + 40x(Python callback -> MuJoCo FFI -> collision pass)
step loop (basic_envs.py:1879-1905), the whole environment is three pure
functions over a static config and an array pytree:

    reset(config, params, key)           -> (state, obs, info)
    step(config, params, state, action)  -> (state, obs, reward, term, trunc, info)
    step_autoreset(...)                  -> same, resetting done envs in-place

Everything is single-env shaped; batch with ``jax.vmap`` and shard the batch
axis with ``NamedSharding`` (see ``parallel/``).  The 40-cycle hot loop is a
``lax.scan`` with a latched collision mask replacing the reference's ``break``
(no further integration after a collision, basic_envs.py:1847-1850, 1902-1905).

Correctness bar (validated in tests/test_planning_env.py): bit-identical
float64 trajectories vs. the reference MuJoCo env at ``std_noise=0`` for fixed
action sequences, and the reference's own physics-oracle tests reproduced.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from gymnasium_planar_robotics_tpu.models import common
from gymnasium_planar_robotics_tpu.ops import dynamics
from gymnasium_planar_robotics_tpu.ops.grid import TileGrid, make_tile_grid

REWARD_SUCCESS = 50.0  # benchmark_planning_env.py:220


@dataclasses.dataclass(frozen=True)
class PlanningConfig:
    """Static (hashable) structure of the env — anything that changes shapes
    or trace structure."""

    num_movers: int
    num_cycles: int = 40
    learn_jerk: bool = False
    collision_shape: str = 'circle'  # 'circle' | 'box'
    max_reset_trials: int = 100
    max_episode_steps: int = 50  # TimeLimit applied by step_autoreset / adapters
    # 'sparse' = reference semantics (+50 / -50 / -#unreached); 'dense' is an
    # opt-in shaped variant (-sum of goal distances, same collision penalty)
    # for learners without hindsight relabeling
    reward_mode: str = 'sparse'


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PlanningParams:
    """Array-valued parameters (a pytree; shardable/donatable)."""

    grid: TileGrid
    mover_mass: jax.Array  # [M] configured mover mass == actuator gain
    accel_scale: jax.Array  # [M] gain-mass / total-body-mass (< 1 with bumper geoms)
    mover_size: jax.Array  # [M, 3] half-extents
    c_size: jax.Array  # [M] (circle) or [M, 2] (box)
    c_offset: jax.Array  # scalar: collision_params['offset']
    c_offset_wall: jax.Array  # scalar: collision_params['offset_wall']
    std_noise: jax.Array  # [3] pos/vel/acc sensor noise std
    v_max: jax.Array
    a_max: jax.Array
    j_max: jax.Array
    threshold_pos: jax.Array
    initial_zpos: jax.Array
    dt: jax.Array  # cycle time (MuJoCo timestep), 0.001
    min_xy: jax.Array  # [2] sampling bounds (benchmark_planning_env.py:262-267)
    max_xy: jax.Array
    min_goal_dist: jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PlanningState:
    """Per-env dynamic state (vmap over a leading batch axis)."""

    pos: jax.Array  # [M, 2]
    vel: jax.Array  # [M, 2]
    acc: jax.Array  # [M, 2] last applied acceleration (MuJoCo qacc)
    act: jax.Array  # [M, 2] jerk-integrator activation state
    goals: jax.Array  # [M, 2]
    key: jax.Array  # jax PRNG key
    steps: jax.Array  # int32 env steps taken this episode


def make_planning_env(
    layout_tiles,
    num_movers: int,
    tile_params: dict[str, Any] | None = None,
    mover_params: dict[str, Any] | None = None,
    initial_mover_zpos: float = 0.003,
    std_noise=1e-5,
    num_cycles: int = 40,
    collision_params: dict[str, Any] | None = None,
    v_max: float = 2.0,
    a_max: float = 10.0,
    j_max: float = 100.0,
    learn_jerk: bool = False,
    threshold_pos: float = 0.1,
    dtype=jnp.float32,
    max_reset_trials: int = 100,
    reward_mode: str = 'sparse',
) -> tuple[PlanningConfig, PlanningParams]:
    """Host-side constructor mirroring the reference's kwargs
    (benchmark_planning_env.py:165-291)."""
    tile_params = tile_params or {}
    mover_params = mover_params or {}
    collision_params = collision_params or {}

    tile_size = np.asarray(tile_params.get('size', np.array([0.24 / 2, 0.24 / 2, 0.0352 / 2])))
    grid = make_tile_grid(layout_tiles, tile_size, dtype=dtype)

    mover_mass = np.broadcast_to(np.asarray(mover_params.get('mass', 1.24), dtype=np.float64).reshape(-1), (num_movers,))
    accel_scale = np.ones((num_movers,))
    mover_shape = mover_params.get('shape', 'box')
    if mover_shape == 'mesh':
        # mesh movers: size comes from the (scaled) mesh AABB, exactly like the
        # reference's _resolve_mover_size (basic_envs.py:1396-1437)
        from gymnasium_planar_robotics_tpu.utils import meshes

        mesh_cfg = mover_params.get('mesh', {})
        mover_size = meshes.resolve_mover_size(
            'mesh',
            None,
            mesh_cfg.get('mover_stl_path', 'beckhoff_apm4330_mover'),
            mesh_cfg.get('scale', (1.0, 1.0, 1.0)),
        )
        mover_size = np.broadcast_to(mover_size.reshape(-1, 3), (num_movers, 3))
        # a bumper geom carries its OWN mass on the same body
        # (basic_envs.py:911-925) while the actuator gain stays the
        # configured mover mass (benchmark_planning_env.py:303-321), so the
        # real acceleration is the command scaled by m_gain / m_total
        if mesh_cfg.get('bumper_stl_path', 'beckhoff_apm4330_bumper') is not None:
            bumper_mass = np.broadcast_to(
                np.asarray(mesh_cfg.get('bumper_mass', 0.1), dtype=np.float64).reshape(-1), (num_movers,)
            )
            assert (bumper_mass >= 0).all(), 'Bumper mass must be non-negative.'
            accel_scale = mover_mass / (mover_mass + bumper_mass)
    else:
        assert mover_shape in ('box', 'cylinder'), f'unknown mover shape {mover_shape!r}'
        mover_size = np.asarray(mover_params.get('size', np.array([0.155 / 2, 0.155 / 2, 0.012 / 2])))
        mover_size = np.broadcast_to(mover_size.reshape(-1, 3), (num_movers, 3))

    c_shape = collision_params.get('shape', 'circle')
    c_size_in = collision_params.get('size', 0.11)
    c_offset = float(collision_params.get('offset', 0.0))
    c_offset_wall = float(collision_params.get('offset_wall', 0.0))
    c_size = common.expand_c_size(c_size_in, num_movers, c_shape, dtype)

    std = np.asarray(std_noise, dtype=np.float64).reshape(-1)
    std = np.broadcast_to(std, (3,)) if std.shape == (1,) else std
    assert std.shape == (3,), 'noise standard deviation has to be a float or an array of shape (3,)'

    # construction-time validation (reference basic_envs.py:1469-1626)
    from gymnasium_planar_robotics_tpu.models import validation

    validation.check_tile_config(layout_tiles, tile_size)
    validation.check_mover_config(num_movers, mover_size, mover_mass, initial_mover_zpos)
    validation.check_collision_params(c_shape, np.asarray(c_size), mover_size, mover_shape)

    # sampling bounds: the reference's workspace (max tile center +
    # tile_size/2) shrunk by the full safety margin
    # (benchmark_planning_env.py:262-267; for 'box' the margin is the 2-vector)
    if c_shape == 'circle':
        margin = np.asarray(c_size_in).reshape(-1)[0] + c_offset + c_offset_wall
        margin = np.array([margin, margin])
    else:
        margin = np.asarray(c_size_in).reshape(-1, 2)[0] + c_offset + c_offset_wall
    hi = np.array(
        [
            (2 * layout_tiles.shape[0] - 1) * tile_size[0] + tile_size[0] / 2,
            (2 * layout_tiles.shape[1] - 1) * tile_size[1] + tile_size[1] / 2,
        ]
    )

    config = PlanningConfig(
        num_movers=num_movers,
        num_cycles=num_cycles,
        learn_jerk=learn_jerk,
        collision_shape=c_shape,
        max_reset_trials=max_reset_trials,
        reward_mode=reward_mode,
    )
    params = PlanningParams(
        grid=grid,
        mover_mass=jnp.asarray(mover_mass, dtype),
        accel_scale=jnp.asarray(accel_scale, dtype),
        mover_size=jnp.asarray(mover_size, dtype),
        c_size=c_size,
        c_offset=jnp.asarray(c_offset, dtype),
        c_offset_wall=jnp.asarray(c_offset_wall, dtype),
        std_noise=jnp.asarray(std, dtype),
        v_max=jnp.asarray(v_max, dtype),
        a_max=jnp.asarray(a_max, dtype),
        j_max=jnp.asarray(j_max, dtype),
        threshold_pos=jnp.asarray(threshold_pos, dtype),
        initial_zpos=jnp.asarray(initial_mover_zpos, dtype),
        dt=jnp.asarray(0.001, dtype),
        min_xy=jnp.asarray(margin, dtype),
        max_xy=jnp.asarray(hi - margin, dtype),
        min_goal_dist=common.min_goal_distance(c_size, jnp.asarray(c_offset, dtype), c_shape),
    )
    return config, params


# ---------------------------------------------------------------------------
# collision checks (shared by reset and the cycle loop)
# ---------------------------------------------------------------------------


def _apply_pose_noise(config, pos, noise):
    """(noisy_xy, noisy_quat) from a pre-drawn noise row ([M, 2] or [M, 6])."""
    xy = pos + noise[:, :2]
    if config.collision_shape == 'box':
        quat = jnp.asarray(common.IDENTITY_QUAT, pos.dtype) + noise[:, 2:]
    else:
        quat = None
    return xy, quat


def _pose_noise_dims(config: PlanningConfig) -> int:
    return 6 if config.collision_shape == 'box' else 2


def _collision_checks(
    config: PlanningConfig,
    params: PlanningParams,
    pos: jnp.ndarray,
    wall_noise: jnp.ndarray,
    mover_noise: jnp.ndarray,
    wall_safety_offset: bool,
    mover_safety_offset: bool,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(wall_collision, mover_collision) using pre-drawn sensor noise,
    mirroring the two per-cycle checks at basic_envs.py:1888-1901 (each check
    perturbs the pose independently, as the reference's separate
    get_mover_qpos calls do)."""
    xy_w, quat_w = _apply_pose_noise(config, pos, wall_noise)
    c_wall = params.c_size + params.c_offset_wall + jnp.where(wall_safety_offset, params.c_offset, 0.0)
    wall = common.wall_collision_any(params.grid, xy_w, quat_w, c_wall, config.collision_shape)

    xy_m, quat_m = _apply_pose_noise(config, pos, mover_noise)
    c_mover = params.c_size + jnp.where(mover_safety_offset, params.c_offset, 0.0)
    mover = common.mover_collision_any(xy_m, quat_m, c_mover, config.collision_shape)
    return wall, mover


def _noisy_collision_checks(
    config: PlanningConfig,
    params: PlanningParams,
    key: jax.Array,
    pos: jnp.ndarray,
    wall_safety_offset: bool,
    mover_safety_offset: bool,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    m = config.num_movers
    n = _pose_noise_dims(config)
    noise = jax.random.normal(key, (2, m, n), pos.dtype) * params.std_noise[0]
    return _collision_checks(
        config, params, pos, noise[0], noise[1], wall_safety_offset, mover_safety_offset
    )


# ---------------------------------------------------------------------------
# reset
# ---------------------------------------------------------------------------


def _rejection_sample(key, sample_fn, accept_fn, max_trials: int, block: int = 8):
    """Bounded rejection sampler: first-accepted of ``block`` iid draws per
    round, retrying until accepted or ``max_trials`` draws.

    Returns (sample, accepted, trials).  The reference's unbounded while loops
    (benchmark_planning_env.py:369-413) become a ``lax.while_loop`` with a
    trial bound so resets stay jittable; a stall shows up as trials ==
    max_trials in the info dict instead of a log-warning spin.

    Drawing a block per round matters under ``vmap``: a batched while_loop
    runs until EVERY lane accepts, so the expected round count is the *max*
    of per-lane geometrics — which grows with batch width.  First-accepted-
    of-K has identical distribution to pure rejection sampling and cuts the
    round count ~K-fold (it made 4-mover auto-reset the bottleneck at 1024
    envs before this).  For high-acceptance samplers K > 1 is pure overhead
    (it halved pushing auto-reset throughput) — pass ``block=1`` there.
    """

    def draw(k):
        samples = jax.vmap(sample_fn)(jax.random.split(k, block))
        accepts = jax.vmap(accept_fn)(samples)
        idx = jnp.argmax(accepts)  # first accepted (or 0 if none)
        return jax.tree_util.tree_map(lambda s: s[idx], samples), accepts.any()

    def cond(carry):
        _, _, ok, trials = carry
        return jnp.logical_and(~ok, trials < max_trials)

    def body(carry):
        key, _, _, trials = carry
        key, sub = jax.random.split(key)
        sample, ok = draw(sub)
        return key, sample, ok, trials + block

    key, first = jax.random.split(key)
    init_sample, init_ok = draw(first)
    carry = (key, init_sample, init_ok, jnp.asarray(block, jnp.int32))
    _, sample, ok, trials = jax.lax.while_loop(cond, body, carry)
    return sample, ok, trials


def reset(
    config: PlanningConfig,
    params: PlanningParams,
    key: jax.Array,
    start_xy: jnp.ndarray | None = None,
    goals_xy: jnp.ndarray | None = None,
) -> tuple[PlanningState, dict[str, jnp.ndarray], dict[str, jnp.ndarray]]:
    """Sample collision-free starts and reachable, separated goals; build a
    fresh episode state (reference _reset_callback + base reset,
    benchmark_planning_env.py:355-418, basic_envs.py:1770-1833).

    ``start_xy`` / ``goals_xy`` ([M, 2]) override sampling — the counterpart
    of the reference base class's ``initial_mover_start_xy_pos`` /
    ``initial_mover_goal_xy_pos`` kwargs (basic_envs.py:176-177)."""
    m = config.num_movers
    dtype = params.min_xy.dtype
    key, k_start, k_goal, k_noise, next_key = jax.random.split(key, 5)

    def sample_xy(k):
        return jax.random.uniform(k, (m, 2), dtype, params.min_xy, params.max_xy)

    ident = jnp.tile(jnp.asarray([common.IDENTITY_QUAT], dtype), (m, 1))
    c_wall_sample = params.c_size + params.c_offset_wall + params.c_offset
    c_mover_sample = params.c_size + params.c_offset

    def accept_start(xy):
        from gymnasium_planar_robotics_tpu.ops import walls

        valid = walls.qpos_is_valid(params.grid, xy, c_wall_sample, quat=ident, collision_shape=config.collision_shape).all()
        no_col = ~common.mover_collision_any(xy, ident, c_mover_sample, config.collision_shape)
        return valid & no_col

    def accept_goal(xy):
        from gymnasium_planar_robotics_tpu.ops import walls

        reachable = walls.qpos_is_valid(
            params.grid, xy, c_wall_sample, quat=ident, collision_shape=config.collision_shape
        ).all()
        if m > 1:
            ii, jj = np.triu_indices(m, k=1)
            dist = jnp.linalg.norm(xy[ii] - xy[jj], axis=-1)
            separated = (dist >= params.min_goal_dist).all()
        else:
            separated = jnp.asarray(True)
        return reachable & separated

    # multi-mover acceptance decays with M (pairwise separation + per-mover
    # validity): blocks pay off; single-mover acceptance is near 1: block=1
    block = 8 if m > 1 else 1
    if start_xy is None:
        start_xy, start_ok, start_trials = _rejection_sample(
            k_start, sample_xy, accept_start, config.max_reset_trials, block=block
        )
    else:
        start_xy = jnp.asarray(start_xy, dtype).reshape(m, 2)
        start_ok, start_trials = accept_start(start_xy), jnp.asarray(0, jnp.int32)
    if goals_xy is None:
        goal_xy, goal_ok, goal_trials = _rejection_sample(
            k_goal, sample_xy, accept_goal, config.max_reset_trials, block=block
        )
    else:
        goal_xy = jnp.asarray(goals_xy, dtype).reshape(m, 2)
        goal_ok, goal_trials = accept_goal(goal_xy), jnp.asarray(0, jnp.int32)

    zeros = jnp.zeros((m, 2), dtype)
    state = PlanningState(
        pos=start_xy,
        vel=zeros,
        acc=zeros,
        act=zeros,
        goals=goal_xy,
        key=next_key,
        steps=jnp.asarray(0, jnp.int32),
    )

    # base-class reset re-checks with noise (wall with offset, mover without —
    # basic_envs.py:1799-1805)
    k_checks, k_obs = jax.random.split(k_noise)
    wall, mover = _noisy_collision_checks(config, params, k_checks, start_xy, wall_safety_offset=True, mover_safety_offset=False)
    obs = _get_obs(config, params, state, k_obs)
    info = _get_info(config, params, obs, mover, wall)
    info['reset_stalled'] = ~(start_ok & goal_ok)
    info['reset_trials'] = start_trials + goal_trials
    return state, obs, info


# ---------------------------------------------------------------------------
# step
# ---------------------------------------------------------------------------


def _step_core(
    config: PlanningConfig, params: PlanningParams, state: PlanningState, action: jnp.ndarray
):
    m = config.num_movers
    dtype = state.pos.dtype
    limit = params.j_max if config.learn_jerk else params.a_max
    action = jnp.clip(jnp.asarray(action, dtype).reshape(m, 2), -limit, limit)

    key, k_cycles, k_obs = jax.random.split(state.key, 3)

    # all per-cycle sensor noise drawn in one fused op before the scan (same
    # distributions as per-cycle draws; the stream layout differs, which only
    # matters for cross-engine bit-matching of noisy runs — impossible anyway,
    # SURVEY.md §2.3 D4)
    c = config.num_cycles
    n = _pose_noise_dims(config)
    k_vel, k_checks = jax.random.split(k_cycles)
    vel_noise = jax.random.normal(k_vel, (c, m, 2), dtype) * params.std_noise[1]
    pose_noise = jax.random.normal(k_checks, (c, 2, m, n), dtype) * params.std_noise[0]

    def cycle(carry, noise):
        pos, vel, acc, act, wall, mover, done = carry
        nv, npose = noise
        # noisy velocity reading for the clamp chain (benchmark_planning_env.py:430)
        vel_meas = vel + nv
        scale = params.accel_scale[:, None]  # [M, 1] over the (x, y) pair
        if config.learn_jerk:
            res = dynamics.jerk_cycle(
                pos, vel, act, vel_meas, action, params.v_max, params.a_max, params.dt, accel_scale=scale
            )
        else:
            res = dynamics.acceleration_cycle(
                pos, vel, vel_meas, action, params.v_max, params.dt, accel_scale=scale
            )
        new_wall, new_mover = _collision_checks(
            config, params, res.pos, npose[0], npose[1],
            wall_safety_offset=False, mover_safety_offset=False,
        )
        # latch: once done, state freezes and flags keep their value at the
        # colliding cycle (reference `break`, basic_envs.py:1902-1905)
        pos = jnp.where(done, pos, res.pos)
        vel = jnp.where(done, vel, res.vel)
        acc = jnp.where(done, acc, res.acc)
        act = jnp.where(done, act, res.act)
        wall = jnp.where(done, wall, new_wall)
        mover = jnp.where(done, mover, new_mover)
        done = done | wall | mover
        # per-cycle pose + done emitted for render_every_cycle (reference
        # basic_envs.py:1884-1905 renders the colliding cycle's frame, then
        # breaks); dead-code-eliminated when the caller discards it
        return (pos, vel, acc, act, wall, mover, done), (pos, vel, done)

    init = (
        state.pos,
        state.vel,
        state.acc,
        state.act,
        jnp.asarray(False),
        jnp.asarray(False),
        jnp.asarray(False),
    )
    (pos, vel, acc, act, wall, mover, _), cyc = jax.lax.scan(cycle, init, (vel_noise, pose_noise))

    new_state = PlanningState(
        pos=pos, vel=vel, acc=acc, act=act, goals=state.goals, key=key, steps=state.steps + 1
    )
    obs = _get_obs(config, params, new_state, k_obs)
    info = _get_info(config, params, obs, mover, wall)
    reward = compute_reward(config, params, obs['achieved_goal'], obs['desired_goal'], mover, wall)
    terminated = jnp.abs(reward) == REWARD_SUCCESS  # benchmark_planning_env.py:477-479
    truncated = jnp.asarray(False)  # TimeLimit handled by adapters / autoreset
    return (new_state, obs, reward, terminated, truncated, info), cyc


def step(
    config: PlanningConfig, params: PlanningParams, state: PlanningState, action: jnp.ndarray
) -> tuple[PlanningState, dict[str, jnp.ndarray], jnp.ndarray, jnp.ndarray, jnp.ndarray, dict[str, jnp.ndarray]]:
    """One env step = ``num_cycles`` 1 ms control cycles with per-cycle noisy
    collision checks and a latched early stop (basic_envs.py:1835-1950)."""
    return _step_core(config, params, state, action)[0]


def step_with_cycles(
    config: PlanningConfig, params: PlanningParams, state: PlanningState, action: jnp.ndarray
):
    """``step`` plus the per-cycle ``(pos[C, M, 2], vel[C, M, 2], done[C])``
    trajectory, for the adapters' ``render_every_cycle`` mode (reference
    ``basic_envs.py:1708,1884-1885``); ``done`` lets the replay stop at the
    colliding cycle like the reference's render-then-break."""
    out, cyc = _step_core(config, params, state, action)
    return (*out, cyc)


def _get_obs(
    config: PlanningConfig, params: PlanningParams, state: PlanningState, key: jax.Array
) -> dict[str, jnp.ndarray]:
    """Noisy velocities (+accelerations in jerk mode), noisy positions as the
    achieved goal (benchmark_planning_env.py:536-573)."""
    m = config.num_movers
    dtype = state.pos.dtype
    k_pos, k_vel = jax.random.split(key)
    pos_noisy = state.pos + jax.random.normal(k_pos, (m, 2), dtype) * params.std_noise[0]
    vel_noisy = state.vel + jax.random.normal(k_vel, (m, 2), dtype) * params.std_noise[1]
    if config.learn_jerk:
        observation = jnp.concatenate([vel_noisy, state.acc], axis=0).reshape(-1)
    else:
        observation = vel_noisy.reshape(-1)
    return {
        'observation': observation,
        'achieved_goal': pos_noisy.reshape(-1),
        'desired_goal': state.goals.reshape(-1),
    }


def _get_info(config, params, obs, mover_collision, wall_collision) -> dict[str, jnp.ndarray]:
    dist = _goal_distances(config, obs['achieved_goal'], obs['desired_goal'])
    is_success = (dist <= params.threshold_pos).all() & ~mover_collision & ~wall_collision
    return {
        'is_success': is_success,
        'mover_collision': mover_collision,
        'wall_collision': wall_collision,
    }


def _goal_distances(config: PlanningConfig, achieved: jnp.ndarray, desired: jnp.ndarray) -> jnp.ndarray:
    a = achieved.reshape(*achieved.shape[:-1], config.num_movers, 2)
    d = desired.reshape(*desired.shape[:-1], config.num_movers, 2)
    return jnp.linalg.norm(a - d, axis=-1)


def compute_reward(
    config: PlanningConfig,
    params: PlanningParams,
    achieved_goal: jnp.ndarray,
    desired_goal: jnp.ndarray,
    mover_collision: jnp.ndarray,
    wall_collision: jnp.ndarray,
) -> jnp.ndarray:
    """HER-compatible batched reward (benchmark_planning_env.py:502-534):
    +50 all goals reached, -50 on collision, else -(#unreached).  Pure
    function of (achieved, desired, collision flags) — collision flags ride in
    ``info`` exactly so HER relabeling never re-runs collision checks."""
    dist = _goal_distances(config, achieved_goal, desired_goal)
    num_reached = (dist <= params.threshold_pos).sum(axis=-1)
    collided = mover_collision | wall_collision
    if config.reward_mode == 'dense':
        reward = jnp.where(collided, -REWARD_SUCCESS, -dist.sum(axis=-1))
    else:
        reward = jnp.where(collided, -REWARD_SUCCESS, -(config.num_movers - num_reached).astype(dist.dtype))
    all_reached = num_reached == config.num_movers
    return jnp.where(all_reached & ~collided, REWARD_SUCCESS, reward)


# ---------------------------------------------------------------------------
# fused kernel paths (batched; 1 mover — ops/pallas_step)
# ---------------------------------------------------------------------------


def _kernel_state(config: PlanningConfig, state: PlanningState) -> dict:
    """Batched 1-mover state -> the kernel's ``[B]`` vectors.  The kernel's
    acceleration is control-space: the integrator activation in jerk mode,
    unused on entry in acceleration mode (``ops/pallas_step._integrate_mover``)."""
    a = state.act if config.learn_jerk else state.acc
    return dict(
        px=state.pos[:, 0, 0], py=state.pos[:, 0, 1], vx=state.vel[:, 0, 0], vy=state.vel[:, 0, 1],
        ax=a[:, 0, 0], ay=a[:, 0, 1], gx=state.goals[:, 0, 0], gy=state.goals[:, 0, 1],
        steps=state.steps.astype(jnp.float32),
    )


def _state_from_kernel(config, params, vec: dict, keys, dtype) -> PlanningState:
    """Inverse of ``_kernel_state``: the body's qacc is accel_scale x the
    control-space activation (identical without a bumper)."""

    def pair(x, y):
        return jnp.stack([vec[x], vec[y]], axis=-1)[:, None, :].astype(dtype)

    act = pair('ax', 'ay')
    scale = float(np.asarray(params.accel_scale).reshape(-1)[0])
    return PlanningState(
        pos=pair('px', 'py'), vel=pair('vx', 'vy'),
        acc=act if scale == 1.0 else scale * act,
        act=act if config.learn_jerk else jnp.zeros_like(act),
        goals=pair('gx', 'gy'), key=keys, steps=vec['steps'].astype(jnp.int32),
    )


def make_fused_step_autoreset(
    config: PlanningConfig, params: PlanningParams, interpret: bool = False, cand_k: int = 16,
):
    """Batched autoreset step as ONE fused-kernel launch (``ops/pallas_step``;
    1 mover, circle or box shape, acceleration or jerk mode, both reward
    modes): cycles, termination, reward, restart and both observations run
    in the kernel.  Same contract as ``batched_step_autoreset``:
    ``step(state, action[B, 2]) -> (state, obs, reward, terminated,
    truncated, info)``.

    Each env's noise stream is 32 bits of its own PRNG key, which advances
    every step, so results do not depend on the batch layout or sharding.
    A stalled in-kernel sampler (no valid candidate among ``cand_k``) leaves
    the env un-reset and reports ``info['reset_stalled']`` — the retry
    happens on the next step."""
    from gymnasium_planar_robotics_tpu.ops import pallas_step

    run = pallas_step.planning_kernel(config, params, 1, cand_k=cand_k, interpret=interpret)
    limit = params.j_max if config.learn_jerk else params.a_max
    scale = float(np.asarray(params.accel_scale).reshape(-1)[0])

    def step_fn(state: PlanningState, action: jnp.ndarray):
        b = state.pos.shape[0]
        dtype = state.pos.dtype
        action = jnp.clip(jnp.asarray(action, dtype).reshape(b, 2), -limit, limit)
        keys = jax.vmap(jax.random.split)(state.key)
        streams = jax.vmap(partial(jax.random.bits, dtype=jnp.uint32))(keys[:, 1])
        vec, (reward, term, trunc), last = run(
            streams, 0, _kernel_state(config, state), (action[None, :, 0], action[None, :, 1])
        )
        new_state = _state_from_kernel(config, params, vec, keys[:, 0], dtype)

        def pair(x, y):
            return jnp.stack([last[x], last[y]], axis=-1).astype(dtype)

        f_acc = pair('f_ax', 'f_ay')
        if scale != 1.0:
            f_acc = scale * f_acc  # pre-reset qacc from the activation

        def obs_vec(vel, acc):
            return jnp.concatenate([vel, acc], axis=-1) if config.learn_jerk else vel

        wall = last['wall'] > 0.5
        final_obs = {
            'observation': obs_vec(pair('f_vx', 'f_vy'), f_acc),
            'achieved_goal': pair('f_agx', 'f_agy'),
            'desired_goal': state.goals[:, 0].astype(dtype),
        }
        out_obs = {
            'observation': obs_vec(pair('s_vx', 's_vy'), new_state.acc[:, 0]),
            'achieved_goal': pair('s_agx', 's_agy'),
            'desired_goal': new_state.goals[:, 0],
        }
        info = {
            'is_success': (last['reached'] > 0.5) & ~wall,
            'mover_collision': jnp.zeros((b,), jnp.bool_),
            'wall_collision': wall,
            'final_observation': final_obs,
            'reset_stalled': last['stalled'] > 0.5,
            'reset_trials': last['trials'].astype(jnp.int32),
        }
        return new_state, out_obs, reward[0].astype(dtype), term[0] > 0.5, trunc[0] > 0.5, info

    return step_fn


def make_fused_rollout(config: PlanningConfig, params: PlanningParams, interpret: bool = False, cand_k: int = 16):
    """``T`` autoreset env steps as ONE fused-kernel launch, for precomputed
    actions (random or offline policies; 1 mover).

    Returns ``rollout(state, actions[T, B, 2], seed, env_offset=0) ->
    (final PlanningState, rewards [T, B], terminated [T, B], truncated
    [T, B])``.  Env ``e`` draws its noise from the generator stream of
    ``(seed, env_offset + e)`` (``ops/pallas_step.env_streams``): pass a
    shard's global offset under ``shard_map`` and the result equals the
    unsharded rollout."""
    from gymnasium_planar_robotics_tpu.ops import pallas_step

    limit = params.j_max if config.learn_jerk else params.a_max

    def rollout(state: PlanningState, actions: jnp.ndarray, seed, env_offset=0):
        b = state.pos.shape[0]
        dtype = state.pos.dtype
        actions = jnp.clip(jnp.asarray(actions, jnp.float32).reshape(-1, b, 2), -limit, limit)
        run = pallas_step.planning_kernel(config, params, actions.shape[0], cand_k=cand_k, interpret=interpret)
        streams = pallas_step.env_streams(seed, env_offset + jnp.arange(b, dtype=jnp.int32))
        vec, (reward, term, trunc), _ = run(
            streams, 0, _kernel_state(config, state), (actions[..., 0], actions[..., 1])
        )
        keys = jax.vmap(lambda k: jax.random.split(k, 1)[0])(state.key)
        final = _state_from_kernel(config, params, vec, keys, dtype)
        return final, reward.astype(dtype), term > 0.5, trunc > 0.5

    return rollout


# ---------------------------------------------------------------------------
# auto-reset wrapper (the batch/throughput entry point)
# ---------------------------------------------------------------------------


def step_autoreset(
    config: PlanningConfig, params: PlanningParams, state: PlanningState, action: jnp.ndarray
):
    """Step with in-place episode restart: done (terminated or 50-step
    time limit) envs are replaced by freshly reset episodes.  Returns
    ``(state, obs, reward, terminated, truncated, info)`` where ``obs`` is the
    first observation of the new episode for restarted envs (the pre-restart
    observation is in ``info['final_observation']``)."""
    new_state, obs, reward, terminated, _, info = step(config, params, state, action)
    truncated = new_state.steps >= config.max_episode_steps
    done = terminated | truncated

    reset_key, carry_key = jax.random.split(new_state.key)
    reset_state, reset_obs, reset_info = reset(config, params, reset_key)

    # stalled reset sampling => keep the env un-reset (state + step counter
    # carry over); done re-fires next step and the sampler retries with a
    # fresh key.  The reference instead spins in an unbounded rejection loop,
    # warning every 100 trials (benchmark_planning_env.py:371-375).
    do_reset = done & ~reset_info['reset_stalled']
    kept = autoreset_select(do_reset, new_state, reset_state, carry_key)
    out_obs = jax.tree_util.tree_map(lambda a, b: _where_done(do_reset, b, a), obs, reset_obs)
    info = dict(info)
    info['final_observation'] = obs
    info['reset_stalled'] = done & reset_info['reset_stalled']
    info['reset_trials'] = jnp.where(done, reset_info['reset_trials'], 0)
    return kept, out_obs, reward, terminated, truncated, info


def _where_done(done, if_done, if_not):
    """Broadcast the scalar done flag over an arbitrary-rank leaf."""
    return jnp.where(jnp.reshape(done, (1,) * if_not.ndim) if if_not.ndim else done, if_done, if_not)


def autoreset_select(done, stepped_state, reset_state, carry_key):
    """Replace done envs' state with the freshly reset one (pytree-generic, so
    new state fields cannot silently escape auto-reset), keeping the RNG key
    chain: continuing envs advance to ``carry_key``."""
    kept = jax.tree_util.tree_map(lambda a, b: _where_done(done, b, a), stepped_state, reset_state)
    return dataclasses.replace(kept, key=jnp.where(done, reset_state.key, carry_key))


@partial(jax.jit, static_argnums=(0, 3))
def init_batch(config: PlanningConfig, params: PlanningParams, key: jax.Array, batch: int):
    """Vectorized reset for a batch of envs: returns batched state/obs/info.

    Jitted with static (config, batch): the vmapped bounded rejection sampler
    dispatched eagerly costs ~20 s of op-by-op batched while_loops on CPU vs
    a one-time ~5 s compile here (instant on repeat shapes)."""
    keys = jax.random.split(key, batch)
    return jax.vmap(partial(reset, config, params))(keys)


batched_step = jax.vmap(step, in_axes=(None, None, 0, 0))
batched_step_autoreset = jax.vmap(step_autoreset, in_axes=(None, None, 0, 0))
