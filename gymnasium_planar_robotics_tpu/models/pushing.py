"""BenchmarkPushingEnv: single mover pushes a box to a goal.

Re-design of ``/root/reference/gymnasium_planar_robotics/envs/manipulation/
benchmark_pushing_env.py``: fixed 3x3 tile table, one mover, one passive box
object (0.07 x 0.07 x 0.04 m, 10 g, free joint damping 0.01 —
benchmark_pushing_env.py:172-178), goal-conditioned on the object's (x, y).

Differences from the reference's MuJoCo path, by design (SURVEY.md §2.2
P3/P4):

- mover z and all rotations are held analytically (the reference's task-space
  impedance controller with joint_mask [0,0,1,1,1,1] exists precisely to pin
  them — benchmark_pushing_env.py:260-268; its K=1 stiffness lets z wander by
  millimeters during contact, which nothing observes: observations expose only
  x/y quantities);
- mover-object contact is the quasi-2D penalty model of ``ops/contact.py``
  (v2: object yaw state, minimum-translation face normal, sticky tangential
  friction with a Coulomb cap, contact torque about the object center),
  tolerance-calibrated against reference trajectories — see CALIBRATION.md
  for per-case error-growth bounds over full 50-step episodes;
- the contact reaction force does act back on the mover (as in MuJoCo),
  divided by the TOTAL body mass (mover + bumper for mesh movers).

Reward/termination/info/reset semantics mirror the reference exactly
(benchmark_pushing_env.py:373-417, 457-527, 578-608).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

from gymnasium_planar_robotics_tpu.models import common
from gymnasium_planar_robotics_tpu.ops import contact, dynamics, walls
from gymnasium_planar_robotics_tpu.ops.grid import make_tile_grid

REWARD_WALL_COLLISION = -50.0  # benchmark_pushing_env.py:218


@dataclasses.dataclass(frozen=True)
class PushingConfig:
    num_cycles: int = 40
    learn_jerk: bool = False
    collision_shape: str = 'circle'
    max_reset_trials: int = 100
    max_episode_steps: int = 50
    num_movers: int = 1  # fixed in the reference (benchmark_pushing_env.py:196)
    # 'sparse' = reference semantics (0 at goal / -1 per step / -50 wall,
    # benchmark_pushing_env.py:499-527); 'dense' is a TRAINING AID for
    # on-policy learners (potential-style shaping toward the push stand-off
    # point) — evaluate
    # on 'sparse', the scoring the reference env applies
    reward_mode: str = 'sparse'


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PushingParams:
    grid: Any
    mover_mass: jax.Array  # scalar actuator-gain mass (the configured mover mass)
    accel_scale: jax.Array  # scalar gain-mass / total-body-mass (< 1 with a bumper geom)
    total_mass: jax.Array  # scalar mover + bumper mass (divides the contact reaction)
    mover_half: jax.Array  # [2] x/y half-extents of the mover box (mesh: AABB)
    c_size: jax.Array  # [1] or [1, 2]
    c_offset: jax.Array
    c_offset_wall: jax.Array
    std_noise: jax.Array  # [3]
    object_half: jax.Array  # [2] (0.035, 0.035)
    object_mass: jax.Array  # 0.01
    object_damping: jax.Array  # 0.01 (free joint damping)
    object_noise: jax.Array  # 1e-5 achieved-goal observation noise
    v_max: jax.Array
    a_max: jax.Array
    j_max: jax.Array
    threshold_pos: jax.Array
    initial_zpos: jax.Array
    dt: jax.Array
    min_xy: jax.Array  # [2] mover sampling bounds
    max_xy: jax.Array
    obj_min_xy: jax.Array  # [2] object/goal sampling bounds (inner box)
    obj_max_xy: jax.Array
    min_mo_dist: jax.Array  # min mover-object start distance
    # contact model (tolerance-calibrated against the reference engine)
    contact_k: jax.Array  # normal stiffness [N/m]
    contact_b: jax.Array  # normal damping [N s/m]
    contact_bt: jax.Array  # tangential viscosity [N s/m]
    contact_mu: jax.Array  # mover-object friction
    floor_mu: jax.Array  # object-floor friction
    gravity: jax.Array  # 9.81
    obj_inertia: jax.Array  # yaw inertia m*(hx^2 + hy^2)/3
    mu_spin: jax.Array  # torsional floor friction [rad/s^2 equivalent decel]
    plow_kappa: jax.Array  # vertical load per unit impact force (floor N = m*g + kappa*f_imp)
    plow_cap: jax.Array  # cap on the load uplift (N <= (1 + cap) * m*g)
    cone_zeta: jax.Array  # vertical share of the elliptic friction cone during slip
    cone_vt: jax.Array  # tangential slip speed [m/s] at which the share saturates
    cone_vt_hi: jax.Array  # slip speed where the share starts fading (impact-ride regime)
    cone_vt_off: jax.Array  # slip speed where the share is fully off
    cone_plow: jax.Array  # floor-load per unit f_z (N += cone_plow * f_z)
    cone_plow_cap: jax.Array  # cap on the f_z load uplift, in units of m*g
    # quasi-3D mover z DOF (the measured corner-escape mechanism: the f_z
    # reaction LIFTS the mover against the reference's soft K=1 z impedance
    # until it clears the 40 mm object and sails over it)
    mover_height: jax.Array  # full mover height [m] (2 * half_z)
    object_height: jax.Array  # full object height [m] (0.04)
    imp_k: jax.Array  # impedance translational stiffness (reference: 1.0)
    imp_d: jax.Array  # critical damping 2*sqrt(K*m) (impedance_control.py:43-47)
    # wedge positive feedback (round 5, CALIBRATION.md): the vertical-share
    # cap grows with the accumulated mover lift, so sustained gentle captures
    # unlock the measured runaway climb while short strong pushes stay at the
    # seed cap (the two regimes are indistinguishable in instantaneous state)
    cone_fz_cap: jax.Array  # base cap [N] on the vertical share (wedge seed force)
    cone_fz_slope: jax.Array  # cap growth per metre of accumulated mover lift [N/m]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PushingState:
    pos: jax.Array  # [2] mover position
    vel: jax.Array  # [2]
    acc: jax.Array  # [2] last qacc (incl. contact reaction)
    act: jax.Array  # [2] jerk-integrator activation
    obj_pos: jax.Array  # [2]
    obj_vel: jax.Array  # [2]
    obj_yaw: jax.Array  # [] object rotation about z (MuJoCo free-joint yaw)
    obj_w: jax.Array  # [] object angular velocity
    mover_z: jax.Array  # [] mover bottom height above the tile top
    mover_vz: jax.Array  # [] mover vertical velocity
    goal: jax.Array  # [2] object goal
    key: jax.Array
    steps: jax.Array


def make_pushing_env(
    mover_params: dict[str, Any] | None = None,
    initial_mover_zpos: float = 0.003,
    std_noise=1e-5,
    num_cycles: int = 40,
    collision_params: dict[str, Any] | None = None,
    v_max: float = 2.0,
    a_max: float = 10.0,
    j_max: float = 100.0,
    learn_jerk: bool = False,
    threshold_pos: float = 0.05,
    dtype=jnp.float32,
    max_reset_trials: int = 100,
    reward_mode: str = 'sparse',
) -> tuple[PushingConfig, PushingParams]:
    """Constructor mirroring the reference's kwargs (fixed 3x3 layout, 1 mover).

    ``mover_params`` accepts 'mass', 'size', 'shape', 'mesh' — the reference's
    base layer builds any of these movers for any env on top of it
    (basic_envs.py:875-929), including mesh movers with a bumper geom whose
    own mass joins the body (basic_envs.py:911-925) while the actuator gain
    stays the configured mover mass.  The dynamics model that composition as
    ``accel_scale`` = m_gain/(m_mover+m_bumper) on the commanded acceleration
    and the TOTAL body mass under the contact reaction; the contact face uses
    the (scaled) mesh AABB x/y half-extents."""
    mover_params = mover_params or {}
    collision_params = collision_params or {}
    unsupported = set(mover_params) - {'mass', 'size', 'shape', 'mesh'}
    if unsupported:
        raise ValueError(
            f'unsupported mover_params keys for the pushing env: {sorted(unsupported)} '
            "(supported: 'mass', 'size', 'shape', 'mesh')"
        )

    layout = np.ones((3, 3))
    tile_size = np.array([0.24 / 2, 0.24 / 2, 0.0352 / 2])
    grid = make_tile_grid(layout, tile_size, dtype=dtype)

    mover_mass = float(np.asarray(mover_params.get('mass', 1.24)).reshape(-1)[0])
    mover_shape = mover_params.get('shape', 'box')
    bumper_mass = 0.0
    if mover_shape == 'mesh':
        # size from the (scaled) mesh AABB, like the reference's
        # _resolve_mover_size (basic_envs.py:1396-1437)
        from gymnasium_planar_robotics_tpu.utils import meshes

        mesh_cfg = mover_params.get('mesh', {})
        mover_size = np.asarray(
            meshes.resolve_mover_size(
                'mesh', None,
                mesh_cfg.get('mover_stl_path', 'beckhoff_apm4330_mover'),
                mesh_cfg.get('scale', (1.0, 1.0, 1.0)),
            )
        ).reshape(-1)
        if mesh_cfg.get('bumper_stl_path', 'beckhoff_apm4330_bumper') is not None:
            bumper_mass = float(np.asarray(mesh_cfg.get('bumper_mass', 0.1)).reshape(-1)[0])
            assert bumper_mass >= 0, 'Bumper mass must be non-negative.'
    else:
        assert mover_shape in ('box', 'cylinder'), f'unknown mover shape {mover_shape!r}'
        mover_size = np.asarray(mover_params.get('size', np.array([0.155 / 2, 0.155 / 2, 0.012 / 2]))).reshape(-1)
    total_mass = mover_mass + bumper_mass
    accel_scale = mover_mass / total_mass

    c_shape = collision_params.get('shape', 'circle')
    c_size_in = collision_params.get('size', 0.11)
    c_offset = float(collision_params.get('offset', 0.0))
    c_offset_wall = float(collision_params.get('offset_wall', 0.0))
    c_size = common.expand_c_size(c_size_in, 1, c_shape, dtype)

    std = np.asarray(std_noise, dtype=np.float64).reshape(-1)
    std = np.broadcast_to(std, (3,)) if std.shape == (1,) else std

    object_half = 0.07 / 2
    if c_shape == 'circle':
        margin = np.asarray(c_size_in).reshape(-1)[0] + c_offset + c_offset_wall
        margin = np.array([margin, margin])
        min_mo = max(float(np.linalg.norm(object_half + mover_size[:2])), float(np.asarray(c_size_in).reshape(-1)[0] + c_offset))
    else:
        margin = np.asarray(c_size_in).reshape(-1, 2)[0] + c_offset + c_offset_wall
        min_mo = max(
            float(np.linalg.norm(object_half + mover_size[:2])),
            float(np.linalg.norm(np.asarray(c_size_in).reshape(-1, 2)[0] + c_offset)),
        )
    # the reference's workspace bound: max tile center + tile_size/2 = 0.66 on
    # the fixed 3x3 table (benchmark_pushing_env.py:233, 252-254)
    hi = np.array([5 * tile_size[0] + tile_size[0] / 2, 5 * tile_size[1] + tile_size[1] / 2])

    assert reward_mode in ('sparse', 'dense'), reward_mode
    config = PushingConfig(
        num_cycles=num_cycles,
        learn_jerk=learn_jerk,
        collision_shape=c_shape,
        max_reset_trials=max_reset_trials,
        reward_mode=reward_mode,
    )
    obj_mass = 0.01
    # calibrated against reference trajectories (grid sweep over k, mu, bt,
    # mu_spin across 10 scenarios incl. corner/diagonal pushes): max object
    # position error 8.8 mm over 10 steps, diagonal 3.7 mm
    k_n = 30.0
    params = PushingParams(
        grid=grid,
        mover_mass=jnp.asarray(mover_mass, dtype),
        accel_scale=jnp.asarray(accel_scale, dtype),
        total_mass=jnp.asarray(total_mass, dtype),
        mover_half=jnp.asarray(mover_size[:2], dtype),
        c_size=c_size,
        c_offset=jnp.asarray(c_offset, dtype),
        c_offset_wall=jnp.asarray(c_offset_wall, dtype),
        std_noise=jnp.asarray(std, dtype),
        object_half=jnp.asarray([object_half, object_half], dtype),
        object_mass=jnp.asarray(obj_mass, dtype),
        object_damping=jnp.asarray(0.01, dtype),
        object_noise=jnp.asarray(1e-5, dtype),
        v_max=jnp.asarray(v_max, dtype),
        a_max=jnp.asarray(a_max, dtype),
        j_max=jnp.asarray(j_max, dtype),
        threshold_pos=jnp.asarray(threshold_pos, dtype),
        initial_zpos=jnp.asarray(initial_mover_zpos, dtype),
        dt=jnp.asarray(0.001, dtype),
        min_xy=jnp.asarray(margin, dtype),
        max_xy=jnp.asarray(hi - margin, dtype),
        obj_min_xy=jnp.asarray(2 * margin, dtype),
        obj_max_xy=jnp.asarray(hi - 2 * margin, dtype),
        min_mo_dist=jnp.asarray(min_mo, dtype),
        contact_k=jnp.asarray(k_n, dtype),
        contact_b=jnp.asarray(2.0 * np.sqrt(k_n * obj_mass), dtype),
        contact_bt=jnp.asarray(1.0, dtype),
        contact_mu=jnp.asarray(0.8, dtype),
        floor_mu=jnp.asarray(1.0, dtype),
        gravity=jnp.asarray(9.81, dtype),
        # box yaw inertia m*(hx^2+hy^2)/3; torsional floor friction from the
        # reference's friction=(1, 0.005, 1e-4) defaults, calibrated
        obj_inertia=jnp.asarray(obj_mass * (object_half**2 + object_half**2) / 3.0, dtype),
        mu_spin=jnp.asarray(60.0, dtype),
        # measured in the reference engine: impact bursts of the intermittent
        # hard contact press the object into the floor (tilted box-box
        # normals; the tile-object normal reads ~1.45*m*g at the friction-
        # cone limit during a push), so sustained pushes see extra floor
        # friction.  kappa couples the load to the impact (damping) part of
        # the normal force — quasi-static face-face pushes are unaffected —
        # and the uplift is capped near the measured cone-limit value.
        # Calibrated on the 50-step episode suite (tools/calibrate_contact.py,
        # CALIBRATION.md) with the 10-step strong-push suite held green.
        plow_kappa=jnp.asarray(4.0, dtype),
        plow_cap=jnp.asarray(1.5, dtype),
        # elliptic-cone vertical share (f_z = zeta * f_imp eats the lateral
        # friction budget): measured 0.8-1.0 during impact bursts via
        # mj_contactForce on the reference's diagonal corner push; calibrated
        # on the 50-step suite (round 4) — this is what releases the object
        # past the mover's corner instead of keeping it captured
        cone_zeta=jnp.asarray(0.8, dtype),
        cone_vt=jnp.asarray(0.25, dtype),
        # high-cut of the slip gate: measured slip speeds are ~0.08 m/s
        # (median) during gentle capture vs 0.4-1.3 m/s during strong
        # impact-train rides, and MuJoCo does NOT pin the object in the
        # latter — fading the share above 0.4 m/s halves the strong-push
        # residual with zero change to the 50-step suite (round-4 sweep)
        cone_vt_hi=jnp.asarray(0.4, dtype),
        cone_vt_off=jnp.asarray(0.7, dtype),
        cone_plow=jnp.asarray(1.0, dtype),
        cone_plow_cap=jnp.asarray(8.0, dtype),
        mover_height=jnp.asarray(2.0 * mover_size[2], dtype),
        object_height=jnp.asarray(0.04, dtype),
        imp_k=jnp.asarray(1.0, dtype),
        imp_d=jnp.asarray(2.0 * np.sqrt(1.0 * mover_mass), dtype),
        # wedge-capped vertical share (round-5 joint sweep: strong 10-step
        # suite 72-91 -> 11-17 mm with the 50-step suite, gentle 10-step
        # suite, climb test and ensemble all held green — CALIBRATION.md)
        cone_fz_cap=jnp.asarray(0.008, dtype),
        cone_fz_slope=jnp.asarray(100.0, dtype),
    )
    return config, params


def _pose_noise_dims(config: PushingConfig) -> int:
    return 6 if config.collision_shape == 'box' else 2


def _wall_collision_with_noise(config, params, pos, noise, with_offset: bool):
    """Mover wall check with a pre-drawn pose-noise row ([2] or [6])."""
    xy = (pos + noise[:2])[None, :]
    if config.collision_shape == 'box':
        quat = (jnp.asarray(common.IDENTITY_QUAT, pos.dtype) + noise[2:])[None, :]
    else:
        quat = None
    c = params.c_size + params.c_offset_wall + jnp.where(with_offset, params.c_offset, 0.0)
    return ~walls.qpos_is_valid(params.grid, xy, c, quat=quat, collision_shape=config.collision_shape).all()


def _mover_wall_collision(config, params, key, pos, with_offset: bool):
    noise = jax.random.normal(key, (_pose_noise_dims(config),), pos.dtype) * params.std_noise[0]
    return _wall_collision_with_noise(config, params, pos, noise, with_offset)


def reset(
    config: PushingConfig,
    params: PushingParams,
    key: jax.Array,
    mover_start_xy_pos: jnp.ndarray | None = None,
    object_goal_xy_pos: jnp.ndarray | None = None,
):
    """Mirror of the reference reset (benchmark_pushing_env.py:373-417): mover
    uniform over the table, object uniform over the inner box at least
    ``min_mo_dist`` away (so the mover fits between wall and object), goal
    uniform over the inner box.  The two optional overrides correspond to the
    reference's ``options`` keys."""
    dtype = params.min_xy.dtype
    key, k_mover, k_obj, k_goal, k_noise, next_key = jax.random.split(key, 6)

    if mover_start_xy_pos is None:
        mover_xy = jax.random.uniform(k_mover, (2,), dtype, params.min_xy, params.max_xy)
    else:
        mover_xy = jnp.asarray(mover_start_xy_pos, dtype).reshape(2)

    # object placement: first-accepted of max_reset_trials iid draws, all in
    # ONE flat vectorized draw — identical distribution to the reference's
    # rejection loop, with no sequential while_loop at all.  (The acceptance
    # test is a single distance; near-center mover positions make acceptance
    # arbitrarily low — the reference spins forever there,
    # benchmark_pushing_env.py:394-407 — so a loop's worst case is brutal
    # under vmap while a flat draw is constant-cost.)
    k_draws = config.max_reset_trials
    cands = jax.random.uniform(k_obj, (k_draws, 2), dtype, params.obj_min_xy, params.obj_max_xy)
    accepts = jnp.linalg.norm(cands - mover_xy[None, :], axis=-1) > params.min_mo_dist
    idx = jnp.argmax(accepts)
    obj_xy = cands[idx]
    obj_ok = accepts.any()
    trials = jnp.where(obj_ok, idx + 1, k_draws).astype(jnp.int32)

    if object_goal_xy_pos is None:
        goal = jax.random.uniform(k_goal, (2,), dtype, params.obj_min_xy, params.obj_max_xy)
    else:
        goal = jnp.asarray(object_goal_xy_pos, dtype).reshape(2)

    zeros = jnp.zeros(2, dtype)
    zero = jnp.zeros((), dtype)
    state = PushingState(
        pos=mover_xy, vel=zeros, acc=zeros, act=zeros,
        obj_pos=obj_xy, obj_vel=zeros, obj_yaw=zero, obj_w=zero,
        mover_z=jnp.asarray(params.initial_zpos, dtype), mover_vz=zero, goal=goal,
        key=next_key, steps=jnp.asarray(0, jnp.int32),
    )
    k_wall, k_obs = jax.random.split(k_noise)
    wall = _mover_wall_collision(config, params, k_wall, mover_xy, with_offset=True)
    obs = _get_obs(config, params, state, k_obs)
    info = _get_info(params, obs, wall)
    info['reset_stalled'] = ~obj_ok
    info['reset_trials'] = trials
    return state, obs, info


def _step_core(config: PushingConfig, params: PushingParams, state: PushingState, action: jnp.ndarray):
    dtype = state.pos.dtype
    limit = params.j_max if config.learn_jerk else params.a_max
    action = jnp.clip(jnp.asarray(action, dtype).reshape(2), -limit, limit)

    key, k_cycles, k_obs = jax.random.split(state.key, 3)
    mu_g_dt = params.floor_mu * params.gravity * params.dt

    # pre-draw all per-cycle sensor noise (one fused op instead of 40x2 draws)
    c = config.num_cycles
    k_vel, k_wall = jax.random.split(k_cycles)
    vel_noise = jax.random.normal(k_vel, (c, 2), dtype) * params.std_noise[1]
    pose_noise = jax.random.normal(k_wall, (c, _pose_noise_dims(config)), dtype) * params.std_noise[0]

    def cycle(carry, noise):
        pos, vel, acc, act, obj_pos, obj_vel, obj_yaw, obj_w, mz, mvz, c_axis, wall, done = carry
        nv, npose = noise
        vel_meas = vel + nv

        # clamp chain -> commanded acceleration of the actuator (jerk mode
        # measures the *full* qacc incl. contact, benchmark_pushing_env.py:431)
        if config.learn_jerk:
            acc_tmp, jerk_1 = dynamics.ensure_max_dyn_val(acc, params.a_max, action, params.dt)
            _, acc_final = dynamics.ensure_max_dyn_val(vel_meas, params.v_max, acc_tmp, params.dt)
            clamped = (acc_final != acc_tmp).any(axis=-1, keepdims=True)
            jerk_ctrl = jnp.where(clamped, (acc_final - acc) / params.dt, jerk_1)
            new_act = act + params.dt * jerk_ctrl
            ctrl_acc = new_act
        else:
            _, ctrl_acc = dynamics.ensure_max_dyn_val(vel_meas, params.v_max, action, params.dt)
            new_act = act

        # contact from the current (pre-integration) state, like MuJoCo's
        # force evaluation at the step's start
        forces = contact.box_push_contact_v2(
            pos, vel, obj_pos, obj_vel, obj_yaw, obj_w,
            params.mover_half, params.object_half,
            params.contact_k, params.contact_b, params.contact_bt, params.contact_mu,
            sticky_axis=c_axis, cone_zeta=params.cone_zeta, cone_vt=params.cone_vt,
            cone_vt_hi=params.cone_vt_hi, cone_vt_off=params.cone_vt_off,
            # wedge positive feedback: the vertical-share cap grows with the
            # accumulated mover lift (the measured climb ACCELERATES,
            # 0.5 -> 3 mm/step) — sustained gentle captures unlock the
            # runaway climb while short strong pushes never accumulate
            # enough lift to leave the seed cap (CALIBRATION.md round 5)
            fz_cap=params.cone_fz_cap
            + params.cone_fz_slope * jnp.maximum(mz - params.initial_zpos, 0.0),
        )
        # quasi-3D: the contact only acts over the z-overlap of the mover's
        # side face [mz, mz + H_m] with the object's [0, H_o]; as the mover
        # climbs, every contact force (incl. the plow/lift terms) fades
        zf = jnp.clip(
            (jnp.minimum(mz + params.mover_height, params.object_height) - mz) / params.mover_height,
            0.0, 1.0,
        )
        f_obj_c = forces.f_obj * zf
        f_imp_c = forces.f_imp * zf
        f_z_c = forces.f_z * zf
        torque_c = forces.torque_obj * zf
        # mover z: soft task-space impedance (reference K=1 + critical
        # damping, impedance_control.py:43-47) vs the vertical friction
        # REACTION of pressing the object down — measured in the reference:
        # a sustained corner push lifts the mover ~0.5-3 mm/step until it
        # clears the object (the real 'corner escape')
        zacc = (params.imp_k * (params.initial_zpos - mz) - params.imp_d * mvz + f_z_c) / params.total_mass
        new_mvz = mvz + params.dt * zacc
        new_mz = jnp.maximum(mz + params.dt * new_mvz, 0.0)
        # body qacc: gain-mass-scaled command + contact reaction over the
        # TOTAL body mass (mover + bumper); accel_scale == 1 multiplies
        # exactly (IEEE), keeping the bumperless path bit-identical
        qacc = params.accel_scale * ctrl_acc.reshape(2) + (-f_obj_c) / params.total_mass
        new_vel = vel + params.dt * qacc
        new_pos = pos + params.dt * new_vel

        obj_acc = f_obj_c / params.object_mass
        # implicit joint damping as in MuJoCo's Euler integrator
        damp = 1.0 + params.dt * params.object_damping / params.object_mass
        v_obj = (obj_vel + params.dt * obj_acc) / damp
        # floor friction under the PLOW LOAD: impact bursts of the reference's
        # intermittent hard contact press the object down (tilted box-box
        # normals — see ops/contact.box_push_contact_v2), so the load couples
        # to the impact (damping) part of the force, capped near the measured
        # cone-limit uplift: N = m*g * (1 + min(kappa*f_imp/(m*g), cap))
        load = 1.0 + jnp.minimum(
            params.plow_kappa * f_imp_c / (params.object_mass * params.gravity),
            params.plow_cap,
        ) + jnp.minimum(
            params.cone_plow * f_z_c / (params.object_mass * params.gravity),
            params.cone_plow_cap,
        )
        v_obj = contact.coulomb_floor_step(v_obj, mu_g_dt * load)
        new_obj_pos = obj_pos + params.dt * v_obj
        # yaw: contact torque, implicit rotational joint damping, torsional
        # floor friction (discrete Coulomb on omega)
        damp_w = 1.0 + params.dt * params.object_damping / params.obj_inertia
        w_obj = (obj_w + params.dt * torque_c / params.obj_inertia) / damp_w
        w_obj = contact.coulomb_spin_step(w_obj, params.mu_spin * params.dt * load)
        new_obj_yaw = obj_yaw + params.dt * w_obj

        new_wall = _wall_collision_with_noise(config, params, new_pos, npose, with_offset=False)

        pos = jnp.where(done, pos, new_pos)
        vel = jnp.where(done, vel, new_vel)
        acc = jnp.where(done, acc, qacc)
        act = jnp.where(done, act, new_act)
        obj_pos = jnp.where(done, obj_pos, new_obj_pos)
        obj_vel = jnp.where(done, obj_vel, v_obj)
        obj_yaw = jnp.where(done, obj_yaw, new_obj_yaw)
        obj_w = jnp.where(done, obj_w, w_obj)
        mz = jnp.where(done, mz, new_mz)
        mvz = jnp.where(done, mvz, new_mvz)
        # the carried axis dies when the climb breaks contact (zf == 0)
        c_axis = jnp.where(done, c_axis, jnp.where(zf > 0, forces.axis, -1.0))
        wall = jnp.where(done, wall, new_wall)
        done = done | wall
        # per-cycle poses + done for render_every_cycle (basic_envs.py:
        # 1884-1905 renders the colliding cycle's frame, then breaks);
        # dead-code-eliminated when the caller discards them
        return (pos, vel, acc, act, obj_pos, obj_vel, obj_yaw, obj_w, mz, mvz, c_axis, wall, done), (pos, vel, obj_pos, obj_yaw, done)

    init = (state.pos, state.vel, state.acc, state.act, state.obj_pos, state.obj_vel,
            state.obj_yaw, state.obj_w, state.mover_z, state.mover_vz,
            jnp.asarray(-1.0, dtype), jnp.asarray(False), jnp.asarray(False))
    (pos, vel, acc, act, obj_pos, obj_vel, obj_yaw, obj_w, mz, mvz, _, wall, _), cyc = jax.lax.scan(
        cycle, init, (vel_noise, pose_noise)
    )

    new_state = PushingState(
        pos=pos, vel=vel, acc=acc, act=act, obj_pos=obj_pos, obj_vel=obj_vel,
        obj_yaw=obj_yaw, obj_w=obj_w, mover_z=mz, mover_vz=mvz,
        goal=state.goal, key=key, steps=state.steps + 1,
    )
    obs = _get_obs(config, params, new_state, k_obs)
    info = _get_info(params, obs, wall)
    if config.reward_mode == 'dense':
        # training shaping (reward_mode docs on PushingConfig): object-to-goal
        # distance plus an approach term that fades once the mover is at
        # contact range (~0.105 m = mover half + object half-diagonal); once
        # the object IS at the goal the approach term flips into a retreat
        # bonus (back off instead of nudging it away — the scoring requires
        # the object at the goal when the episode truncates,
        # benchmark_pushing_env.py:457-476).  Terminal semantics unchanged.
        d_og = jnp.linalg.norm(obj_pos - new_state.goal)
        d_mo = jnp.linalg.norm(pos - obj_pos)
        near = d_og <= params.threshold_pos
        approach = -0.3 * jnp.maximum(d_mo - 0.105, 0.0)
        retreat = 0.5 * jnp.minimum(d_mo, 0.15)
        shaped = -d_og + jnp.where(near, retreat, approach)
        reward = jnp.where(wall, REWARD_WALL_COLLISION, shaped).astype(obj_pos.dtype)
    else:
        reward = compute_reward(params, obs['achieved_goal'], obs['desired_goal'], wall)
    terminated = wall  # benchmark_pushing_env.py:474-476
    truncated = jnp.asarray(False)
    return (new_state, obs, reward, terminated, truncated, info), cyc


def step(config: PushingConfig, params: PushingParams, state: PushingState, action: jnp.ndarray):
    """One env step: 40 cycles of (clamp chain -> contact -> integrate ->
    noisy wall check) with latched early stop."""
    return _step_core(config, params, state, action)[0]


def step_with_cycles(config: PushingConfig, params: PushingParams, state: PushingState, action: jnp.ndarray):
    """``step`` plus per-cycle ``(pos, vel, obj_pos, obj_yaw, done)`` stacks
    for the adapters' ``render_every_cycle`` mode (reference
    basic_envs.py:1708); ``done`` stops the replay at the colliding cycle."""
    out, cyc = _step_core(config, params, state, action)
    return (*out, cyc)


def _get_obs(config, params, state: PushingState, key):
    dtype = state.pos.dtype
    k_pos, k_vel, k_obj = jax.random.split(key, 3)
    pos_noisy = state.pos + jax.random.normal(k_pos, (2,), dtype) * params.std_noise[0]
    vel_noisy = state.vel + jax.random.normal(k_vel, (2,), dtype) * params.std_noise[1]
    if config.learn_jerk:
        observation = jnp.concatenate([pos_noisy, vel_noisy, state.acc])
    else:
        observation = jnp.concatenate([pos_noisy, vel_noisy])
    achieved = state.obj_pos + jax.random.normal(k_obj, (2,), dtype) * params.object_noise
    return {
        'observation': observation,
        'achieved_goal': achieved,
        'desired_goal': state.goal,
    }


def _get_info(params, obs, wall_collision):
    dist = jnp.linalg.norm(obs['achieved_goal'] - obs['desired_goal'], axis=-1)
    return {
        'is_success': (dist <= params.threshold_pos) & ~wall_collision,
        'mover_collision': jnp.asarray(False),
        'wall_collision': wall_collision,
    }


def compute_reward(params: PushingParams, achieved_goal, desired_goal, wall_collision):
    """HER-compatible batched reward (benchmark_pushing_env.py:499-527):
    0 at the goal, -1 per step, -50 on mover wall collision."""
    dist = jnp.linalg.norm(achieved_goal - desired_goal, axis=-1)
    reached = dist <= params.threshold_pos
    reward = jnp.where(wall_collision, REWARD_WALL_COLLISION, -1.0)
    return jnp.where(reached & ~wall_collision, 0.0, reward)


def _kernel_state(state: PushingState) -> dict:
    """Batched pushing state -> the kernel's ``[B]`` vectors."""
    vec = dict(steps=state.steps.astype(jnp.float32))
    for (x, y), arr in zip(
        (('px', 'py'), ('vx', 'vy'), ('ax', 'ay'), ('kx', 'ky'), ('ox', 'oy'), ('wvx', 'wvy'), ('gx', 'gy')),
        (state.pos, state.vel, state.acc, state.act, state.obj_pos, state.obj_vel, state.goal),
    ):
        vec[x], vec[y] = arr[:, 0], arr[:, 1]
    vec.update(oyaw=state.obj_yaw, ow=state.obj_w, mz=state.mover_z, mvz=state.mover_vz)
    return vec


def _state_from_kernel(vec: dict, keys, dtype) -> PushingState:
    def pair(x, y):
        return jnp.stack([vec[x], vec[y]], axis=-1).astype(dtype)

    return PushingState(
        pos=pair('px', 'py'), vel=pair('vx', 'vy'), acc=pair('ax', 'ay'), act=pair('kx', 'ky'),
        obj_pos=pair('ox', 'oy'), obj_vel=pair('wvx', 'wvy'),
        obj_yaw=vec['oyaw'].astype(dtype), obj_w=vec['ow'].astype(dtype),
        mover_z=vec['mz'].astype(dtype), mover_vz=vec['mvz'].astype(dtype),
        goal=pair('gx', 'gy'), key=keys, steps=vec['steps'].astype(jnp.int32),
    )


def make_fused_step_autoreset(
    config: PushingConfig, params: PushingParams, interpret: bool = False, cand_k: int = 32,
):
    """Batched pushing autoreset step as ONE fused-kernel launch
    (``ops/pallas_step``): cycles with contact, termination, reward (sparse
    or dense), restart and both observations run in the kernel, which emits
    the pre-reset qacc so the jerk-mode final observation is exact.  Same
    contract as ``batched_step_autoreset``; noise streams and stalled
    restarts as in ``planning.make_fused_step_autoreset``."""
    from gymnasium_planar_robotics_tpu.ops import pallas_step

    run = pallas_step.pushing_kernel(config, params, 1, cand_k=cand_k, interpret=interpret)
    limit = params.j_max if config.learn_jerk else params.a_max

    def step_fn(state: PushingState, action: jnp.ndarray):
        b = state.pos.shape[0]
        dtype = state.pos.dtype
        action = jnp.clip(jnp.asarray(action, dtype).reshape(b, 2), -limit, limit)
        keys = jax.vmap(jax.random.split)(state.key)
        streams = jax.vmap(partial(jax.random.bits, dtype=jnp.uint32))(keys[:, 1])
        vec, (reward, term, trunc), last = run(
            streams, 0, _kernel_state(state), (action[None, :, 0], action[None, :, 1])
        )
        new_state = _state_from_kernel(vec, keys[:, 0], dtype)

        def pair(x, y):
            return jnp.stack([last[x], last[y]], axis=-1).astype(dtype)

        def obs_vec(pos, vel, acc):
            return jnp.concatenate([pos, vel] + ([acc] if config.learn_jerk else []), axis=-1)

        wall = last['wall'] > 0.5
        final_obs = {
            'observation': obs_vec(pair('f_mpx', 'f_mpy'), pair('f_mvx', 'f_mvy'), pair('f_qax', 'f_qay')),
            'achieved_goal': pair('f_agx', 'f_agy'),
            'desired_goal': state.goal.astype(dtype),
        }
        out_obs = {
            'observation': obs_vec(pair('s_mpx', 's_mpy'), pair('s_mvx', 's_mvy'), new_state.acc),
            'achieved_goal': pair('s_agx', 's_agy'),
            'desired_goal': new_state.goal,
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


def make_fused_rollout(config: PushingConfig, params: PushingParams, interpret: bool = False, cand_k: int = 32):
    """``T`` pushing autoreset env steps as ONE fused-kernel launch, for
    precomputed actions — same contract as ``planning.make_fused_rollout``:
    ``rollout(state, actions[T, B, 2], seed, env_offset=0) -> (final
    PushingState, rewards [T, B], terminated [T, B], truncated [T, B])``
    with the reference's reward/termination semantics
    (benchmark_pushing_env.py:457-527) or the dense shaping."""
    from gymnasium_planar_robotics_tpu.ops import pallas_step

    limit = params.j_max if config.learn_jerk else params.a_max

    def rollout(state: PushingState, actions: jnp.ndarray, seed, env_offset=0):
        b = state.pos.shape[0]
        dtype = state.pos.dtype
        actions = jnp.clip(jnp.asarray(actions, jnp.float32).reshape(-1, b, 2), -limit, limit)
        run = pallas_step.pushing_kernel(config, params, actions.shape[0], cand_k=cand_k, interpret=interpret)
        streams = pallas_step.env_streams(seed, env_offset + jnp.arange(b, dtype=jnp.int32))
        vec, (reward, term, trunc), _ = run(streams, 0, _kernel_state(state), (actions[..., 0], actions[..., 1]))
        keys = jax.vmap(lambda k: jax.random.split(k, 1)[0])(state.key)
        return _state_from_kernel(vec, keys, dtype), reward.astype(dtype), term > 0.5, trunc > 0.5

    return rollout


def step_autoreset(config: PushingConfig, params: PushingParams, state: PushingState, action):
    """Step + in-graph episode restart on termination/truncation.  The
    pre-reset observation is surfaced as ``info['final_observation']`` and a
    stalled object resample defers the restart to the next step (bounded
    alternative to the reference's unbounded sampling loop,
    benchmark_pushing_env.py:394-407)."""
    new_state, obs, reward, terminated, _, info = step(config, params, state, action)
    truncated = new_state.steps >= config.max_episode_steps
    done = terminated | truncated

    reset_key, carry_key = jax.random.split(new_state.key)
    reset_state, reset_obs, reset_info = reset(config, params, reset_key)

    from gymnasium_planar_robotics_tpu.models.planning import _where_done, autoreset_select

    # stalled object sampling => no restart this step; done re-fires next
    # step and the sampler retries with a fresh key (vs. the reference's
    # unbounded loop, benchmark_pushing_env.py:394-407)
    do_reset = done & ~reset_info['reset_stalled']
    kept = autoreset_select(do_reset, new_state, reset_state, carry_key)
    out_obs = jax.tree_util.tree_map(lambda a, b: _where_done(do_reset, b, a), obs, reset_obs)
    info = dict(info)
    info['final_observation'] = obs
    info['reset_stalled'] = done & reset_info['reset_stalled']
    info['reset_trials'] = jnp.where(done, reset_info['reset_trials'], 0)
    return kept, out_obs, reward, terminated, truncated, info


@partial(jax.jit, static_argnums=(0, 3))
def init_batch(config, params, key, batch: int):
    """Reset ``batch`` independent pushing envs from per-env fold-in keys.

    Jitted with static (config, batch) — see planning.init_batch."""
    keys = jax.random.split(key, batch)
    return jax.vmap(lambda k: reset(config, params, k))(keys)


batched_step = jax.vmap(step, in_axes=(None, None, 0, 0))
batched_step_autoreset = jax.vmap(step_autoreset, in_axes=(None, None, 0, 0))
