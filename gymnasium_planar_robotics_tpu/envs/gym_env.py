"""Gymnasium single-env adapters (B=1 view over the batched core).

API-compatible stand-ins for the reference's ``BenchmarkPlanningEnv`` /
``BenchmarkPushingEnv`` (``/root/reference/gymnasium_planar_robotics/envs/
planning/benchmark_planning_env.py``, ``.../manipulation/
benchmark_pushing_env.py``): same observation/action spaces, same reset
``options``, same HER-compatible batched ``compute_reward`` /
``compute_terminated`` / ``compute_truncated`` signatures (array-of-info-dicts
included), same info keys.  The adapter is a thin NumPy shell: all physics
runs as one jitted call into the pure-functional core.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import gymnasium as gym
import jax
import jax.numpy as jnp

from gymnasium_planar_robotics_tpu.models import planning as planning_model
from gymnasium_planar_robotics_tpu.models import pushing as pushing_model


def _default_dtype(dtype):
    """float64 when x64 is enabled (exact reference parity), else float32."""
    if dtype is not None:
        return dtype
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32


def _info_to_collision_arrays(info) -> tuple[int, np.ndarray, np.ndarray]:
    """Reference ``_preprocess_info_dict`` (benchmark_planning_env.py:666-688):
    accept one info dict or an ndarray of per-transition info dicts (SB3 HER)."""
    if isinstance(info, (np.ndarray, list, tuple)):
        batch = len(info)
        mover = np.array([bool(i['mover_collision']) for i in info])
        wall = np.array([bool(i['wall_collision']) for i in info])
        return batch, mover, wall
    if info is None:
        return 1, np.zeros(1, bool), np.zeros(1, bool)
    return 1, np.array([bool(info['mover_collision'])]), np.array([bool(info['wall_collision'])])


class _JaxGymEnv(gym.Env):
    """Shared shell: owns the (config, params, state) triple and jitted fns."""

    metadata = {'render_modes': ['human', 'rgb_array', 'depth_array', 'human_2d', 'rgb_array_2d'], 'render_fps': 25}

    def __init__(self, model, config, params, render_mode: str | None = None,
                 render_every_cycle: bool = False, show_2D_plot: bool = False,
                 mover_colors_2D_plot=None, use_mj_passive_viewer: bool = False):
        self._model = model
        self.config = config
        self.params = params
        self.render_mode = render_mode
        #: render after every 1 ms control cycle inside step(), not just at
        #: step boundaries (reference basic_envs.py:1708,1884-1885)
        self.render_every_cycle = bool(render_every_cycle)
        #: live top-down matplotlib debug plot updated every reset/step,
        #: independent of render_mode (reference show_2D_plot /
        #: Matplotlib2DViewer, benchmark_planning_env.py:277-291)
        self._show_2d = bool(show_2D_plot)
        self._mover_colors_2d = list(mover_colors_2D_plot) if mover_colors_2D_plot else None
        #: 'human' 3D backend = mujoco.viewer.launch_passive (reference
        #: rendering.py:246-252)
        self._use_passive = bool(use_mj_passive_viewer)
        self._viewer2d_live = None
        self._state = None
        self._viewer = None
        self._viewer3d = None
        # dedicated sensor-noise stream for the name-keyed accessors, reseeded
        # with the env on reset (reference basic_envs.py:182,1789-1791)
        self._rng_noise = np.random.default_rng()
        self._step_jit = jax.jit(lambda s, a: model.step(config, params, s, a))
        self._step_cycles_jit = jax.jit(lambda s, a: model.step_with_cycles(config, params, s, a))
        # plain (no-override) resets go through jit; option-overridden resets
        # (rare, shape-changing) fall back to eager in _reset_core
        self._reset_jit = jax.jit(lambda k: model.reset(config, params, k))

    # -- Gymnasium API ------------------------------------------------------

    def reset(self, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
        elif getattr(self, '_key', None) is None:
            self._key = jax.random.PRNGKey(int(self.np_random.integers(2**31)))
        self._key, sub = jax.random.split(self._key)
        self._rng_noise = np.random.default_rng(seed)
        self._state, obs, info = self._reset_core(sub, options or {})
        # ONE batched device->host transfer instead of one per obs/info leaf
        obs, info = jax.device_get((obs, info))
        if self.render_mode is not None:
            self.render()
        self._render_2d_live()
        return self._np_obs(obs), self._np_info(info)

    def step(self, action):
        assert self._state is not None, 'call reset() first'
        action = np.asarray(action, dtype=np.float64)
        assert action.shape == self.action_space.shape, 'action dim != action_space dim'
        # clip-with-warning, matching the reference step preamble
        # (basic_envs.py:1869-1873); the core clips again inside jit
        if not self.action_space.contains(action.astype(self.action_space.dtype)):
            gym.logger.warn(
                'The desired action is not within the action space and will be clipped: '
                f'{action}'
            )
            action = np.clip(action, self.action_space.low, self.action_space.high)
        if self.render_every_cycle and self.render_mode is not None:
            (self._state, obs, reward, terminated, truncated, info, cyc) = self._step_cycles_jit(
                self._state, jnp.asarray(action)
            )
            self._render_cycles(cyc)
        else:
            self._state, obs, reward, terminated, truncated, info = self._step_jit(
                self._state, jnp.asarray(action)
            )
        # ONE batched async device->host transfer (see reset())
        obs, reward, terminated, truncated, info = jax.device_get(
            (obs, reward, terminated, truncated, info)
        )
        # reward-shape guard (basic_envs.py:1943-1948): a scalar or shape-(1,)
        # array; anything else means a broken compute_reward override
        r = np.asarray(reward)
        if r.shape not in ((), (1,)):
            raise ValueError(f'the reward has to be a float or an array of shape (1,), got shape {r.shape}')
        if self.render_mode is not None:
            self.render()
        self._render_2d_live()
        return (
            self._np_obs(obs),
            float(r.reshape(-1)[0]) if r.shape else float(r),
            bool(terminated),
            bool(truncated),
            self._np_info(info),
        )

    # -- name-keyed state accessors (reference basic_envs.py:801-855) -------

    @property
    def mover_names(self) -> list[str]:
        """Body names of the movers, ``mover_{k}`` — identical to the names in
        the exported scene / 3D mirror model (reference basic_envs.py:286,878)."""
        return [f'mover_{i}' for i in range(getattr(self.config, 'num_movers', 1))]

    def _mover_plane(self, attr: str, mover_name: str) -> np.ndarray:
        assert self._state is not None, 'call reset() first'
        idx = self.mover_names.index(mover_name)
        return np.asarray(getattr(self._state, attr), np.float64).reshape(-1, 2)[idx]

    def get_mover_qpos(self, mover_name: str, add_noise: bool = False) -> np.ndarray:
        """(x, y, z, quat wxyz) of the named mover.  As in the reference, z is
        the distance between the mover's bottom and the tile top (here exactly
        ``initial_mover_zpos`` — the analytic hold replaces the impedance z
        loop); noise draws are consumed either way with the reference's
        scale-by-gate trick (basic_envs.py:801-829)."""
        xy = self._mover_plane('pos', mover_name)
        # pushing states carry a live mover z (the quasi-3D climb DOF);
        # planning holds z analytically at the hover height
        z = float(np.asarray(getattr(self._state, 'mover_z', self.params.initial_zpos)))
        qpos = np.array([xy[0], xy[1], z, 1.0, 0.0, 0.0, 0.0])
        std = float(np.asarray(self.params.std_noise).reshape(-1)[0])
        return qpos + self._rng_noise.normal(loc=0.0, scale=std * int(add_noise), size=qpos.shape[0])

    def get_mover_qvel(self, mover_name: str, add_noise: bool = False) -> np.ndarray:
        """(vx, vy, vz, wx, wy, wz) of the named mover (basic_envs.py:831-843)."""
        xy = self._mover_plane('vel', mover_name)
        qvel = np.array([xy[0], xy[1], 0.0, 0.0, 0.0, 0.0])
        std = float(np.asarray(self.params.std_noise).reshape(-1)[1])
        return qvel + self._rng_noise.normal(loc=0.0, scale=std * int(add_noise), size=qvel.shape[0])

    def get_mover_qacc(self, mover_name: str, add_noise: bool = False) -> np.ndarray:
        """(ax, ay, az, al_x, al_y, al_z) of the named mover (basic_envs.py:845-855)."""
        xy = self._mover_plane('acc', mover_name)
        qacc = np.array([xy[0], xy[1], 0.0, 0.0, 0.0, 0.0])
        std = float(np.asarray(self.params.std_noise).reshape(-1)[2])
        return qacc + self._rng_noise.normal(loc=0.0, scale=std * int(add_noise), size=qacc.shape[0])

    def _render_2d_live(self):
        """Update the live show_2D_plot window (reference Matplotlib2DViewer
        semantics: a debug plot that updates every step regardless of
        render_mode)."""
        if not self._show_2d:
            return
        from gymnasium_planar_robotics_tpu.utils import rendering

        if self._viewer2d_live is None:
            self._viewer2d_live = rendering.Planar2DViewer(
                self.params, interactive=True, mover_colors=self._mover_colors_2d
            )
        self._viewer2d_live.render(self._render_state())

    def _render_cycles(self, cyc):
        """Replay the per-cycle poses through the active viewer: each frame
        temporarily swaps the state's pose fields, renders, then the final
        state is restored.  The replay stops after the colliding cycle's
        frame — the reference renders inside its cycle loop and then breaks
        out at the collision (basic_envs.py:1884-1905), so the frozen
        post-collision poses are never shown as duplicate frames."""
        final_state = self._state
        done = np.asarray(cyc[-1])
        for c in range(int(done.shape[0])):
            self._state = self._cycle_state(final_state, cyc, c)
            self.render()
            if done[c]:
                break
        self._state = final_state

    def _cycle_state(self, final_state, cyc, c):
        import dataclasses

        return dataclasses.replace(final_state, pos=cyc[0][c], vel=cyc[1][c])

    def render(self):
        """'human'/'rgb_array'/'depth_array' drive the live 3D MuJoCo mirror
        (reference MujocoViewerCollection, rendering.py:99-280); the '_2d'
        variants use the dependency-free matplotlib top-down view."""
        if self.render_mode is None:
            return None
        if self.render_mode in ('human', 'rgb_array', 'depth_array') and self._viewer3d is not False:
            try:
                from gymnasium_planar_robotics_tpu.utils.mujoco_viewer import MujocoViewerCollection

                # mesh movers mirror with their real silhouettes
                _shape = getattr(self, '_mover_shape', 'box')
                _mesh = getattr(self, '_mesh_cfg', None)

                if self._viewer3d is None:
                    self._viewer3d = MujocoViewerCollection(
                        self.params, num_movers=self.config.num_movers,
                        mover_shape=_shape, mesh_cfg=_mesh,
                        use_mj_passive_viewer=self._use_passive,
                    )
                self._viewer3d.update(self._state)
                return self._viewer3d.render(self.render_mode)
            except Exception as e:  # no mujoco / no GL backend
                if self.render_mode != 'rgb_array':
                    raise
                gym.logger.warn(f'3D rendering unavailable ({e}); falling back to the 2D viewer')
                self._viewer3d = False  # do not retry per frame
        from gymnasium_planar_robotics_tpu.utils import rendering

        if self._viewer is None:
            self._viewer = rendering.Planar2DViewer(self.params, interactive=self.render_mode == 'human_2d')
        frame = self._viewer.render(self._render_state())
        return frame if self.render_mode in ('rgb_array_2d', 'rgb_array') else None

    def close(self):
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None
        if self._viewer2d_live is not None:
            self._viewer2d_live.close()
            self._viewer2d_live = None
        if self._viewer3d:
            self._viewer3d.close()
        self._viewer3d = None

    # -- helpers ------------------------------------------------------------

    @staticmethod
    def _np_obs(obs) -> dict[str, np.ndarray]:
        return {k: np.asarray(v, dtype=np.float64) for k, v in obs.items()}

    @staticmethod
    def _np_info(info) -> dict[str, Any]:
        out = {}
        for k, v in info.items():
            a = np.asarray(v)
            out[k] = a.item() if a.shape == () else a
        return out


class PlanningGymEnv(_JaxGymEnv):
    """``BenchmarkPlanningEnv-v0``: collision-free multi-mover goal reaching."""

    def __init__(
        self,
        layout_tiles=None,
        num_movers: int = 1,
        render_mode: str | None = None,
        dtype=None,
        render_every_cycle: bool = False,
        show_2D_plot: bool = False,
        mover_colors_2D_plot=None,
        use_mj_passive_viewer: bool = False,
        **kwargs,
    ):
        layout_tiles = np.ones((3, 3)) if layout_tiles is None else np.asarray(layout_tiles)
        dtype = _default_dtype(dtype)
        self._render_every_cycle_init = render_every_cycle
        mp = kwargs.get('mover_params') or {}
        self._mover_shape = mp.get('shape', 'box')
        self._mesh_cfg = mp.get('mesh')
        config, params = planning_model.make_planning_env(
            layout_tiles=layout_tiles, num_movers=num_movers, dtype=dtype, **kwargs
        )
        super().__init__(planning_model, config, params, render_mode,
                         render_every_cycle=self._render_every_cycle_init,
                         show_2D_plot=show_2D_plot,
                         mover_colors_2D_plot=mover_colors_2D_plot,
                         use_mj_passive_viewer=use_mj_passive_viewer)

        m = config.num_movers
        hi = np.asarray(params.grid.workspace_max_xy)
        low_goals = np.zeros(m * 2)
        high_goals = np.tile(hi, m)
        jerk_dims = (1 + int(config.learn_jerk)) * 2
        self.observation_space = gym.spaces.Dict(
            {
                'observation': gym.spaces.Box(-np.inf, np.inf, shape=(m * jerk_dims,), dtype=np.float64),
                'achieved_goal': gym.spaces.Box(low=low_goals, high=high_goals, dtype=np.float64),
                'desired_goal': gym.spaces.Box(low=low_goals, high=high_goals, dtype=np.float64),
            }
        )
        limit = float(params.j_max if config.learn_jerk else params.a_max)
        self.action_space = gym.spaces.Box(-limit, limit, shape=(m * 2,), dtype=np.float64)

    def _reset_core(self, key, options):
        # start/goal overrides: counterpart of the reference base class's
        # initial_mover_{start,goal}_xy_pos kwargs (basic_envs.py:176-177)
        if options.get('mover_start_xy_pos') is None and options.get('mover_goal_xy_pos') is None:
            return self._reset_jit(key)
        return planning_model.reset(
            self.config,
            self.params,
            key,
            start_xy=options.get('mover_start_xy_pos'),
            goals_xy=options.get('mover_goal_xy_pos'),
        )

    def _render_state(self):
        return {
            'mover_xy': np.asarray(self._state.pos),
            'mover_vel': np.asarray(self._state.vel),
            'goals': np.asarray(self._state.goals),
        }

    # -- HER API (batched, NumPy) ------------------------------------------

    def compute_reward(self, achieved_goal, desired_goal, info=None):
        """Batched HER reward recomputation (reference ``basic_envs.py``
        ``compute_reward``): -50 on a collision recorded in ``info``, else
        0/-1 sparse goal-distance reward.  Accepts single samples, stacked
        arrays, or an array of info dicts as Stable-Baselines3 HER passes."""
        batch, mover, wall = _info_to_collision_arrays(info)
        a = np.asarray(achieved_goal).reshape(batch, -1)
        d = np.asarray(desired_goal).reshape(batch, -1)
        r = np.asarray(
            planning_model.compute_reward(
                self.config, self.params, jnp.asarray(a), jnp.asarray(d), jnp.asarray(mover), jnp.asarray(wall)
            )
        )
        return r if batch > 1 else float(r[0])

    def compute_terminated(self, achieved_goal, desired_goal, info=None):
        """Relabeled termination flag: true iff the recomputed reward hits
        the +/-50 success/collision magnitude (reference semantics where an
        episode ends on success or collision, never on plain -1 steps)."""
        r = self.compute_reward(achieved_goal, desired_goal, info)
        out = np.abs(r) == planning_model.REWARD_SUCCESS
        return out if isinstance(r, np.ndarray) else bool(out)

    def compute_truncated(self, achieved_goal, desired_goal, info=None):
        """Always false: truncation is driven by the TimeLimit wrapper, not
        by goal state (matches the reference ``compute_truncated``)."""
        batch = achieved_goal.shape[0] if np.asarray(achieved_goal).ndim > 1 else 1
        return np.zeros(batch, bool) if batch > 1 else False


class PushingGymEnv(_JaxGymEnv):
    """``BenchmarkPushingEnv-v0``: push the box object to its goal."""

    def __init__(self, render_mode: str | None = None, dtype=None,
                 render_every_cycle: bool = False,
                 use_mj_passive_viewer: bool = False, **kwargs):
        dtype = _default_dtype(dtype)
        mp = kwargs.get('mover_params') or {}
        self._mover_shape = mp.get('shape', 'box')
        self._mesh_cfg = mp.get('mesh')
        config, params = pushing_model.make_pushing_env(dtype=dtype, **kwargs)
        super().__init__(pushing_model, config, params, render_mode,
                         render_every_cycle=render_every_cycle,
                         use_mj_passive_viewer=use_mj_passive_viewer)

        hi = np.asarray(params.grid.workspace_max_xy)
        jerk_dims = (2 + int(config.learn_jerk)) * 2
        self.observation_space = gym.spaces.Dict(
            {
                'observation': gym.spaces.Box(-np.inf, np.inf, shape=(jerk_dims,), dtype=np.float64),
                'achieved_goal': gym.spaces.Box(low=np.zeros(2), high=hi, dtype=np.float64),
                'desired_goal': gym.spaces.Box(low=np.zeros(2), high=hi, dtype=np.float64),
            }
        )
        limit = float(params.j_max if config.learn_jerk else params.a_max)
        self.action_space = gym.spaces.Box(-limit, limit, shape=(2,), dtype=np.float64)

    def _cycle_state(self, final_state, cyc, c):
        import dataclasses

        return dataclasses.replace(
            final_state, pos=cyc[0][c], vel=cyc[1][c], obj_pos=cyc[2][c], obj_yaw=cyc[3][c]
        )

    def _reset_core(self, key, options):
        if options.get('mover_start_xy_pos') is None and options.get('object_goal_xy_pos') is None:
            return self._reset_jit(key)
        return pushing_model.reset(
            self.config,
            self.params,
            key,
            mover_start_xy_pos=options.get('mover_start_xy_pos'),
            object_goal_xy_pos=options.get('object_goal_xy_pos'),
        )

    def _render_state(self):
        return {
            'mover_xy': np.asarray(self._state.pos)[None],
            'mover_vel': np.asarray(self._state.vel)[None],
            'goals': np.asarray(self._state.goal)[None],
            'object_xy': np.asarray(self._state.obj_pos),
            'object_half': np.asarray(self.params.object_half),
        }

    def compute_reward(self, achieved_goal, desired_goal, info=None):
        """Batched HER reward for pushing: -50 on a wall collision recorded
        in ``info``, else the sparse 0/-1 object-to-goal distance reward
        (reference ``benchmark_pushing_env.py`` semantics)."""
        batch, _, wall = _info_to_collision_arrays(info)
        a = np.asarray(achieved_goal).reshape(batch, -1)
        d = np.asarray(desired_goal).reshape(batch, -1)
        r = np.asarray(
            pushing_model.compute_reward(self.params, jnp.asarray(a), jnp.asarray(d), jnp.asarray(wall))
        )
        return r if batch > 1 else float(r[0])

    def compute_terminated(self, achieved_goal, desired_goal, info=None):
        """Relabeled termination: pushing terminates only on wall collision
        (success does NOT end the episode in the reference pushing env)."""
        r = self.compute_reward(achieved_goal, desired_goal, info)
        out = r == pushing_model.REWARD_WALL_COLLISION
        return out if isinstance(r, np.ndarray) else bool(out)

    def compute_truncated(self, achieved_goal, desired_goal, info=None):
        """Always false: truncation comes from the TimeLimit wrapper only."""
        batch = achieved_goal.shape[0] if np.asarray(achieved_goal).ndim > 1 else 1
        return np.zeros(batch, bool) if batch > 1 else False


# registration entry points (envs/registration.py)

def make_planning_env(**kwargs) -> PlanningGymEnv:
    """Entry point used by the ``BenchmarkPlanningEnv-v0`` registration."""
    return PlanningGymEnv(**kwargs)


def make_pushing_env(**kwargs) -> PushingGymEnv:
    """Entry point used by the ``BenchmarkPushingEnv-v0`` registration."""
    return PushingGymEnv(**kwargs)
