"""Gymnasium VectorEnv adapter over the batched core.

The reference has no vectorization at all (SURVEY.md §2.3 D1 — no
``gym.vector`` usage anywhere); this adapter is what replaces it: B envs
stepped as ONE jitted device call with in-place autoreset, optionally sharded
over a device mesh.  Matches Gymnasium's ``VectorEnv`` API with
``AutoresetMode.SAME_STEP`` semantics (the observation returned for a
finished episode is the first of the new one; the final observation rides in
``info['final_observation']``).
"""

from __future__ import annotations

from typing import Any

import numpy as np

import gymnasium as gym
import jax
import jax.numpy as jnp

from gymnasium_planar_robotics_tpu.models import planning as planning_model
from gymnasium_planar_robotics_tpu.models import pushing as pushing_model


def _autoreset_mode():
    # standard vector wrappers assert isinstance(..., AutoresetMode)
    try:
        return gym.vector.AutoresetMode.SAME_STEP
    except AttributeError:  # older gymnasium without the enum
        return 'SameStep'


class _JaxVectorEnv(gym.vector.VectorEnv):
    metadata = {'autoreset_mode': _autoreset_mode()}

    def __init__(self, model, config, params, num_envs: int, mesh=None):
        self._model = model
        self.config = config
        self.params = params
        self.num_envs = num_envs
        self._mesh = mesh
        self._state = None
        self._key = None

        from gymnasium_planar_robotics_tpu.ops.pallas_step import batched_autoreset_step

        step = batched_autoreset_step(model, config, params, mesh)
        #: True when steps run through the fused kernel (observable so runs on
        #: the GPU can assert that the fast path engaged)
        self.using_fused = step.uses_kernel
        if mesh is None:
            self._step_jit = jax.jit(step)
        else:
            from jax.sharding import NamedSharding, PartitionSpec as P

            sh = NamedSharding(mesh, P('data'))
            self._step_jit = jax.jit(step, in_shardings=(sh, sh))
        self._reset_jit = jax.jit(lambda k: jax.vmap(lambda kk: model.reset(config, params, kk))(k))

    def reset(self, seed: int | None = None, options: dict[str, Any] | None = None):
        if seed is not None:
            self._key = jax.random.PRNGKey(seed)
        elif self._key is None:
            # Gymnasium semantics: unseeded resets continue a nondeterministic
            # stream, they do not replay a fixed one
            import secrets

            self._key = jax.random.PRNGKey(secrets.randbits(31))
        self._key, sub = jax.random.split(self._key)
        keys = jax.random.split(sub, self.num_envs)
        self._state, obs, info = self._reset_jit(keys)
        if self._mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._state = jax.device_put(self._state, NamedSharding(self._mesh, P('data')))
        obs, info = jax.device_get((obs, info))  # one batched transfer
        return self._np(obs), self._np(info)

    def step(self, actions):
        self._state, obs, reward, terminated, truncated, info = self._step_jit(
            self._state, jnp.asarray(np.asarray(actions))
        )
        # one batched device->host transfer instead of one per leaf
        obs, reward, terminated, truncated, info = jax.device_get(
            (obs, reward, terminated, truncated, info)
        )
        return (
            self._np(obs),
            np.asarray(reward),
            np.asarray(terminated),
            np.asarray(truncated),
            self._np(info),
        )

    @staticmethod
    def _np(tree):
        return jax.tree_util.tree_map(np.asarray, tree)

    # direct on-device access for learners that skip the NumPy boundary
    @property
    def device_state(self):
        return self._state

    def render(self):
        """Top-down rgb frame of env 0 — a debugging window into the batch
        (the reference has no vector envs at all, so there is no parity
        semantics to match; this mirrors the single-env 2D view)."""
        assert self._state is not None, 'call reset() first'
        from gymnasium_planar_robotics_tpu.utils import rendering

        if getattr(self, '_viewer2d', None) is None:
            self._viewer2d = rendering.Planar2DViewer(self.params)
        return self._viewer2d.render(self._render_state0())

    def close_extras(self, **kwargs):
        if getattr(self, '_viewer2d', None) is not None:
            self._viewer2d.close()
            self._viewer2d = None


class PlanningVectorEnv(_JaxVectorEnv):
    def __init__(self, num_envs: int, layout_tiles=None, num_movers: int = 1, mesh=None, dtype=None, **kwargs):
        from gymnasium_planar_robotics_tpu.envs.gym_env import _default_dtype

        dtype = _default_dtype(dtype) if dtype is None else dtype
        layout_tiles = np.ones((3, 3)) if layout_tiles is None else np.asarray(layout_tiles)
        config, params = planning_model.make_planning_env(
            layout_tiles=layout_tiles, num_movers=num_movers, dtype=dtype, **kwargs
        )
        super().__init__(planning_model, config, params, num_envs, mesh)
        m = config.num_movers
        space_dtype = np.dtype(np.asarray(params.v_max).dtype)
        limit = float(params.j_max if config.learn_jerk else params.a_max)
        hi = np.asarray(params.grid.workspace_max_xy)
        jerk_dims = (1 + int(config.learn_jerk)) * 2
        self.single_observation_space = gym.spaces.Dict(
            {
                'observation': gym.spaces.Box(-np.inf, np.inf, shape=(m * jerk_dims,), dtype=space_dtype),
                'achieved_goal': gym.spaces.Box(np.zeros(m * 2), np.tile(hi, m), dtype=space_dtype),
                'desired_goal': gym.spaces.Box(np.zeros(m * 2), np.tile(hi, m), dtype=space_dtype),
            }
        )
        self.single_action_space = gym.spaces.Box(-limit, limit, shape=(m * 2,), dtype=np.float64)
        self.observation_space = gym.vector.utils.batch_space(self.single_observation_space, num_envs)
        self.action_space = gym.vector.utils.batch_space(self.single_action_space, num_envs)

    def _render_state0(self):
        s = self._state
        return {
            'mover_xy': np.asarray(s.pos)[0],
            'mover_vel': np.asarray(s.vel)[0],
            'goals': np.asarray(s.goals)[0],
        }


class PushingVectorEnv(_JaxVectorEnv):
    def __init__(self, num_envs: int, mesh=None, dtype=None, **kwargs):
        from gymnasium_planar_robotics_tpu.envs.gym_env import _default_dtype

        dtype = _default_dtype(dtype) if dtype is None else dtype
        config, params = pushing_model.make_pushing_env(dtype=dtype, **kwargs)
        super().__init__(pushing_model, config, params, num_envs, mesh)
        space_dtype = np.dtype(np.asarray(params.v_max).dtype)
        limit = float(params.j_max if config.learn_jerk else params.a_max)
        hi = np.asarray(params.grid.workspace_max_xy)
        jerk_dims = (2 + int(config.learn_jerk)) * 2
        self.single_observation_space = gym.spaces.Dict(
            {
                'observation': gym.spaces.Box(-np.inf, np.inf, shape=(jerk_dims,), dtype=space_dtype),
                'achieved_goal': gym.spaces.Box(np.zeros(2), hi, dtype=space_dtype),
                'desired_goal': gym.spaces.Box(np.zeros(2), hi, dtype=space_dtype),
            }
        )
        self.single_action_space = gym.spaces.Box(-limit, limit, shape=(2,), dtype=np.float64)
        self.observation_space = gym.vector.utils.batch_space(self.single_observation_space, num_envs)
        self.action_space = gym.vector.utils.batch_space(self.single_action_space, num_envs)

    def _render_state0(self):
        s = self._state
        return {
            'mover_xy': np.asarray(s.pos)[0][None],
            'mover_vel': np.asarray(s.vel)[0][None],
            'goals': np.asarray(s.goal)[0][None],
            'object_xy': np.asarray(s.obj_pos)[0],
            'object_half': np.asarray(self.params.object_half),
        }
