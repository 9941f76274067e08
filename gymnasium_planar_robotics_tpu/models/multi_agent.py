"""Batched multi-agent planning: per-agent views over the vectorized core.

The PettingZoo adapter (``envs/pettingzoo_env.py``) serves the standard
single-env dict-in/dict-out API; this module is its throughput-oriented
sibling for BASELINE.md config 4 (N agents x B batched envs): the same
planning physics stepped as one jitted call, with observations/actions/
rewards exposed per agent as stacked arrays ``[B, ...]`` — no Python
per-agent loop anywhere.

Per-agent semantics match the PettingZoo adapter: own velocity[, accel]
observation, own position/goal as achieved/desired goal, shared-fate
termination, reward = +/-50 on shared success/collision else -1 for each
agent that has not reached its goal.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from gymnasium_planar_robotics_tpu.models import planning
from gymnasium_planar_robotics_tpu.ops.pallas_step import batched_autoreset_step


class AgentBatch(NamedTuple):
    """Per-agent stacked views: leading dims [B, N_agents, ...]."""

    observation: jnp.ndarray  # [B, N, 2] own velocity (or [B, N, 4] with accel)
    achieved_goal: jnp.ndarray  # [B, N, 2]
    desired_goal: jnp.ndarray  # [B, N, 2]
    reward: jnp.ndarray  # [B, N]
    terminated: jnp.ndarray  # [B, N] (shared fate: identical across N)
    truncated: jnp.ndarray  # [B, N]


def split_obs(config: planning.PlanningConfig, obs: dict) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Batched obs dict -> per-agent (observation, achieved, desired)."""
    m = config.num_movers
    lead = obs['observation'].shape[:-1]
    vel = obs['observation'][..., : m * 2].reshape(*lead, m, 2)
    achieved = obs['achieved_goal'].reshape(*lead, m, 2)
    desired = obs['desired_goal'].reshape(*lead, m, 2)
    if config.learn_jerk:
        acc = obs['observation'][..., m * 2 :].reshape(*lead, m, 2)
        observation = jnp.concatenate([vel, acc], axis=-1)
    else:
        observation = vel
    return observation, achieved, desired


def per_agent_rewards(config, params, achieved, desired, reward_shared):
    """Split the shared planning reward into per-agent terms (PettingZoo
    adapter semantics): shared +/-50 events broadcast, otherwise -1 per
    unreached own goal."""
    dist = jnp.linalg.norm(achieved - desired, axis=-1)  # [..., N]
    reached = dist <= params.threshold_pos
    shared_event = jnp.abs(reward_shared) == planning.REWARD_SUCCESS
    own = -(~reached).astype(dist.dtype)
    return jnp.where(shared_event[..., None], reward_shared[..., None], own)


def make_batched_parallel_step(config: planning.PlanningConfig, params: planning.PlanningParams, jit: bool = True):
    """Returns ``step(state, actions[B, N, 2]) -> (state, AgentBatch)``;
    ``state`` is the batched ``PlanningState``.

    Pass ``jit=False`` when composing this step inside a larger jitted
    computation (e.g. a rollout ``lax.scan``): a nested jit compiles as a
    separate XLA call that blocks fusion across the scan body."""

    batched_step = batched_autoreset_step(planning, config, params)

    def step(state, actions):
        b = actions.shape[0]
        state, obs, reward, terminated, truncated, info = batched_step(
            state, actions.reshape(b, config.num_movers * 2)
        )
        observation, achieved, desired = split_obs(config, obs)
        # rewards must come from the episode's FINAL observation: on done
        # steps (termination or truncation) ``obs`` is already the next
        # episode's first observation, so scoring it would grade agents on
        # the post-reset state; on non-done steps final_observation == obs
        _, f_achieved, f_desired = split_obs(config, info['final_observation'])
        rew = per_agent_rewards(config, params, f_achieved, f_desired, reward)
        n = config.num_movers
        out = AgentBatch(
            observation=observation,
            achieved_goal=achieved,
            desired_goal=desired,
            reward=rew,
            terminated=jnp.repeat(terminated[..., None], n, axis=-1),
            truncated=jnp.repeat(truncated[..., None], n, axis=-1),
        )
        return state, out

    return jax.jit(step) if jit else step
