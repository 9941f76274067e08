"""On-device rollout loops.

The reference's training loop is the SB3 Python loop calling ``env.step`` one
process-hop at a time; here the whole (policy -> step -> autoreset) chain is a
``lax.scan`` inside one jitted computation, so a T-step rollout of B sharded
envs is a single device program with no host round-trips.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp


def uniform_policy(action_dim: int, low, high) -> Callable:
    """Random policy: actions ~ U(low, high), independent of observations."""

    def policy(obs, key):
        batch = jax.tree_util.tree_leaves(obs)[0].shape[0]
        return jax.random.uniform(key, (batch, action_dim), jnp.float32, low, high)

    return policy


def make_rollout_fn(config, params, step_autoreset_fn, policy: Callable, num_steps: int):
    """Build ``rollout(state, obs, key) -> (state, obs, key, metrics)`` scanning
    ``num_steps`` autoreset env steps under one jit.

    ``metrics`` are per-scan-step scalars (mean reward, episode-done rate)
    stacked over time; everything stays on device.
    """
    batched = jax.vmap(step_autoreset_fn, in_axes=(None, None, 0, 0))
    return make_rollout_fn_batched(lambda state, action: batched(config, params, state, action), policy, num_steps)


def make_rollout_fn_batched(batched_step: Callable, policy: Callable, num_steps: int):
    """Rollout over an ALREADY-batched autoreset step — e.g. the one
    ``ops/pallas_step.batched_autoreset_step`` chooses.  Same contract as
    ``make_rollout_fn``."""

    def body(carry, _):
        state, obs, key = carry
        key, k_act = jax.random.split(key)
        actions = policy(obs, k_act)
        state, obs, reward, terminated, truncated, info = batched_step(state, actions)
        metrics = {
            'reward_mean': jnp.mean(reward),
            'done_rate': jnp.mean((terminated | truncated).astype(jnp.float32)),
            'success_rate': jnp.mean(info['is_success'].astype(jnp.float32)),
        }
        return (state, obs, key), metrics

    def rollout(state, obs, key):
        (state, obs, key), metrics = jax.lax.scan(body, (state, obs, key), None, length=num_steps)
        return state, obs, key, metrics

    return rollout


def jit_rollout(config, params, step_autoreset_fn, policy, num_steps, mesh=None, axis_name='data'):
    """jit the rollout, optionally with the env batch sharded over ``mesh``.

    No donation at this boundary, deliberately: observation pytrees can alias
    state leaves (e.g. ``desired_goal`` IS ``state.goal``, and XLA dedupes
    identical executable outputs), so donating the state produces
    "buffer previously donated in the same call" failures.  The state is
    KB-scale per thousand envs; the copy is free next to the 40-cycle step.
    """
    fn = make_rollout_fn(config, params, step_autoreset_fn, policy, num_steps)
    if mesh is None:
        return jax.jit(fn)
    from jax.sharding import NamedSharding, PartitionSpec as P

    sh = NamedSharding(mesh, P(axis_name))
    rep = NamedSharding(mesh, P())
    return jax.jit(fn, in_shardings=(sh, sh, rep))
