"""Mesh-sharded env batches.

The reference has no parallelism at all (SURVEY.md §2.3: one ``MjData``, one
env per process).  Here the batch axis *is* the parallelism model: env state
is a pytree with a leading ``[B, ...]`` axis, sharded over a ``data`` mesh
axis with ``NamedSharding``; every physics/collision/reward op is per-env
local, so a sharded ``step`` compiles to pure per-device compute with zero
communication, and XLA inserts collectives only where metrics or a learner
actually gather across devices.

Multi-host: construct the mesh over ``jax.devices()`` (all hosts' devices);
per-host batch shards follow from the same ``NamedSharding``.  Tested on a
virtual 8-device CPU mesh (tests/test_sharding.py) and on four GPUs of one
host (``chip_smoke.py --four-cards``).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Callable

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = 'data'


def make_mesh(devices=None, axis_name: str = DATA_AXIS) -> Mesh:
    """A 1D mesh over all (or the given) devices; the env batch shards over it."""
    import numpy as np

    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def batch_sharding(mesh: Mesh, axis_name: str = DATA_AXIS) -> NamedSharding:
    """Leading-axis sharding for env-state / obs / action pytrees."""
    return NamedSharding(mesh, P(axis_name))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully-replicated sharding (params, scalars) over the mesh."""
    return NamedSharding(mesh, P())


def shard_batch(tree: Any, mesh: Mesh, axis_name: str = DATA_AXIS) -> Any:
    """Place a batched pytree with its leading axis sharded over the mesh."""
    sh = batch_sharding(mesh, axis_name)
    return jax.device_put(tree, sh)


def sharded_step_fn(
    config, params, mesh: Mesh, step_fn: Callable, axis_name: str = DATA_AXIS, donate: bool = True
) -> Callable:
    """jit a batched ``step_fn(config, params, state, action)`` with the env
    batch sharded on ``axis_name`` and params replicated.

    The compiled function has signature ``(state, action) -> (state, obs,
    reward, terminated, truncated, info)``; state is donated so the update is
    in-place in HBM.
    """
    batched = jax.vmap(step_fn, in_axes=(None, None, 0, 0))
    sh = batch_sharding(mesh, axis_name)

    fn = partial(batched, config, params)
    return jax.jit(
        fn,
        in_shardings=(sh, sh),
        donate_argnums=(0,) if donate else (),
    )


def make_sharded_fused_step(
    model, config, params, mesh: Mesh, axis_name: str = DATA_AXIS, **fused_kw
) -> Callable:
    """The fused autoreset kernel step under ``jax.shard_map`` over the data
    mesh: each device runs the kernel on its local ``[B/D, ...]`` rows.

    Each env's noise stream comes from its own PRNG key
    (``models/planning.make_fused_step_autoreset``), so the sharded step is
    bit-identical to the unsharded one at any mesh size.  ``B`` must divide
    evenly over the mesh; masked block tails in the kernel take any
    per-device batch.  Returns ``step(state, action) -> (state, obs, reward,
    terminated, truncated, info)``; jit it with the batch sharded on
    ``axis_name``.
    """
    from gymnasium_planar_robotics_tpu.ops import pallas_step

    return pallas_step.shard_step(model.make_fused_step_autoreset(config, params, **fused_kw), mesh, axis_name)


def make_sharded_fused_rollout(
    model, config, params, mesh: Mesh, axis_name: str = DATA_AXIS, **fused_kw
) -> Callable:
    """The one-launch fused rollout (``model.make_fused_rollout``) under
    ``jax.shard_map``: each device runs its local ``[B/D]`` shard with zero
    cross-device communication, keyed by the shard's global env offset, so
    the result equals the unsharded rollout with the same seed.

    Returns ``rollout(state, actions[T, B, A], seed) -> (final state,
    rewards [T, B], terminated [T, B], truncated [T, B])``; jit it with the
    batch axes sharded on ``axis_name``.
    """
    roll = model.make_fused_rollout(config, params, **fused_kw)

    def local(state, actions, seed):
        b_local = actions.shape[1]
        return roll(state, actions, seed, env_offset=jax.lax.axis_index(axis_name) * b_local)

    spec = P(axis_name)
    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(spec, P(None, axis_name), P()),
        out_specs=(spec, P(None, axis_name), P(None, axis_name), P(None, axis_name)),
        check_vma=False,
    )

    def rollout(state, actions, seed):
        return sharded(state, actions, jnp.asarray(seed, jnp.int32))

    return rollout


def metrics_summary(reward: jax.Array, terminated: jax.Array, info: dict) -> dict[str, jax.Array]:
    """Replicated scalar metrics from sharded per-env arrays.

    Written as plain reductions: under ``jit`` with sharded inputs, XLA lowers
    these to per-device partial reductions + an all-reduce — the batched
    equivalent of the reference's info-dict telemetry (SURVEY.md §5
    'metrics'), scaled to the whole batch.
    """
    return {
        'reward_mean': jnp.mean(reward),
        'terminated_rate': jnp.mean(terminated.astype(jnp.float32)),
        'success_rate': jnp.mean(info['is_success'].astype(jnp.float32)),
        'mover_collision_rate': jnp.mean(info['mover_collision'].astype(jnp.float32)),
        'wall_collision_rate': jnp.mean(info['wall_collision'].astype(jnp.float32)),
    }
