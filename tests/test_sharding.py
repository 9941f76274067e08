"""Mesh-sharded batch execution on the virtual 8-device CPU mesh.

What the reference cannot do at all (SURVEY.md §2.3 D1/D2): shard the env
batch over a device mesh, step it in lockstep, verify results are identical
to unsharded execution and that per-device shards are actually distributed.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gymnasium_planar_robotics_tpu.models import planning
from gymnasium_planar_robotics_tpu.parallel import rollout as rollout_lib
from gymnasium_planar_robotics_tpu.parallel import sharding


@pytest.fixture(scope='module')
def env():
    return planning.make_planning_env(
        layout_tiles=np.ones((3, 3)),
        num_movers=2,
        std_noise=1e-5,
        num_cycles=10,
        dtype=jnp.float64,
    )


def test_eight_device_mesh_available():
    assert len(jax.devices()) == 8, 'conftest should provide 8 virtual CPU devices'


def test_sharded_step_matches_unsharded(env):
    config, params = env
    mesh = sharding.make_mesh()
    batch = 16

    state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(0), batch)
    actions = jax.random.uniform(jax.random.PRNGKey(1), (batch, 4), jnp.float64, -5.0, 5.0)

    # unsharded
    s0, o0, r0, t0, _, i0 = planning.batched_step(config, params, state, actions)

    # sharded (no donation so `state` stays usable above)
    sh_state = sharding.shard_batch(state, mesh)
    sh_actions = sharding.shard_batch(actions, mesh)
    step = sharding.sharded_step_fn(config, params, mesh, planning.step, donate=False)
    s1, o1, r1, t1, _, i1 = step(sh_state, sh_actions)

    assert s1.pos.sharding.is_equivalent_to(sharding.batch_sharding(mesh), s1.pos.ndim)
    np.testing.assert_array_equal(np.asarray(r0), np.asarray(r1))
    np.testing.assert_array_equal(np.asarray(s0.pos), np.asarray(s1.pos))
    np.testing.assert_array_equal(np.asarray(o0['observation']), np.asarray(o1['observation']))
    np.testing.assert_array_equal(np.asarray(i0['is_success']), np.asarray(i1['is_success']))


def test_sharded_fused_step_bitmatches_unsharded():
    """The fused autoreset kernel under ``shard_map`` over the 8-device mesh
    produces bit-identical results to the unsharded kernel, noise on: each
    env's stream comes from its own key, whatever device holds it."""
    config, params = planning.make_planning_env(
        layout_tiles=np.ones((3, 3)), num_movers=1, std_noise=1e-5,
        num_cycles=4, dtype=jnp.float32,
    )
    mesh = sharding.make_mesh()
    batch = 16 * mesh.size

    state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(7), batch)
    state = dataclasses.replace(state, steps=jnp.where(jnp.arange(batch) % 2 == 0, 49, state.steps))
    actions = jax.random.uniform(jax.random.PRNGKey(8), (batch, 2), jnp.float32, -5.0, 5.0)

    fused = planning.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)
    s0, o0, r0, t0, tr0, i0 = fused(state, actions)

    sharded = sharding.make_sharded_fused_step(planning, config, params, mesh, interpret=True, cand_k=2)
    s1, o1, r1, t1, tr1, i1 = sharded(sharding.shard_batch(state, mesh), sharding.shard_batch(actions, mesh))

    for a, b in [
        (s0.pos, s1.pos), (s0.vel, s1.vel), (s0.goals, s1.goals), (s0.steps, s1.steps),
        (r0, r1), (t0, t1), (tr0, tr1),
        (o0['observation'], o1['observation']), (o0['achieved_goal'], o1['achieved_goal']),
        (i0['wall_collision'], i1['wall_collision']),
        (i0['reset_stalled'], i1['reset_stalled']),
        (i0['final_observation']['achieved_goal'], i1['final_observation']['achieved_goal']),
    ]:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(tr0).any()  # restarts happened inside the comparison
    # the sharded result really is distributed over the 8 devices
    assert len(s1.pos.sharding.device_set) == len(jax.devices())


def test_sharded_fused_pushing_bitmatches_unsharded():
    """Same bit-match guarantee for the pushing family's fused kernel, on a
    2-device submesh."""
    from jax.sharding import Mesh

    from gymnasium_planar_robotics_tpu.models import pushing

    config, params = pushing.make_pushing_env(std_noise=1e-5, num_cycles=4, dtype=jnp.float32)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ('data',))
    batch = 40 * mesh.size

    state, obs, _ = pushing.init_batch(config, params, jax.random.PRNGKey(3), batch)
    actions = jax.random.uniform(jax.random.PRNGKey(4), (batch, 2), jnp.float32, -5.0, 5.0)

    fused = pushing.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)
    s0, o0, r0, t0, tr0, i0 = fused(state, actions)

    sharded = sharding.make_sharded_fused_step(pushing, config, params, mesh, interpret=True, cand_k=2)
    s1, o1, r1, t1, tr1, i1 = sharded(sharding.shard_batch(state, mesh), sharding.shard_batch(actions, mesh))
    for a, b in [
        (s0.pos, s1.pos), (s0.obj_pos, s1.obj_pos), (s0.obj_yaw, s1.obj_yaw),
        (r0, r1), (t0, t1), (o0['achieved_goal'], o1['achieved_goal']),
        (i0['wall_collision'], i1['wall_collision']),
    ]:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_jit_rollout_fused_sharded():
    """A multi-step fused rollout under the 8-device mesh: the scan drives the
    shard_mapped kernel; metrics reduce across shards (the only collectives)."""
    import jax.numpy as jnp

    config, params = planning.make_planning_env(
        layout_tiles=np.ones((3, 3)), num_movers=1, std_noise=1e-5,
        num_cycles=3, dtype=jnp.float32,
    )
    mesh = sharding.make_mesh()
    batch = 16 * mesh.size
    state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(11), batch)
    policy = rollout_lib.uniform_policy(2, -10.0, 10.0)
    step = sharding.make_sharded_fused_step(planning, config, params, mesh, interpret=True)
    sh = sharding.batch_sharding(mesh)
    roll = jax.jit(rollout_lib.make_rollout_fn_batched(step, policy, 3),
                   in_shardings=(sh, sh, sharding.replicated(mesh)))
    s, o, k, metrics = roll(
        sharding.shard_batch(state, mesh), sharding.shard_batch(obs, mesh), jax.random.PRNGKey(12)
    )
    assert metrics['reward_mean'].shape == (3,)
    assert np.isfinite(np.asarray(metrics['reward_mean'])).all()
    assert s.pos.sharding.is_equivalent_to(sharding.batch_sharding(mesh), s.pos.ndim)


_COLLECTIVES = ('all-reduce', 'all-gather', 'collective-permute', 'all-to-all', 'reduce-scatter')


def test_sharded_step_hlo_has_no_collectives(env):
    """Machine-checked scaling claim (round-2 VERDICT item #6): the sharded
    env step compiles to pure per-device compute — zero cross-device
    collectives in the optimized HLO — so aggregate throughput scales
    linearly with device count up to host/interconnect limits.  (Wall-clock scaling
    on the CPU proxy is recorded in BASELINE.md; this assertion is the
    deterministic CI form.)"""
    config, params = env
    mesh = sharding.make_mesh()
    batch = 16
    state, _, _ = planning.init_batch(config, params, jax.random.PRNGKey(21), batch)
    actions = jnp.zeros((batch, 4), jnp.float64)
    step = sharding.sharded_step_fn(config, params, mesh, planning.step, donate=False)
    txt = step.lower(
        sharding.shard_batch(state, mesh), sharding.shard_batch(actions, mesh)
    ).compile().as_text()
    found = [c for c in _COLLECTIVES if c in txt]
    assert not found, f'sharded step HLO contains collectives: {found}'


def test_sharded_fused_step_hlo_has_no_collectives():
    """The shard_mapped fused kernel path is likewise collective-free."""
    import jax.numpy as jnp

    config, params = planning.make_planning_env(
        layout_tiles=np.ones((3, 3)), num_movers=1, std_noise=1e-5,
        num_cycles=2, dtype=jnp.float32,
    )
    mesh = sharding.make_mesh()
    batch = 16 * mesh.size
    state, _, _ = planning.init_batch(config, params, jax.random.PRNGKey(22), batch)
    actions = jnp.zeros((batch, 2), jnp.float32)
    sharded = sharding.make_sharded_fused_step(planning, config, params, mesh, interpret=True)
    sh = sharding.batch_sharding(mesh)
    txt = jax.jit(lambda s, a: sharded(s, a), in_shardings=(sh, sh)).lower(
        sharding.shard_batch(state, mesh), sharding.shard_batch(actions, mesh)
    ).compile().as_text()
    found = [c for c in _COLLECTIVES if c in txt]
    assert not found, f'sharded fused step HLO contains collectives: {found}'


def test_metrics_summary_replicated(env):
    config, params = env
    mesh = sharding.make_mesh()
    batch = 16
    state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(2), batch)
    actions = jnp.zeros((batch, 4), jnp.float64)
    step = sharding.sharded_step_fn(config, params, mesh, planning.step, donate=False)

    @jax.jit
    def step_and_metrics(state, actions):
        s, o, r, t, tr, i = step(state, actions)
        return sharding.metrics_summary(r, t, i)

    m = step_and_metrics(sharding.shard_batch(state, mesh), sharding.shard_batch(actions, mesh))
    assert m['reward_mean'].shape == ()
    assert 0.0 <= float(m['terminated_rate']) <= 1.0


def test_jit_rollout_sharded(env):
    config, params = env
    mesh = sharding.make_mesh()
    batch = 16

    state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(3), batch)
    policy = rollout_lib.uniform_policy(4, -10.0, 10.0)
    roll = rollout_lib.jit_rollout(
        config, params, planning.step_autoreset, policy, num_steps=7, mesh=mesh
    )
    state = sharding.shard_batch(state, mesh)
    obs = sharding.shard_batch(obs, mesh)
    s, o, k, metrics = roll(state, obs, jax.random.PRNGKey(4))
    assert metrics['reward_mean'].shape == (7,)
    assert np.isfinite(np.asarray(metrics['reward_mean'])).all()
    # autoreset keeps every env inside the table
    assert (np.asarray(s.pos) >= 0).all()


def test_sharded_fused_rollout_runs_and_stays_sharded():
    """One-launch fused rollout under shard_map: runs on an 8-device mesh,
    keeps the batch sharding end to end, and — since each shard keys its
    noise by global env index — equals the unsharded rollout."""
    config, params = planning.make_planning_env(
        np.ones((3, 3)), 1, std_noise=1e-5, num_cycles=4, dtype=jnp.float32
    )
    mesh = sharding.make_mesh(jax.devices()[:8])
    B, T = 8 * 16, 3
    state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(0), B)
    roll = sharding.make_sharded_fused_rollout(planning, config, params, mesh, interpret=True, cand_k=2)
    acts = jax.random.uniform(jax.random.PRNGKey(1), (T, B, 2), jnp.float32, -2.0, 2.0)
    sh = sharding.batch_sharding(mesh)
    rj = jax.jit(roll, in_shardings=(sh, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec(None, 'data')), None))

    fs, rew, te, tr = rj(sharding.shard_batch(state, mesh), acts, 7)
    assert rew.shape == (T, B) and np.isfinite(np.asarray(rew)).all()
    assert fs.pos.sharding.is_equivalent_to(sh, fs.pos.ndim), 'rollout lost the batch sharding'
    assert len(fs.pos.addressable_shards) == 8
    ref = planning.make_fused_rollout(config, params, interpret=True, cand_k=2)
    fs0, rew0, te0, tr0 = jax.jit(ref)(state, acts, 7)
    np.testing.assert_array_equal(np.asarray(rew), np.asarray(rew0))
    np.testing.assert_array_equal(np.asarray(fs.pos), np.asarray(fs0.pos))
    np.testing.assert_array_equal(np.asarray(te), np.asarray(te0))
