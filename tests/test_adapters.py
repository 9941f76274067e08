"""Adapter-level API tests: Gymnasium single env, vector env, PettingZoo.

Checks the user-facing contract a reference user relies on: env ids resolve
through ``gym.make`` with the 50-step TimeLimit, spaces match the reference's
shapes/dtypes, HER's batched compute_* signatures accept array-of-info-dicts,
reset options work, and rendering produces frames.
"""

import numpy as np
import pytest

import gymnasium as gym

import gymnasium_planar_robotics_tpu  # noqa: F401  (registers envs)
from gymnasium_planar_robotics_tpu.envs import registration


@pytest.fixture(autouse=True)
def _ensure_our_registration():
    """Other test modules import the reference package, which overrides the
    shared env ids in the global Gymnasium registry; pin OURS back for every
    test in this module (execution order must not matter)."""
    registration.register_gymnasium_envs(force=True)


def test_gym_make_planning_roundtrip():
    env = gym.make('BenchmarkPlanningEnv-v0', num_movers=2, layout_tiles=np.ones((4, 4)))
    obs, info = env.reset(seed=7)
    assert set(obs) == {'observation', 'achieved_goal', 'desired_goal'}
    assert obs['observation'].shape == (4,)
    assert obs['achieved_goal'].shape == (4,)
    assert env.action_space.shape == (4,)
    assert {'is_success', 'mover_collision', 'wall_collision'} <= set(info)

    terminated = truncated = False
    steps = 0
    while not (terminated or truncated):
        obs, reward, terminated, truncated, info = env.step(np.zeros(4))
        steps += 1
        assert isinstance(reward, float)
    assert steps <= 50
    if steps == 50 and not terminated:
        assert truncated  # TimeLimit wrapper (registration max_episode_steps=50)
    env.close()


def test_gym_make_planning_seeding_deterministic():
    env1 = gym.make('BenchmarkPlanningEnv-v0', num_movers=1)
    env2 = gym.make('BenchmarkPlanningEnv-v0', num_movers=1)
    o1, _ = env1.reset(seed=123)
    o2, _ = env2.reset(seed=123)
    np.testing.assert_array_equal(o1['achieved_goal'], o2['achieved_goal'])
    np.testing.assert_array_equal(o1['desired_goal'], o2['desired_goal'])
    a = np.array([1.0, -1.0])
    r1 = env1.step(a)
    r2 = env2.step(a)
    np.testing.assert_array_equal(r1[0]['observation'], r2[0]['observation'])
    assert r1[1] == r2[1]


def test_gym_make_pushing_roundtrip_and_options():
    env = gym.make('BenchmarkPushingEnv-v0')
    obs, info = env.reset(
        seed=3, options={'mover_start_xy_pos': np.array([0.3, 0.3]), 'object_goal_xy_pos': np.array([0.5, 0.5])}
    )
    assert obs['observation'].shape == (4,)
    np.testing.assert_allclose(obs['desired_goal'], [0.5, 0.5], atol=1e-12)
    obs, reward, terminated, truncated, info = env.step(np.array([1.0, 0.0]))
    assert reward == -1.0
    assert not terminated
    env.close()


def test_her_batched_compute_reward_with_info_dicts():
    env = gym.make('BenchmarkPlanningEnv-v0', num_movers=1).unwrapped
    achieved = np.array([[0.3, 0.3], [0.3, 0.3], [0.3, 0.3]])
    desired = np.array([[0.31, 0.3], [0.6, 0.6], [0.31, 0.3]])
    infos = np.array(
        [
            {'mover_collision': False, 'wall_collision': False},
            {'mover_collision': False, 'wall_collision': False},
            {'mover_collision': True, 'wall_collision': False},
        ]
    )
    r = env.compute_reward(achieved, desired, infos)
    np.testing.assert_array_equal(r, [50.0, -1.0, -50.0])
    t = env.compute_terminated(achieved, desired, infos)
    np.testing.assert_array_equal(t, [True, False, True])
    tr = env.compute_truncated(achieved, desired, infos)
    np.testing.assert_array_equal(tr, [False, False, False])

    # scalar path
    assert env.compute_reward(achieved[0], desired[0], infos[0]) == 50.0
    assert env.compute_terminated(achieved[0], desired[0], infos[0]) is True


def test_pushing_her_reward():
    env = gym.make('BenchmarkPushingEnv-v0').unwrapped
    achieved = np.array([[0.4, 0.4], [0.4, 0.4]])
    desired = np.array([[0.42, 0.4], [0.6, 0.6]])
    infos = np.array(
        [
            {'mover_collision': False, 'wall_collision': False},
            {'mover_collision': False, 'wall_collision': True},
        ]
    )
    r = env.compute_reward(achieved, desired, infos)
    np.testing.assert_array_equal(r, [0.0, -50.0])
    t = env.compute_terminated(achieved, desired, infos)
    np.testing.assert_array_equal(t, [False, True])


def test_vector_env_autoreset():
    from gymnasium_planar_robotics_tpu.envs.vector_env import PlanningVectorEnv
    import jax.numpy as jnp

    venv = PlanningVectorEnv(num_envs=8, num_movers=1, dtype=jnp.float64)
    obs, info = venv.reset(seed=0)
    assert obs['observation'].shape == (8, 2)
    for _ in range(55):
        obs, reward, terminated, truncated, info = venv.step(np.zeros((8, 2)))
    assert reward.shape == (8,)
    assert 'final_observation' in info
    assert np.isfinite(obs['observation']).all()


def test_pettingzoo_parallel_api():
    from gymnasium_planar_robotics_tpu.envs.pettingzoo_env import PlanningParallelEnv

    env = PlanningParallelEnv(num_movers=3, layout_tiles=np.ones((4, 4)), std_noise=0.0)
    obs, infos = env.reset(seed=1)
    assert set(env.agents) == {'mover_0', 'mover_1', 'mover_2'}
    assert set(obs) == set(env.agents)
    assert obs['mover_0']['observation'].shape == (2,)
    assert obs['mover_1']['achieved_goal'].shape == (2,)

    actions = {a: np.zeros(2) for a in env.agents}
    obs, rewards, terminations, truncations, infos = env.step(actions)
    assert set(rewards) == set(env.possible_agents)
    assert all(isinstance(v, float) for v in rewards.values())
    # shared-fate termination flags agree across agents
    assert len(set(terminations.values())) == 1


def test_rgb_array_render():
    env = gym.make('BenchmarkPlanningEnv-v0', num_movers=2, render_mode='rgb_array')
    env.reset(seed=0)
    frame = env.render()
    assert frame is not None and frame.ndim == 3 and frame.shape[2] == 3
    assert frame.max() > 0
    env.close()


def test_pushing_render_shows_object():
    env = gym.make('BenchmarkPushingEnv-v0', render_mode='rgb_array')
    env.reset(seed=0)
    frame = env.render()
    assert frame is not None and frame.shape[2] == 3
    env.close()


def test_gymnasium_official_env_checker():
    """Both envs pass Gymnasium's own compliance checker (reset/step/space
    contracts, seeding, determinism probes) — third-party validation of the
    adapter, beyond our targeted tests."""
    from gymnasium.utils.env_checker import check_env

    for env_id, kwargs in (('BenchmarkPlanningEnv-v0', {'num_movers': 1}), ('BenchmarkPushingEnv-v0', {})):
        env = gym.make(env_id, **kwargs).unwrapped
        check_env(env, skip_render_check=True)
        env.close()


def test_pettingzoo_official_parallel_api():
    """The multi-agent adapter passes PettingZoo's parallel_api_test."""
    pytest.importorskip('pettingzoo')  # optional extra ([multiagent])
    from pettingzoo.test import parallel_api_test

    from gymnasium_planar_robotics_tpu.envs.pettingzoo_env import PlanningParallelEnv

    penv = PlanningParallelEnv(num_movers=2)
    parallel_api_test(penv, num_cycles=60)


def test_render_every_cycle():
    """render_every_cycle renders after each 1 ms cycle inside step()
    (reference basic_envs.py:1708,1884-1885): num_cycles frames plus the
    final step-boundary render, with intermediate poses along the motion."""
    env = gym.make(
        'BenchmarkPlanningEnv-v0', num_movers=1, num_cycles=6,
        render_mode='rgb_array_2d', render_every_cycle=True,
    ).unwrapped
    env.reset(seed=0)
    seen = []
    orig_render = env.render
    env.render = lambda: (seen.append(np.asarray(env._state.pos).copy()), orig_render())[1]
    env.step(np.array([5.0, 0.0]))
    assert len(seen) == 7  # 6 cycles + 1 final
    xs = np.asarray(seen)[:, 0, 0]
    assert (np.diff(xs[:6]) > 0).all(), 'per-cycle frames should advance monotonically'
    np.testing.assert_allclose(xs[5], xs[6])  # final render shows the final pose
    env.close()

    env2 = gym.make(
        'BenchmarkPushingEnv-v0', num_cycles=6, render_mode='rgb_array_2d',
        render_every_cycle=True,
    ).unwrapped
    env2.reset(seed=1)
    env2.step(np.array([3.0, 0.0]))
    assert np.asarray(env2.render()).ndim == 3
    env2.close()


def test_reference_constructor_kwargs_accepted():
    """A migrating user's reference constructor kwargs work: show_2D_plot
    opens the live top-down debug plot (updated every reset/step regardless
    of render_mode — reference Matplotlib2DViewer semantics),
    mover_colors_2D_plot styles it, use_mj_passive_viewer selects the 3D
    human backend (benchmark_planning_env.py:165-185)."""
    env = gym.make(
        'BenchmarkPlanningEnv-v0', num_movers=1, show_2D_plot=True,
        mover_colors_2D_plot=['red'], use_mj_passive_viewer=False,
    ).unwrapped
    env.reset(seed=0)
    env.step(np.zeros(2))
    assert env._viewer2d_live is not None, 'show_2D_plot did not open the live plot'
    assert env._viewer2d_live._mover_colors == ['red']
    env.close()
    assert env._viewer2d_live is None

    env2 = gym.make('BenchmarkPushingEnv-v0', use_mj_passive_viewer=False).unwrapped
    env2.reset(seed=0)
    env2.step(np.zeros(2))
    env2.close()


def test_render_every_cycle_stops_at_collision():
    """Once the in-step collision latch fires, the per-cycle replay renders
    the colliding cycle's frame and stops — the reference renders then breaks
    out of its cycle loop (basic_envs.py:1884-1905), so the frozen
    post-collision poses never appear as duplicate stationary frames."""
    import jax.numpy as jnp

    env = gym.make(
        'BenchmarkPlanningEnv-v0', num_movers=1, num_cycles=6,
        render_mode='rgb_array_2d', render_every_cycle=True,
    ).unwrapped
    env.reset(seed=0)
    calls = []
    env.render = lambda: calls.append(np.asarray(env._state.pos).copy())
    pos = jnp.stack([env._state.pos + 0.001 * c for c in range(6)])
    vel = jnp.zeros_like(pos)
    done = jnp.asarray([False, False, True, True, True, True])
    env._render_cycles((pos, vel, done))
    assert len(calls) == 3, 'replay must stop after the colliding cycle frame'
    np.testing.assert_allclose(np.asarray(calls[-1]), np.asarray(pos[2]))
    env.close()


def _kernel_chosen(monkeypatch):
    """Make the path chooser pick the fused kernel on this CPU and build it
    in interpret mode (the kernel compiles for GPUs only)."""
    from functools import partial

    from gymnasium_planar_robotics_tpu.models import planning
    from gymnasium_planar_robotics_tpu.ops import pallas_step

    monkeypatch.setattr(pallas_step, 'use_kernel', pallas_step.supports)
    monkeypatch.setattr(
        planning, 'make_fused_step_autoreset',
        partial(planning.make_fused_step_autoreset, interpret=True, cand_k=2),
    )


def test_vector_env_fused_dispatch_wiring(monkeypatch):
    """The VectorEnv's step follows the one path chooser
    (``ops/pallas_step.use_kernel``): with the kernel chosen, the wiring
    (jit of the fused step, obs/info plumbing) is exercised in interpret
    mode, any batch size included; with it not chosen, the XLA step runs."""
    import jax.numpy as jnp

    from gymnasium_planar_robotics_tpu.envs import vector_env

    plain = vector_env.PlanningVectorEnv(num_envs=8, num_movers=1, num_cycles=6, dtype=jnp.float32)
    assert not plain.using_fused, 'the CPU must take the XLA step'

    _kernel_chosen(monkeypatch)
    venv = vector_env.PlanningVectorEnv(num_envs=128, num_movers=1, num_cycles=6, dtype=jnp.float32)
    assert venv.using_fused, 'the chooser picked the kernel but the env did not use it'
    obs, info = venv.reset(seed=0)
    actions = np.zeros((128, 2), np.float32)
    obs, rew, term, trunc, info = venv.step(actions)
    assert obs['observation'].shape[0] == 128
    assert np.isfinite(rew).all()
    assert 'reset_stalled' in info

    # a batch the kernel block does not divide stays fused (masked tails)
    venv2 = vector_env.PlanningVectorEnv(num_envs=40, num_movers=1, num_cycles=6, dtype=jnp.float32)
    assert venv2.using_fused
    obs2, _ = venv2.reset(seed=0)
    obs2, rew2, term2, trunc2, info2 = venv2.step(np.zeros((40, 2), np.float32))
    assert obs2['observation'].shape[0] == 40 and rew2.shape == (40,)
    assert np.isfinite(rew2).all()


def test_vector_env_fused_dispatch_sharded(monkeypatch):
    """A mesh-sharded VectorEnv keeps the fused kernel (per device under
    shard_map) when the chooser picks it, at any per-device shard size."""
    import jax
    import jax.numpy as jnp

    from gymnasium_planar_robotics_tpu.envs import vector_env
    from gymnasium_planar_robotics_tpu.parallel import sharding

    _kernel_chosen(monkeypatch)
    mesh = sharding.make_mesh(jax.devices()[:2])
    venv = vector_env.PlanningVectorEnv(
        num_envs=64, num_movers=1, num_cycles=4, dtype=jnp.float32, mesh=mesh
    )
    assert venv.using_fused, 'sharded fused dispatch did not engage'
    obs, info = venv.reset(seed=0)
    obs, rew, term, trunc, info = venv.step(np.zeros((64, 2), np.float32))
    assert obs['observation'].shape[0] == 64
    assert np.isfinite(rew).all()
    assert len(venv.device_state.pos.sharding.device_set) == 2

    # per-device shard of 20: a partial block on each device, still fused
    venv2 = vector_env.PlanningVectorEnv(
        num_envs=40, num_movers=1, num_cycles=4, dtype=jnp.float32, mesh=mesh
    )
    assert venv2.using_fused
    obs2, _ = venv2.reset(seed=0)
    obs2, rew2, *_ = venv2.step(np.zeros((40, 2), np.float32))
    assert np.isfinite(rew2).all() and rew2.shape == (40,)


def test_vector_env_render_env0():
    """VectorEnv.render() returns a top-down rgb frame of env 0 instead of
    gymnasium's default NotImplementedError (batch debugging window)."""
    import jax.numpy as jnp

    from gymnasium_planar_robotics_tpu.envs.vector_env import PlanningVectorEnv, PushingVectorEnv

    v = PlanningVectorEnv(num_envs=4, num_movers=2, dtype=jnp.float32)
    v.reset(seed=0)
    frame = v.render()
    assert frame.ndim == 3 and frame.shape[2] == 3 and frame.any()
    v.close()
    p = PushingVectorEnv(num_envs=4, dtype=jnp.float32)
    p.reset(seed=0)
    assert p.render().ndim == 3
    p.close()
