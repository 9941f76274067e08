#!/usr/bin/env python
"""Smoke test of the engine on NVIDIA GPUs: the quickest proof that it runs.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards of one host: the mesh path only

One card drives the main path once, through the entry points users call, at
full width (4096 envs, 40 control cycles per step, float32):

- XLA rollouts (``parallel.rollout.jit_rollout``, uniform random policy, 64
  steps): planning 1 mover on 3x3 tiles (acceleration, jerk, box shape),
  planning 4 movers on 4x4 tiles (circle, box), pushing, pushing with the
  bumpered mesh mover, multi-agent planning with 4 agents;
- the flagship learner (``ppo.make_train_step``, dense pushing, 2048 envs x 25
  steps, hidden (256, 256), 12 features) and a HER learner;
- the Gymnasium, vector and PettingZoo adapters, where those packages exist;
- the fused step kernel (``ops/pallas_step``, compiled for the card through
  Pallas' Triton route) in its per-step and 512-step forms;
- the tests marked ``gpu``.

Each phase compiles (reported as set-up time), runs once, compares with a
reference and asserts.  The reference of an XLA rollout is the same function
on the in-process CPU device at ``std_noise=0`` from one state; the kernel's
reference is the XLA step on the card.  "std_noise=0" zeroes every noise
term, the pushing env's achieved-goal noise included.  Float fields must
agree within ``POS_TOL`` / ``VEL_TOL``; collision, success and done flags
must be equal, except for envs whose reference step passes within
``POS_TOL`` of a decision boundary (a wall, another mover, or the success
threshold) — those exceptions are counted and printed.  Rates are warmed
calls closed by ``block_until_ready``: findings, not benchmark cells.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
any failure exits non-zero before it.  There is no CPU fallback: the script
fails where JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from functools import partial

# the card for the program, the in-process CPU device for references; JAX
# fails at start-up if CUDA is missing, which is what this script wants
os.environ['JAX_PLATFORMS'] = 'cuda,cpu'

import numpy as np  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from gymnasium_planar_robotics_tpu.models import her, multi_agent, planning, ppo, pushing  # noqa: E402
from gymnasium_planar_robotics_tpu.ops import pallas_step  # noqa: E402
from gymnasium_planar_robotics_tpu.parallel import rollout, sharding  # noqa: E402
from gymnasium_planar_robotics_tpu.utils import compile_cache, profiling  # noqa: E402

B = 4096
ROLL_T = 64
CHECK_STEPS = 3
POS_TOL = 1e-4  # m: positions, goals, achieved goals; also the wall-distance band for flag exceptions
VEL_TOL = 1e-3  # m/s and m/s^2: velocities, accelerations, rewards
BOX = {'shape': 'box', 'size': np.array([0.09, 0.09])}
MESH_BUMPER = {'shape': 'mesh', 'mesh': {'bumper_mass': 0.35}}


def say(msg: str) -> None:
    print(msg, flush=True)


def peak_bytes() -> int:
    return int(jax.devices()[0].memory_stats().get('peak_bytes_in_use', 0))


def compile_timed(fn, *args):
    """(compiled, seconds): the lowering and compilation of ``jax.jit(fn)``."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    return compiled, time.perf_counter() - t0


def rate(compiled, args, env_steps: int) -> float:
    times = profiling.time_calls(compiled, *args, warmup=1, reps=3)
    return env_steps / sorted(times)[1]


def to(x, device):
    return jax.device_put(x, device)


# ---------------------------------------------------------------------------
# references and comparisons
# ---------------------------------------------------------------------------


def _planning_flags_at(config, params, pos):
    """(wall, mover) collision flags of one env's [M, 2] pose, no noise."""
    z = jnp.zeros((config.num_movers, 6 if config.collision_shape == 'box' else 2), pos.dtype)
    return planning._collision_checks(config, params, pos, z, z, False, False)


def _pushing_flags_at(config, params, pos):
    z = jnp.zeros((6 if config.collision_shape == 'box' else 2,), pos.dtype)
    return (pushing._wall_collision_with_noise(config, params, pos, z, False),)


def near_boundary(model, config, params, state, actions, tol=POS_TOL):
    """[n] True where the reference step (on the CPU) passes within ``tol`` of
    a decision boundary: in some control cycle a mover is within ``tol`` of a
    wall or another mover (shifting it by ``tol`` in one of 8 directions
    changes a collision flag), or at the step's end a mover's (pushing: the
    object's) distance to its goal is within ``tol`` of the success threshold."""
    cpu = jax.devices('cpu')[0]
    flags_at = partial(_planning_flags_at if model is planning else _pushing_flags_at, config, params)
    shifts = tol * np.array([[1, 0], [-1, 0], [0, 1], [0, -1], [1, 1], [1, -1], [-1, 1], [-1, -1]], np.float32)
    threshold = float(np.asarray(params.threshold_pos))

    @jax.jit
    def go(state, actions):
        cyc = jax.vmap(lambda s, a: model.step_with_cycles(config, params, s, a)[-1])(state, actions)
        pos = cyc[0]  # [n, C, (M,) 2]

        def one(p):
            base = jnp.stack(flags_at(p))
            moved = jax.vmap(lambda d: jnp.stack(flags_at(p + d)))(jnp.asarray(shifts))
            return (moved != base).any()

        walls = jax.vmap(jax.vmap(one))(pos).any(axis=1)
        final = jax.vmap(partial(model.step_autoreset, config, params))(state, actions)[5]['final_observation']
        n = actions.shape[0]
        dist = jnp.linalg.norm((final['achieved_goal'] - final['desired_goal']).reshape(n, -1, 2), axis=-1)
        return walls | (jnp.abs(dist - threshold) < tol).any(axis=1)

    return np.asarray(go(to(state, cpu), to(actions, cpu)))


def _per_env(x) -> np.ndarray:
    x = np.asarray(x)
    return x.reshape(x.shape[0], -1).any(axis=1)


def compare(name, model, config, params, state, actions, ref, got, restarted=None) -> int:
    """Compare one step's outputs, ``ref`` and ``got`` as ``(fields, flags)``
    dicts of batch-leading arrays.  Flags must be equal and float fields
    within ``TOLS`` (default ``POS_TOL``, plus 1e-4 relative); fields other
    than the reward are skipped on ``restarted`` envs, whose new episodes
    come from another generator.  Every env that differs must lie at a
    decision boundary of the reference step (``near_boundary``, evaluated
    on those envs only); returns how many such boundary exceptions there were."""
    (rf, rflags), (gf, gflags) = ref, got
    n = np.asarray(actions).shape[0]
    why = {}
    for key, r in rflags.items():
        why[key] = _per_env(np.asarray(r) != np.asarray(gflags[key]))
    for key, r in rf.items():
        r, g = np.asarray(r, np.float64), np.asarray(gf[key], np.float64)
        bad = _per_env(~(np.abs(r - g) <= TOLS.get(key, POS_TOL) + 1e-4 * np.abs(r)))
        if restarted is not None and key != 'reward':
            bad &= ~restarted
        why[key] = bad
    differ = np.zeros(n, bool)
    for bad in why.values():
        differ |= bad
    if differ.any():
        idx = np.flatnonzero(differ)
        sub = jax.tree_util.tree_map(lambda x: np.asarray(x)[idx], (state, actions))
        near = near_boundary(model, config, params, *sub)
        if not near.all():
            e = idx[~near][0]
            raise AssertionError(f'{name}: {int((~near).sum())} envs differ away from any boundary; '
                                 f'env {e} differs in {[k for k, bad in why.items() if bad[e]]}')
    return int(differ.sum())


def _xla_outputs(model, out):
    state, obs, reward, term, trunc, info = out
    fields = {'pos': state.pos, 'vel': state.vel, 'acc': state.acc, 'reward': reward,
              'obs': obs['observation'], 'achieved': obs['achieved_goal'], 'desired': obs['desired_goal']}
    if model is pushing:
        fields.update(obj_pos=state.obj_pos, obj_vel=state.obj_vel, goal=state.goal)
    else:
        fields.update(goals=state.goals)
    flags = {'wall': info['wall_collision'], 'mover': info['mover_collision'], 'success': info['is_success'],
             'term': term, 'trunc': trunc}
    return fields, flags


# accelerations: a clamped command is (v' - v) / dt, which scales velocity
# rounding by 1/dt = 1000
TOLS = {'vel': VEL_TOL, 'acc': 10 * VEL_TOL, 'reward': VEL_TOL, 'obs': VEL_TOL, 'obj_vel': VEL_TOL,
        'observation': VEL_TOL}


def noiseless(model, make, **kw):
    """``make(std_noise=0, **kw)`` with every noise term zero: the pushing
    env's achieved-goal noise is a parameter of its own."""
    config, params = make(std_noise=0.0, **kw)
    if model is pushing:
        params = dataclasses.replace(params, object_noise=jnp.zeros_like(params.object_noise))
    return config, params


def check_xla_vs_cpu(name, model, config, params, state0, lim, key=0):
    """CHECK_STEPS steps of the batched XLA autoreset step on the card and on
    the CPU from one state (std_noise=0), teacher-forced: both devices step
    the CPU trajectory's state each time."""
    gpu, cpu = jax.devices()[0], jax.devices('cpu')[0]
    step = jax.jit(jax.vmap(partial(model.step_autoreset, config, params)))
    state, exceptions = to(state0, cpu), 0
    for t in range(CHECK_STEPS):
        a = jax.random.uniform(jax.random.PRNGKey(100 + key + t), (B, config.num_movers * 2), jnp.float32, -lim, lim)
        ref = step(state, to(a, cpu))
        got = step(to(state, gpu), to(a, gpu))
        exceptions += compare(f'{name} t={t}', model, config, params, state, a,
                              _xla_outputs(model, ref), _xla_outputs(model, got))
        state = ref[0]
    return exceptions


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_xla_rollouts():
    rows = [
        ('planning 1 mover 3x3 acc', planning, dict(layout_tiles=np.ones((3, 3)), num_movers=1)),
        ('planning 1 mover 3x3 jerk', planning, dict(layout_tiles=np.ones((3, 3)), num_movers=1, learn_jerk=True)),
        ('planning 1 mover 3x3 box', planning, dict(layout_tiles=np.ones((3, 3)), num_movers=1,
                                                      collision_params=BOX)),
        ('planning 4 movers 4x4 circle', planning, dict(layout_tiles=np.ones((4, 4)), num_movers=4)),
        ('planning 4 movers 4x4 box', planning, dict(layout_tiles=np.ones((4, 4)), num_movers=4,
                                                       collision_params=BOX)),
        ('pushing', pushing, {}),
        ('pushing mesh mover + bumper', pushing, dict(mover_params=MESH_BUMPER)),
    ]
    make = {planning: planning.make_planning_env, pushing: pushing.make_pushing_env}
    for name, model, kw in rows:
        config, params = make[model](dtype=jnp.float32, std_noise=1e-5, **kw)
        lim = float(params.j_max if config.learn_jerk else params.a_max)
        state, obs, _ = model.init_batch(config, params, jax.random.PRNGKey(0), B)
        policy = rollout.uniform_policy(config.num_movers * 2, -lim, lim)
        fn = rollout.make_rollout_fn(config, params, model.step_autoreset, policy, ROLL_T)
        args = (state, obs, jax.random.PRNGKey(1))
        compiled, t_c = compile_timed(fn, *args)
        out = jax.block_until_ready(compiled(*args))
        assert np.isfinite(np.asarray(out[3]['reward_mean'])).all(), name
        assert out[0].pos.shape[0] == B
        r = rate(compiled, args, B * ROLL_T)
        config0, params0 = noiseless(model, make[model], dtype=jnp.float32, **kw)
        exc = check_xla_vs_cpu(name, model, config0, params0, state, lim)
        say(f'[xla rollout] {name}: {B} envs x {ROLL_T} steps, compile {t_c:.1f} s (set-up), '
            f'{r:,.0f} env-steps/s (finding, not a benchmark cell), peak {peak_bytes()} B; '
            f'matches CPU over {CHECK_STEPS} steps at std_noise=0, {exc} boundary exceptions')


def phase_multi_agent():
    config, params = planning.make_planning_env(np.ones((4, 4)), 4, std_noise=1e-5, dtype=jnp.float32)
    state, _, _ = planning.init_batch(config, params, jax.random.PRNGKey(0), B)
    inner = multi_agent.make_batched_parallel_step(config, params, jit=False)

    def roll(state, key):
        def body(s, k):
            a = jax.random.uniform(k, (B, 4, 2), jnp.float32, -10.0, 10.0)
            s, out = inner(s, a)
            return s, out.reward.mean()

        return jax.lax.scan(body, state, jax.random.split(key, ROLL_T))

    args = (state, jax.random.PRNGKey(1))
    compiled, t_c = compile_timed(roll, *args)
    s, rews = jax.block_until_ready(compiled(*args))
    assert np.isfinite(np.asarray(rews)).all()
    r = rate(compiled, args, B * ROLL_T)
    # reference: the per-agent step on the CPU, teacher-forced, std_noise=0
    config0, params0 = planning.make_planning_env(np.ones((4, 4)), 4, std_noise=0.0, dtype=jnp.float32)
    step0 = multi_agent.make_batched_parallel_step(config0, params0)
    gpu, cpu = jax.devices()[0], jax.devices('cpu')[0]
    fields = ('observation', 'achieved_goal', 'desired_goal', 'reward')

    def outputs(out):
        return {k: getattr(out, k) for k in fields}, {'term': out.terminated, 'trunc': out.truncated}

    st, exc = to(state, cpu), 0
    for t in range(CHECK_STEPS):
        a = jax.random.uniform(jax.random.PRNGKey(200 + t), (B, 4, 2), jnp.float32, -10.0, 10.0)
        s_ref, ref = step0(st, to(a, cpu))
        _, got = step0(to(st, gpu), to(a, gpu))
        exc += compare(f'multi-agent t={t}', planning, config0, params0, st, a.reshape(B, 8),
                       outputs(ref), outputs(got))
        st = s_ref
    say(f'[xla rollout] multi-agent planning 4 agents x {B} envs x {ROLL_T} steps: compile {t_c:.1f} s (set-up), '
        f'{r:,.0f} env-steps/s (finding, not a benchmark cell), peak {peak_bytes()} B; '
        f'matches CPU over {CHECK_STEPS} steps at std_noise=0, {exc} boundary exceptions')


def _pushing_vec(obs):
    mp = obs['observation'][..., :2]
    ag, dg = obs['achieved_goal'], obs['desired_goal']
    return jnp.concatenate([obs['observation'], ag, dg, ag - mp, dg - ag], -1).astype(jnp.float32)


def phase_ppo():
    """The flagship recipe's shapes (tools/train_push_strong.py, 'big')."""
    b = 2048
    cfg = ppo.PPOConfig(obs_dim=12, action_dim=2, hidden=(256, 256), rollout_steps=25, action_scale=10.0)
    results = {}
    runs = (('timed', 1e-5, jax.devices()[0]), ('card', 0.0, jax.devices()[0]), ('cpu', 0.0, jax.devices('cpu')[0]))
    for label, std, device in runs:
        config, params = pushing.make_pushing_env(std_noise=std, dtype=jnp.float32, reward_mode='dense')
        train_step, opt = ppo.make_train_step(config, params, cfg, pushing.step_autoreset, obs_to_vec=_pushing_vec)
        with jax.default_device(device):
            state, obs, _ = pushing.init_batch(config, params, jax.random.PRNGKey(1), b)
            pol = ppo.init_params(jax.random.PRNGKey(0), cfg)
            runner = (state, _pushing_vec(obs), pol, opt.init(pol), jax.random.PRNGKey(2))
            runner = to(runner, device)
            compiled, t_c = compile_timed(train_step, runner)
            out, m = jax.block_until_ready(compiled(runner))
            results[label] = {k: float(v) for k, v in m.items()}
            assert all(np.isfinite(v) for v in results[label].values()), (label, results[label])
            if label == 'timed':
                it = rate(compiled, (runner,), b * cfg.rollout_steps)
                say(f'[learner] PPO dense pushing {b} envs x {cfg.rollout_steps} steps, hidden (256, 256), '
                    f'matmuls at default precision (TF32): compile {t_c:.1f} s (set-up), {it:,.0f} env-steps/s '
                    f'of full train iterations (finding, not a benchmark cell), peak {peak_bytes()} B, '
                    f'loss {m["loss"]:.4f}')
    g, c = results['card'], results['cpu']
    # the learner's TF32 matmuls move actions by ~1e-3 relative, so the
    # iteration's aggregates agree with the float32 CPU run only loosely
    assert abs(g['reward_mean'] - c['reward_mean']) <= 0.02 * abs(c['reward_mean']) + 0.01, (g, c)
    assert abs(g['done_rate'] - c['done_rate']) <= 0.01, (g, c)
    assert abs(g['loss'] - c['loss']) <= 0.1 * abs(c['loss']) + 0.05, (g, c)
    say(f'[learner] PPO GPU vs CPU at std_noise=0: reward_mean {g["reward_mean"]:.4f} vs {c["reward_mean"]:.4f}, '
        f'loss {g["loss"]:.4f} vs {c["loss"]:.4f} (TF32 learner tolerance: 2% reward, 10% loss)')


HER_CFG = her.HERConfig(
    obs_dim=8, goal_dim=2, action_dim=2, hidden=(256, 256), action_scale=10.0, rollout_steps=50,
    relabel_prob=0.8, update_steps=20, gamma=0.95, replay_size=1_000_000, minibatch=4096,
)


def _her_learner(config, params, b, batched_step_fn=None):
    """(HER train step on pushing, its initial runner for ``b`` envs); the
    env step is ``batched_step_fn``, or the vmapped XLA step without it."""
    cfg = HER_CFG
    vec = lambda o, a, d: jnp.concatenate([o, a, d, a - o[..., :2], d - a], -1)  # noqa: E731
    train_step, (a_opt, c_opt) = her.make_train_step(
        config, params, cfg, None if batched_step_fn else pushing.step_autoreset,
        lambda ach, des, mc, wc: pushing.compute_reward(params, ach, des, wc), lambda r: r == -50.0,
        vec_fn=vec, batched_step_fn=batched_step_fn,
    )
    state, obs, _ = pushing.init_batch(config, params, jax.random.PRNGKey(1), b)
    pol = her.init_params(jax.random.PRNGKey(0), cfg)
    runner = (state, obs, pol, a_opt.init(pol['actor']), c_opt.init(pol['critic']), her.init_replay(cfg),
              jax.random.PRNGKey(2))
    return train_step, runner


def phase_her():
    b, cfg = 512, HER_CFG
    config, params = pushing.make_pushing_env(std_noise=1e-5, dtype=jnp.float32)
    step = pallas_step.batched_autoreset_step(pushing, config, params)
    assert step.uses_kernel, 'the path chooser did not pick the fused kernel on the GPU'
    train_step, runner = _her_learner(config, params, b, step)
    compiled, t_c = compile_timed(train_step, runner)
    metrics = []
    t0 = time.perf_counter()
    for _ in range(3):
        runner, m = compiled(runner)
        metrics.append({k: float(v) for k, v in m.items()})
    dt = (time.perf_counter() - t0) / 3
    assert all(np.isfinite(v) for mm in metrics for v in mm.values()), metrics
    assert int(runner[5]['filled']) == 3 * 2 * cfg.rollout_steps * b
    assert (np.asarray(runner[0].steps) >= 0).all() and (np.asarray(runner[0].steps) <= 50).all()
    say(f'[learner] HER pushing {b} envs x {cfg.rollout_steps} steps over the fused kernel, hidden (256, 256): '
        f'compile {t_c:.1f} s (set-up), {dt * 1e3:.1f} ms per iteration (finding, not a benchmark cell), '
        f'critic loss {metrics[-1]["critic_loss"]:.4f}, replay filled as expected, peak {peak_bytes()} B')
    # reference: one iteration through the XLA step at std_noise=0 on the
    # card and on the CPU, from one runner (the same keys draw the same
    # exploration noise, relabelling and minibatches on both devices)
    config0, params0 = noiseless(pushing, pushing.make_pushing_env, dtype=jnp.float32)
    results = {}
    for label, device in (('card', jax.devices()[0]), ('cpu', jax.devices('cpu')[0])):
        with jax.default_device(device):
            train0, runner0 = _her_learner(config0, params0, b)
            _, m = jax.jit(train0)(to(runner0, device))
            results[label] = {k: float(v) for k, v in m.items()}
    g, c = results['card'], results['cpu']
    say(f'[learner] HER GPU vs CPU at std_noise=0 over the XLA step: reward_mean {g["reward_mean"]:.4f} vs '
        f'{c["reward_mean"]:.4f}, critic loss {g["critic_loss"]:.4f} vs {c["critic_loss"]:.4f}, actor loss '
        f'{g["actor_loss"]:.4f} vs {c["actor_loss"]:.4f} (TF32 learner tolerance: 1% reward, 3% losses)')
    # the card's TF32 matmuls move the actor's actions and the 20 updates'
    # gradients by ~1e-3 relative; on an H100 the three aggregates agreed
    # with the float32 CPU run within 0.06%
    assert all(np.isfinite(v) for v in g.values()), g
    assert abs(g['reward_mean'] - c['reward_mean']) <= 0.01 * abs(c['reward_mean']) + 0.01, (g, c)
    for k in ('critic_loss', 'actor_loss'):
        assert abs(g[k] - c[k]) <= 0.03 * abs(c[k]), (k, g, c)


def phase_adapters():
    try:
        import gymnasium as gym
    except ImportError:
        say('[adapters] gymnasium is not installed here: Gymnasium and vector adapters not run '
            '(an optional package, not a failure)')
        return
    import gymnasium_planar_robotics_tpu  # noqa: F401  (registers the env ids)
    from gymnasium_planar_robotics_tpu.envs.vector_env import PlanningVectorEnv

    env = gym.make('BenchmarkPushingEnv-v0')
    obs, _ = env.reset(seed=0)
    t0 = time.perf_counter()
    for _ in range(50):
        obs, rew, term, trunc, info = env.step(env.action_space.sample())
        assert np.isfinite(rew)
        if term or trunc:
            obs, _ = env.reset()
    dt = (time.perf_counter() - t0) / 50
    env.close()
    venv = PlanningVectorEnv(num_envs=64, dtype=jnp.float32)
    assert venv.using_fused, 'VectorEnv did not take the fused kernel on the GPU'
    venv.reset(seed=0)
    for _ in range(5):
        obs, rew, term, trunc, info = venv.step(venv.action_space.sample())
        assert np.isfinite(rew).all() and rew.shape == (64,)
    say(f'[adapters] gym.make BenchmarkPushingEnv-v0: 50 steps, {dt * 1e3:.2f} ms per step (finding); '
        'PlanningVectorEnv 64 envs on the fused kernel: 5 steps ok')
    try:
        from gymnasium_planar_robotics_tpu.envs.pettingzoo_env import PlanningParallelEnv
    except ImportError:
        say('[adapters] pettingzoo is not installed here: PettingZoo adapter not run '
            '(an optional package, not a failure)')
        return
    penv = PlanningParallelEnv(num_movers=4, layout_tiles=np.ones((4, 4)))
    obs, _ = penv.reset(seed=0)
    for _ in range(5):
        obs, rew, term, trunc, info = penv.step({a: penv.action_space(a).sample() for a in penv.agents})
        if not penv.agents:
            obs, _ = penv.reset()
    say('[adapters] PlanningParallelEnv 4 agents: 5 steps ok')


def _kernel_cases():
    plan = lambda **kw: planning.make_planning_env(np.ones((3, 3)), 1, dtype=jnp.float32, **kw)  # noqa: E731
    return [
        ('planning acc', planning, plan),
        ('planning jerk', planning, partial(plan, learn_jerk=True)),
        ('planning box', planning, partial(plan, collision_params=BOX)),
        ('pushing', pushing, partial(pushing.make_pushing_env, dtype=jnp.float32)),
        ('pushing mesh + bumper', pushing, partial(pushing.make_pushing_env, dtype=jnp.float32,
                                                   mover_params=MESH_BUMPER)),
    ]


def _reset_rows_valid(model, config, params, state, restarted):
    """Restarted envs start where the sampler may put them."""
    lo, hi = np.asarray(params.min_xy), np.asarray(params.max_xy)
    if model is planning:
        from gymnasium_planar_robotics_tpu.models.common import IDENTITY_QUAT
        from gymnasium_planar_robotics_tpu.ops import walls

        c = params.c_size + params.c_offset + params.c_offset_wall
        for xy in (np.asarray(state.pos)[restarted, 0], np.asarray(state.goals)[restarted, 0]):
            quat = np.tile(np.asarray([IDENTITY_QUAT], np.float32), (len(xy), 1))
            ok = walls.qpos_is_valid(params.grid, jnp.asarray(xy), jnp.broadcast_to(c, (len(xy),) + c.shape[1:]),
                                     quat=jnp.asarray(quat), collision_shape=config.collision_shape)
            assert np.asarray(ok).all(), 'a kernel restart is wall-invalid'
            assert ((xy >= lo - 1e-6) & (xy <= hi + 1e-6)).all()
    else:
        pos, obj = np.asarray(state.pos)[restarted], np.asarray(state.obj_pos)[restarted]
        assert ((pos >= lo - 1e-6) & (pos <= hi + 1e-6)).all()
        assert (np.linalg.norm(obj - pos, axis=-1) > float(params.min_mo_dist) - 1e-6).all()
    assert (np.asarray(state.steps)[restarted] == 0).all()


def phase_kernel():
    gpu = jax.devices()[0]
    for name, model, make in _kernel_cases():
        config, params = noiseless(model, make)
        assert pallas_step.batched_autoreset_step(model, config, params).uses_kernel
        lim = float(params.j_max if config.learn_jerk else params.a_max)
        state, _, _ = model.init_batch(config, params, jax.random.PRNGKey(0), B)
        a = jax.random.uniform(jax.random.PRNGKey(1), (B, 2), jnp.float32, -lim, lim)
        fused, t_c1 = compile_timed(model.make_fused_step_autoreset(config, params), state, a)
        xla = jax.jit(jax.vmap(partial(model.step_autoreset, config, params)))
        # per-step form vs the XLA step on the card, from identical states
        st, exc, restarts = state, 0, 0
        for t in range(CHECK_STEPS):
            a = jax.random.uniform(jax.random.PRNGKey(10 + t), (B, 2), jnp.float32, -lim, lim)
            ref, got = xla(st, a), fused(st, a)
            rf, rflags = _xla_outputs(model, ref)
            done = np.asarray(rflags['term']) | np.asarray(rflags['trunc'])
            # restarted envs draw from the kernel's own generator: compare
            # their reward and flags, check that the restarts are valid
            exc += compare(f'kernel {name} t={t}', model, config, params, st, a, (rf, rflags),
                           _xla_outputs(model, got), restarted=done)
            same = done == (np.asarray(got[3]) | np.asarray(got[4]))
            stalled = np.asarray(got[5]['reset_stalled'])
            _reset_rows_valid(model, config, params, got[0], done & same & ~stalled)
            restarts += int((done & ~stalled).sum())
            st = ref[0]
        # the 512-step form: one launch
        config, params = make(std_noise=1e-5)
        acts = jax.random.uniform(jax.random.PRNGKey(2), (512, B, 2), jnp.float32, -lim, lim)
        roll, t_c2 = compile_timed(model.make_fused_rollout(config, params), state, acts, 0)
        fs, rew, term, trunc = jax.block_until_ready(roll(state, acts, 0))
        assert np.isfinite(np.asarray(rew)).all() and np.isfinite(np.asarray(fs.pos)).all()
        assert np.asarray(term | trunc).mean() > 0.01, 'no episode ended in 512 steps'
        r = rate(roll, (state, acts, 0), B * 512)
        say(f'[kernel] {name}: Triton kernel on {gpu.device_kind}, compile {t_c1:.1f} s per-step + {t_c2:.1f} s '
            f'512-step (set-up); per-step form matches the XLA step over {CHECK_STEPS} steps at std_noise=0 '
            f'({exc} boundary exceptions, {restarts} valid restarts); 512-step form {r:,.0f} env-steps/s '
            f'(finding, not a benchmark cell), peak {peak_bytes()} B')


def phase_gpu_tests():
    import pytest

    here = os.path.dirname(os.path.abspath(__file__))
    # in this process (it holds the card); the file that holds them imports
    # no optional package, and no worker processes are started
    rc = pytest.main(['-q', '-o', 'addopts=', '-m', 'gpu', '-p', 'no:cacheprovider',
                      os.path.join(here, 'tests', 'test_pallas_step.py')])
    assert rc == 0, f'tests marked gpu failed (pytest exit code {rc})'
    say('[gpu tests] the tests marked gpu passed on the card')


# ---------------------------------------------------------------------------
# four cards: the mesh path only
# ---------------------------------------------------------------------------

_COLLECTIVES = ('all-reduce', 'all-gather', 'collective-permute', 'all-to-all', 'reduce-scatter')


def _rows_per_card(x, mesh):
    rows = {s.data.shape[0] for s in x.addressable_shards}
    assert rows == {x.shape[0] // mesh.size}, f'cards hold {rows} rows, expected {x.shape[0] // mesh.size}'
    assert len(x.sharding.device_set) == mesh.size


def _identical(a, b) -> bool:
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


def _agreeing_share(a, b, tol=1e-5) -> float:
    """Share of envs whose every float state field agrees within ``tol``
    (absolute and relative) between two runs of one rollout."""
    ok = np.ones(np.asarray(a.pos).shape[0], bool)
    for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)):
        x, y = np.asarray(x), np.asarray(y)
        if np.issubdtype(x.dtype, np.floating):
            ok &= ~_per_env(~(np.abs(x - y) <= tol + tol * np.abs(y)))
    return float(ok.mean())


# The sharded XLA rollout is not bit-identical to the one-card rollout for
# pushing: on four H100s one env of 4096 (share 0.9998) left 1e-5 after 64
# steps, planning was bit-identical.  Why the partitioned program rounds
# differently was not traced (no HLO diff yet); contact dynamics amplify an
# ulp over a rollout.  Whole XLA rollouts must agree on this share of envs
# (at most 4 of 4096 may leave 1e-5), single steps from identical states
# within the POS_TOL / VEL_TOL rules of ``compare``.  The kernel keys its
# noise by global env index, so both of its sharded forms must be
# bit-identical to one card.
ROLLOUT_AGREE = 0.999


def four_cards():
    devices = jax.devices()
    assert len(devices) == 4, f'need 4 GPUs, got {devices}'
    mesh = sharding.make_mesh(devices)
    sh = sharding.batch_sharding(mesh)
    one = devices[0]
    for name, model, make in (('planning', planning, partial(planning.make_planning_env, np.ones((3, 3)), 1)),
                              ('pushing', pushing, pushing.make_pushing_env)):
        config, params = make(std_noise=1e-5, dtype=jnp.float32)
        state, obs, _ = model.init_batch(config, params, jax.random.PRNGKey(0), B)
        policy = rollout.uniform_policy(2, -10.0, 10.0)
        # sharded XLA rollout vs the same rollout on one card
        roll_m = rollout.jit_rollout(config, params, model.step_autoreset, policy, ROLL_T, mesh=mesh)
        roll_1 = rollout.jit_rollout(config, params, model.step_autoreset, policy, ROLL_T)
        t0 = time.perf_counter()
        out_m = jax.block_until_ready(roll_m(jax.device_put(state, sh), jax.device_put(obs, sh), jax.random.PRNGKey(1)))
        t_c = time.perf_counter() - t0
        out_1 = roll_1(to(state, one), to(obs, one), to(jax.random.PRNGKey(1), one))
        _rows_per_card(out_m[0].pos, mesh)
        xla_share = _agreeing_share(out_m[0], out_1[0])
        assert xla_share >= ROLLOUT_AGREE, f'{name}: only {xla_share:.4f} of envs agree after the sharded rollout'
        r = rate(roll_m, (jax.device_put(state, sh), jax.device_put(obs, sh), jax.random.PRNGKey(1)), B * ROLL_T)
        # the sharded XLA step from identical states, teacher-forced
        config0, params0 = noiseless(model, make, dtype=jnp.float32)
        step = jax.jit(jax.vmap(partial(model.step_autoreset, config0, params0)))
        st, exc = to(state, one), 0
        for t in range(CHECK_STEPS):
            a = jax.random.uniform(jax.random.PRNGKey(300 + t), (B, 2), jnp.float32, -10.0, 10.0)
            ref, got = step(st, to(a, one)), step(jax.device_put(st, sh), jax.device_put(a, sh))
            _rows_per_card(got[0].pos, mesh)
            exc += compare(f'{name} sharded XLA step t={t}', model, config0, params0, st, a,
                           _xla_outputs(model, ref), _xla_outputs(model, got))
            st = ref[0]
        # the kernel under shard_map: per-step form and one-launch form
        step_m = sharding.make_sharded_fused_step(model, config, params, mesh)
        a = jax.random.uniform(jax.random.PRNGKey(3), (B, 2), jnp.float32, -10.0, 10.0)
        txt = jax.jit(step_m, in_shardings=(sh, sh)).lower(jax.device_put(state, sh), jax.device_put(a, sh)).compile().as_text()
        found = [c for c in _COLLECTIVES if c in txt]
        assert not found, f'{name}: the sharded step HLO has collectives {found}'
        got_m = jax.jit(step_m)(jax.device_put(state, sh), jax.device_put(a, sh))
        got_1 = jax.jit(model.make_fused_step_autoreset(config, params))(to(state, one), to(a, one))
        _rows_per_card(got_m[0].pos, mesh)
        assert _identical(got_m, got_1), f'{name}: the sharded kernel step differs from one card'
        acts = jax.random.uniform(jax.random.PRNGKey(4), (ROLL_T, B, 2), jnp.float32, -10.0, 10.0)
        fr_m = sharding.make_sharded_fused_rollout(model, config, params, mesh)
        fr_1 = model.make_fused_rollout(config, params)
        out_fm = jax.jit(fr_m)(jax.device_put(state, sh), jax.device_put(acts, NamedSharding(mesh, P(None, 'data'))), 5)
        out_f1 = jax.jit(fr_1)(to(state, one), to(acts, one), 5)
        _rows_per_card(out_fm[0].pos, mesh)
        assert _identical(out_fm, out_f1), f'{name}: the sharded one-launch rollout differs from one card'
        say(f'[four cards] {name}: {B} envs, {B // 4} per card; sharded jit_rollout vs one card: '
            f'{ROLL_T}-step final states bit-identical {_identical(out_m[0], out_1[0])}, {xla_share:.4f} of envs '
            f'within 1e-5 (bound {ROLLOUT_AGREE}); first call {t_c:.1f} s (set-up), {r:,.0f} env-steps/s over 4 cards '
            f'(finding); sharded XLA step matches over {CHECK_STEPS} steps at std_noise=0, {exc} boundary '
            f'exceptions; kernel under shard_map: per-step form and one-launch {ROLL_T}-step form bit-identical; '
            f'step HLO has no collectives')
    # one data-parallel PPO step vs the same step on one card
    config, params = pushing.make_pushing_env(std_noise=1e-5, dtype=jnp.float32, reward_mode='dense')
    cfg = ppo.PPOConfig(obs_dim=12, action_dim=2, hidden=(256, 256), rollout_steps=25, action_scale=10.0)
    train_step, opt = ppo.make_train_step(config, params, cfg, pushing.step_autoreset, obs_to_vec=_pushing_vec)
    state, obs, _ = pushing.init_batch(config, params, jax.random.PRNGKey(1), 2048)
    pol = ppo.init_params(jax.random.PRNGKey(0), cfg)
    runner = (state, _pushing_vec(obs), pol, opt.init(pol), jax.random.PRNGKey(2))
    rep = sharding.replicated(mesh)
    runner_m = (jax.device_put(runner[0], sh), jax.device_put(runner[1], sh), *jax.device_put(runner[2:], rep))
    out_m, m_m = jax.jit(train_step)(runner_m)
    out_1, m_1 = jax.jit(train_step)(to(runner, one))
    _rows_per_card(out_m[0].pos, mesh)
    g, c = {k: float(v) for k, v in m_m.items()}, {k: float(v) for k, v in m_1.items()}
    assert all(np.isfinite(v) for v in g.values()), g
    # the same program, partitioned: the reductions sum in another order
    assert abs(g['reward_mean'] - c['reward_mean']) <= 1e-3 * abs(c['reward_mean']) + 1e-3, (g, c)
    assert abs(g['loss'] - c['loss']) <= 0.05 * abs(c['loss']) + 0.05, (g, c)
    say(f'[four cards] data-parallel PPO step (2048 envs, 512 per card): loss {g["loss"]:.4f} vs one card '
        f'{c["loss"]:.4f}, reward_mean {g["reward_mean"]:.4f} vs {c["reward_mean"]:.4f}')


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--four-cards', action='store_true', help='run only the path across four cards')
    args = ap.parse_args()
    device = jax.devices()[0]
    if device.platform != 'gpu':
        print(f'chip_smoke: no GPU (JAX found {device.platform}); nothing was run', file=sys.stderr)
        return 1
    compile_cache.enable()
    say(profiling.gpu_name_and_power_limit())
    say(f'jax {jax.__version__}, XLA_FLAGS={os.environ.get("XLA_FLAGS", "")!r}, '
        f'compile cache {compile_cache.cache_dir()}, devices {jax.devices()}')
    if args.four_cards:
        four_cards()
    else:
        for phase in (phase_xla_rollouts, phase_multi_agent, phase_ppo, phase_her, phase_adapters,
                      phase_kernel, phase_gpu_tests):
            t0 = time.perf_counter()
            phase()
            say(f'  ({phase.__name__} took {time.perf_counter() - t0:.1f} s)')
    print(json.dumps({'ok': True, 'device': {'platform': device.platform, 'kind': device.device_kind,
                                             'count': len(jax.devices())}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
