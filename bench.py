"""Throughput benchmark: the batched env engine on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device"}.

Headline config (BASELINE.json): pushing env, 4096 envs, env-steps/s on one
device, compared against the reference's measured single-core CPU rate
(BASELINE.md: ~79 env-steps/s for the pushing env).  One env-step =
num_cycles (40) physics sub-steps of 1 ms, exactly as in the reference.
Run ``python bench.py --suite`` for the full BASELINE.md config table.
Every result names the device it ran on; the fused-kernel rows need an
NVIDIA GPU and fail elsewhere.  Times are warmed calls closed by
``jax.block_until_ready`` (``utils/profiling.time_calls``), median of 5.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


BATCH = 4096
ROLLOUT_T = 512  # env-steps per jitted rollout call


def _rate(fn, args, env_steps_per_call: int) -> float:
    """env-steps/s of ``fn(*args)``: median of 5 warmed, blocked calls."""
    from gymnasium_planar_robotics_tpu.utils.profiling import time_calls

    t_c = time.perf_counter()
    jax.block_until_ready(fn(*args))
    _log(f'bench: compiled + first call in {time.perf_counter() - t_c:.1f}s (set-up)')
    times = sorted(time_calls(fn, *args, warmup=0, reps=5))
    return env_steps_per_call / times[len(times) // 2]


def _device() -> dict:
    """The device every result was measured on."""
    from gymnasium_planar_robotics_tpu.utils.profiling import gpu_name_and_power_limit

    d = jax.devices()[0]
    return {'platform': d.platform, 'kind': d.device_kind, 'count': len(jax.devices()),
            'nvidia_smi': gpu_name_and_power_limit()}


# reference CPU rates (BASELINE.md: the reference MuJoCo envs, one CPU core)
REF_PUSHING = 79.0
REF_PLANNING_1 = 134.0
REF_PLANNING_4 = 35.0


def _throughput(config, params, step_autoreset_fn, init_batch_fn, action_dim, batch):
    from gymnasium_planar_robotics_tpu.parallel import rollout as rollout_lib

    _log(f'bench: init {batch} envs on {jax.default_backend()}')
    state, obs, _ = jax.block_until_ready(init_batch_fn(config, params, jax.random.PRNGKey(0), batch))
    policy = rollout_lib.uniform_policy(action_dim, -10.0, 10.0)
    roll = rollout_lib.jit_rollout(config, params, step_autoreset_fn, policy, ROLLOUT_T)
    return _rate(roll, (state, obs, jax.random.PRNGKey(1)), batch * ROLLOUT_T)


def bench_pushing(batch=BATCH, n_mesh_devices=None, **env_kwargs):
    """Pushing through the per-step fused kernel, one launch per env step
    inside a jitted scan."""
    from gymnasium_planar_robotics_tpu.models import pushing

    config, params = pushing.make_pushing_env(std_noise=1e-5, dtype=jnp.float32, **env_kwargs)
    return _kernel_step_rate(pushing, config, params, batch, n_mesh_devices)


def _kernel_step_rate(model, config, params, batch: int, n_mesh_devices=None) -> float:
    """Rate of ``ROLLOUT_T`` uniform-random steps of the per-step fused kernel
    (GPU only) in a jitted scan, per device under ``shard_map`` when
    ``n_mesh_devices`` is given."""
    from gymnasium_planar_robotics_tpu.ops import pallas_step
    from gymnasium_planar_robotics_tpu.parallel import sharding

    state, obs, _ = jax.block_until_ready(model.init_batch(config, params, jax.random.PRNGKey(0), batch))
    mesh = None
    if n_mesh_devices is not None:
        mesh = sharding.make_mesh(jax.devices()[:n_mesh_devices])
        state = sharding.shard_batch(state, mesh)
    step = pallas_step.batched_autoreset_step(model, config, params, mesh)
    if not step.uses_kernel:
        raise RuntimeError(f'the fused kernel does not run on {jax.default_backend()!r} for this configuration')
    a_lim = float(np.asarray(params.j_max if config.learn_jerk else params.a_max))

    @jax.jit
    def roll(state, key):
        def body(s, k):
            a = jax.random.uniform(k, (batch, 2), jnp.float32, -a_lim, a_lim)
            s, o, r, te, tr, i = step(s, a)
            return s, r.mean()

        return jax.lax.scan(body, state, jax.random.split(key, ROLLOUT_T))

    return _rate(roll, (state, jax.random.PRNGKey(1)), batch * ROLLOUT_T)


def bench_planning(batch=BATCH, num_movers=1, layout=None, **env_kwargs):
    """Planning through the vmapped XLA ``step_autoreset`` (``jit_rollout``)."""
    from gymnasium_planar_robotics_tpu.models import planning

    config, params = planning.make_planning_env(
        layout_tiles=np.ones((3, 3)) if layout is None else layout,
        num_movers=num_movers,
        std_noise=1e-5,
        dtype=jnp.float32,
        **env_kwargs,
    )
    return _throughput(config, params, planning.step_autoreset, planning.init_batch, num_movers * 2, batch)


def _scaling_worker(n_devices: int, batch: int) -> float:
    """Measure sharded planning throughput on an n-device CPU mesh (this
    process must be launched with the matching XLA device-count flag)."""
    from gymnasium_planar_robotics_tpu.models import planning
    from gymnasium_planar_robotics_tpu.parallel import rollout as rollout_lib, sharding

    config, params = planning.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, dtype=jnp.float32)
    mesh = sharding.make_mesh(jax.devices()[:n_devices])
    state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(0), batch)
    state = sharding.shard_batch(state, mesh)
    obs = sharding.shard_batch(obs, mesh)
    policy = rollout_lib.uniform_policy(2, -10.0, 10.0)
    roll = rollout_lib.jit_rollout(config, params, planning.step_autoreset, policy, 16, mesh=mesh)
    from gymnasium_planar_robotics_tpu.utils.profiling import time_calls

    times = time_calls(roll, state, obs, jax.random.PRNGKey(1), reps=3)
    return batch * 16 / sorted(times)[1]


def _run_scaling() -> None:
    """Weak-scaling sweep over a virtual CPU device mesh (multi-host proxy:
    batch per device held constant; efficiency = rate_N / (N * rate_1)).
    The children run on the CPU only and this process opens no device while
    they run."""
    import os
    import subprocess

    per_device = 2048
    # virtual devices share physical cores: past nproc the sweep measures
    # oversubscription, not sharding overhead — judge efficiency at <= nproc
    max_fair = min(8, os.cpu_count() or 8)
    rates = {}
    for n in (1, 2, 4, 8):
        env = dict(os.environ)
        env['JAX_PLATFORMS'] = 'cpu'
        env['XLA_FLAGS'] = f'--xla_force_host_platform_device_count={n}'
        env['GPRT_SCALING_N'] = str(n)
        env['GPRT_SCALING_B'] = str(per_device * n)
        out = subprocess.run(
            [sys.executable, __file__, '--scaling-inner'], env=env, capture_output=True, text=True, check=True
        )
        rates[n] = float(out.stdout.strip().splitlines()[-1])
        _log(f'scaling: {n} CPU devices -> {rates[n]:.0f} env-steps/s')
    n_eff = max(k for k in rates if k <= max_fair)
    eff = rates[n_eff] / (n_eff * rates[1])
    print(json.dumps({
        'metric': f'weak-scaling efficiency, {n_eff}-device CPU mesh (2048 envs/device; {max_fair} physical cores)',
        'value': round(eff, 3), 'unit': 'fraction', 'vs_baseline': round(eff / 0.8, 2),
        'device': {'platform': 'cpu', 'kind': 'virtual host devices', 'count': n_eff},
    }))


def bench_planning_fused(batch=BATCH, layout=None, n_mesh_devices=None, **env_kwargs):
    """1-mover planning through the per-step fused kernel in a jitted scan.
    ``env_kwargs`` forwards to ``make_planning_env`` (jerk mode, box shape)."""
    from gymnasium_planar_robotics_tpu.models import planning

    config, params = planning.make_planning_env(
        layout_tiles=np.ones((3, 3)) if layout is None else layout,
        num_movers=1, std_noise=1e-5, dtype=jnp.float32, **env_kwargs,
    )
    return _kernel_step_rate(planning, config, params, batch, n_mesh_devices)


def _one_launch_rate(model, config, params, batch: int) -> float:
    state, obs, _ = jax.block_until_ready(model.init_batch(config, params, jax.random.PRNGKey(0), batch))
    roll_fn = model.make_fused_rollout(config, params)
    a_lim = float(np.asarray(params.j_max if config.learn_jerk else params.a_max))

    @jax.jit
    def roll(state, key, seed):
        acts = jax.random.uniform(key, (ROLLOUT_T, batch, 2), jnp.float32, -a_lim, a_lim)
        s, rew, te, tr = roll_fn(state, acts, seed)
        return s, rew.mean()

    return _rate(roll, (state, jax.random.PRNGKey(1), 0), batch * ROLLOUT_T)


def bench_planning_rollout(batch=BATCH, **env_kwargs):
    """1-mover planning: ``ROLLOUT_T`` steps as ONE fused-kernel launch
    (``planning.make_fused_rollout``; GPU only)."""
    from gymnasium_planar_robotics_tpu.models import planning

    config, params = planning.make_planning_env(
        np.ones((3, 3)), 1, std_noise=1e-5, dtype=jnp.float32, **env_kwargs
    )
    return _one_launch_rate(planning, config, params, batch)


def bench_pushing_rollout(batch=BATCH, **env_kwargs):
    """Pushing: ``ROLLOUT_T`` steps as ONE fused-kernel launch
    (``pushing.make_fused_rollout``; GPU only)."""
    from gymnasium_planar_robotics_tpu.models import pushing

    config, params = pushing.make_pushing_env(std_noise=1e-5, dtype=jnp.float32, **env_kwargs)
    return _one_launch_rate(pushing, config, params, batch)


def bench_training_rollout(batch=BATCH, hidden=(256, 256)):
    """TRAINING rollout rate with a reactive policy: the policy MLP (the
    transfer recipe's (256, 256) trunk, 12 features) runs every env step on
    the env's own observations, over the batched step the path chooser
    picks."""
    from gymnasium_planar_robotics_tpu.models import ppo, pushing
    from gymnasium_planar_robotics_tpu.ops import pallas_step

    config, params = pushing.make_pushing_env(std_noise=1e-5, dtype=jnp.float32)
    cfg = ppo.PPOConfig(obs_dim=12, action_dim=2, hidden=hidden, rollout_steps=ROLLOUT_T, action_scale=10.0)
    pol = ppo.init_params(jax.random.PRNGKey(0), cfg)
    state, obs, _ = jax.block_until_ready(pushing.init_batch(config, params, jax.random.PRNGKey(1), batch))
    step = pallas_step.batched_autoreset_step(pushing, config, params)

    def _vec(obs):
        mp = obs['observation'][..., :2]
        ag, dg = obs['achieved_goal'], obs['desired_goal']
        return jnp.concatenate([obs['observation'], ag, dg, ag - mp, dg - ag], -1).astype(jnp.float32)

    @jax.jit
    def roll(state, obs, pol, key):
        def body(carry, k):
            s, vec = carry
            action = ppo.sample_action(pol, vec, k, cfg.action_scale)[0]
            s, o, rew, te, tr, info = step(s, action)
            return (s, _vec(o)), rew.mean()

        (s, _), rs = jax.lax.scan(body, (state, _vec(obs)), jax.random.split(key, ROLLOUT_T))
        return s, rs.mean()

    return _rate(roll, (state, obs, pol, jax.random.PRNGKey(2)), batch * ROLLOUT_T)


def bench_multiagent(batch=4096, num_agents=4):
    """BASELINE config 4: PettingZoo-style parallel multi-agent, batched."""
    from gymnasium_planar_robotics_tpu.models import multi_agent, planning

    config, params = planning.make_planning_env(
        layout_tiles=np.ones((4, 4)), num_movers=num_agents, std_noise=1e-5, dtype=jnp.float32
    )
    state, obs, _ = jax.block_until_ready(planning.init_batch(config, params, jax.random.PRNGKey(0), batch))
    inner = multi_agent.make_batched_parallel_step(config, params, jit=False)

    @jax.jit
    def roll(state, key):
        def body(s, k):
            a = jax.random.uniform(k, (batch, num_agents, 2), jnp.float32, -10.0, 10.0)
            s, out = inner(s, a)
            return s, out.reward.mean()

        return jax.lax.scan(body, state, jax.random.split(key, ROLLOUT_T))

    return _rate(roll, (state, jax.random.PRNGKey(1)), batch * ROLLOUT_T)


def bench_mixed(batch_each=2048):
    """BASELINE config 5 shape: planning + pushing batches stepped inside ONE
    jitted program (what a mixed-suite learner consumes per iteration)."""
    from gymnasium_planar_robotics_tpu.models import planning, pushing
    from gymnasium_planar_robotics_tpu.ops import pallas_step

    pc, pp = planning.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, dtype=jnp.float32)
    qc, qp = pushing.make_pushing_env(std_noise=1e-5, dtype=jnp.float32)
    ps, pobs, _ = planning.init_batch(pc, pp, jax.random.PRNGKey(0), batch_each)
    qs, qobs, _ = pushing.init_batch(qc, qp, jax.random.PRNGKey(1), batch_each)
    p_step = pallas_step.batched_autoreset_step(planning, pc, pp)
    q_step = pallas_step.batched_autoreset_step(pushing, qc, qp)

    @jax.jit
    def roll(ps, qs, key):
        def body(carry, k):
            ps, qs = carry
            k1, k2 = jax.random.split(k)
            pa = jax.random.uniform(k1, (batch_each, 2), jnp.float32, -10.0, 10.0)
            qa = jax.random.uniform(k2, (batch_each, 2), jnp.float32, -10.0, 10.0)
            ps, _, pr, *_ = p_step(ps, pa)
            qs, _, qr, *_ = q_step(qs, qa)
            return (ps, qs), pr.mean() + qr.mean()

        return jax.lax.scan(body, (ps, qs), jax.random.split(key, ROLLOUT_T))

    return _rate(roll, (ps, qs, jax.random.PRNGKey(2)), 2 * batch_each * ROLLOUT_T)


# Analytic per-ENV-STEP op counts (one env-step = 40 physics cycles + the
# autoreset epilogue), accurate to ~±25%.  They were counted from the
# earlier plane-layout kernel, whose noise came from a hardware generator and
# whose launch I/O was the plane layout's; they are NOT yet re-derived for
# the Triton kernel (its hash generator, and launch I/O of 9 or 19 state
# vectors plus the per-step and last outputs).  Re-derive them from
# ``_planning_step`` / ``_pushing_step`` before a roofline divides by them
# (ROADMAP speed item 1).
#   flops = adds/muls/fmas(=2)/compares/selects on f32 values
#   transc = transcendental-class ops (log, sqrt, sin, cos, exp, div/rsqrt)
#   bytes = device-memory traffic per env-step of a one-step launch (state
#           stays in registers within a launch, so traffic = launch I/O)
ROOFLINE_KERNELS = {
    # planning 1-mover: per cycle ~ Box-Muller x2 (vel + pose noise: 8
    # transc + 20 flops), clamp chain (~20 flops + 2 sqrt), integrate (8),
    # union-rect wall check (~15) => ~65 flops + 10 transc; x40 cycles +
    # autoreset epilogue (cand_k=16 candidate draws + checks, ~450 flops +
    # 35 transc) + obs noise (2 Box-Muller)
    'planning rollout (1 mover)': dict(flops=3050, transc=445, bytes=(11 + 12) * 4),
    # pushing adds the contact pass (~90 flops + 4 sqrt/div per cycle), the
    # object/floor/yaw updates (~60 flops + 3 div/sqrt) and the mover-z DOF
    # (~12 flops) => ~230 flops + 17 transc per cycle
    'pushing rollout': dict(flops=9650, transc=725, bytes=(21 + 36) * 4),
    # 4-mover (XLA step): 4x the per-mover integrate/wall work + 6 pair SAT
    # tests (~70 flops each, box: 4-axis SAT) + joint reset sampling
    'planning 4-mover rollout': dict(flops=13100, transc=1700, bytes=(33 + 40) * 4),
}


def main() -> None:
    import os

    if '--scaling-inner' in sys.argv:
        n = int(os.environ['GPRT_SCALING_N'])
        b = int(os.environ['GPRT_SCALING_B'])
        print(_scaling_worker(n, b))
        return
    if '--scaling' in sys.argv:
        _run_scaling()
        return
    from gymnasium_planar_robotics_tpu.utils import compile_cache

    compile_cache.enable()
    device = _device()
    box_params = {'shape': 'box', 'size': np.array([0.09, 0.09])}
    if '--suite' in sys.argv:
        rows = [
            ('pushing 4096 envs (per-step fused kernel)', lambda: bench_pushing(4096), REF_PUSHING),
            ('pushing 4096 envs (one-launch fused rollout)', lambda: bench_pushing_rollout(4096), REF_PUSHING),
            ('pushing 4096 envs (fused, shard_map 1-device mesh)',
             lambda: bench_pushing(4096, n_mesh_devices=1), REF_PUSHING),
            ('pushing mesh+bumper 4096 envs (per-step fused kernel)',
             lambda: bench_pushing(4096, mover_params={'shape': 'mesh', 'mesh': {'bumper_mass': 0.35}}),
             REF_PUSHING),
            ('planning 1-mover 4096 envs (XLA step)', lambda: bench_planning(4096, 1), REF_PLANNING_1),
            ('planning 1-mover 4096 envs (per-step fused kernel)', lambda: bench_planning_fused(4096),
             REF_PLANNING_1),
            ('planning 1-mover 4096 envs (one-launch fused rollout)', lambda: bench_planning_rollout(4096),
             REF_PLANNING_1),
            ('planning 1-mover 256 envs (one-launch fused rollout)', lambda: bench_planning_rollout(256),
             REF_PLANNING_1),
            ('planning jerk-mode 4096 envs (one-launch fused rollout)',
             lambda: bench_planning_rollout(4096, learn_jerk=True), REF_PLANNING_1),
            ('planning box-shape 4096 envs (one-launch fused rollout)',
             lambda: bench_planning_rollout(4096, collision_params=box_params), REF_PLANNING_1),
            ('pushing TRAINING rollout 4096 envs (policy MLP per step)',
             lambda: bench_training_rollout(4096), REF_PUSHING),
            ('planning 1-mover 4096 envs (fused, shard_map 1-device mesh)',
             lambda: bench_planning_fused(4096, n_mesh_devices=1), REF_PLANNING_1),
            ('planning jerk-mode 4096 envs (per-step fused kernel)',
             lambda: bench_planning_fused(4096, learn_jerk=True), REF_PLANNING_1),
            ('planning box-shape 4096 envs (per-step fused kernel)',
             lambda: bench_planning_fused(4096, collision_params=box_params), REF_PLANNING_1),
            ('planning 4-mover 256 envs (XLA step)', lambda: bench_planning(256, 4, np.ones((4, 4))),
             REF_PLANNING_4),
            ('planning 4-mover 4096 envs (XLA step)', lambda: bench_planning(4096, 4, np.ones((4, 4))),
             REF_PLANNING_4),
            ('planning 4-mover box-shape 4096 envs (XLA step)',
             lambda: bench_planning(4096, 4, np.ones((4, 4)), collision_params=box_params), REF_PLANNING_4),
            ('multi-agent 4x4096 envs', lambda: bench_multiagent(4096, 4), REF_PLANNING_4),
            ('mixed planning+pushing 4096 envs', lambda: bench_mixed(2048), REF_PUSHING),
        ]
        for name, run, ref in rows:
            v = run()
            print(json.dumps({'metric': f'{name} env-steps/s', 'value': round(v, 1), 'unit': 'env-steps/s',
                              'vs_baseline': round(v / ref, 2), 'device': device}), flush=True)
        return

    value = bench_pushing_rollout()
    print(json.dumps({
        'metric': f'pushing env-steps/s ({BATCH} envs, 40 cycles, one-launch fused rollout)',
        'value': round(value, 1),
        'unit': 'env-steps/s',
        'vs_baseline': round(value / REF_PUSHING, 2),
        'device': device,
    }))


if __name__ == '__main__':
    main()
