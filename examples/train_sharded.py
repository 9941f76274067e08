"""PPO training over a device mesh.

The multi-device pattern: the env batch is sharded over a 1D ``data`` mesh;
each device steps its shard with the batched autoreset step that
``ops.pallas_step.batched_autoreset_step`` chooses (the fused kernel under
``shard_map`` on GPUs, the vmapped XLA step elsewhere), and PPO gradients
all-reduce over the mesh (the only collectives besides metric means).

On a single-device machine this still exercises the full sharded program via
a 1-device mesh; on the CPU it runs the same code over virtual devices, with
the kernel in interpret mode:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/train_sharded.py --devices 8 --interpret --batch 1024

Usage:
    python examples/train_sharded.py [--batch 4096] [--iters 100] [--devices N]
"""

import argparse
import time

import numpy as np

import jax
import jax.numpy as jnp

from gymnasium_planar_robotics_tpu.models import planning, ppo
from gymnasium_planar_robotics_tpu.ops import pallas_step
from gymnasium_planar_robotics_tpu.parallel import sharding


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=4096)
    ap.add_argument('--iters', type=int, default=100)
    ap.add_argument('--devices', type=int, default=0, help='mesh size (0 = all devices)')
    ap.add_argument('--rollout', type=int, default=32)
    ap.add_argument('--cycles', type=int, default=40)
    ap.add_argument('--interpret', action='store_true',
                    help='run the fused kernel in interpret mode (CPU virtual-device runs)')
    args = ap.parse_args()

    devices = jax.devices()[: args.devices] if args.devices else jax.devices()
    mesh = sharding.make_mesh(devices)
    n_dev = mesh.size
    assert args.batch % n_dev == 0, 'the batch must split evenly over the devices'

    config, params = planning.make_planning_env(
        np.ones((3, 3)), 1, std_noise=1e-5, dtype=jnp.float32, a_max=3.0,
        reward_mode='dense', num_cycles=args.cycles,
    )

    cfg = ppo.PPOConfig(obs_dim=6, action_dim=2, rollout_steps=args.rollout,
                        learning_rate=1e-3, action_scale=3.0)
    pol = ppo.init_params(jax.random.PRNGKey(0), cfg)

    sh = sharding.batch_sharding(mesh)
    rep = sharding.replicated(mesh)
    state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(1), args.batch)

    if args.interpret:
        env_step = sharding.make_sharded_fused_step(planning, config, params, mesh, interpret=True)
        fused = True
    else:
        env_step = pallas_step.batched_autoreset_step(planning, config, params, mesh)
        fused = env_step.uses_kernel
    train_step, opt = ppo.make_train_step(config, params, cfg, batched_step_fn=env_step)
    obs_vec = jnp.concatenate(
        [obs['observation'], obs['achieved_goal'], obs['desired_goal']], -1
    ).astype(jnp.float32)
    runner = (
        jax.device_put(state, sh),
        jax.device_put(obs_vec, sh),
        jax.device_put(pol, rep),
        jax.device_put(opt.init(pol), rep),
        jax.device_put(jax.random.PRNGKey(2), rep),
    )
    step = jax.jit(train_step)

    runner, metrics = step(runner)  # compile
    jax.block_until_ready(metrics)
    t0 = time.time()
    for i in range(args.iters):
        runner, metrics = step(runner)
        if i % 10 == 0:
            jax.block_until_ready(metrics)
            sps = args.batch * args.rollout * (i + 1) / (time.time() - t0)
            print(
                f'iter {i:4d}  reward {float(metrics["reward_mean"]):8.3f}  '
                f'loss {float(metrics["loss"]):8.3f}  '
                f'{sps:,.0f} env-steps/s over {n_dev} device(s), '
                + ('fused shard_map rollout' if fused else 'XLA sharded rollout')
            )


if __name__ == '__main__':
    main()
