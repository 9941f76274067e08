"""Train PPO on the batched planning env — fully on-device.

Usage:
    python examples/train_ppo.py [--batch 1024] [--iters 500] [--movers 1]

Everything (env rollout, GAE, updates) runs as one jitted program per
iteration; on several devices the env batch can additionally be sharded over a mesh
(see ``parallel/sharding.py`` and ``__graft_entry__.dryrun_multichip``).
"""

import argparse
import time

import numpy as np

import jax
import jax.numpy as jnp

from gymnasium_planar_robotics_tpu.models import planning, ppo


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--batch', type=int, default=1024)
    ap.add_argument('--iters', type=int, default=500)
    ap.add_argument('--movers', type=int, default=1)
    ap.add_argument('--dense', action='store_true', help='use shaped rewards')
    args = ap.parse_args()

    config, params = planning.make_planning_env(
        np.ones((3, 3)), args.movers, std_noise=1e-5, dtype=jnp.float32,
        reward_mode='dense' if args.dense else 'sparse', a_max=3.0,
    )
    obs_dim = 3 * config.num_movers * 2
    cfg = ppo.PPOConfig(obs_dim=obs_dim, action_dim=config.num_movers * 2,
                        rollout_steps=16, learning_rate=1e-3)
    pol = ppo.init_params(jax.random.PRNGKey(0), cfg)
    train_step, opt = ppo.make_train_step(config, params, cfg, planning.step_autoreset)
    opt_state = opt.init(pol)

    state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(1), args.batch)
    obs_vec = jnp.concatenate(
        [obs['observation'], obs['achieved_goal'], obs['desired_goal']], -1
    ).astype(jnp.float32)
    runner = (state, obs_vec, pol, opt_state, jax.random.PRNGKey(2))
    step = jax.jit(train_step)

    t0 = time.time()
    for i in range(args.iters):
        runner, metrics = step(runner)
        if i % 25 == 0:
            sps = args.batch * cfg.rollout_steps * (i + 1) / (time.time() - t0)
            print(
                f'iter {i:5d}  reward {float(metrics["reward_mean"]):8.3f}  '
                f'loss {float(metrics["loss"]):8.3f}  done% {100 * float(metrics["done_rate"]):5.1f}  '
                f'{sps:,.0f} env-steps/s'
            )


if __name__ == '__main__':
    main()
