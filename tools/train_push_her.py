#!/usr/bin/env python
"""Pushing HER recipe lab (round 5): lift the reference's own documented
recipe — an off-policy learner + HER relabeling on the SPARSE pushing reward
(`/root/reference/docs/train_agents.rst`: SB3 SAC + HerReplayBuffer) — to a
strong policy in this engine.  The round-4 transfer artifact trained plain
DDPG+HER to 13%; this lab adds the TD3 stabilizers (clipped double-Q,
target policy smoothing, delayed policy) from `models/her.py` and trains on
the batched step that `ops.pallas_step.batched_autoreset_step` chooses (the
fused kernel on a GPU).

Usage:
    python tools/train_push_her.py \
        --iters 4000 --batch 512 --twin --target-noise 0.1 --policy-delay 2

Prints eval rows (strict reference scoring: `is_success` on the episode's
final step, deterministic policy, 512 fresh episodes) every `--eval-every`
iters and a JSON summary at the end.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

from gymnasium_planar_robotics_tpu.models import her, pushing  # noqa: E402
from gymnasium_planar_robotics_tpu.ops.pallas_step import batched_autoreset_step  # noqa: E402
from transfer_eval import HORIZON, PUSHING_KW, _pushing_vec, eval_in_engine  # noqa: E402


def build(args):
    config, params = pushing.make_pushing_env(dtype=jnp.float32, **PUSHING_KW)
    cfg = her.HERConfig(
        obs_dim=8, goal_dim=2, action_dim=2, hidden=tuple(args.hidden),
        action_scale=PUSHING_KW['a_max'], rollout_steps=HORIZON,
        relabel_prob=args.relabel, explore_std=args.explore_std,
        explore_eps=args.explore_eps, update_steps=args.update_steps,
        gamma=args.gamma, actor_lr=args.actor_lr, critic_lr=args.critic_lr,
        replay_size=args.replay, minibatch=args.minibatch,
        action_l2=args.action_l2, tau=args.tau,
        twin_critic=args.twin, target_noise=args.target_noise,
        policy_delay=args.policy_delay, n_step=args.n_step,
        explore_per_episode=args.per_episode,
    )
    pol = her.init_params(jax.random.PRNGKey(args.seed), cfg)
    batched = batched_autoreset_step(pushing, config, params)
    train_step, (a_opt, c_opt) = her.make_train_step(
        config, params, cfg,
        None,
        lambda ach, des, mc, wc: pushing.compute_reward(params, ach, des, wc),
        lambda r: r == -50.0,
        vec_fn=_pushing_vec,
        batched_step_fn=batched,
    )
    state, obs, _ = pushing.init_batch(config, params, jax.random.PRNGKey(args.seed + 1), args.batch)
    runner = (state, obs, pol, a_opt.init(pol['actor']), c_opt.init(pol['critic']),
              her.init_replay(cfg), jax.random.PRNGKey(args.seed + 2))
    return config, params, cfg, jax.jit(train_step, donate_argnums=0), runner


def policy_from(pol, scale):
    @jax.jit
    def policy(vec):
        obs_part, ach, des = vec[..., :4], vec[..., 4:6], vec[..., 6:8]
        return her.actor_action(pol['actor'], _pushing_vec(obs_part, ach, des), scale)

    return policy


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument('--iters', type=int, default=4000)
    p.add_argument('--batch', type=int, default=512)
    p.add_argument('--hidden', type=int, nargs='+', default=[256, 256])
    p.add_argument('--gamma', type=float, default=0.95)
    p.add_argument('--tau', type=float, default=0.05)
    p.add_argument('--actor-lr', type=float, default=3e-4)
    p.add_argument('--critic-lr', type=float, default=1e-3)
    p.add_argument('--relabel', type=float, default=0.8)
    p.add_argument('--explore-std', type=float, default=0.2)
    p.add_argument('--explore-eps', type=float, default=0.3)
    p.add_argument('--update-steps', type=int, default=20)
    p.add_argument('--replay', type=int, default=4_000_000)
    p.add_argument('--minibatch', type=int, default=4096)
    p.add_argument('--action-l2', type=float, default=1.0)
    p.add_argument('--twin', action='store_true')
    p.add_argument('--target-noise', type=float, default=0.0)
    p.add_argument('--policy-delay', type=int, default=1)
    p.add_argument('--n-step', type=int, default=1)
    p.add_argument('--per-episode', action='store_true',
                   help='temporally correlated exploration (episode-held coin + direction)')
    p.add_argument('--eval-every', type=int, default=1000)
    p.add_argument('--eval-episodes', type=int, default=512)
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args()

    config, params, cfg, step, runner = build(args)
    scale = cfg.action_scale
    t0 = time.time()
    best = 0.0
    for i in range(args.iters):
        runner, m = step(runner)
        if i % 100 == 0 or i == args.iters - 1:
            print(f'iter {i:6d}  ep-succ {float(m["episode_success_rate"]):.3f}  '
                  f'c-loss {float(m["critic_loss"]):.4f}  ({time.time() - t0:.0f}s)',
                  flush=True)
        if (i + 1) % args.eval_every == 0 or i == args.iters - 1:
            res = eval_in_engine(pushing, config, params,
                                 policy_from(runner[2], scale), args.eval_episodes)
            best = max(best, res['success'])
            print(f'EVAL iter {i:6d}: success {res["success"]:.3f} '
                  f'(any {res["success_any"]:.3f}) return {res["return_mean"]:.1f}',
                  flush=True)
    steps_total = args.iters * args.batch * HORIZON
    print(json.dumps({
        'metric': 'pushing HER strict success', 'value': best,
        'env_steps': steps_total, 'wall_s': round(time.time() - t0, 1),
        'recipe': {k: v for k, v in vars(args).items()},
    }))


if __name__ == '__main__':
    main()
