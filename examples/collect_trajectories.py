"""Collect rollout batches into the native trajectory store.

Usage:
    python examples/collect_trajectories.py --out build/planar_traj --steps 200

Each frame is one batched transition pytree (obs/action/reward/done); the C++
background writer keeps the device loop from ever blocking on disk.
"""

import argparse

import numpy as np

import jax
import jax.numpy as jnp

from gymnasium_planar_robotics_tpu.models import planning
from gymnasium_planar_robotics_tpu.ops import pallas_step
from gymnasium_planar_robotics_tpu.utils import trajstore


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--out', default='build/planar_traj')
    ap.add_argument('--batch', type=int, default=512)
    ap.add_argument('--steps', type=int, default=200)
    args = ap.parse_args()

    config, params = planning.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, dtype=jnp.float32)
    state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(0), args.batch)

    # offline collection has its actions up front: where the fused kernel
    # runs (GPU, covered configurations) a chunk of steps is ONE launch;
    # elsewhere the XLA step runs them one by one
    chunk = min(64, args.steps)
    one_launch = pallas_step.use_kernel(config, params)
    if one_launch:
        roll = jax.jit(planning.make_fused_rollout(config, params))
    else:
        step = jax.jit(lambda s, a: planning.batched_step_autoreset(config, params, s, a))

    key = jax.random.PRNGKey(1)
    written = 0
    with trajstore.TrajWriter(args.out) as w:
        seed = 0
        while written < args.steps:
            n = min(chunk, args.steps - written)
            key, k = jax.random.split(key)
            actions = jax.random.uniform(k, (n, args.batch, 2), jnp.float32, -10.0, 10.0)
            if one_launch:
                state, rewards, terms, truncs = roll(state, actions, seed)
                seed += n
                for t in range(n):
                    w.append_pytree({'action': actions[t], 'reward': rewards[t], 'done': terms[t] | truncs[t]})
            else:
                for t in range(n):
                    state, obs, reward, term, trunc, info = step(state, actions[t])
                    w.append_pytree({'obs': obs, 'action': actions[t], 'reward': reward, 'done': term | trunc})
            written += n
    # report after close(): the native writer appends on a background thread,
    # so frames_written only reflects every append once the writer has drained
    print(f'wrote {w.frames_written} frames to {args.out} '
          f'({"native" if trajstore.native_available() else "python"} writer)')

    with trajstore.TrajReader(args.out) as r:
        print(f'readable frames: {len(r)}; frame 0 leaves: {len(r.get_arrays(0))}')


if __name__ == '__main__':
    main()
