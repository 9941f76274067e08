#!/usr/bin/env python
"""The fused step kernel against the XLA step on one NVIDIA GPU.

    python tools/kernel_vs_xla.py [--out build/kernel_vs_xla.json] [--reps 5]

Two measurements, in one process, each time closed by ``block_until_ready``
around warmed calls:

1. the launch sweep: the one-launch 512-step form of the kernel at 256 and
   4096 envs over envs-per-program {32, 64, 128} x ``num_warps`` {1, 2, 4},
   for 1-mover planning and pushing, which picks the launch rule
   (``ops/pallas_step.ENVS_PER_PROGRAM`` / ``NUM_WARPS``);
2. the end-to-end comparison that decides whether the kernel stays: for
   1-mover planning (acceleration, jerk, box shape) and pushing at 256 and
   4096 envs, 512 uniform-random steps through
   - ``xla``: ``parallel.rollout.jit_rollout`` of the vmapped ``step_autoreset``,
   - ``kernel_step``: the per-step kernel (``make_fused_step_autoreset``) in
     the same ``lax.scan`` with the same policy and metrics,
   - ``kernel_512``: the one-launch form (``make_fused_rollout``) fed the
     same number of uniform-random actions drawn inside the jitted call.
   The three paths run in turns, ``--reps`` rounds, and each reports its
   median.

Prints one line per measurement and writes them all, with the card's name
and power limit, to ``--out`` as JSON.  Needs a GPU; fails elsewhere.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gymnasium_planar_robotics_tpu.models import planning, pushing  # noqa: E402
from gymnasium_planar_robotics_tpu.ops import pallas_step  # noqa: E402
from gymnasium_planar_robotics_tpu.parallel import rollout  # noqa: E402
from gymnasium_planar_robotics_tpu.utils import compile_cache, profiling  # noqa: E402

T = 512
BATCHES = (256, 4096)
BOX = {'shape': 'box', 'size': np.array([0.09, 0.09])}


def _cases():
    plan = partial(planning.make_planning_env, np.ones((3, 3)), 1, std_noise=1e-5, dtype=jnp.float32)
    return {
        'planning acc': (planning, plan),
        'planning jerk': (planning, partial(plan, learn_jerk=True)),
        'planning box': (planning, partial(plan, collision_params=BOX)),
        'pushing': (pushing, partial(pushing.make_pushing_env, std_noise=1e-5, dtype=jnp.float32)),
    }


def _limit(config, params) -> float:
    return float(np.asarray(params.j_max if config.learn_jerk else params.a_max))


def _seconds(fn, args, reps: int) -> float:
    return float(np.median(profiling.time_calls(fn, *args, warmup=0, reps=reps)))


def _warm(fn, args) -> float:
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    return time.perf_counter() - t0


def sweep(reps: int) -> list[dict]:
    rows = []
    for name in ('planning acc', 'pushing'):
        model, make = _cases()[name]
        config, params = make()
        lim = _limit(config, params)
        factory = pallas_step.planning_kernel if model is planning else pallas_step.pushing_kernel
        to_vec = partial(planning._kernel_state, config) if model is planning else pushing._kernel_state
        for b in BATCHES:
            state, _, _ = model.init_batch(config, params, jax.random.PRNGKey(0), b)
            vec = to_vec(state)
            streams = pallas_step.env_streams(0, jnp.arange(b))
            for block in (32, 64, 128):
                for warps in (1, 2, 4):
                    run = factory(config, params, T, block=block, num_warps=warps)

                    @jax.jit
                    def go(vec, key, run=run, b=b):
                        acts = jax.random.uniform(key, (T, b, 2), jnp.float32, -lim, lim)
                        st, (rew, _, _), _ = run(streams, 0, vec, (acts[..., 0], acts[..., 1]))
                        return st, rew.mean()

                    args = (vec, jax.random.PRNGKey(1))
                    t_c = _warm(go, args)
                    s = _seconds(go, args, reps)
                    row = dict(case=name, envs=b, envs_per_program=block, num_warps=warps,
                               seconds=s, env_steps_per_s=b * T / s, compile_s=t_c)
                    print(f'[sweep] {name} {b} envs, {block} envs/program, {warps} warps: '
                          f'{s * 1e3:.3f} ms per {T} steps, {b * T / s:,.0f} env-steps/s', flush=True)
                    rows.append(row)
    return rows


def compare(reps: int) -> list[dict]:
    rows = []
    for name, (model, make) in _cases().items():
        config, params = make()
        lim = _limit(config, params)
        policy = rollout.uniform_policy(2, -lim, lim)
        for b in BATCHES:
            state, obs, _ = model.init_batch(config, params, jax.random.PRNGKey(0), b)
            xla = rollout.jit_rollout(config, params, model.step_autoreset, policy, T)
            step = jax.jit(rollout.make_rollout_fn_batched(model.make_fused_step_autoreset(config, params), policy, T))
            one = model.make_fused_rollout(config, params)

            @jax.jit
            def launch(state, key, one=one, b=b):
                acts = jax.random.uniform(key, (T, b, 2), jnp.float32, -lim, lim)
                st, rew, term, trunc = one(state, acts, 0)
                return st, rew.mean(), (term | trunc).mean()

            paths = {
                'xla': (xla, (state, obs, jax.random.PRNGKey(1))),
                'kernel_step': (step, (state, obs, jax.random.PRNGKey(1))),
                'kernel_512': (launch, (state, jax.random.PRNGKey(1))),
            }
            compile_s = {k: _warm(fn, args) for k, (fn, args) in paths.items()}
            times = {k: [] for k in paths}
            for _ in range(reps):  # in turns, so drift hits every path alike
                for k, (fn, args) in paths.items():
                    times[k].append(profiling.time_calls(fn, *args, warmup=0, reps=1)[0])
            row = dict(case=name, envs=b, steps=T)
            for k in paths:
                s = float(np.median(times[k]))
                row[k] = dict(seconds=s, env_steps_per_s=b * T / s, compile_s=compile_s[k])
            row['kernel_wins'] = bool(max(row['kernel_step']['seconds'], row['kernel_512']['seconds'])
                                      < row['xla']['seconds'])
            print(f'[compare] {name} {b} envs x {T} steps: ' + ', '.join(
                f'{k} {row[k]["seconds"] * 1e3:.3f} ms ({row[k]["env_steps_per_s"]:,.0f} env-steps/s)'
                for k in paths) + f'; kernel wins: {row["kernel_wins"]}', flush=True)
            rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--out', default='build/kernel_vs_xla.json')
    ap.add_argument('--reps', type=int, default=5)
    args = ap.parse_args()
    device = jax.devices()[0]
    if device.platform != 'gpu':
        print(f'kernel_vs_xla: needs a GPU, JAX found {device.platform}', file=sys.stderr)
        return 1
    compile_cache.enable()
    card = profiling.gpu_name_and_power_limit()
    print(card, flush=True)
    result = {'card': card, 'device_kind': device.device_kind, 'jax': jax.__version__,
              'xla_flags': os.environ.get('XLA_FLAGS', ''),
              'launch_rule': [pallas_step.ENVS_PER_PROGRAM, pallas_step.NUM_WARPS]}
    result['sweep'] = sweep(args.reps)
    result['compare'] = compare(args.reps)
    result['kernel_wins_every_comparison'] = all(r['kernel_wins'] for r in result['compare'])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, 'w') as f:
        json.dump(result, f, indent=1)
    print(f'kernel wins every comparison: {result["kernel_wins_every_comparison"]}', flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
