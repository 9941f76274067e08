"""Single-process 4-device baseline for the host-scaling-efficiency proxy:
the same sharded step + metrics reduction as worker.py, without
jax.distributed, at the per-host batch size passed as argv[1]."""

import os
import sys
import time

import jax

jax.config.update('jax_platforms', 'cpu')

import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from gymnasium_planar_robotics_tpu.models import planning
from gymnasium_planar_robotics_tpu.parallel import sharding

B = int(sys.argv[1]) if len(sys.argv) > 1 else 256
assert jax.device_count() == 4

config, params = planning.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, dtype=jnp.float32)
mesh = sharding.make_mesh()
sh = NamedSharding(mesh, P('data'))

state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(0), B)
gstate = jax.tree_util.tree_map(lambda x: jax.device_put(x, sh), state)
actions = jax.device_put(jnp.zeros((B, 2), jnp.float32), sh)

step = sharding.sharded_step_fn(config, params, mesh, planning.step, donate=False)


@jax.jit
def step_and_metrics(s, a):
    s2, o, r, t, tr, i = step(s, a)
    return s2, sharding.metrics_summary(r, t, i)


s, metrics = step_and_metrics(gstate, actions)
jax.block_until_ready(s.pos)
K = 12
t0 = time.perf_counter()
for _ in range(K):
    s, metrics = step_and_metrics(s, actions)
jax.block_until_ready(metrics['reward_mean'])
dt = time.perf_counter() - t0
print(f'RATE {B * K / dt:.1f} env-steps/s (B={B}, {K} steps, single process)', flush=True)
