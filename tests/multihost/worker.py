"""Multi-process mesh worker: 2 processes x 4 CPU devices = one 8-device
data mesh spanning 'hosts'. Each process owns its batch shard; the jitted
sharded step runs SPMD; a global metrics reduction crosses processes.

Launched by test_multihost.py; also runnable by hand:
    python tests/multihost/worker.py 0 & python tests/multihost/worker.py 1
"""
import os
import sys

import jax

proc = int(sys.argv[1])
jax.config.update('jax_platforms', 'cpu')
jax.distributed.initialize(
    coordinator_address='127.0.0.1:9911', num_processes=2, process_id=proc,
    local_device_ids=list(range(4)),
)
import numpy as np
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
from gymnasium_planar_robotics_tpu.models import planning
from gymnasium_planar_robotics_tpu.parallel import sharding

assert jax.device_count() == 8 and jax.local_device_count() == 4

config, params = planning.make_planning_env(np.ones((3, 3)), 1, std_noise=1e-5, dtype=jnp.float32)
mesh = sharding.make_mesh()  # global 8-device mesh across both processes
B = int(sys.argv[2]) if len(sys.argv) > 2 else 64

# build the global batch from per-process shards
state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(0), B)
sh = NamedSharding(mesh, P('data'))

def to_global(x):
    # every process computed the full batch (same seed); take the local rows
    local = np.asarray(x)
    arrs = []
    for d in jax.local_devices():
        idx = sh.addressable_devices_indices_map(local.shape)[d]
        arrs.append(jax.device_put(local[idx], d))
    return jax.make_array_from_single_device_arrays(local.shape, sh, arrs)

gstate = jax.tree_util.tree_map(to_global, state)
actions = to_global(np.zeros((B, 2), np.float32))

step = sharding.sharded_step_fn(config, params, mesh, planning.step, donate=False)

@jax.jit
def step_and_metrics(s, a):
    s2, o, r, t, tr, i = step(s, a)
    return s2, sharding.metrics_summary(r, t, i)

s2, metrics = step_and_metrics(gstate, actions)
val = float(metrics['reward_mean'])  # replicated -> addressable everywhere
assert np.isfinite(val)

# throughput: timed cross-process sharded stepping (the metrics reduction
# inside forces a real inter-host collective every step)
import time

K = 12
s = s2
jax.block_until_ready(s.pos)
t0 = time.perf_counter()
for _ in range(K):
    s, metrics = step_and_metrics(s, actions)
jax.block_until_ready(metrics['reward_mean'])
dt = time.perf_counter() - t0
rate = B * K / dt
print(f'proc {proc}: global reward_mean {val:.4f} over {jax.device_count()} devices OK', flush=True)
print(f'proc {proc}: RATE {rate:.1f} env-steps/s (B={B}, {K} steps, 2-process mesh)', flush=True)

# ---------------------------------------------------------------------------
# FUSED kernel across processes: the fused step kernel under shard_map over
# the REAL 2-process mesh, bit-matched against the single-process unsharded
# kernel.  Interpret mode (CPU devices); each env's noise stream comes from its
# own key, so the comparison is value-exact; small num_cycles keeps the
# interpret run cheap (same trick as tests/test_sharding.py).
# ---------------------------------------------------------------------------
fconfig, fparams = planning.make_planning_env(
    np.ones((3, 3)), 1, std_noise=1e-5, num_cycles=4, dtype=jnp.float32
)
FB = 128  # 16 envs/device -> a masked partial block per device
fstate, _, _ = planning.init_batch(fconfig, fparams, jax.random.PRNGKey(3), FB)
factions = np.asarray(
    jax.random.uniform(jax.random.PRNGKey(4), (FB, 2), jnp.float32, -5.0, 5.0)
)

fused_local = planning.make_fused_step_autoreset(fconfig, fparams, interpret=True, cand_k=2)
# unsharded single-process reference (every process computes the full batch)
rs, ro, rr, rt, rtr, ri = fused_local(fstate, jnp.asarray(factions))

fused_sharded = sharding.make_sharded_fused_step(
    planning, fconfig, fparams, mesh, interpret=True, cand_k=2
)
fsh = NamedSharding(mesh, jax.sharding.PartitionSpec('data'))
gfstate = jax.tree_util.tree_map(
    lambda x: to_global(x) if np.asarray(x).ndim and np.asarray(x).shape[0] == FB else x, fstate
)
gfactions = to_global(factions)

print(f'proc {proc}: fused section: running sharded step ...', flush=True)
ss, so, sr, st_, str_, si = fused_sharded(gfstate, gfactions)

def assert_shards_match(global_arr, ref_arr, name):
    ref_np = np.asarray(ref_arr)
    for shard in global_arr.addressable_shards:
        np.testing.assert_array_equal(
            np.asarray(shard.data), ref_np[shard.index],
            err_msg=f'proc {proc}: fused cross-process mismatch in {name}',
        )

assert_shards_match(ss.pos, rs.pos, 'state.pos')
assert_shards_match(ss.vel, rs.vel, 'state.vel')
assert_shards_match(ss.steps, rs.steps, 'state.steps')
assert_shards_match(sr, rr, 'reward')
assert_shards_match(st_, rt, 'terminated')
assert_shards_match(so['observation'], ro['observation'], 'obs')
assert_shards_match(so['achieved_goal'], ro['achieved_goal'], 'achieved_goal')
assert_shards_match(si['wall_collision'], ri['wall_collision'], 'wall_collision')
print(f'proc {proc}: FUSED OK (shard_map Pallas kernel bit-matches unsharded across 2 processes)', flush=True)
