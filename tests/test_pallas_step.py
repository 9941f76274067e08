"""Fused step kernel (``ops/pallas_step``) vs. the XLA scan path, on the CPU.

The kernel compiles for NVIDIA GPUs only; here it runs in Pallas' interpret
mode (``interpret=True``), which executes the same kernel body.  At
``std_noise=0`` the noise terms vanish, so cycle physics, flags and rewards
must match the XLA step from identical states (bit-exact for planning, at
FMA/ulp tolerance where contact couples quantities).  The counter-based
generator is pure ``jnp`` and is checked directly; its stream is keyed by
(stream id, step, draw), so kernel results must not depend on the block size,
the batch layout, or how a rollout is split into launches.  What only the
card can check (the compiled kernel) is marked ``gpu`` and runs through
``chip_smoke.py``.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gymnasium_planar_robotics_tpu.models import planning, pushing
from gymnasium_planar_robotics_tpu.ops import pallas_step


def _mk(std=0.0, learn_jerk=False, layout=None, num_cycles=12, **kw):
    return planning.make_planning_env(
        np.ones((3, 3)) if layout is None else layout,
        1,
        std_noise=std,
        num_cycles=num_cycles,
        v_max=1.0,
        a_max=8.0,
        j_max=80.0,
        learn_jerk=learn_jerk,
        dtype=jnp.float32,
        **kw,
    )


def _mk_push(std=0.0, learn_jerk=False, mover_params=None, num_cycles=40):
    return pushing.make_pushing_env(
        std_noise=std, learn_jerk=learn_jerk, dtype=jnp.float32, mover_params=mover_params,
        num_cycles=num_cycles,
    )


def _random_states(config, params, b, seed=0):
    state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(seed), b)
    return state


def _run_raw(kernel_fn, state_vec, actions, streams, step0=0):
    """Raw kernel call: actions [K, B, 2]."""
    return kernel_fn(streams, step0, state_vec, (actions[..., 0], actions[..., 1]))


@pytest.mark.parametrize('shape', [(1, 1), (1, 4), (2, 2), (3, 3), (4, 5)])
def test_full_layout_wall_valid_specialization_exact(shape):
    """The full-layout fast path of the kernel wall checks (union-rectangle
    test, the round-3 box-kernel speedup) is EXACTLY the general per-cell
    rule, fuzz-checked over random poses/sizes/rotations for both shapes."""
    from types import SimpleNamespace

    from gymnasium_planar_robotics_tpu.ops.grid import make_tile_grid

    grid = make_tile_grid(np.ones(shape), np.array([0.12, 0.12, 0.0176]), dtype=jnp.float32)
    grid_np = pallas_step._grid_np(SimpleNamespace(grid=grid))
    assert grid_np['layout'].all()

    rng = np.random.default_rng(hash(shape) % 2**31)
    n = 4096
    # positions spanning past the table edges on all sides
    px = jnp.asarray(rng.uniform(-0.3, shape[0] * 0.24 + 0.3, n), jnp.float32)
    py = jnp.asarray(rng.uniform(-0.3, shape[1] * 0.24 + 0.3, n), jnp.float32)

    spec_c = pallas_step._make_wall_valid(grid_np)
    gen_c = pallas_step._make_wall_valid_general(grid_np)
    for c in (0.01, 0.055, 0.11):
        np.testing.assert_array_equal(np.asarray(spec_c(px, py, c)), np.asarray(gen_c(px, py, c)), err_msg=f'circle c={c}')

    spec_b = pallas_step._make_wall_valid_box(grid_np)
    gen_b = pallas_step._make_wall_valid_box_general(grid_np)
    q = rng.normal(size=(4, n)) * 0.05
    R00, R01, R10, R11 = pallas_step._quat_to_R2(
        jnp.asarray(1.0 + q[0], jnp.float32), *(jnp.asarray(qi, jnp.float32) for qi in q[1:])
    )
    for chx, chy in ((0.02, 0.05), (0.09, 0.09), (0.12, 0.06)):
        np.testing.assert_array_equal(
            np.asarray(spec_b(px, py, R00, R01, R10, R11, chx, chy)),
            np.asarray(gen_b(px, py, R00, R01, R10, R11, chx, chy)),
            err_msg=f'box {chx}x{chy}',
        )


def test_supports_gate():
    config, params = planning.make_planning_env(np.ones((3, 3)), 2, dtype=jnp.float32)
    assert not pallas_step.supports(config, params)  # M=2
    config, params = planning.make_planning_env(
        np.ones((3, 3)), 1, dtype=jnp.float32, collision_params={'shape': 'box', 'size': np.array([0.09, 0.09])}
    )
    assert pallas_step.supports(config, params)  # box shape is in-kernel
    config, params = planning.make_planning_env(np.ones((3, 3)), 1, dtype=jnp.float64)
    assert not pallas_step.supports(config, params)  # f64 parity mode -> XLA


@pytest.mark.parametrize(
    'backend, movers, expected',
    [('gpu', 1, True), ('gpu', 2, False), ('cpu', 1, False)],
)
def test_use_kernel_chooses_by_platform_and_config(monkeypatch, backend, movers, expected):
    """The one path chooser: the kernel only on a GPU and only for the
    configurations it covers; ``batched_autoreset_step`` follows it."""
    config, params = planning.make_planning_env(np.ones((3, 3)), movers, num_cycles=2, dtype=jnp.float32)
    monkeypatch.setattr(jax, 'default_backend', lambda: backend)
    assert pallas_step.use_kernel(config, params) is expected
    if not expected:
        assert pallas_step.batched_autoreset_step(planning, config, params).uses_kernel is False


@pytest.mark.parametrize('case', ['platform', 'config'])
def test_kernel_refuses_what_it_cannot_run(case):
    """Asking for the kernel off the GPU (without interpret mode), or for a
    configuration it does not cover, is an error — never a silent fallback."""
    if case == 'platform':
        config, params = _mk()
        with pytest.raises(RuntimeError, match='NVIDIA GPUs'):
            planning.make_fused_step_autoreset(config, params)
    else:
        config, params = planning.make_planning_env(np.ones((4, 4)), 2, dtype=jnp.float32)
        with pytest.raises(ValueError, match='one mover'):
            planning.make_fused_step_autoreset(config, params, interpret=True)


# ---------------------------------------------------------------------------
# the counter-based generator
# ---------------------------------------------------------------------------


def test_box_muller_matches_numpy_oracle_and_moments():
    """The kernels' Box-Muller, fed the generator's uniforms, reproduces the
    NumPy float32 oracle value for value, and the normals have
    standard-normal moments and tails."""
    keys = pallas_step.step_key(pallas_step.env_streams(3, jnp.arange(4096)), 0)
    u1 = np.asarray(jax.vmap(lambda n: pallas_step.uniform(keys, n))(jnp.arange(0, 16, 2)))
    u2 = np.asarray(jax.vmap(lambda n: pallas_step.uniform(keys, n))(jnp.arange(1, 16, 2)))
    a, b = (np.asarray(x) for x in pallas_step.normal_pair(jnp.asarray(u1), jnp.asarray(u2)))
    r = np.sqrt(np.float32(-2.0) * np.log((np.float32(1.0) - u1).astype(np.float32)), dtype=np.float32)
    np.testing.assert_allclose(a, r * np.cos(np.float32(2 * np.pi) * u2, dtype=np.float32), rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(b, r * np.sin(np.float32(2 * np.pi) * u2, dtype=np.float32), rtol=2e-5, atol=2e-6)
    flat = np.concatenate([a.ravel(), b.ravel()])  # 65k samples
    assert abs(flat.mean()) < 0.02
    assert abs(flat.std() - 1.0) < 0.02
    assert (np.abs(flat) > 2.0).mean() > 0.03
    assert np.isfinite(flat).all()


@pytest.mark.parametrize('axis', ['env', 'step', 'draw'])
def test_generator_moments_and_independence(axis):
    """Uniforms along each key axis — global env index, step, draw — have
    U[0, 1) moments, and neighbours along that axis (and the other axes) are
    uncorrelated; the 24-bit values are distinct."""
    n = 1 << 14
    idx = jnp.arange(n)
    if axis == 'env':
        u = pallas_step.uniform(pallas_step.step_key(pallas_step.env_streams(7, idx), 5), 3)
        other = pallas_step.uniform(pallas_step.step_key(pallas_step.env_streams(7, idx), 6), 3)
    elif axis == 'step':
        stream = pallas_step.env_streams(7, jnp.uint32(11))
        u = pallas_step.uniform(pallas_step.step_key(stream, idx), 3)
        other = pallas_step.uniform(pallas_step.step_key(stream, idx), 4)
    else:
        key = pallas_step.step_key(pallas_step.env_streams(7, jnp.uint32(11)), 5)
        u = pallas_step.uniform(key, idx)
        other = pallas_step.uniform(pallas_step.step_key(pallas_step.env_streams(8, jnp.uint32(11)), 5), idx)
    u, other = np.asarray(u, np.float64), np.asarray(other, np.float64)
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.01
    assert abs(u.var() - 1.0 / 12.0) < 0.005
    assert len(np.unique(u)) > 0.99 * n
    for lag in (1, 2, 32):
        assert abs(np.corrcoef(u[:-lag], u[lag:])[0, 1]) < 0.03, f'lag {lag}'
    assert abs(np.corrcoef(u, other)[0, 1]) < 0.03
    # the two halves of the unit interval are equally likely along the axis
    assert abs((u < 0.5).mean() - 0.5) < 0.02


# ---------------------------------------------------------------------------
# planning: kernel vs XLA at std=0
# ---------------------------------------------------------------------------


def test_fused_matches_xla_multi_step_holed_layout():
    layout = np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]])
    config, params = _mk(layout=layout)
    b = 64
    state = _random_states(config, params, b, seed=3)
    step = planning.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)
    key = jax.random.PRNGKey(5)
    for t in range(3):
        key, k = jax.random.split(key)
        actions = jax.random.uniform(k, (b, 2), jnp.float32, -8.0, 8.0)
        xs, _, xr, xt, _, xi = planning.batched_step(config, params, state, actions)
        fs, _, fr, ft, _, fi = step(state, actions)
        live = ~np.asarray(xt)
        np.testing.assert_array_equal(np.asarray(fs.pos)[live], np.asarray(xs.pos)[live], err_msg=f't={t}')
        np.testing.assert_array_equal(
            np.asarray(fi['wall_collision']), np.asarray(xi['wall_collision']), err_msg=f't={t}'
        )
        np.testing.assert_array_equal(np.asarray(fr), np.asarray(xr), err_msg=f't={t}')
        # advance along the XLA trajectory (the kernel restarts done envs)
        state = xs


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_fused_single_autoreset_matches_xla_zero_noise(learn_jerk):
    """1-mover in-kernel autoreset (acc AND jerk): cycle physics, collision
    flags, and rewards bit-match the XLA step on non-restarted lanes."""
    config, params = _mk(learn_jerk=learn_jerk)
    b = 64
    state = _random_states(config, params, b, seed=21)
    limit = 80.0 if learn_jerk else 8.0
    actions = jax.random.uniform(jax.random.PRNGKey(22), (b, 2), jnp.float32, -limit, limit)

    xs, xo, xr, xt, _, xi = planning.batched_step(config, params, state, actions)
    step = planning.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)
    fs, fo, fr, ft, ftr, fi = step(state, actions)

    live = ~np.asarray(xt)
    np.testing.assert_array_equal(np.asarray(fs.pos)[live], np.asarray(xs.pos)[live])
    np.testing.assert_array_equal(np.asarray(fs.vel)[live], np.asarray(xs.vel)[live])
    np.testing.assert_array_equal(np.asarray(fs.acc)[live], np.asarray(xs.acc)[live])
    np.testing.assert_array_equal(np.asarray(fi['wall_collision']), np.asarray(xi['wall_collision']))
    np.testing.assert_array_equal(np.asarray(fr), np.asarray(xr))
    np.testing.assert_array_equal(np.asarray(ft), np.asarray(xt))
    np.testing.assert_array_equal(
        np.asarray(fi['final_observation']['achieved_goal']), np.asarray(xo['achieved_goal'])
    )
    if learn_jerk:
        np.testing.assert_array_equal(np.asarray(fs.act)[live], np.asarray(xs.act)[live])
        assert fo['observation'].shape == (b, 4)
        np.testing.assert_array_equal(
            np.asarray(fo['observation'])[live, 2:], np.asarray(fs.acc)[live, 0]
        )
    else:
        assert fo['observation'].shape == (b, 2)


def test_fused_dense_reward_matches_xla():
    """Dense reward mode runs in-kernel too: at std=0 the fused autoreset
    reward equals the XLA dense reward on every lane (both compute it from
    the pre-reset observation)."""
    config, params = planning.make_planning_env(
        np.ones((3, 3)), 1, std_noise=0.0, num_cycles=12, v_max=1.0, a_max=8.0,
        reward_mode='dense', dtype=jnp.float32,
    )
    b = 64
    state = _random_states(config, params, b, seed=25)
    actions = jax.random.uniform(jax.random.PRNGKey(26), (b, 2), jnp.float32, -8.0, 8.0)

    xs, _, xr, xt, _, xi = planning.batched_step(config, params, state, actions)
    step = planning.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)
    fs, fo, fr, ft, ftr, fi = step(state, actions)

    np.testing.assert_allclose(np.asarray(fr), np.asarray(xr), rtol=1e-6, atol=1e-6)
    assert (np.asarray(xr) < 0).any(), 'dense rewards should be negative distances'


def _scaled_params(params, scales):
    return dataclasses.replace(
        params, accel_scale=jnp.asarray(np.asarray(scales, np.float64), jnp.float32)
    )


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_fused_accel_scale_matches_xla(learn_jerk):
    """Bumpered mesh movers (qacc = accel_scale * command/act): the fused
    step matches the XLA path at std=0 (reference bumper mass,
    basic_envs.py:911-925)."""
    config, params = _mk(learn_jerk=learn_jerk)
    params = _scaled_params(params, [0.8125])  # exact in f32
    assert pallas_step.supports(config, params)
    b = 64
    state = _random_states(config, params, b, seed=51)
    limit = 80.0 if learn_jerk else 8.0
    actions = jax.random.uniform(jax.random.PRNGKey(52), (b, 2), jnp.float32, -limit, limit)

    xs, _, xr, xt, _, xi = planning.batched_step(config, params, state, actions)
    fs, _, fr, ft, _, fi = planning.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)(
        state, actions
    )

    # ulp-level tolerance: the extra accel_scale multiply lets XLA contract
    # FMAs differently in the two programs
    live = ~np.asarray(xt)
    tol = dict(rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(np.asarray(fs.pos)[live], np.asarray(xs.pos)[live], **tol)
    np.testing.assert_allclose(np.asarray(fs.vel)[live], np.asarray(xs.vel)[live], **tol)
    np.testing.assert_allclose(np.asarray(fs.acc)[live], np.asarray(xs.acc)[live], **tol)
    if learn_jerk:
        np.testing.assert_allclose(np.asarray(fs.act)[live], np.asarray(xs.act)[live], **tol)
        # the body accelerates slower than the integrator state
        moving = np.abs(np.asarray(xs.act)) > 1e-6
        assert (np.abs(np.asarray(xs.acc)[moving]) < np.abs(np.asarray(xs.act)[moving])).all()
    np.testing.assert_array_equal(np.asarray(fi['wall_collision']), np.asarray(xi['wall_collision']))


def test_fused_autoreset_accel_scale_matches_xla():
    """Single-mover in-kernel autoreset with accel_scale != 1: live-lane
    physics and rewards match the XLA step."""
    config, params = _mk()
    params = _scaled_params(params, [0.75])
    b = 64
    state = _random_states(config, params, b, seed=53)
    actions = jax.random.uniform(jax.random.PRNGKey(54), (b, 2), jnp.float32, -8.0, 8.0)

    xs, _, xr, xt, _, xi = planning.batched_step(config, params, state, actions)
    fs, fo, fr, ft, ftr, fi = planning.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)(
        state, actions
    )

    live = ~np.asarray(xt)
    tol = dict(rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(np.asarray(fs.pos)[live], np.asarray(xs.pos)[live], **tol)
    np.testing.assert_allclose(np.asarray(fs.vel)[live], np.asarray(xs.vel)[live], **tol)
    np.testing.assert_allclose(np.asarray(fs.acc)[live], np.asarray(xs.acc)[live], **tol)
    np.testing.assert_array_equal(np.asarray(fr), np.asarray(xr))


# ---------------------------------------------------------------------------
# layout independence: batch tails, block size, launch splits
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('b', [200, 1000])
def test_lane_padding_bitmatches_padded_size_run(b):
    """A batch that the kernel's block does not divide runs through masked
    tail loads and stores, and its envs bit-match the same envs inside a
    larger batch (noise on: each env's stream comes from its own key)."""
    config, params = _mk(std=1e-5, num_cycles=4)
    step = planning.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)
    bp = b + 56
    state_p = _random_states(config, params, bp, seed=61)
    state = jax.tree_util.tree_map(lambda x: x[:b], state_p)
    actions = jax.random.uniform(jax.random.PRNGKey(62), (bp, 2), jnp.float32, -8.0, 8.0)

    s, o, r, te, tr, info = step(state, actions[:b])
    sp, op, rp, tep, trp, infop = step(state_p, actions)

    assert s.pos.shape[0] == b and r.shape[0] == b
    for x, y in [(s.pos, sp.pos), (s.vel, sp.vel), (s.goals, sp.goals), (s.steps, sp.steps), (r, rp),
                 (te, tep), (o['observation'], op['observation']),
                 (info['wall_collision'], infop['wall_collision'])]:
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y)[:b])


def _planning_vec(state):
    return planning._kernel_state(planning.PlanningConfig(num_movers=1), state)


@pytest.mark.parametrize('b', [1, 33, 4097])
def test_masked_tail_batches(b):
    """Batches of 1, a block plus one, and 4096 plus one: every env of the
    tail block is computed exactly as inside a full block."""
    config, params = _mk(std=1e-5, num_cycles=2)
    run = pallas_step.planning_kernel(config, params, 2, cand_k=2, interpret=True, block=128)
    bp = -(-b // 128) * 128 + 128
    state = _random_states(config, params, bp, seed=71)
    acts = jax.random.uniform(jax.random.PRNGKey(72), (2, bp, 2), jnp.float32, -8.0, 8.0)
    streams = pallas_step.env_streams(9, jnp.arange(bp))
    full = jax.jit(run)(streams, 0, _planning_vec(state), (acts[..., 0], acts[..., 1]))
    cut = jax.tree_util.tree_map(lambda x: x[..., :b], (streams, _planning_vec(state), acts[..., 0], acts[..., 1]))
    part = jax.jit(run)(cut[0], 0, cut[1], (cut[2], cut[3]))
    for x, y in zip(jax.tree_util.tree_leaves(part), jax.tree_util.tree_leaves(full)):
        assert x.shape[-1] == b
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y)[..., :b])
        assert np.isfinite(np.asarray(x)).all()


@pytest.mark.parametrize('block', [32, 64, 128])
def test_kernel_bitidentical_across_envs_per_program(block):
    """The envs-per-program choice changes only the launch shape: results
    are bit-identical to one env per program (pushing, noise on, restarts)."""
    config, params = _mk_push(std=1e-5, num_cycles=4)
    b = 200
    state, _, _ = pushing.init_batch(config, params, jax.random.PRNGKey(81), b)
    state = dataclasses.replace(state, steps=jnp.full((b,), config.max_episode_steps - 1, jnp.int32))
    acts = jax.random.uniform(jax.random.PRNGKey(82), (2, b, 2), jnp.float32, -8.0, 8.0)
    streams = pallas_step.env_streams(5, jnp.arange(b))
    vec = pushing._kernel_state(state)
    ref = pallas_step.pushing_kernel(config, params, 2, cand_k=2, interpret=True, block=1, num_warps=1)
    got = pallas_step.pushing_kernel(config, params, 2, cand_k=2, interpret=True, block=block)
    out_ref = jax.jit(ref)(streams, 0, vec, (acts[..., 0], acts[..., 1]))
    out = jax.jit(got)(streams, 0, vec, (acts[..., 0], acts[..., 1]))
    for x, y in zip(jax.tree_util.tree_leaves(out), jax.tree_util.tree_leaves(out_ref)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert (np.asarray(out[1][2])[0] > 0.5).all()  # every env truncated and restarted


@pytest.mark.parametrize('steps_per_launch', [1, 2])
def test_fused_rollout_matches_per_step_path(steps_per_launch):
    """A 4-step rollout in ONE launch equals the same 4 steps split over
    launches of ``steps_per_launch`` (the step index keys the noise), noise,
    restarts and all — bit for bit."""
    config, params = _mk(std=1e-5, num_cycles=4)
    b, T = 64, 4
    state = _random_states(config, params, b, seed=71)
    state = dataclasses.replace(state, steps=jnp.full((b,), config.max_episode_steps - 2, jnp.int32))
    acts = jax.random.uniform(jax.random.PRNGKey(72), (T, b, 2), jnp.float32, -8.0, 8.0)
    fs, rew, te, tr = planning.make_fused_rollout(config, params, interpret=True, cand_k=2)(state, acts, 7)

    streams = pallas_step.env_streams(7, jnp.arange(b))
    run = pallas_step.planning_kernel(config, params, steps_per_launch, cand_k=2, interpret=True)
    vec = _planning_vec(state)
    rews = []
    for t0 in range(0, T, steps_per_launch):
        a = acts[t0:t0 + steps_per_launch]
        vec, (r, _, _), _ = run(streams, t0, vec, (a[..., 0], a[..., 1]))
        rews.append(np.asarray(r))
    np.testing.assert_array_equal(np.asarray(rew), np.concatenate(rews))
    np.testing.assert_array_equal(np.asarray(fs.pos)[:, 0, 0], np.asarray(vec['px']))
    np.testing.assert_array_equal(np.asarray(fs.goals)[:, 0, 1], np.asarray(vec['gy']))
    np.testing.assert_array_equal(np.asarray(fs.steps), np.asarray(vec['steps']).astype(np.int32))
    assert np.asarray(tr).any(), 'no truncation restart inside the rollout'
    assert rew.shape == (T, b) and te.shape == (T, b) and tr.shape == (T, b)


@pytest.mark.parametrize('steps_per_launch', [1, 2])
def test_fused_pushing_rollout_matches_per_step_path(steps_per_launch):
    """Pushing: one launch of 4 steps vs launches of ``steps_per_launch``
    steps — identical, with contact firing and restarts inside the window."""
    config, params = _mk_push(std=1e-5, num_cycles=4)
    b, T = 64, 4
    state, _, _ = pushing.init_batch(config, params, jax.random.PRNGKey(81), b)
    state = dataclasses.replace(
        state,
        pos=state.obj_pos + jnp.asarray([-0.115, 0.0], jnp.float32),
        vel=jnp.tile(jnp.asarray([0.3, 0.0], jnp.float32), (b, 1)),
        steps=jnp.full((b,), config.max_episode_steps - 2, jnp.int32),
    )
    acts = jnp.tile(jnp.asarray([1.5, 0.2], jnp.float32), (T, b, 1))
    fs, rew, te, tr = pushing.make_fused_rollout(config, params, interpret=True, cand_k=2)(state, acts, 7)

    streams = pallas_step.env_streams(7, jnp.arange(b))
    run = pallas_step.pushing_kernel(config, params, steps_per_launch, cand_k=2, interpret=True)
    vec = pushing._kernel_state(state)
    rews = []
    for t0 in range(0, T, steps_per_launch):
        a = acts[t0:t0 + steps_per_launch]
        vec, (r, _, _), _ = run(streams, t0, vec, (a[..., 0], a[..., 1]))
        rews.append(np.asarray(r))
    np.testing.assert_array_equal(np.asarray(rew), np.concatenate(rews))
    np.testing.assert_array_equal(np.asarray(fs.obj_pos)[:, 0], np.asarray(vec['ox']))
    np.testing.assert_array_equal(np.asarray(fs.mover_z), np.asarray(vec['mz']))
    assert set(np.unique(np.asarray(rew))) <= {0.0, -1.0, -50.0}
    assert np.asarray(tr).any()


def test_rollout_lane_padding_any_batch():
    """b=72 runs the one-launch rollout and equals the first 72 rows of a
    128-env rollout with the same seed (noise is keyed by global env index)."""
    config, params = _mk_push(std=1e-5, num_cycles=4)
    T = 2
    state128, _, _ = pushing.init_batch(config, params, jax.random.PRNGKey(2), 128)
    state72 = jax.tree_util.tree_map(lambda x: x[:72], state128)
    acts = jax.random.uniform(jax.random.PRNGKey(3), (T, 128, 2), jnp.float32, -3.0, 3.0)
    rollout = pushing.make_fused_rollout(config, params, interpret=True)
    f72, r72, t72, tr72 = jax.jit(lambda s, a: rollout(s, a, 11))(state72, acts[:, :72])
    assert f72.pos.shape == (72, 2) and r72.shape == (T, 72)
    f128, r128, _, _ = jax.jit(lambda s, a: rollout(s, a, 11))(state128, acts)
    np.testing.assert_array_equal(np.asarray(f72.pos), np.asarray(f128.pos[:72]))
    np.testing.assert_array_equal(np.asarray(f72.obj_pos), np.asarray(f128.obj_pos[:72]))
    np.testing.assert_array_equal(np.asarray(r72), np.asarray(r128[:, :72]))


# ---------------------------------------------------------------------------
# pushing kernel vs XLA at std=0
# ---------------------------------------------------------------------------


def _fused_push_step(config, params, state, actions):
    return pushing.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)(state, actions)


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_fused_pushing_matches_xla_at_zero_noise(learn_jerk):
    config, params = _mk_push(std=0.0, learn_jerk=learn_jerk)
    b = 64
    state, obs, _ = pushing.init_batch(config, params, jax.random.PRNGKey(0), b)
    # plant the movers right next to the object so contact fires
    state = dataclasses.replace(
        state,
        pos=state.obj_pos + jnp.asarray([-0.115, 0.0], jnp.float32),
        vel=jnp.tile(jnp.asarray([0.4, 0.0], jnp.float32), (b, 1)),
    )
    limit = 80.0 if learn_jerk else 8.0
    actions = jax.random.uniform(jax.random.PRNGKey(1), (b, 2), jnp.float32, -limit, limit)

    xs, _, xr, xt, _, xi = pushing.batched_step(config, params, state, actions)
    fs, _, fr, ft, _, fi = _fused_push_step(config, params, state, actions)

    # ulp-level tolerance: the two programs fuse multiplies differently (FMA
    # contraction), so contact-coupled quantities can differ in the last bit;
    # the z-overlap multiply (quasi-3D climb) adds one more rounding per cycle
    live = ~np.asarray(xt)
    tol = dict(rtol=2e-6, atol=2e-6)
    np.testing.assert_allclose(np.asarray(fs.pos)[live], np.asarray(xs.pos)[live], **tol)
    np.testing.assert_allclose(np.asarray(fs.vel)[live], np.asarray(xs.vel)[live], **tol)
    np.testing.assert_allclose(np.asarray(fs.obj_pos)[live], np.asarray(xs.obj_pos)[live], **tol)
    np.testing.assert_allclose(np.asarray(fs.obj_vel)[live], np.asarray(xs.obj_vel)[live], **tol)
    np.testing.assert_allclose(np.asarray(fs.acc)[live], np.asarray(xs.acc)[live], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(fi['wall_collision']), np.asarray(xi['wall_collision']))
    np.testing.assert_array_equal(np.asarray(fr), np.asarray(xr))
    # object moved for at least some envs (contact actually exercised)
    assert (np.abs(np.asarray(fs.obj_pos - state.obj_pos)) > 1e-5).any()


def test_fused_pushing_diagonal_contact_matches_xla():
    """DIAGONAL (corner) contact at std=0: the hysteretic normal-axis carry
    must behave identically in the kernel and the XLA path over multiple
    steps of sustained corner pushing."""
    config, params = _mk_push(std=0.0)
    b = 64
    state, obs, _ = pushing.init_batch(config, params, jax.random.PRNGKey(41), b)
    state = dataclasses.replace(
        state,
        pos=state.obj_pos + jnp.asarray([-0.0795, -0.0790], jnp.float32),
        vel=jnp.tile(jnp.asarray([0.3, 0.28], jnp.float32), (b, 1)),
    )
    actions = jnp.tile(jnp.asarray([2.0, 1.9], jnp.float32), (b, 1))
    step = pushing.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)

    tol = dict(rtol=2e-6, atol=2e-7)
    for t in range(3):
        xs, _, xr, xt, _, xi = pushing.batched_step(config, params, state, actions)
        fs, _, fr, ft, _, fi = step(state, actions)
        live = ~np.asarray(xt)
        np.testing.assert_allclose(np.asarray(fs.obj_pos)[live], np.asarray(xs.obj_pos)[live], **tol)
        np.testing.assert_allclose(np.asarray(fs.obj_yaw)[live], np.asarray(xs.obj_yaw)[live], rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(fs.pos)[live], np.asarray(xs.pos)[live], **tol)
        state = xs
    assert (np.abs(np.asarray(state.obj_pos - state.pos)) > 0.05).any()


def test_fused_pushing_cone_share_matches_xla():
    """Elliptic-cone budget share ENGAGED (cone_zeta > 0, diagonal slip):
    the kernel's f_z / lateral-cap / floor-load math must track the XLA
    path through a sustained corner push — the corner-escape fix."""
    config, params = _mk_push(std=0.0)
    params = dataclasses.replace(
        params,
        cone_zeta=jnp.asarray(0.8, jnp.float32),
        cone_vt=jnp.asarray(0.25, jnp.float32),
        cone_plow=jnp.asarray(1.0, jnp.float32),
    )
    b = 64
    state, obs, _ = pushing.init_batch(config, params, jax.random.PRNGKey(43), b)
    state = dataclasses.replace(
        state,
        pos=state.obj_pos + jnp.asarray([-0.0795, -0.0790], jnp.float32),
        vel=jnp.tile(jnp.asarray([0.35, 0.33], jnp.float32), (b, 1)),
    )
    actions = jnp.tile(jnp.asarray([4.0, 3.7], jnp.float32), (b, 1))
    step = pushing.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)

    tol = dict(rtol=3e-5, atol=3e-6)  # extra sqrt/div in the cap: a few ulp more
    # the lateral-pinned object sits AT the Coulomb stick/slip boundary, where
    # the floor step's 1 - mu*g*dt*load/|v| amplifies ulp/FMA differences into
    # ~1e-5 m/s velocity noise (physically: pinned either way)
    vel_tol = dict(rtol=3e-5, atol=1e-4)
    moved_lat = False
    for t in range(3):
        xs, _, xr, xt, _, xi = pushing.batched_step(config, params, state, actions)
        fs, _, fr, ft, _, fi = step(state, actions)
        live = ~np.asarray(xt)
        np.testing.assert_allclose(np.asarray(fs.obj_pos)[live], np.asarray(xs.obj_pos)[live], **tol)
        np.testing.assert_allclose(np.asarray(fs.obj_vel)[live], np.asarray(xs.obj_vel)[live], **vel_tol)
        np.testing.assert_allclose(np.asarray(fs.pos)[live], np.asarray(xs.pos)[live], **tol)
        moved_lat = moved_lat or bool((np.abs(np.asarray(xs.obj_pos - state.obj_pos)) > 1e-5).any())
        state = xs
    assert moved_lat, 'corner push never moved the object'
    # the share actually binds: same push with zeta=0 gives a DIFFERENT object path
    params0 = dataclasses.replace(params, cone_zeta=jnp.asarray(0.0, jnp.float32))
    xs0, *_ = pushing.batched_step(config, params0, state, actions)
    xs1, *_ = pushing.batched_step(config, params, state, actions)
    assert np.abs(np.asarray(xs0.obj_pos) - np.asarray(xs1.obj_pos)).max() > 1e-6


@pytest.mark.parametrize('learn_jerk', [False, True])
def test_fused_pushing_mesh_bumper_matches_xla(learn_jerk):
    """Bumpered mesh mover in the pushing kernel: accel_scale on the
    command, total body mass under the contact reaction — the fused kernel
    must track the XLA path through contact."""
    config, params = _mk_push(
        std=0.0, learn_jerk=learn_jerk,
        mover_params={'shape': 'mesh', 'mesh': {'bumper_mass': 0.35}},
    )
    assert float(params.accel_scale) < 1.0 and float(params.total_mass) > float(params.mover_mass)
    b = 64
    state, obs, _ = pushing.init_batch(config, params, jax.random.PRNGKey(0), b)
    state = dataclasses.replace(
        state,
        pos=state.obj_pos + jnp.asarray([-(float(params.mover_half[0]) + 0.034), 0.0], jnp.float32),
        vel=jnp.tile(jnp.asarray([0.4, 0.0], jnp.float32), (b, 1)),
    )
    limit = 80.0 if learn_jerk else 8.0
    actions = jax.random.uniform(jax.random.PRNGKey(1), (b, 2), jnp.float32, -limit, limit)

    xs, _, xr, xt, _, xi = pushing.batched_step(config, params, state, actions)
    fs, _, fr, ft, _, fi = _fused_push_step(config, params, state, actions)

    live = ~np.asarray(xt)
    tol = dict(rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(np.asarray(fs.pos)[live], np.asarray(xs.pos)[live], **tol)
    np.testing.assert_allclose(np.asarray(fs.vel)[live], np.asarray(xs.vel)[live], **tol)
    np.testing.assert_allclose(np.asarray(fs.obj_pos)[live], np.asarray(xs.obj_pos)[live], **tol)
    np.testing.assert_allclose(np.asarray(fs.acc)[live], np.asarray(xs.acc)[live], rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(fi['wall_collision']), np.asarray(xi['wall_collision']))
    assert (np.abs(np.asarray(fs.obj_pos - state.obj_pos)) > 1e-5).any(), 'contact never fired'


@pytest.mark.gpu
def test_compiled_kernel_matches_interpret_mode(gpu_device):
    """On the card: the compiled Triton kernel equals its interpret-mode run
    at std=0 within FMA tolerance, flags and rewards exactly."""
    config, params = _mk_push(std=0.0)
    b = 1000
    state, _, _ = pushing.init_batch(config, params, jax.random.PRNGKey(0), b)
    acts = jax.random.uniform(jax.random.PRNGKey(1), (3, b, 2), jnp.float32, -8.0, 8.0)
    streams = pallas_step.env_streams(1, jnp.arange(b))
    vec = pushing._kernel_state(state)
    args = (streams, 0, vec, (acts[..., 0], acts[..., 1]))
    with jax.default_device(jax.devices('cpu')[0]):
        ref = pallas_step.pushing_kernel(config, params, 3, interpret=True)(*jax.device_put(args, jax.devices('cpu')[0]))
    got = pallas_step.pushing_kernel(config, params, 3)(*jax.device_put(args, gpu_device))
    np.testing.assert_array_equal(np.asarray(got[1][0]), np.asarray(ref[1][0]))
    np.testing.assert_allclose(np.asarray(got[0]['ox']), np.asarray(ref[0]['ox']), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# long-running: 40 cycles, box shapes, noise and reset distributions
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize('learn_jerk', [False, True])
def test_fused_matches_xla_at_zero_noise(learn_jerk):
    config, params = _mk(learn_jerk=learn_jerk, num_cycles=40)
    b = 128
    state = _random_states(config, params, b)
    limit = 80.0 if learn_jerk else 8.0
    actions = jax.random.uniform(jax.random.PRNGKey(1), (b, 2), jnp.float32, -limit, limit)
    xs, _, xr, xt, _, xi = planning.batched_step(config, params, state, actions)
    fs, _, fr, ft, _, fi = planning.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)(
        state, actions
    )
    live = ~np.asarray(xt)
    np.testing.assert_array_equal(np.asarray(fs.pos)[live], np.asarray(xs.pos)[live])
    np.testing.assert_array_equal(np.asarray(fs.vel)[live], np.asarray(xs.vel)[live])
    np.testing.assert_array_equal(np.asarray(fi['wall_collision']), np.asarray(xi['wall_collision']))
    np.testing.assert_array_equal(np.asarray(fr), np.asarray(xr))


def _mk_box():
    layout = np.array([[1, 1, 1], [1, 1, 0], [1, 1, 1]])
    return planning.make_planning_env(
        layout, 1, std_noise=0.0, num_cycles=8, v_max=1.0, a_max=8.0, dtype=jnp.float32,
        collision_params={'shape': 'box', 'size': np.array([0.09, 0.08])},
    )


@pytest.mark.slow
def test_fused_box_shape_matches_xla():
    """Box collision shape in-kernel: rotated-vertex wall checks + corner
    rect tests match ``ops/walls`` at std=0 on a holed layout."""
    config, params = _mk_box()
    b = 128
    # plant against the missing-tile wall: both the edge tests and the
    # missing-corner rectangle tests fire within 2 steps
    ys = np.linspace(0.30, 0.42, b)
    plant = np.stack([np.full(b, 0.55), ys], axis=-1)[:, None, :]
    keys = jax.random.split(jax.random.PRNGKey(31), b)
    state, _, _ = jax.vmap(lambda k, s: planning.reset(config, params, k, start_xy=s))(
        keys, jnp.asarray(plant, jnp.float32)
    )
    step = planning.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)
    hit_any = False
    for t in range(2):
        actions = jnp.tile(jnp.asarray([6.0, 2.0], jnp.float32), (b, 1))
        xs, _, _, xt, _, xi = planning.batched_step(config, params, state, actions)
        fs, _, _, ft, _, fi = step(state, actions)
        live = ~np.asarray(xt)
        np.testing.assert_array_equal(np.asarray(fs.pos)[live], np.asarray(xs.pos)[live], err_msg=f't={t}')
        np.testing.assert_array_equal(
            np.asarray(fi['wall_collision']), np.asarray(xi['wall_collision']), err_msg=f't={t}'
        )
        hit_any = hit_any or bool(np.asarray(xi['wall_collision']).any())
        state = xs
    assert hit_any, 'no box wall collision ever fired'


def _restart_all(state, config):
    return dataclasses.replace(state, steps=jnp.full(state.steps.shape, config.max_episode_steps - 1, jnp.int32))


@pytest.mark.slow
def test_fused_box_autoreset_restarts_box_valid():
    """In-kernel box autoreset restarts at box-valid positions."""
    from gymnasium_planar_robotics_tpu.models.common import IDENTITY_QUAT
    from gymnasium_planar_robotics_tpu.ops import walls

    config, params = _mk_box()
    b = 128
    step = planning.make_fused_step_autoreset(config, params, interpret=True, cand_k=4)
    state = _random_states(config, params, b, seed=35)
    actions = jnp.zeros((b, 2), jnp.float32)
    starts = []
    for t in range(2):
        state, obs, rew, term, trunc, info = step(_restart_all(state, config), actions)
        fresh = (np.asarray(term) | np.asarray(trunc)) & ~np.asarray(info['reset_stalled'])
        starts.append(np.asarray(state.pos)[fresh, 0])
    starts = np.concatenate(starts)
    assert len(starts) > 200
    c_sample = np.asarray(params.c_size).reshape(1, 2) + float(params.c_offset) + float(params.c_offset_wall)
    quat = jnp.tile(jnp.asarray([IDENTITY_QUAT], jnp.float32), (len(starts), 1))
    valid = np.asarray(
        walls.qpos_is_valid(
            params.grid, jnp.asarray(starts), jnp.broadcast_to(c_sample, (len(starts), 2)),
            quat=quat, collision_shape='box',
        )
    )
    assert valid.all(), 'a box-shape reset restarted at a wall-invalid pose'


@pytest.mark.slow
def test_fused_noise_flows_and_matches_xla_distribution():
    """std>0: the fused path's collision rates and speeds match the XLA path
    distributionally — and MOVE when the noise does (guards against a
    silently dead noise path)."""
    config, params = _mk(std=3e-3, num_cycles=40)
    config0, params0 = _mk(std=0.0, num_cycles=40)
    b = 512
    state = _random_states(config, params, b, seed=7)
    step = planning.make_fused_step_autoreset(config, params, interpret=True, cand_k=2)
    step0 = planning.make_fused_step_autoreset(config0, params0, interpret=True, cand_k=2)
    actions = jnp.tile(jnp.asarray([6.0, 0.0], jnp.float32), (b, 1))  # drive at the wall

    walls_x, walls_f, speed_x, speed_f = [], [], [], []
    sx = sf = state
    for t in range(5):
        sx2, _, _, _, _, ix = planning.batched_step(config, params, sx, actions)
        sf2, _, _, xt, _, iff = step(sf, actions)
        if t == 0:
            zero_vel = np.asarray(step0(sf, actions)[0].vel)
        walls_x.append(np.asarray(ix['wall_collision']).mean())
        walls_f.append(np.asarray(iff['wall_collision']).mean())
        speed_x.append(np.linalg.norm(np.asarray(sx2.vel), axis=-1).mean())
        speed_f.append(np.linalg.norm(np.asarray(iff['final_observation']['observation']), axis=-1).mean())
        sx, sf = sx2, sf2
    np.testing.assert_allclose(np.mean(speed_x), np.mean(speed_f), rtol=0.05)
    np.testing.assert_allclose(np.mean(walls_x), np.mean(walls_f), atol=0.03)
    assert np.mean(walls_x) > 0.01 and np.mean(walls_f) > 0.01
    assert np.abs(np.asarray(step(state, actions)[0].vel) - zero_vel).max() > 0  # noise reached the state


@pytest.mark.slow
def test_reset_sampling_wall_valid_and_uniform():
    """In-kernel reset draws (planning, holed layout): every restart is
    wall-valid at the inflated sampling radius, and accepted draws cover the
    valid region uniformly."""
    from gymnasium_planar_robotics_tpu.ops import walls

    layout = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]])
    config, params = planning.make_planning_env(
        layout, 1, std_noise=1e-5, num_cycles=10, dtype=jnp.float32,
        collision_params={'shape': 'circle', 'size': 0.05, 'offset': 0.0, 'offset_wall': 0.0},
    )
    b = 1024
    state = _random_states(config, params, b, seed=13)
    step = planning.make_fused_step_autoreset(config, params, interpret=True, cand_k=8)
    actions = jnp.zeros((b, 2), jnp.float32)
    c_sample = params.c_size + params.c_offset + params.c_offset_wall
    starts, goals = [], []
    for t in range(2):
        state, obs, rew, term, trunc, info = step(_restart_all(state, config), actions)
        done = np.asarray(term) | np.asarray(trunc)
        assert done.all()
        fresh = done & ~np.asarray(info['reset_stalled'])
        starts.append(np.asarray(state.pos)[fresh, 0])
        goals.append(np.asarray(state.goals)[fresh, 0])
        assert (np.asarray(info['reset_trials'])[fresh] >= 2).all()
    starts, goals = np.concatenate(starts), np.concatenate(goals)
    assert len(starts) > 1900

    rng = np.random.default_rng(0)
    cand = rng.uniform(np.asarray(params.min_xy), np.asarray(params.max_xy), (20000, 2)).astype(np.float32)
    ok = np.asarray(walls.qpos_is_valid(params.grid, jnp.asarray(cand), jnp.broadcast_to(c_sample, (len(cand),))))
    oracle = cand[ok]
    cx = float(params.max_xy[0] + params.min_xy[0]) / 2
    cy = float(params.max_xy[1] + params.min_xy[1]) / 2

    def quadrants(pts):
        return np.array([
            ((pts[:, 0] < cx) & (pts[:, 1] < cy)).mean(), ((pts[:, 0] < cx) & (pts[:, 1] >= cy)).mean(),
            ((pts[:, 0] >= cx) & (pts[:, 1] < cy)).mean(), ((pts[:, 0] >= cx) & (pts[:, 1] >= cy)).mean(),
        ])

    for pts in (starts, goals):
        valid = np.asarray(walls.qpos_is_valid(params.grid, jnp.asarray(pts), jnp.broadcast_to(c_sample, (len(pts),))))
        assert valid.all(), 'an in-kernel reset restarted at a wall-invalid position'
        assert (np.abs(quadrants(pts) - quadrants(oracle)) < 0.05).all()
        assert pts[:, 0].min() < float(params.min_xy[0]) + 0.05
        assert pts[:, 0].max() > float(params.max_xy[0]) - 0.05


@pytest.mark.slow
def test_reset_stall_reported_and_env_not_reset():
    """A sampling region that lies inside the layout's hole: every candidate
    is wall-invalid, so done envs must NOT restart (state and step counter
    carry over) and info must flag the stall."""
    layout = np.array([[1, 1, 1], [1, 0, 1], [1, 1, 1]])
    config, params = planning.make_planning_env(layout, 1, std_noise=1e-5, num_cycles=4, dtype=jnp.float32)
    b = 128
    state = _random_states(config, params, b, seed=19)
    hole = np.asarray(params.grid.tile_x)[1, 1], np.asarray(params.grid.tile_y)[1, 1]
    params = dataclasses.replace(
        params,
        min_xy=jnp.asarray([hole[0] - 0.01, hole[1] - 0.01], jnp.float32),
        max_xy=jnp.asarray([hole[0] + 0.01, hole[1] + 0.01], jnp.float32),
    )
    step = planning.make_fused_step_autoreset(config, params, interpret=True)
    prev = _restart_all(state, config)
    state, obs, rew, term, trunc, info = step(prev, jnp.zeros((b, 2), jnp.float32))
    done = np.asarray(term) | np.asarray(trunc)
    assert done.all()
    np.testing.assert_array_equal(np.asarray(info['reset_stalled']), done)
    assert (np.asarray(state.steps) == config.max_episode_steps).all()
    assert (np.asarray(info['reset_trials']) == 32).all()
    np.testing.assert_array_equal(np.asarray(state.goals), np.asarray(prev.goals))


@pytest.mark.slow
def test_pushing_reset_respects_min_distance():
    config, params = pushing.make_pushing_env(std_noise=1e-5, num_cycles=10, dtype=jnp.float32)
    b = 512
    state, obs, _ = pushing.init_batch(config, params, jax.random.PRNGKey(29), b)
    step = pushing.make_fused_step_autoreset(config, params, interpret=True)
    actions = jnp.zeros((b, 2), jnp.float32)
    movers, objs, goals = [], [], []
    for t in range(2):
        state, obs, rew, term, trunc, info = step(_restart_all(state, config), actions)
        done = np.asarray(term) | np.asarray(trunc)
        assert done.all()
        fresh = done & ~np.asarray(info['reset_stalled'])
        movers.append(np.asarray(state.pos)[fresh])
        objs.append(np.asarray(state.obj_pos)[fresh])
        goals.append(np.asarray(state.goal)[fresh])
    movers, objs, goals = map(np.concatenate, (movers, objs, goals))
    assert len(movers) > 900
    # reference acceptance rule: object strictly farther than min_mo_dist
    # from the freshly placed mover (benchmark_pushing_env.py:394-407)
    d = np.linalg.norm(objs - movers, axis=-1)
    assert (d > float(params.min_mo_dist) - 1e-6).all()
    for pts, lo, hi in ((movers, params.min_xy, params.max_xy),
                        (objs, params.obj_min_xy, params.obj_max_xy),
                        (goals, params.obj_min_xy, params.obj_max_xy)):
        lo, hi = np.asarray(lo), np.asarray(hi)
        assert (pts >= lo - 1e-5).all() and (pts <= hi + 1e-5).all()
    center = (np.asarray(params.obj_min_xy) + np.asarray(params.obj_max_xy)) / 2
    span = np.asarray(params.obj_max_xy) - np.asarray(params.obj_min_xy)
    assert (np.abs(goals.mean(0) - center) < 0.1 * span).all()


@pytest.mark.slow
def test_fused_autoreset_restarts_episodes():
    config, params = _mk(std=1e-5)
    b = 128
    # plant near the +x wall so the slam terminates within a few short steps
    xs = np.linspace(0.55, 0.62, b)
    plant = np.stack([xs, np.full(b, 0.36)], axis=-1)[:, None, :]
    keys = jax.random.split(jax.random.PRNGKey(11), b)
    state, _, _ = jax.vmap(lambda k, s: planning.reset(config, params, k, start_xy=s))(
        keys, jnp.asarray(plant, jnp.float32)
    )
    step = planning.make_fused_step_autoreset(config, params, interpret=True, cand_k=8)
    actions = jnp.tile(jnp.asarray([8.0, 0.0], jnp.float32), (b, 1))  # slam the wall
    terminated_any = False
    for _ in range(4):
        state, obs, rew, term, trunc, info = step(state, actions)
        terminated_any = terminated_any or bool(np.asarray(term).any())
        done = (np.asarray(term) | np.asarray(trunc)) & ~np.asarray(info['reset_stalled'])
        assert (np.asarray(state.steps)[done] == 0).all()
        pos = np.asarray(state.pos)[done]
        if pos.size:
            assert (pos >= np.asarray(params.min_xy) - 1e-6).all()
            assert (pos <= np.asarray(params.max_xy) + 1e-6).all()
    assert terminated_any, 'wall slam never terminated an episode'


@pytest.mark.slow
@pytest.mark.parametrize('learn_jerk', [False, True])
def test_fused_pushing_inkernel_autoreset_semantics(learn_jerk):
    """In-kernel reset (acc AND jerk modes): step counters, goal switching,
    final-obs bookkeeping, reward values."""
    config, params = _mk_push(std=0.0, learn_jerk=learn_jerk)
    b = 128
    state, obs, _ = pushing.init_batch(config, params, jax.random.PRNGKey(3), b)
    step = pushing.make_fused_step_autoreset(config, params, interpret=True)
    drive = 70.0 if learn_jerk else 9.0
    actions = jnp.tile(jnp.asarray([drive, 0.0], jnp.float32), (b, 1))
    resets = 0
    for t in range(6):
        prev_goal = np.asarray(state.goal)
        state, obs, rew, term, trunc, info = step(state, actions)
        assert obs['observation'].shape == (b, 6 if learn_jerk else 4)
        done = (np.asarray(term) | np.asarray(trunc)) & ~np.asarray(info['reset_stalled'])
        resets += int(done.sum())
        keep = ~done
        assert (np.asarray(state.steps)[done] == 0).all()
        assert (np.abs(np.asarray(state.vel)[done]) < 1e-6).all()
        # final_observation keeps the OLD goal; out obs carries the new state goal
        np.testing.assert_allclose(np.asarray(info['final_observation']['desired_goal']), prev_goal, atol=1e-6)
        np.testing.assert_allclose(np.asarray(obs['desired_goal']), np.asarray(state.goal), atol=1e-6)
        np.testing.assert_allclose(np.asarray(state.goal)[keep], prev_goal[keep], atol=1e-6)
        assert set(np.unique(np.asarray(rew))) <= {0.0, -1.0, -50.0}
        assert (np.asarray(rew)[np.asarray(term)] == -50.0).all()
    assert resets > 0, 'no episode ever restarted'
