"""Hindsight Experience Replay on sparse rewards, fully on device.

The reference's actual training recipe is SB3 HER + an off-policy learner on
the sparse goal-conditioned rewards (``/root/reference/docs/train_agents.rst``;
the envs' batched ``compute_reward(achieved, desired, info)`` signature with
collision flags riding in ``info`` exists precisely so relabeling never
re-runs collision checks — basic_envs.py:1993-1995).  This module is the
on-device equivalent: one jitted program per iteration that

1. rolls the batched env ``T`` steps with exploration noise,
2. relabels goals with the 'future' strategy INSIDE the rollout window —
   per (env, t), a uniformly drawn future step of the same episode (episode
   boundaries found by a reverse scan over the done flags) donates its
   achieved goal, and the reward/termination are recomputed by the same pure
   ``compute_reward`` HER calls in the reference,
3. runs DDPG updates (actor + critic + soft target nets) on the original +
   relabeled transitions.

Everything is ``[T, B]``-shaped array math — no replay-buffer host loop.
The actor and critic matmuls run at XLA's default float32 precision (TF32 on
NVIDIA GPUs), as in ``models/ppo``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import jax
import jax.numpy as jnp
import optax


@dataclasses.dataclass(frozen=True)
class HERConfig:
    obs_dim: int  # non-goal observation width
    goal_dim: int
    action_dim: int
    hidden: tuple[int, ...] = (128, 128)
    action_scale: float = 3.0
    rollout_steps: int = 16
    gamma: float = 0.95
    tau: float = 0.05
    actor_lr: float = 1e-3
    critic_lr: float = 1e-3
    relabel_prob: float = 0.8
    explore_std: float = 0.3
    explore_eps: float = 0.3  # fraction of fully-random actions (standard HER)
    reward_scale: float = 0.02  # critic trains on r*scale (sparse ±50 -> ±1)
    update_steps: int = 10
    #: transitions kept in the on-device circular replay buffer; 0 = train on
    #: the current rollout window only.  Replay is the stabilizer the
    #: reference recipe gets from SB3's HerReplayBuffer (docs/train_agents.rst):
    #: rare contact-progress transitions survive many updates instead of
    #: washing away with the window
    replay_size: int = 0
    minibatch: int = 4096  # replay minibatch per update step
    #: actor loss += action_l2 * mean((a/scale)^2) — the standard HER actor
    #: regularizer (keeps the deterministic policy off the action limits,
    #: where DDPG's critic-exploitation divergence starts)
    action_l2: float = 0.0
    #: TD3-style clipped double-Q (Fujimoto et al. 2018): two critics, the
    #: Bellman target takes min(Q1', Q2') — removes the overestimation
    #: spiral that caps plain DDPG on sparse contact rewards.  The round-5
    #: lever that took pushing HER from 13% to a strong result
    twin_critic: bool = False
    #: target policy smoothing: clipped Gaussian noise (std as a fraction of
    #: action_scale) added to the target action in the Bellman backup
    target_noise: float = 0.0
    noise_clip: float = 0.5
    #: actor/target update every k-th critic update (TD3 delayed policy)
    policy_delay: int = 1
    #: n-step Bellman targets (round 5): each stored transition carries the
    #: discounted sum of the next n rewards (cut at episode boundaries and,
    #: for relabeled goals, at relabeled success) and bootstraps from the
    #: state n steps ahead with per-sample discount gamma^n_eff — the sparse
    #: -1/step signal propagates n times faster down the value chain
    n_step: int = 1
    #: temporally correlated exploration (round 5): decide the explore_eps
    #: random-action coin PER EPISODE (redrawn at autoreset boundaries), and
    #: hold ONE random action direction for the whole episode instead of
    #: redrawing per step.  Per-step random forces on an inertial mover
    #: average to zero (it dithers in place); an episode-long random push
    #: sweeps the workspace — for pushing, that multiplies object-contact
    #: events, which is what 'future' relabeling learns from
    explore_per_episode: bool = False


def _mlp_init(key, sizes, dtype=jnp.float32, out_scale=0.01):
    keys = jax.random.split(key, len(sizes))
    layers = []
    for i in range(len(sizes) - 1):
        scale = out_scale if i == len(sizes) - 2 else jnp.sqrt(2.0 / sizes[i])
        layers.append({
            'w': jax.random.normal(keys[i], (sizes[i], sizes[i + 1]), dtype) * scale,
            'b': jnp.zeros(sizes[i + 1], dtype),
        })
    return layers


def _mlp(layers, x):
    for i, layer in enumerate(layers):
        x = jnp.dot(x, layer['w'], preferred_element_type=jnp.float32) + layer['b']
        if i < len(layers) - 1:
            x = jnp.tanh(x)
    return x


def init_params(key: jax.Array, cfg: HERConfig) -> dict:
    """Initialize DDPG/TD3 actor/critic MLPs plus their Polyak target copies.
    With ``cfg.twin_critic`` the critic pytree is a 2-element list of
    independently initialized MLPs (TD3 clipped double-Q)."""
    in_dim = cfg.obs_dim + 2 * cfg.goal_dim
    k_a, k_c, k_c2 = jax.random.split(key, 3)
    actor = _mlp_init(k_a, (in_dim, *cfg.hidden, cfg.action_dim))
    c_sizes = (in_dim + cfg.action_dim, *cfg.hidden, 1)
    critic = _mlp_init(k_c, c_sizes, out_scale=1.0)
    if cfg.twin_critic:
        critic = [critic, _mlp_init(k_c2, c_sizes, out_scale=1.0)]
    return {
        'actor': actor,
        'critic': critic,
        'actor_target': jax.tree_util.tree_map(jnp.copy, actor),
        'critic_target': jax.tree_util.tree_map(jnp.copy, critic),
    }


def actor_action(actor, obs_vec, scale):
    """Deterministic policy: tanh-squashed MLP output scaled to the action limit."""
    return jnp.tanh(_mlp(actor, obs_vec)) * scale


def _critic_heads(critic) -> list:
    """A single critic is an MLP (list of layer dicts); a twin critic is a
    2-element list of such MLPs."""
    return critic if isinstance(critic[0], list) else [critic]


def critic_q(critic, obs_vec, action):
    """State-action value estimate Q(s, a).  For a twin critic this returns
    the FIRST head — the one the actor ascends."""
    return _mlp(_critic_heads(critic)[0], jnp.concatenate([obs_vec, action], axis=-1))[..., 0]


def episode_end_indices(done: jnp.ndarray) -> jnp.ndarray:
    """[T, B] done flags -> [T, B] index of each step's episode end within
    the window (the first t' >= t with done[t'], else T-1)."""
    T = done.shape[0]

    def body(carry, x):
        t, d = x
        end = jnp.where(d, t, carry)
        return end, end

    ts = jnp.arange(T - 1, -1, -1, dtype=jnp.int32)
    init = jnp.full(done.shape[1:], T - 1, jnp.int32)
    _, ends_rev = jax.lax.scan(body, init, (ts, done[::-1]))
    return ends_rev[::-1]


def relabel_future(key, done, next_achieved, desired, relabel_prob):
    """'Future' HER relabeling over a [T, B] rollout window: per transition,
    with probability ``relabel_prob``, replace the desired goal with the
    achieved goal of a uniformly chosen step in [t, episode_end]."""
    T, B = done.shape
    ends = episode_end_indices(done)  # [T, B]
    k_u, k_p = jax.random.split(key)
    u = jax.random.uniform(k_u, (T, B))
    ts = jnp.arange(T)[:, None]
    span = (ends - ts + 1).astype(jnp.float32)
    future = ts + jnp.floor(u * span).astype(jnp.int32)
    future = jnp.clip(future, 0, T - 1)
    donor = jnp.take_along_axis(next_achieved, future[..., None], axis=0)
    use = jax.random.uniform(k_p, (T, B)) < relabel_prob
    return jnp.where(use[..., None], donor, desired), use


def nstep_backup(n: int, gamma: float, done: jnp.ndarray, reward_at, term_at, snext_at):
    """Per-transition n-step backup pieces over a [T, B] rollout window.

    ``reward_at(k) -> [T, B]``: reward of step t+k judged against transition
    t's goal; ``term_at(k) -> [T, B]`` its termination flag; ``snext_at(k)``
    the bootstrap state vector of step t+k.  Chains cut at env episode
    boundaries (``done``, autoreset), at goal-judged termination, and at the
    window end (bootstrapping there).  Returns ``(R_n, s_next_n, not_term_n,
    disc_n)`` where ``R_n[t] = sum_{k<n_eff} gamma^k r_{t+k}`` and
    ``disc_n = gamma^{n_eff}``."""
    T = done.shape[0]
    is_last = (jnp.arange(T) == T - 1)[:, None] & jnp.ones_like(done)

    def shift(x, k):
        if k == 0:
            return x
        pad = jnp.zeros((k,) + x.shape[1:], x.dtype)
        return jnp.concatenate([x[k:], pad], axis=0)

    zero = jnp.zeros_like(done, jnp.float32)
    racc, alive = zero, jnp.ones_like(done)
    s_next_n = jnp.zeros_like(snext_at(0))
    nt_n, disc_n = zero, zero
    for k in range(n):
        r_k = reward_at(k)
        term_k = term_at(k)
        racc = racc + jnp.where(alive, (gamma ** k) * r_k, 0.0)
        stop = shift(done, k) | term_k | shift(is_last, k) | (k == n - 1)
        final_here = alive & stop
        s_next_n = jnp.where(final_here[..., None], snext_at(k), s_next_n)
        nt_n = jnp.where(final_here, 1.0 - term_k.astype(jnp.float32), nt_n)
        disc_n = jnp.where(final_here, gamma ** (k + 1), disc_n)
        alive = alive & ~stop
    return racc, s_next_n, nt_n, disc_n


def init_replay(cfg: HERConfig) -> dict:
    """Zero-initialized circular replay buffer (a pytree carried in the
    runner; lives on device / sharded like any other state)."""
    d = cfg.obs_dim + 2 * cfg.goal_dim
    n = cfg.replay_size
    return {
        's': jnp.zeros((n, d), jnp.float32),
        'a': jnp.zeros((n, cfg.action_dim), jnp.float32),
        'r': jnp.zeros((n,), jnp.float32),
        's_next': jnp.zeros((n, d), jnp.float32),
        'not_term': jnp.zeros((n,), jnp.float32),
        # per-sample bootstrap discount gamma^n_eff (n-step; == gamma at n=1)
        'disc': jnp.zeros((n,), jnp.float32),
        'ptr': jnp.zeros((), jnp.int32),
        'filled': jnp.zeros((), jnp.int32),
    }


def _replay_insert(buf: dict, batch) -> dict:
    s, a, r, s_next, not_term, disc = batch
    n = buf['s'].shape[0]
    m = s.shape[0]
    idx = (buf['ptr'] + jnp.arange(m, dtype=jnp.int32)) % n
    return dict(
        buf,
        s=buf['s'].at[idx].set(s),
        a=buf['a'].at[idx].set(a),
        r=buf['r'].at[idx].set(r),
        s_next=buf['s_next'].at[idx].set(s_next),
        not_term=buf['not_term'].at[idx].set(not_term),
        disc=buf['disc'].at[idx].set(disc),
        ptr=(buf['ptr'] + m) % n,
        filled=jnp.minimum(buf['filled'] + m, n),
    )


def _replay_sample(buf: dict, key, minibatch: int):
    idx = jax.random.randint(key, (minibatch,), 0, jnp.maximum(buf['filled'], 1))
    return (buf['s'][idx], buf['a'][idx], buf['r'][idx], buf['s_next'][idx],
            buf['not_term'][idx], buf['disc'][idx])


def make_train_step(
    env_config,
    env_params,
    cfg: HERConfig,
    step_autoreset_fn: Callable | None,
    compute_reward_fn: Callable,
    terminated_fn: Callable,
    vec_fn: Callable | None = None,
    batched_step_fn: Callable | None = None,
):
    """Build ``train_step(runner) -> (runner, metrics)``.

    ``compute_reward_fn(achieved, desired, mover_col, wall_col)`` and
    ``terminated_fn(reward)`` are the env family's HER-relabeling surface
    (planning: ``|r| == 50``; pushing: ``r == -50``).

    ``vec_fn(obs_part, achieved, desired) -> [.., D]`` optionally replaces the
    plain concat network input — policy-internal featurization (e.g. the
    relative object/goal offsets pushing needs); it must be a pure function of
    the obs dict so the trained policy transfers to any engine serving the
    same observations.  ``cfg.obs_dim + 2*cfg.goal_dim`` must equal D.

    Pass EITHER ``step_autoreset_fn`` (a per-env step, vmapped here) or
    ``batched_step_fn(state, action)`` — an already-batched step such as the
    one ``ops/pallas_step.batched_autoreset_step`` chooses (same contract as
    ``ppo.make_train_step``)."""
    actor_opt = optax.adam(cfg.actor_lr)
    critic_opt = optax.adam(cfg.critic_lr)
    if batched_step_fn is not None:
        def batched_env_step(_config, _params, state, action):
            return batched_step_fn(state, action)
    else:
        assert step_autoreset_fn is not None, 'pass step_autoreset_fn or batched_step_fn'
        batched_env_step = jax.vmap(step_autoreset_fn, in_axes=(None, None, 0, 0))

    if vec_fn is not None:
        vec = vec_fn
    else:
        def vec(obs_part, achieved, desired):
            return jnp.concatenate([obs_part, achieved, desired], axis=-1).astype(jnp.float32)

    def _explore_init(key, obs):
        """Episode-exploration carry: (coin [B], held action [B, A]); drawn
        fresh at each rollout window start, redrawn at autoreset boundaries."""
        b = obs['achieved_goal'].shape[0]
        k_c, k_a = jax.random.split(jax.random.fold_in(key, 7))
        coin = jax.random.uniform(k_c, (b,)) < cfg.explore_eps
        held = jax.random.uniform(
            k_a, (b, cfg.action_dim), minval=-cfg.action_scale, maxval=cfg.action_scale
        )
        return coin, held

    def rollout_body(carry, _):
        env_state, obs, params, key, ep_rand, ep_a = carry
        key, k_n, k_e, k_u = jax.random.split(key, 4)
        a = actor_action(params['actor'], vec(obs['observation'], obs['achieved_goal'], obs['desired_goal']), cfg.action_scale)
        a = jnp.clip(a + cfg.explore_std * cfg.action_scale * jax.random.normal(k_n, a.shape), -cfg.action_scale, cfg.action_scale)
        # epsilon-random actions (the exploration half of the standard HER
        # recipe; pure parameter noise rarely leaves the start region)
        rand_a = jax.random.uniform(k_u, a.shape, minval=-cfg.action_scale, maxval=cfg.action_scale)
        if cfg.explore_per_episode:
            # episode-held coin + direction (see HERConfig.explore_per_episode)
            a = jnp.where(ep_rand[:, None], ep_a, a)
        else:
            use_rand = jax.random.uniform(k_e, a.shape[:1]) < cfg.explore_eps
            a = jnp.where(use_rand[:, None], rand_a, a)
        env_state, next_obs, reward, terminated, truncated, info = batched_env_step(
            env_config, env_params, env_state, a
        )
        if cfg.explore_per_episode:
            # redraw the episode coin/direction at autoreset boundaries
            ep_done = terminated | truncated
            new_rand = jax.random.uniform(k_e, a.shape[:1]) < cfg.explore_eps
            ep_rand = jnp.where(ep_done, new_rand, ep_rand)
            ep_a = jnp.where(ep_done[:, None], rand_a, ep_a)
        fin = info['final_observation']
        tr = dict(
            obs_part=obs['observation'],
            achieved=obs['achieved_goal'],
            desired=obs['desired_goal'],
            action=a,
            next_obs_part=fin['observation'],
            next_achieved=fin['achieved_goal'],
            reward=reward.astype(jnp.float32),
            terminated=terminated,
            truncated=truncated,
            mover_col=info['mover_collision'],
            wall_col=info['wall_collision'],
            success=info['is_success'],
        )
        return (env_state, next_obs, params, key, ep_rand, ep_a), tr

    def critic_loss(critic, params, batch, key):
        s, a, r, s_next, not_term, disc = batch
        a_next = actor_action(params['actor_target'], s_next, cfg.action_scale)
        if cfg.target_noise > 0.0:
            # TD3 target policy smoothing: clipped Gaussian on the backup action
            eps = jnp.clip(
                cfg.target_noise * jax.random.normal(key, a_next.shape),
                -cfg.noise_clip, cfg.noise_clip,
            ) * cfg.action_scale
            a_next = jnp.clip(a_next + eps, -cfg.action_scale, cfg.action_scale)
        q_nexts = [
            _mlp(c, jnp.concatenate([s_next, a_next], axis=-1))[..., 0]
            for c in _critic_heads(params['critic_target'])
        ]
        # clipped double-Q: the backup bootstraps from the PESSIMISTIC head
        q_next = q_nexts[0] if len(q_nexts) == 1 else jnp.minimum(*q_nexts)
        # the critic trains on scaled rewards (sparse ±50 -> ±1) with the
        # target clipped into the feasible return range — the standard HER
        # stabilization (without it the ±50 terminals blow up the Bellman
        # targets and the critic never settles)
        y = r * cfg.reward_scale + disc * not_term * q_next
        lim = 50.0 * cfg.reward_scale / (1.0 - cfg.gamma)
        y = jax.lax.stop_gradient(jnp.clip(y, -lim, lim))
        qs = [
            _mlp(c, jnp.concatenate([s, a], axis=-1))[..., 0]
            for c in _critic_heads(critic)
        ]
        return sum(((q - y) ** 2).mean() for q in qs)

    def actor_loss(actor, params, s):
        a = actor_action(actor, s, cfg.action_scale)
        reg = cfg.action_l2 * jnp.mean((a / cfg.action_scale) ** 2)
        return -critic_q(params['critic'], s, a).mean() + reg

    def train_step(runner):
        if cfg.replay_size > 0:
            env_state, obs, params, a_opt, c_opt, buffer, key = runner
        else:
            env_state, obs, params, a_opt, c_opt, key = runner
            buffer = None
        key, k_roll, k_rel, k_upd = jax.random.split(key, 4)
        (env_state, obs, params, *_), traj = jax.lax.scan(
            rollout_body, (env_state, obs, params, k_roll) + _explore_init(k_roll, obs),
            None, length=cfg.rollout_steps
        )

        done = traj['terminated'] | traj['truncated']
        new_desired, used = relabel_future(
            k_rel, done, traj['next_achieved'], traj['desired'], cfg.relabel_prob
        )
        new_reward = compute_reward_fn(
            traj['next_achieved'], new_desired, traj['mover_col'], traj['wall_col']
        ).astype(jnp.float32)
        new_term = terminated_fn(new_reward)

        def flat2(x):
            return x.reshape((-1,) + x.shape[2:])

        def shift(x, k):
            """x[t+k] along the window axis, zero-padded past the end (the
            padding is never read: every chain stops at the window cut)."""
            if k == 0:
                return x
            pad = jnp.zeros((k,) + x.shape[1:], x.dtype)
            return jnp.concatenate([x[k:], pad], axis=0)

        if cfg.n_step > 1:
            r_o, sn_o, nt_o, d_o = nstep_backup(
                cfg.n_step, cfg.gamma, done,
                lambda k: shift(traj['reward'], k),
                lambda k: shift(traj['terminated'], k),
                lambda k: vec(shift(traj['next_obs_part'], k),
                              shift(traj['next_achieved'], k), traj['desired']),
            )

            def rel_reward(k):
                return compute_reward_fn(
                    shift(traj['next_achieved'], k), new_desired,
                    shift(traj['mover_col'], k), shift(traj['wall_col'], k),
                ).astype(jnp.float32)

            r_r, sn_r, nt_r, d_r = nstep_backup(
                cfg.n_step, cfg.gamma, done,
                rel_reward, lambda k: terminated_fn(rel_reward(k)),
                lambda k: vec(shift(traj['next_obs_part'], k),
                              shift(traj['next_achieved'], k), new_desired),
            )
        else:
            gm = jnp.full_like(done, cfg.gamma, jnp.float32)
            r_o, sn_o = traj['reward'], vec(traj['next_obs_part'], traj['next_achieved'], traj['desired'])
            nt_o, d_o = 1.0 - traj['terminated'].astype(jnp.float32), gm
            r_r, sn_r = new_reward, vec(traj['next_obs_part'], traj['next_achieved'], new_desired)
            nt_r, d_r = 1.0 - new_term.astype(jnp.float32), gm

        # originals + relabeled copies (the standard HER buffer mix)
        s = jnp.concatenate([
            flat2(vec(traj['obs_part'], traj['achieved'], traj['desired'])),
            flat2(vec(traj['obs_part'], traj['achieved'], new_desired)),
        ])
        s_next = jnp.concatenate([flat2(sn_o), flat2(sn_r)])
        a = jnp.concatenate([flat2(traj['action'])] * 2)
        r = jnp.concatenate([flat2(r_o), flat2(r_r)])
        not_term = jnp.concatenate([flat2(nt_o), flat2(nt_r)])
        disc = jnp.concatenate([flat2(d_o), flat2(d_r)])
        batch = (s, a, r, s_next, not_term, disc)
        if buffer is not None:
            buffer = _replay_insert(buffer, batch)

        def update(carry, xs):
            params, a_opt, c_opt = carry
            k_step, step_i = xs
            k_mb, k_tn = jax.random.split(k_step)
            # replay mode: each update step trains on a fresh uniform
            # minibatch from the buffer; window mode: full-window GD
            mb = batch if buffer is None else _replay_sample(buffer, k_mb, cfg.minibatch)
            c_l, c_g = jax.value_and_grad(critic_loss)(params['critic'], params, mb, k_tn)
            c_up, c_opt = critic_opt.update(c_g, c_opt, params['critic'])
            params = dict(params, critic=optax.apply_updates(params['critic'], c_up))

            def do_actor(params, a_opt):
                a_l, a_g = jax.value_and_grad(actor_loss)(params['actor'], params, mb[0])
                a_up, a_opt = actor_opt.update(a_g, a_opt, params['actor'])
                params = dict(params, actor=optax.apply_updates(params['actor'], a_up))
                # polyak target updates (TD3 couples them to the delayed actor step)
                params = dict(
                    params,
                    actor_target=jax.tree_util.tree_map(
                        lambda t, o: (1 - cfg.tau) * t + cfg.tau * o, params['actor_target'], params['actor']
                    ),
                    critic_target=jax.tree_util.tree_map(
                        lambda t, o: (1 - cfg.tau) * t + cfg.tau * o, params['critic_target'], params['critic']
                    ),
                )
                return params, a_opt, a_l

            if cfg.policy_delay > 1:
                params, a_opt, a_l = jax.lax.cond(
                    step_i % cfg.policy_delay == 0,
                    do_actor,
                    lambda params, a_opt: (params, a_opt, jnp.float32(0.0)),
                    params, a_opt,
                )
            else:
                params, a_opt, a_l = do_actor(params, a_opt)
            return (params, a_opt, c_opt), (c_l, a_l)

        (params, a_opt, c_opt), (c_losses, a_losses) = jax.lax.scan(
            update, (params, a_opt, c_opt),
            (jax.random.split(k_upd, cfg.update_steps),
             jnp.arange(cfg.update_steps, dtype=jnp.int32)),
        )
        n_done = done.astype(jnp.float32).sum()
        metrics = {
            'critic_loss': c_losses[-1],
            'actor_loss': a_losses[-1],
            'reward_mean': traj['reward'].mean(),
            'success_rate': traj['success'].astype(jnp.float32).mean(),
            # of the episodes that ENDED this rollout, the fraction whose
            # FINAL step was a success (the reference's eval notion; counting
            # all success-flagged steps overshoots for pushing, where
            # is_success holds on every at-goal step, not just the last)
            'episode_success_rate': (
                (done & traj['success']).astype(jnp.float32).sum() / jnp.maximum(n_done, 1.0)
            ),
            'collision_rate': (traj['mover_col'] | traj['wall_col']).astype(jnp.float32).mean(),
            'relabeled_frac': used.astype(jnp.float32).mean(),
            'relabel_reward_mean': new_reward.mean(),
        }
        if buffer is not None:
            return (env_state, obs, params, a_opt, c_opt, buffer, key), metrics
        return (env_state, obs, params, a_opt, c_opt, key), metrics

    return train_step, (actor_opt, critic_opt)
