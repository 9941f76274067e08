"""Data-parallel PPO learner fed by the batched env engine.

The reference trains via SB3's Python loop over a single env
(the reference's ``docs/train_agents.rst``); here the entire (rollout -> GAE
-> PPO update) pipeline is one jitted program: envs stepped as a sharded
``[B, ...]`` batch, trajectories stacked on device, the actor-critic MLP
running batched matmuls, and gradients reduced across the ``data`` mesh axis
by XLA-inserted all-reduces (the parameters are replicated, the batch is
sharded — classic DP; TP/PP are deliberately not built: observation widths
are tens of floats, SURVEY.md §2.3 D3).

Matmul precision: the MLP's float32 matmuls run at XLA's default precision,
which on NVIDIA GPUs is TF32 (about three decimal digits of mantissa) — a
deliberate choice for the learner, whose updates are noisy anyway; the
physics never depends on it.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    obs_dim: int
    action_dim: int
    hidden: tuple[int, ...] = (256, 256)
    action_scale: float = 10.0  # actions squashed to [-scale, scale]
    rollout_steps: int = 16
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 0.5
    entropy_coef: float = 0.0
    learning_rate: float = 3e-4
    update_epochs: int = 4


def init_params(key: jax.Array, cfg: PPOConfig, dtype=jnp.float32) -> dict:
    """Actor-critic MLP parameters (shared trunk, gaussian policy head)."""
    sizes = (cfg.obs_dim, *cfg.hidden)
    keys = jax.random.split(key, len(sizes) + 2)
    params = {'trunk': []}
    for i in range(len(sizes) - 1):
        w = jax.random.normal(keys[i], (sizes[i], sizes[i + 1]), dtype) * jnp.sqrt(2.0 / sizes[i])
        params['trunk'].append({'w': w, 'b': jnp.zeros(sizes[i + 1], dtype)})
    h = sizes[-1]
    params['mu'] = {
        'w': jax.random.normal(keys[-2], (h, cfg.action_dim), dtype) * 0.01,
        'b': jnp.zeros(cfg.action_dim, dtype),
    }
    params['value'] = {
        'w': jax.random.normal(keys[-1], (h, 1), dtype) * 1.0,
        'b': jnp.zeros(1, dtype),
    }
    params['log_std'] = jnp.zeros(cfg.action_dim, dtype)
    return params


def apply(params: dict, obs: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(mu, log_std, value) — batched over leading dims (default matmul
    precision: TF32 on NVIDIA GPUs, see the module docstring)."""
    x = obs
    for layer in params['trunk']:
        x = jnp.tanh(jnp.dot(x, layer['w'], preferred_element_type=jnp.float32) + layer['b'])
    mu = jnp.dot(x, params['mu']['w'], preferred_element_type=jnp.float32) + params['mu']['b']
    value = (jnp.dot(x, params['value']['w'], preferred_element_type=jnp.float32) + params['value']['b'])[..., 0]
    return mu, params['log_std'], value


def sample_action(params: dict, obs: jnp.ndarray, key: jax.Array, scale: float):
    """Sample a Gaussian action; returns (clipped action, pre-clip raw
    sample, its log-prob, and the value estimate).  The raw sample is what
    the PPO ratio is computed against — clipping only protects the env."""
    mu, log_std, value = apply(params, obs)
    noise = jax.random.normal(key, mu.shape, mu.dtype)
    raw = mu + jnp.exp(log_std) * noise
    logp = _gaussian_logp(raw, mu, log_std)
    action = jnp.clip(raw, -scale, scale)
    return action, raw, logp, value


def _gaussian_logp(x, mu, log_std):
    return (-0.5 * ((x - mu) / jnp.exp(log_std)) ** 2 - log_std - 0.5 * jnp.log(2 * jnp.pi)).sum(-1)


class Transition(NamedTuple):
    obs: jnp.ndarray  # [B, obs_dim]
    raw_action: jnp.ndarray  # [B, A] pre-clip sample (the policy's own variable)
    logp: jnp.ndarray  # [B]
    value: jnp.ndarray  # [B]
    reward: jnp.ndarray  # [B]
    terminated: jnp.ndarray  # [B]
    truncated: jnp.ndarray  # [B]
    final_value: jnp.ndarray  # [B] V(final_observation) — the bootstrap at truncations


def compute_gae(traj: Transition, last_value: jnp.ndarray, gamma: float, lam: float):
    """GAE over a [T, B] trajectory via reverse scan.

    Truncation is NOT termination: a 50-step time limit ends the episode
    without zeroing future value, so truncated steps bootstrap with
    V(final_observation) (the state the episode would have continued from),
    while terminated steps bootstrap with 0.  The advantage chain still cuts
    at every episode boundary (auto-reset replaces the next state with a new
    episode's)."""

    def body(carry, tr):
        gae, next_value = carry
        term = tr.terminated.astype(tr.value.dtype)
        trunc = tr.truncated.astype(tr.value.dtype)
        episode_continues = 1.0 - term - trunc + term * trunc  # 1 - (term | trunc)
        bootstrap = (1.0 - term) * jnp.where(tr.truncated, tr.final_value, next_value)
        delta = tr.reward + gamma * bootstrap - tr.value
        gae = delta + gamma * lam * episode_continues * gae
        return (gae, tr.value), gae

    (_, _), advantages = jax.lax.scan(
        body, (jnp.zeros_like(last_value), last_value), traj, reverse=True
    )
    returns = advantages + traj.value
    return advantages, returns


def ppo_loss(params: dict, cfg: PPOConfig, batch) -> jnp.ndarray:
    """Clipped-surrogate PPO loss (policy + value + entropy terms) over a
    minibatch of (obs, raw_action, old_logp, advantages, returns)."""
    obs, raw_action, old_logp, advantages, returns = batch
    mu, log_std, value = apply(params, obs)
    logp = _gaussian_logp(raw_action, mu, log_std)
    ratio = jnp.exp(logp - old_logp)
    adv = (advantages - advantages.mean()) / (advantages.std() + 1e-8)
    pg = -jnp.minimum(ratio * adv, jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv).mean()
    v_loss = ((value - returns) ** 2).mean()
    entropy = (log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e)).sum()
    return pg + cfg.value_coef * v_loss - cfg.entropy_coef * entropy


def make_train_step(
    env_config,
    env_params,
    cfg: PPOConfig,
    step_autoreset_fn: Callable | None = None,
    obs_to_vec: Callable | None = None,
    batched_step_fn: Callable | None = None,
):
    """Build ``train_step(runner_state) -> (runner_state, metrics)``: one
    rollout of ``cfg.rollout_steps`` sharded env steps + PPO updates, all in
    one traceable function (jit it, optionally with shardings, at the call
    site).

    Pass EITHER ``step_autoreset_fn`` (a per-env step, vmapped here) or
    ``batched_step_fn(state, action)`` — an already-batched step such as the
    one ``ops/pallas_step.batched_autoreset_step`` chooses (the fused kernel
    on a GPU, or its shard_mapped form on a mesh)."""
    optimizer = optax.adam(cfg.learning_rate)
    if batched_step_fn is not None:
        def batched_env_step(_config, _params, state, action):
            return batched_step_fn(state, action)
    else:
        assert step_autoreset_fn is not None, 'pass step_autoreset_fn or batched_step_fn'
        batched_env_step = jax.vmap(step_autoreset_fn, in_axes=(None, None, 0, 0))

    if obs_to_vec is None:
        def obs_to_vec(obs):
            return jnp.concatenate(
                [obs['observation'], obs['achieved_goal'], obs['desired_goal']], axis=-1
            ).astype(jnp.float32)

    def rollout_body(carry, _):
        env_state, obs_vec, params, key = carry
        key, k_act = jax.random.split(key)
        action, raw, logp, value = sample_action(params, obs_vec, k_act, cfg.action_scale)
        env_state, obs, reward, terminated, truncated, info = batched_env_step(
            env_config, env_params, env_state, action
        )
        next_obs_vec = obs_to_vec(obs)
        _, _, final_value = apply(params, obs_to_vec(info['final_observation']))
        tr = Transition(
            obs=obs_vec,
            raw_action=raw,
            logp=logp,
            value=value,
            reward=reward.astype(jnp.float32),
            terminated=terminated,
            truncated=truncated,
            final_value=final_value,
        )
        return (env_state, next_obs_vec, params, key), tr

    def train_step(runner):
        env_state, obs_vec, params, opt_state, key = runner
        (env_state, obs_vec, params, key), traj = jax.lax.scan(
            rollout_body, (env_state, obs_vec, params, key), None, length=cfg.rollout_steps
        )
        _, _, last_value = apply(params, obs_vec)
        advantages, returns = compute_gae(traj, last_value, cfg.gamma, cfg.gae_lambda)

        flat = jax.tree_util.tree_map(lambda x: x.reshape((-1,) + x.shape[2:]), (
            traj.obs, traj.raw_action, traj.logp, advantages, returns))

        def epoch(carry, _):
            params, opt_state = carry
            loss, grads = jax.value_and_grad(ppo_loss)(params, cfg, flat)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            epoch, (params, opt_state), None, length=cfg.update_epochs
        )
        metrics = {
            'loss': losses[-1],
            'reward_mean': traj.reward.mean(),
            'done_rate': (traj.terminated | traj.truncated).astype(jnp.float32).mean(),
        }
        return (env_state, obs_vec, params, opt_state, key), metrics

    return train_step, optimizer
