"""Environment registration.

This engine's counterpart of the reference's registry
(``/root/reference/gymnasium_planar_robotics/__init__.py:21-41``): registers the
same env ids with the same 50-step time limit, but the entry points construct
thin Gymnasium adapters over the batched JAX core.
"""

from __future__ import annotations

_REGISTERED = False


def register_gymnasium_envs(force: bool = False) -> None:
    """Register the benchmark environments with the Gymnasium registry
    (idempotent).  ``force=True`` re-registers even if another package (e.g.
    the reference implementation, imported side by side in tests/migration)
    has overridden the same env ids since."""
    global _REGISTERED
    if _REGISTERED and not force:
        return
    import gymnasium as gym

    # reference registers with max_episode_steps=50 (__init__.py:25-41)
    gym.register(
        id='BenchmarkPlanningEnv-v0',
        entry_point='gymnasium_planar_robotics_tpu.envs.gym_env:make_planning_env',
        max_episode_steps=50,
    )
    gym.register(
        id='BenchmarkPushingEnv-v0',
        entry_point='gymnasium_planar_robotics_tpu.envs.gym_env:make_pushing_env',
        max_episode_steps=50,
    )
    _REGISTERED = True
