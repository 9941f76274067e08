"""gymnasium_planar_robotics_tpu — a batched planar-robotics environment engine.

A from-scratch JAX/XLA re-design of the capabilities of
``gymnasium-planar-robotics`` (magnetic-levitation planar motor RL
environments): batched, jit-compiled physics and collision kernels stepping
thousands of environments in lockstep on an accelerator (NVIDIA GPUs),
mesh-sharded across devices and hosts, with
Gymnasium / PettingZoo adapters at the edge.

Architecture (vs. the reference's MuJoCo + Python class stack):

- ``ops/``      pure-jnp kernels (geometry, rotations, dynamics, walls, collision, contact)
- ``models/``   environment families as pure functions: EnvParams + EnvState -> step/reset
- ``parallel/`` device-mesh sharding of env batches, collective metrics
- ``envs/``     Gymnasium single-env, Gymnasium vector, PettingZoo parallel adapters
- ``utils/``    host-side rendering, STL mesh sizing, impedance-control API surface
"""

__version__ = '0.5.0'

import importlib.util

# registration needs gymnasium, which is an optional extra (``envs``): the
# physics core, learners and parallel modules import without it
if importlib.util.find_spec('gymnasium') is not None:
    from gymnasium_planar_robotics_tpu.envs.registration import register_gymnasium_envs

    register_gymnasium_envs()


def __getattr__(name):
    """Lazy public API (mirrors the reference's re-exports,
    ``/root/reference/gymnasium_planar_robotics/__init__.py:5-18``, mapped to
    this engine's equivalents) without paying adapter import costs up front."""
    surface = {
        'PlanningGymEnv': ('gymnasium_planar_robotics_tpu.envs.gym_env', 'PlanningGymEnv'),
        'PushingGymEnv': ('gymnasium_planar_robotics_tpu.envs.gym_env', 'PushingGymEnv'),
        'PlanningVectorEnv': ('gymnasium_planar_robotics_tpu.envs.vector_env', 'PlanningVectorEnv'),
        'PushingVectorEnv': ('gymnasium_planar_robotics_tpu.envs.vector_env', 'PushingVectorEnv'),
        'PlanningParallelEnv': ('gymnasium_planar_robotics_tpu.envs.pettingzoo_env', 'PlanningParallelEnv'),
        'Planar2DViewer': ('gymnasium_planar_robotics_tpu.utils.rendering', 'Planar2DViewer'),
        'MujocoViewerCollection': ('gymnasium_planar_robotics_tpu.utils.mujoco_viewer', 'MujocoViewerCollection'),
        'ImpedanceGains': ('gymnasium_planar_robotics_tpu.utils.impedance', 'ImpedanceGains'),
        'impedance_wrench': ('gymnasium_planar_robotics_tpu.utils.impedance', 'impedance_wrench'),
        'make_gains': ('gymnasium_planar_robotics_tpu.utils.impedance', 'make_gains'),
        # reference-name aliases so migrating imports keep working verbatim
        'Matplotlib2DViewer': ('gymnasium_planar_robotics_tpu.utils.rendering', 'Planar2DViewer'),
        'BasicPlanarRoboticsEnv': ('gymnasium_planar_robotics_tpu.core', 'PlanarRoboticsCore'),
    }
    if name in surface:
        import importlib

        module, attr = surface[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
