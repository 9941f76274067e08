"""Test configuration: force a virtual 8-device CPU platform and float64.

The reference physics engine (MuJoCo) computes in float64; our correctness
tests compare trajectories against it, so tests run with x64 enabled on CPU.
The 8 virtual devices let the sharding tests exercise a real
``jax.sharding.Mesh`` without accelerators (SURVEY.md §4 carry-over #3).
What only a GPU can run is marked ``gpu`` and runs on the card through
``chip_smoke.py``; the ``gpu_device`` fixture skips it here.
"""

import os
import sys

# unit tests run on the (multi-device virtual) CPU, whatever accelerator the
# machine has; only a run that names CUDA (chip_smoke.py, for the tests
# marked ``gpu``) keeps the GPU
if 'cuda' not in os.environ.get('JAX_PLATFORMS', ''):
    os.environ['JAX_PLATFORMS'] = 'cpu'
# headless offscreen MuJoCo rendering (3D viewer tests); EGL is the backend
# that works in this container
os.environ.setdefault('MUJOCO_GL', 'egl')
flags = os.environ.get('XLA_FLAGS', '')
if '--xla_force_host_platform_device_count' not in flags:
    os.environ['XLA_FLAGS'] = (flags + ' --xla_force_host_platform_device_count=8').strip()

# the CPU AOT cache loader logs E-level machine-feature complaints about the
# 'prefer-no-scatter/gather' pseudo-features on every cache hit (the features
# match; the serialized form differs) — drop native log noise below FATAL
os.environ.setdefault('TF_CPP_MIN_LOG_LEVEL', '3')

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update('jax_platforms', os.environ['JAX_PLATFORMS'])
jax.config.update('jax_enable_x64', True)

# repo root on sys.path so `import gymnasium_planar_robotics_tpu` works uninstalled
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gymnasium_planar_robotics_tpu.utils import compile_cache  # noqa: E402

# persistent compile cache: XLA CPU compiles (the non-interpret half of the
# suite's fixed cost) reload from disk on repeat runs
compile_cache.enable()


@pytest.fixture
def gpu_device():
    """The GPU for tests marked ``gpu``; skips where there is none.  Decided
    here, at run time, so every xdist worker collects the same tests."""
    gpus = [d for d in jax.devices() if d.platform == 'gpu'] if jax.default_backend() == 'gpu' else []
    if not gpus:
        pytest.skip('needs an NVIDIA GPU: run through chip_smoke.py on the card')
    return gpus[0]

REFERENCE_PATH = '/root/reference'


def reference_available() -> bool:
    return os.path.isdir(REFERENCE_PATH)


def import_reference():
    """Import the reference implementation (test oracle only — never shipped)."""
    if REFERENCE_PATH not in sys.path:
        sys.path.insert(0, REFERENCE_PATH)
    import gymnasium_planar_robotics  # noqa: F401

    return gymnasium_planar_robotics
