"""Helpers of the GPU bring-up that run everywhere: the compile-cache location,
warmed ``block_until_ready`` timing, the card query, and ``chip_smoke.py``'s
refusal to run where JAX finds no GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

import jax
import jax.numpy as jnp

from gymnasium_planar_robotics_tpu.utils import compile_cache, profiling

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize('env_set', [True, False])
def test_compile_cache_location(monkeypatch, tmp_path, env_set):
    """``JAX_COMPILATION_CACHE_DIR`` wins and nothing else is set; without it
    the cache is the fixed ``.jax_cache/`` of the checkout, which git ignores."""
    calls = {}
    monkeypatch.setattr(jax.config, 'update', lambda name, value: calls.__setitem__(name, value))
    if env_set:
        monkeypatch.setenv('JAX_COMPILATION_CACHE_DIR', str(tmp_path))
        expected = str(tmp_path)
    else:
        monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
        expected = str(ROOT / '.jax_cache')
    assert compile_cache.cache_dir() == expected
    assert compile_cache.enable() == expected
    assert ('jax_compilation_cache_dir' in calls) is not env_set
    if not env_set:
        assert calls['jax_compilation_cache_dir'] == expected
        assert '.jax_cache/' in (ROOT / '.gitignore').read_text().split()
    assert calls['jax_persistent_cache_min_compile_time_secs'] == compile_cache.MIN_COMPILE_TIME_SECS


@pytest.mark.parametrize('where', ['checkout', 'alone'])
def test_chip_smoke_refuses_without_gpu(tmp_path, where):
    """No GPU (here: the CPU only), or the script without the repository:
    a non-zero exit and no result line."""
    script = ROOT / 'chip_smoke.py'
    cwd = ROOT
    if where == 'alone':
        shutil.copy(script, tmp_path / 'chip_smoke.py')
        script, cwd = tmp_path / 'chip_smoke.py', tmp_path
    env = {k: v for k, v in os.environ.items() if k not in ('PYTHONPATH', 'XLA_FLAGS')}
    out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_time_calls_warms_up_then_times_each_call():
    calls = []

    def fn(x):
        calls.append(1)
        return x + 1

    times = profiling.time_calls(fn, jnp.ones(3), warmup=2, reps=4)
    assert len(calls) == 6
    assert len(times) == 4 and all(t >= 0.0 for t in times)


def test_time_calls_blocks_on_every_result(monkeypatch):
    """Every call, warm-up included, ends in ``block_until_ready`` on its own
    result: JAX returns before the device finishes."""
    blocked = []
    real = jax.block_until_ready
    monkeypatch.setattr(jax, 'block_until_ready', lambda x: blocked.append(x) or real(x))
    results = iter(range(10))
    profiling.time_calls(lambda: next(results), warmup=1, reps=2)
    assert blocked == [0, 1, 2]


def test_card_query_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv('PATH', '')
    assert profiling.gpu_name_and_power_limit().startswith('nvidia-smi unavailable')
