"""Profiling and throughput telemetry.

The reference's only instrumentation is an FPS HUD overlay in the interactive
viewer (``/root/reference/gymnasium_planar_robotics/utils/rendering.py:64-66``).
Here: ``jax.profiler`` trace capture around rollout sections (view in
TensorBoard/XProf), warmed ``block_until_ready`` timing of jitted calls, and
a steps/sec meter for the batched engine.
"""

from __future__ import annotations

import contextlib
import subprocess
import time

import jax


def time_calls(fn, *args, warmup: int = 1, reps: int = 5) -> list[float]:
    """Wall seconds of ``reps`` calls of ``fn(*args)``, each closed by
    ``jax.block_until_ready`` on its result, after ``warmup`` untimed calls
    (the first one compiles).  JAX dispatch is asynchronous, so a timing
    without the block measures only the enqueue."""
    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times


def gpu_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` prints them (one line per card), or a note saying
    why they could not be read.  A card may be set below its maximum power,
    and then runs slower under load, so every measurement carries this."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30, check=True,
        )
    except (OSError, subprocess.SubprocessError) as e:
        return f'nvidia-smi unavailable ({type(e).__name__})'
    return out.stdout.strip()


@contextlib.contextmanager
def trace(log_dir: str = 'build/trace'):
    """Capture a device trace of the enclosed block (XProf/TensorBoard format)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class ThroughputMeter:
    """env-steps/sec over a sliding window; host-side, negligible overhead.

    The meter trusts the CALLER to synchronize with the device between
    ticks (``jax.block_until_ready`` on each batch of work): dispatch is
    asynchronous, so unsynchronized ticks count enqueued, not finished, work."""

    def __init__(self):
        self._t0 = None
        self._steps = 0
        self.rate = 0.0

    def tick(self, env_steps: int) -> float:
        """Record ``env_steps`` completed steps; returns the running rate.
        The first call only arms the timer (returns 0.0)."""
        now = time.perf_counter()
        if self._t0 is None:
            self._t0 = now
            return 0.0
        self._steps += env_steps
        dt = now - self._t0
        if dt > 0:
            self.rate = self._steps / dt
        return self.rate

    def reset(self):
        """Clear the window; the next ``tick`` re-arms the timer."""
        self._t0 = None
        self._steps = 0
