"""The example scripts stay runnable: each main() executes end-to-end with
tiny arguments on the CPU test platform (guards the documented entry points
against API drift — the reference's examples live only in its docs and rot
silently)."""

import importlib.util
import os
import sys

_EXAMPLES = os.path.join(os.path.dirname(__file__), '..', 'examples')


def _load(name):
    spec = importlib.util.spec_from_file_location(f'example_{name}', os.path.join(_EXAMPLES, f'{name}.py'))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[f'example_{name}'] = mod
    spec.loader.exec_module(mod)
    return mod


def _run_main(mod, argv):
    old = sys.argv
    sys.argv = ['x', *argv]
    try:
        mod.main()
    finally:
        sys.argv = old


def test_train_ppo_example(capsys):
    _run_main(_load('train_ppo'), ['--batch', '64', '--iters', '3'])
    out = capsys.readouterr().out
    assert 'iter' in out


def test_train_her_example(capsys):
    _run_main(_load('train_her'), ['--batch', '64', '--iters', '3'])
    out = capsys.readouterr().out
    assert 'episode_success' in out


def test_collect_trajectories_example(tmp_path, capsys):
    _run_main(_load('collect_trajectories'), ['--out', str(tmp_path / 'traj'), '--batch', '64', '--steps', '4'])
    out = capsys.readouterr().out
    assert 'wrote 4 frames' in out


def test_train_sharded_example(capsys):
    """The sharded PPO example runs end-to-end on a 2-device virtual mesh
    with the fused kernel in interpret mode (the multi-device pattern)."""
    mod = _load('train_sharded')
    _run_main(mod, ['--batch', '256', '--iters', '2', '--devices', '2',
                    '--rollout', '2', '--cycles', '3', '--interpret'])
    out = capsys.readouterr().out
    assert 'fused shard_map rollout' in out
