"""3D MuJoCo viewer bridge: stream the JAX engine state, render rgb/depth.

Parity target: the reference's offscreen rendering with geom-group
filtering (`/root/reference/gymnasium_planar_robotics/utils/rendering.py:69-96`)
and the lazy `mode_camid` viewer collection (`rendering.py:197-256`).
Skips when no GL backend is available in the environment.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

os.environ.setdefault('MUJOCO_GL', 'egl')

mujoco = pytest.importorskip('mujoco')

from gymnasium_planar_robotics_tpu.models import planning, pushing  # noqa: E402
from gymnasium_planar_robotics_tpu.utils.mujoco_viewer import MujocoViewerCollection  # noqa: E402


def _gl_available():
    try:
        m = mujoco.MjModel.from_xml_string('<mujoco><worldbody/></mujoco>')
        r = mujoco.Renderer(m, height=16, width=16)
        r.close()
        return True
    except Exception:
        return False


pytestmark = pytest.mark.skipif(not _gl_available(), reason='no GL backend for offscreen rendering')


@pytest.fixture(scope='module')
def planning_setup():
    config, params = planning.make_planning_env(np.ones((3, 3)), 2, std_noise=1e-5, dtype=jnp.float32)
    state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(0), 4)
    viewer = MujocoViewerCollection(params, num_movers=2, width=128, height=96)
    yield config, params, state, viewer
    viewer.close()


def test_rgb_array_tracks_state(planning_setup):
    config, params, state, viewer = planning_setup
    viewer.update(state, env_index=0)
    img0 = viewer.render('rgb_array')
    assert img0.shape == (96, 128, 3) and img0.dtype == np.uint8
    assert (img0 > 10).mean() > 0.3, 'frame is essentially black'
    # a different env renders a different frame (movers/goals moved)
    viewer.update(state, env_index=1)
    img1 = viewer.render('rgb_array')
    assert (img0 != img1).any()


def test_mover_qpos_matches_engine_state(planning_setup):
    config, params, state, viewer = planning_setup
    viewer.update(state, env_index=2)
    pos = np.asarray(state.pos)[2]
    for k in range(2):
        adr = viewer.model.joint(f'mover_joint_{k}').qposadr[0]
        np.testing.assert_allclose(viewer.data.qpos[adr : adr + 2], pos[k], atol=1e-6)
    # goal sites moved to the env's goals
    goals = np.asarray(state.goals)[2]
    for k in range(2):
        sid = viewer.model.site(f'goal_site_mover_{k}').id
        np.testing.assert_allclose(viewer.model.site_pos[sid][:2], goals[k], atol=1e-6)


def test_depth_array_and_lazy_viewers(planning_setup):
    config, params, state, viewer = planning_setup
    viewer.update(state, env_index=0)
    depth = viewer.render('depth_array')
    assert depth.shape == (96, 128) and depth.dtype == np.float32
    assert float(depth.max()) > float(depth.min()) > 0.0
    # one lazily-created renderer per mode_camid key (reference rendering.py:212-256)
    viewer.render('rgb_array')
    assert set(viewer._viewers) == {'depth_array_-1', 'rgb_array_-1'}


def test_geomgroup_filtering(planning_setup):
    config, params, state, viewer = planning_setup
    viewer.update(state, env_index=0)
    full = viewer.render('rgb_array')
    none = viewer.render('rgb_array', geomgroup=np.zeros(6))
    assert (none != full).any()
    assert (none > 10).mean() < (full > 10).mean(), 'masking all geom groups should empty the frame'


def test_pushing_viewer_object_tracks():
    config, params = pushing.make_pushing_env(std_noise=1e-5, dtype=jnp.float32)
    state, obs, _ = pushing.init_batch(config, params, jax.random.PRNGKey(1), 2)
    viewer = MujocoViewerCollection(params, width=96, height=96)
    try:
        viewer.update(state, env_index=1)
        img = viewer.render('rgb_array')
        assert img.shape == (96, 96, 3)
        adr = viewer.model.joint('object_joint').qposadr[0]
        np.testing.assert_allclose(
            viewer.data.qpos[adr : adr + 2], np.asarray(state.obj_pos)[1], atol=1e-6
        )
        sid = viewer.model.site('object_goal_site').id
        np.testing.assert_allclose(
            viewer.model.site_pos[sid][:2], np.asarray(state.goal)[1], atol=1e-6
        )
    finally:
        viewer.close()


def test_mesh_mover_renders_real_silhouette():
    """A mesh-mover env's 3D mirror uses the regenerated real-silhouette
    assets (rounded-corner mover + hollow-frame bumper geoms), not box
    stand-ins."""
    mover_params = {'shape': 'mesh', 'mesh': {'bumper_mass': 0.35}}
    config, params = planning.make_planning_env(
        np.ones((3, 3)), 1, std_noise=1e-5, dtype=jnp.float32, mover_params=mover_params
    )
    state, obs, _ = planning.init_batch(config, params, jax.random.PRNGKey(0), 2)
    viewer = MujocoViewerCollection(
        params, num_movers=1, width=128, height=96,
        mover_shape='mesh', mesh_cfg=mover_params['mesh'],
    )
    try:
        assert viewer.model.geom('mover_geom_0').type[0] == mujoco.mjtGeom.mjGEOM_MESH
        assert viewer.model.geom('bumper_geom_0') is not None
        viewer.update(state, env_index=0)
        img = viewer.render('rgb_array')
        assert img.shape == (96, 128, 3) and img.any()
    finally:
        viewer.close()


def test_hud_overlay_entries_reference_semantics():
    """The interactive viewer's HUD assembly (reference rendering.py:14-66):
    keyboard map top-left, FPS/step/timestep bottom-left, with the same
    state-dependent rows — testable without a window."""
    from gymnasium_planar_robotics_tpu.utils.mujoco_viewer import hud_overlay_entries

    rows = hud_overlay_entries(
        run_speed=1.0, render_every_frame=False, ncam=2, cam_id=-1,
        contacts=True, transparent=False, paused=False, frames_on=True,
        captured_path=None, fps=60, step=480, timestep=0.001,
    )
    top = [(a, b) for pos, a, b in rows if pos == 'topleft']
    bottom = [(a, b) for pos, a, b in rows if pos == 'bottomleft']
    assert ('Run speed = 1.000 x real time', '[S]lower, [F]aster') in top
    assert ('Switch camera (#cams = 3)', '[Tab] (camera ID = -1)') in top
    assert ('[C]ontact forces', 'On') in top
    assert ('T[r]ansparent', 'Off') in top
    assert ('Stop', '[Space]') in top
    assert ('Referenc[e] frames', 'On') in top
    assert bottom == [('FPS', '60 '), ('Step', '480'), ('timestep', '0.00100')]

    # paused: Start + single-step rows replace Stop; render_every_frame hides
    # the run-speed row; a capture path is echoed
    rows = hud_overlay_entries(
        run_speed=0.5, render_every_frame=True, ncam=0, cam_id=0,
        contacts=False, transparent=True, paused=True, frames_on=False,
        captured_path='/tmp/frame_7.png', fps=30, step=1, timestep=0.001,
    )
    top = [(a, b) for pos, a, b in rows if pos == 'topleft']
    assert ('', '') == top[0]
    assert ('Start', '[Space]') in top
    assert ('Advance simulation by one step', '[right arrow]') in top
    assert ('Cap[t]ure frame', 'Saved as /tmp/frame_7.png') in top
    assert not any(a == 'Stop' for a, b in top)
