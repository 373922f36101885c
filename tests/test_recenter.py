"""Rolling-window scan-match maps (auto-recenter)."""

import numpy as np
import jax.numpy as jnp

from roborts_slam.engine import SlamEngine
from roborts_slam.io.scenes import SCENES, load_scene_map
from roborts_slam.io.simulate import simulate_log
from roborts_slam.models.grid_map import ProbMap, ProbMapSpec, shift_prob_map
from roborts_slam.utils.evaluation import ate_rmse, match_by_time
from tests.test_e2e_small import _small_config


def test_shift_prob_map_geometry():
    spec = ProbMapSpec(resolution=0.1, height=16, width=16, deviation=0.1,
                       blur_offset=0.9, default_prob=0.25)
    probs = np.full((16, 16), 0.25, np.float32)
    probs[4, 7] = 0.9                       # marked world point
    pmap = ProbMap(jnp.asarray(probs), jnp.asarray([0.8, 0.8], jnp.float32))
    # world position of the mark: map (x=7, y=4) -> w = m*res - off
    wx, wy = 7 * 0.1 - 0.8, 4 * 0.1 - 0.8

    shifted = shift_prob_map(spec, pmap, (2, 3))       # (sy, sx)
    # same world point must map to the same value through the new offset
    off = np.asarray(shifted.offset)
    mx = round((wx + off[0]) / 0.1)
    my = round((wy + off[1]) / 0.1)
    arr = np.asarray(shifted.probs)
    assert arr[my, mx] == np.float32(0.9), (mx, my)
    # exposed cells take the default
    assert arr[-1, -1] == np.float32(0.25)
    # negative shifts too
    back = shift_prob_map(spec, shifted, (-2, -3))
    np.testing.assert_allclose(np.asarray(back.offset),
                               np.asarray(pmap.offset), atol=1e-6)
    np.testing.assert_allclose(np.asarray(back.probs)[4, 7], 0.9)


def test_windowed_run_tracks_long_trajectory():
    """rm arena with a match window much smaller than the world: the rolling
    maps must recenter repeatedly without losing track."""
    sc = SCENES["rm"]
    gt = load_scene_map(sc)
    log = simulate_log(gt, sc.laser, odom_error=sc.odom_error,
                       range_noise=0.005, seed=5, speed=1.0)
    cfg = _small_config().replace(world_size=40.0, max_points=384,
                                  match_map_window=12.0)
    eng = SlamEngine(cfg, log.laser)
    n = len(log) // 2
    for i in range(n):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    eng.finish()
    # window (12 m) << trajectory span; recentering must have happened
    fs = eng.fspec.fine_spec
    # window rounds up to the 128-cell tile, never to the world extent
    assert fs.width * fs.resolution <= 13.0
    init_off = np.array([fs.width * fs.resolution / 2] * 2)
    assert not np.allclose(np.asarray(eng.state.fine.offset), init_off), \
        "window never recentered"
    est, gtm = match_by_time(eng.trajectory_array(), log.gt_poses, log.times)
    ate = ate_rmse(est, gtm)
    assert eng.diag.scans_processed > 10
    assert ate < 0.15, ate


def test_recenter_rebuilds_from_history():
    """Recentered match maps are rebuilt from stored scans: areas the robot
    left long ago carry real content when a window covers them again (the
    round-1 shift left newly exposed cells at the default until re-scanned)."""
    from roborts_slam.io.pgm import GroundTruthMap
    from roborts_slam.io.simulate import raycast
    from roborts_slam.models.scan import LaserModel

    # corridor 30 m x 4 m with pillars every 2 m (x-texture for matching)
    res = 0.05
    H, W = int(6 / res), int(32 / res)
    occ = np.zeros((H, W), bool)
    occ[int(1 / res), :] = True               # y = -2 wall (origin at -3)
    occ[int(5 / res), :] = True               # y = +2 wall
    for x in np.arange(1.0, 31.0, 2.0):
        occ[int(2.2 / res):int(2.5 / res), int(x / res)] = True
    gt = GroundTruthMap(occupancy=occ, free=~occ, resolution=res,
                        origin=np.array([-1.0, -3.0]))
    laser = LaserModel(angle_min=-2.0, angle_max=2.0, range_min=0.2,
                       range_max=5.0, num_beams=300)
    cfg = _small_config().replace(max_points=384, world_size=70.0,
                                  match_map_window=10.0, use_move_check=False)
    eng = SlamEngine(cfg, laser, synchronous_backend=True)

    for step in range(40):                    # walk +x: 0 -> 19.5 m
        px = 0.5 * step
        pose = np.array([px, 0.0, 0.0])
        eng.process(raycast(gt, pose, laser), pose, 0.1 * step)
    fs = eng.fspec.fine_spec
    extent = fs.width * fs.resolution
    off = np.asarray(eng.state.fine.offset)
    assert not np.allclose(off, [extent / 2] * 2), "window never recentered"
    assert eng.diag.scans_processed > 30, eng.diag

    # current window sits around x ~ 19.5; the start region (x < 5) is out
    center_now = extent / 2 - off[0]
    assert center_now > 10.0
    probs_now = np.asarray(eng.state.fine.probs)

    # re-center a window back over the START region: content from the early
    # scans must be rebuilt into it
    home_off = np.array([extent / 2, extent / 2])   # window centered at (0,0)
    with eng._state_lock:
        eng._rebuild_match_maps_at(home_off,
                                   np.asarray([eng.fspec.coarse_spec.width
                                               * eng.fspec.coarse_spec.resolution / 2] * 2))
    probs = np.asarray(eng.state.fine.probs)
    # probe the y=+2 wall at x in [0, 3]: seen only by early scans
    hits = 0
    for wx in np.arange(0.0, 3.0, 0.25):
        mx = int(round((wx + home_off[0]) / fs.resolution))
        my = int(round((2.0 + home_off[1]) / fs.resolution))
        if probs[my, mx] > fs.default_prob + 0.2:
            hits += 1
    assert hits >= 8, f"old corridor walls not rebuilt (hits={hits})"
