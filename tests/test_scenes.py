"""Scene coverage: rm + willow ground-truth maps drive the pipeline.

(icra has its own full e2e in test_e2e_small.py; these keep CPU cost sane
with shorter runs / coarser maps, exercising the big-map and 1081-beam
paths the icra test doesn't.)"""

import numpy as np
import pytest

from roborts_slam.config import SlamConfig
from roborts_slam.engine import SlamEngine
from roborts_slam.io.scenes import SCENES, load_scene_map
from roborts_slam.io.simulate import path_to_trajectory, simulate_log
from roborts_slam.utils.evaluation import ate_rmse, match_by_time
from tests.test_e2e_small import _small_config


def test_scene_maps_load():
    for name, sc in SCENES.items():
        gt = load_scene_map(sc)
        assert gt.occupancy.any(), name
        assert gt.free.sum() > gt.occupancy.sum(), name
        assert abs(gt.resolution - 0.05) < 1e-9


# (width, height) in pixels of the reference's maps (BASELINE.md)
REFERENCE_SIZES = {"willow": (1165, 945), "icra": (162, 102),
                   "rm": (336, 574)}


@pytest.mark.parametrize("name", sorted(REFERENCE_SIZES))
def test_scene_generator_is_seeded_and_sized(name):
    """Same seed, same map; another seed, another map; always the
    reference map's size, with a plannable loop through free space."""
    from roborts_slam.io.scenes import generate_scene_map
    from roborts_slam.io.simulate import auto_loop_waypoints

    sc = SCENES[name]
    a, b = generate_scene_map(sc), generate_scene_map(sc)
    assert (a.width, a.height) == REFERENCE_SIZES[name]
    np.testing.assert_array_equal(a.occupancy, b.occupancy)
    np.testing.assert_array_equal(a.free, b.free)
    assert not (a.occupancy & a.free).any()
    other = generate_scene_map(sc, seed=sc.seed + 1)
    assert (other.occupancy != a.occupancy).any()
    wps = auto_loop_waypoints(a, n=sc.n_waypoints, clearance_m=sc.clearance_m)
    assert wps.shape == (sc.n_waypoints, 2)


def test_rm_short_run():
    sc = SCENES["rm"]
    gt = load_scene_map(sc)
    log = simulate_log(gt, sc.laser, odom_error=sc.odom_error,
                       range_noise=0.005, seed=5, speed=1.0)
    # first quarter of the loop only (CPU budget)
    n = len(log) // 4
    cfg = _small_config().replace(world_size=40.0, max_points=384)
    eng = SlamEngine(cfg, log.laser)
    for i in range(n):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    eng.finish()
    traj = eng.trajectory_array()
    assert eng.diag.scans_processed > 10
    est, gtm = match_by_time(traj, log.gt_poses, log.times)
    ate = ate_rmse(est, gtm)
    assert ate < 0.15, ate


def test_willow_frontend_1081_beams():
    sc = SCENES["willow"]
    gt = load_scene_map(sc)
    # short straight-ish path through free space; willow map is 58x47 m
    ys, xs = np.nonzero(gt.free)
    cy, cx = ys.mean(), xs.mean()
    start = np.array([gt.origin[0] + cx * 0.05, gt.origin[1] + cy * 0.05])
    path = np.stack([np.linspace(start[0], start[0] + 2.0, 30),
                     np.full(30, start[1])], -1)
    traj = path_to_trajectory(path, speed=0.5, scan_rate=10.0)
    log = simulate_log(gt, sc.laser, trajectory=traj,
                       odom_error=sc.odom_error, range_noise=0.01, seed=7)
    assert log.ranges.shape[1] == 1081
    cfg = _small_config().replace(world_size=25.0, max_points=1152)
    eng = SlamEngine(cfg, log.laser)
    for i in range(len(log)):
        eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
    eng.finish()
    assert eng.diag.scans_processed > 5
    est, gtm = match_by_time(eng.trajectory_array(), log.gt_poses, log.times)
    assert ate_rmse(est, gtm) < 0.1
