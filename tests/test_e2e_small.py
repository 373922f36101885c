"""End-to-end SLAM on a simulated icra run (reduced resolution for CPU CI).

The minimum end-to-end slice of SURVEY §7.6: scan log → predict → match →
gate → map update → trajectory, validated by ATE against the simulator's
ground truth.
"""

import numpy as np
import pytest

from roborts_slam.config import SlamConfig
from roborts_slam.engine import SlamEngine
from roborts_slam.io.scenes import SCENES, load_scene_map
from roborts_slam.io.simulate import simulate_log
from roborts_slam.utils.evaluation import ate_rmse, match_by_time


def _small_config():
    # CPU-friendly: fine map at 2 cm instead of 1 cm, smaller world
    return SlamConfig(
        use_odometry=True, use_optimize_scan_match=False,
        use_move_check=True, move_distance_threshold=0.1,
        move_angle_threshold=0.0873, move_time_threshold=3.6,
        map_resolution=0.05, map_min_passthrough=2.0,
        map_update_free_factor=0.0, map_update_occu_factor=0.0,
        map_update_score_threshold=0.5,
        coarse_map_resolution=0.08, coarse_map_deviation=0.24,
        fine_map_resolution=0.02, fine_map_deviation=0.05,
        gaussian_blur_offset=0.88,
        coarse_search_space_size=0.6, coarse_search_space_resolution=0.05,
        coarse_search_angle_offset=0.349, coarse_search_angle_resolution=0.0349,
        coarse_response_threshold=0.6, coarse_use_point_size=100,
        fine_search_space_size=0.2, fine_search_space_resolution=0.02,
        fine_search_angle_offset=0.175, fine_search_angle_resolution=0.0349,
        fine_response_threshold=0.6, fine_use_point_size=100,
        super_fine_search_space_size=0.02,
        super_fine_search_space_resolution=0.01,
        super_fine_search_angle_offset=0.0349,
        super_fine_search_angle_resolution=0.00349,
        super_fine_response_threshold=0.6, super_fine_use_point_size=100,
        use_map_check_feedback=True, map_check_point_num=100,
        map_check_bound_tolerance=2.5, map_check_penalty_gain=0.015,
        loop_match_min_chain_size=8, link_match_min_response=0.68,
        link_scan_max_distance=3.0, loop_match_min_response_coarse=0.7,
        loop_match_max_variance_coarse=0.4, loop_match_min_response_fine=0.7,
        max_points=384, world_size=20.0,
    )


@pytest.fixture(scope="module")
def icra_log():
    sc = SCENES["icra"]
    gt = load_scene_map(sc)
    return simulate_log(gt, sc.laser, odom_error=sc.odom_error,
                        range_noise=0.005, seed=1)


def test_icra_end_to_end(icra_log):
    log = icra_log
    cfg = _small_config()
    engine = SlamEngine(cfg, log.laser)
    traj = engine.run_log(log)

    assert engine.diag.scans_processed > 30, engine.diag
    est, gt = match_by_time(traj, log.gt_poses, log.times)
    ate = ate_rmse(est, gt)
    # odometry-only baseline for comparison
    odom_est = log.odom[np.searchsorted(log.times, traj[:, 0]).clip(0, len(log) - 1)]
    ate_odom = ate_rmse(odom_est, gt)
    print(f"\nATE slam={ate:.3f}m odom={ate_odom:.3f}m "
          f"kept={engine.diag.scans_processed} loops={engine.diag.loop_closures} "
          f"links={engine.backend.num_links}")
    assert ate < 0.15, f"ATE too high: {ate:.3f} (odom {ate_odom:.3f})"
    assert ate < ate_odom, "SLAM should beat raw odometry"

    # published map sanity: some occupied cells near GT walls
    pub = engine.get_pub_map()
    assert (pub == 100).sum() > 100
    assert (pub == 0).sum() > 1000


def test_icra_end_to_end_with_optimize_matcher(icra_log):
    """use_optimize_scan_match on, end to end: pins the Gauss-Newton stage
    and its optimize-failed -> coarse-correlative ``lax.cond`` fallback
    (scan_matchers.h:205-242, frontend/matchers.py) on a full run — the
    reference profiles ship it off (simulatin_param.yaml:40), so this is
    the only sustained exercise of that branch."""
    log = icra_log
    cfg = _small_config().replace(use_optimize_scan_match=True)
    engine = SlamEngine(cfg, log.laser)
    n = 2 * len(log) // 3
    for i in range(n):
        engine.process(log.ranges[i], log.odom[i], float(log.times[i]))
    engine.finish()
    traj = engine.trajectory_array()
    assert engine.diag.scans_processed > 20, engine.diag
    est, gt = match_by_time(traj, log.gt_poses, log.times)
    ate = ate_rmse(est, gt)
    odom_est = log.odom[np.searchsorted(log.times, traj[:, 0]).clip(0, len(log) - 1)]
    ate_odom = ate_rmse(odom_est, gt)
    print(f"\noptimize-on ATE slam={ate:.3f}m odom={ate_odom:.3f}m")
    assert ate < 0.15, f"ATE too high with optimize matcher: {ate:.3f}"
