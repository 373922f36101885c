"""Branch-and-bound (beam search) matcher vs exhaustive dense scoring."""

import numpy as np
import jax.numpy as jnp

from roborts_slam.models.grid_map import ProbMapSpec, make_prob_map
from roborts_slam.ops.branch_and_bound import BnBParams, bnb_scan_match
from roborts_slam.ops.correlative import (
    COARSE, CorrelativeParams, score_candidates,
)
from roborts_slam.models.grid_map import world_to_map_pose
from roborts_slam.ops.raster import stamp_scan


def _scan(n=160, max_points=192):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([2.4 * np.cos(t) + 0.5 * np.cos(3 * t),
                    1.8 * np.sin(t)], -1).astype(np.float32)
    points = np.zeros((max_points, 2), np.float32)
    points[:n] = pts
    mask = np.zeros(max_points, bool)
    mask[:n] = True
    return jnp.asarray(points), jnp.asarray(mask), n


def _map_and_scan():
    spec = ProbMapSpec(resolution=0.01, height=1024, width=1024,
                       deviation=0.03, blur_offset=0.88)
    points, mask, n = _scan()
    pmap = make_prob_map(spec, offset=[5.12, 5.12])
    pmap = stamp_scan(spec, pmap, points, mask, jnp.zeros(3))
    return spec, pmap, points, mask, n


def test_bnb_matches_exhaustive_best():
    spec, pmap, points, mask, n = _map_and_scan()
    bnb = BnBParams(search_space_size=0.32, search_space_resolution=0.01,
                    search_angle_offset=0.0698,
                    search_angle_resolution=0.0349,
                    max_depth=3, beam_width=640, use_point_size=100)
    init = jnp.array([0.03, -0.02, 0.0], jnp.float32)
    res = bnb_scan_match(spec, bnb, pmap.probs, pmap.offset,
                         points, mask, jnp.int32(n), init)

    dense = CorrelativeParams(
        search_space_size=0.32, search_space_resolution=0.01,
        search_angle_offset=0.0698, search_angle_resolution=0.0349,
        response_threshold=0.5, use_point_size=100,
        use_center_penalty=False, tier=COARSE)
    center = world_to_map_pose(pmap.offset, spec.inv_res, init)
    scores, angles, xs, ys = score_candidates(
        spec, dense, pmap.probs, pmap.offset, points, mask, jnp.int32(n),
        center)
    best_dense = float(jnp.max(scores))
    assert abs(float(res.response) - best_dense) < 1e-5, (
        float(res.response), best_dense)


def test_bnb_recovers_perturbed_pose():
    spec, pmap, points, mask, n = _map_and_scan()
    bnb = BnBParams(search_space_size=0.4, search_space_resolution=0.01,
                    search_angle_offset=0.14, search_angle_resolution=0.0175,
                    max_depth=4, beam_width=512)
    init = jnp.array([0.09, -0.07, 0.05], jnp.float32)
    res = bnb_scan_match(spec, bnb, pmap.probs, pmap.offset,
                         points, mask, jnp.int32(n), init)
    pose = np.asarray(res.pose)
    assert float(res.response) > 0.6
    assert abs(pose[0]) < 0.025 and abs(pose[1]) < 0.025, pose
    assert abs(pose[2]) < 0.03, pose


def test_bnb_low_score_keeps_pose():
    spec, pmap, points, mask, n = _map_and_scan()
    bnb = BnBParams(search_space_size=0.16, search_space_resolution=0.01,
                    search_angle_offset=0.0349,
                    search_angle_resolution=0.0349, max_depth=2)
    far = jnp.array([4.5, 4.5, 0.0], jnp.float32)   # empty map corner
    res = bnb_scan_match(spec, bnb, pmap.probs, pmap.offset,
                         points, mask, jnp.int32(n), far)
    assert float(res.response) <= 0.5
    np.testing.assert_allclose(np.asarray(res.pose), np.asarray(far), atol=1e-6)


def test_engine_with_fast_correlation_match():
    """e2e equivalence: the BnB coarse stage (use_fast_correlation_match)
    tracks the dense 3-tier stack on an icra slice."""
    import numpy as np

    from roborts_slam.engine import SlamEngine
    from roborts_slam.io.scenes import SCENES, load_scene_map
    from roborts_slam.io.simulate import simulate_log
    from roborts_slam.utils.evaluation import ate_rmse, match_by_time
    from tests.test_e2e_small import _small_config

    sc = SCENES["icra"]
    gt = load_scene_map(sc)
    log = simulate_log(gt, sc.laser, odom_error=sc.odom_error,
                       range_noise=0.005, seed=7)
    n = min(150, len(log))

    def run(cfg):
        eng = SlamEngine(cfg, log.laser, synchronous_backend=True)
        for i in range(n):
            eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
        traj = eng.trajectory_array()
        est, g = match_by_time(traj, log.gt_poses, log.times)
        return ate_rmse(est, g), eng.diag.scans_processed

    base_cfg = _small_config()
    bnb_cfg = base_cfg.replace(
        use_fast_correlation_match=True,
        fast_match_space_size=0.64, fast_match_space_resolution=0.02,
        fast_match_angle_offset=0.349, fast_match_angle_resolution=0.0349,
        fast_match_response_threshold=0.5, fast_match_use_point_size=100,
        fast_match_max_depth=3, fast_match_beam_width=64)
    ate_dense, kept_dense = run(base_cfg)
    ate_bnb, kept_bnb = run(bnb_cfg)
    print(f"dense ATE={ate_dense:.3f} kept={kept_dense}; "
          f"bnb ATE={ate_bnb:.3f} kept={kept_bnb}")
    assert kept_bnb > 10
    assert ate_bnb < max(1.5 * ate_dense, 0.1), (ate_bnb, ate_dense)
