"""Gauss-Newton matcher + tiered facade tests."""

import numpy as np
import jax.numpy as jnp

from roborts_slam.config import SlamConfig
from roborts_slam.frontend.matchers import MatcherParams, scan_match
from roborts_slam.models.grid_map import ProbMap, ProbMapSpec, make_prob_map
from roborts_slam.ops.gauss_newton import OptimizeParams, optimize_scan_match
from roborts_slam.ops.raster import stamp_scan


def _box_scan(n=160, max_points=192):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    pts = np.stack([3.0 * np.sign(np.cos(t)) * np.abs(np.cos(t)) ** 0.15,
                    2.0 * np.sign(np.sin(t)) * np.abs(np.sin(t)) ** 0.15], -1)
    points = np.zeros((max_points, 2), np.float32)
    points[:n] = pts
    mask = np.zeros(max_points, bool)
    mask[:n] = True
    return jnp.asarray(points), jnp.asarray(mask), n


def test_gauss_newton_refines_pose():
    spec = ProbMapSpec(resolution=0.05, height=256, width=256, deviation=0.1,
                       blur_offset=0.9, default_prob=0.3)
    points, mask, n = _box_scan()
    pmap = make_prob_map(spec, offset=[6.4, 6.4])
    pmap = stamp_scan(spec, pmap, points, mask, jnp.zeros(3))

    params = OptimizeParams(iterate_max_times=20, cost_decrease_threshold=0.1,
                            cost_min_threshold=0.5, max_update_distance=0.5,
                            max_update_angle=0.5)
    init = jnp.array([0.05, -0.04, 0.02], jnp.float32)
    res = optimize_scan_match(spec, params, pmap.probs, pmap.offset,
                              points, mask, init)
    err = np.asarray(res.pose)
    assert abs(err[0]) < 0.03 and abs(err[1]) < 0.03 and abs(err[2]) < 0.015, err
    # starting at the true pose should yield low cost
    res0 = optimize_scan_match(spec, params, pmap.probs, pmap.offset,
                               points, mask, jnp.zeros(3))
    assert float(res0.cost) < float(res.cost) + 50.0


def _build_maps(config, points, mask):
    fine_spec = ProbMapSpec(resolution=config.fine_map_resolution, height=1024,
                            width=1024, deviation=config.fine_map_deviation,
                            blur_offset=config.gaussian_blur_offset)
    coarse_spec = ProbMapSpec(resolution=config.coarse_map_resolution, height=128,
                              width=128, deviation=config.coarse_map_deviation,
                              blur_offset=config.gaussian_blur_offset)
    fine = make_prob_map(fine_spec, offset=[5.12, 5.12])
    coarse = make_prob_map(coarse_spec, offset=[5.12, 5.12])
    fine = stamp_scan(fine_spec, fine, points, mask, jnp.zeros(3))
    coarse = stamp_scan(coarse_spec, coarse, points, mask, jnp.zeros(3))
    return fine_spec, fine, coarse_spec, coarse


def test_tiered_scan_match_recovers_pose():
    config = SlamConfig(
        fine_map_resolution=0.02, coarse_map_resolution=0.08,
        coarse_map_deviation=0.24, fine_map_deviation=0.05,
        gaussian_blur_offset=0.88, use_optimize_scan_match=False,
        coarse_search_space_size=0.6, coarse_search_space_resolution=0.05,
        coarse_search_angle_offset=0.523, coarse_search_angle_resolution=0.0349,
        fine_search_space_size=0.2, fine_search_space_resolution=0.02,
        fine_search_angle_offset=0.175, fine_search_angle_resolution=0.0349,
        super_fine_search_space_size=0.02, super_fine_search_space_resolution=0.01,
        super_fine_search_angle_offset=0.0349,
        super_fine_search_angle_resolution=0.00349,
    )
    points, mask, n = _box_scan()
    fine_spec, fine, coarse_spec, coarse = _build_maps(config, points, mask)
    params = MatcherParams.from_config(config)

    init = jnp.array([0.15, -0.1, 0.1], jnp.float32)
    out = scan_match(params, fine_spec, fine.probs, fine.offset,
                     coarse_spec, coarse.probs, coarse.offset,
                     points, mask, n, init)
    pose = np.asarray(out.pose)
    assert float(out.score) > 0.6, float(out.score)
    assert abs(pose[0]) < 0.03 and abs(pose[1]) < 0.03, pose
    assert abs(pose[2]) < 0.01, pose
    cov = np.asarray(out.cov)
    assert cov[0, 0] > 0 and cov[2, 2] > 0


def test_tiered_scan_match_with_optimizer():
    config = SlamConfig(
        fine_map_resolution=0.02, coarse_map_resolution=0.08,
        coarse_map_deviation=0.24, fine_map_deviation=0.05,
        gaussian_blur_offset=0.88, use_optimize_scan_match=True,
        optimize_failed_cost=200.0, iterate_times=10,
        cost_decrease_threshold=0.1, cost_min_threshold=0.5,
        coarse_search_space_size=0.6, coarse_search_space_resolution=0.05,
        coarse_search_angle_offset=0.523, coarse_search_angle_resolution=0.0349,
        fine_search_space_size=0.2, fine_search_space_resolution=0.02,
        fine_search_angle_offset=0.175, fine_search_angle_resolution=0.0349,
        super_fine_search_space_size=0.02, super_fine_search_space_resolution=0.01,
        super_fine_search_angle_offset=0.0349,
        super_fine_search_angle_resolution=0.00349,
    )
    points, mask, n = _box_scan()
    fine_spec, fine, coarse_spec, coarse = _build_maps(config, points, mask)
    params = MatcherParams.from_config(config)
    init = jnp.array([0.1, -0.05, 0.05], jnp.float32)
    out = scan_match(params, fine_spec, fine.probs, fine.offset,
                     coarse_spec, coarse.probs, coarse.offset,
                     points, mask, n, init)
    pose = np.asarray(out.pose)
    assert abs(pose[0]) < 0.04 and abs(pose[1]) < 0.04 and abs(pose[2]) < 0.02, pose
