"""Batched correlative matcher vs the serial CPU reference semantics."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from roborts_slam.models.grid_map import ProbMapSpec
from roborts_slam.ops.correlative import (
    COARSE, FINE, SUPER, CorrelativeParams, correlative_scan_match,
    find_best_candidate, penalize_scores, score_candidates,
)
from roborts_slam.bench.cpu_reference import (
    find_best_serial, penalize_serial, score_candidates_serial,
)


def _spec(res=0.05, n=256):
    return ProbMapSpec(resolution=res, height=n, width=n, deviation=0.2,
                       blur_offset=0.72, default_prob=0.3)


def _params(tier=COARSE):
    return CorrelativeParams(
        search_space_size=0.4, search_space_resolution=0.1,
        search_angle_offset=0.0349 * 4, search_angle_resolution=0.0349,
        response_threshold=0.5, use_point_size=30,
        use_center_penalty=True, tier=tier)


def _random_world(seed=0, n_points=80, max_points=128):
    rng = np.random.default_rng(seed)
    spec = _spec()
    probs = rng.uniform(0.0, 1.0, size=(spec.height, spec.width)).astype(np.float32)
    pts = rng.uniform(-2.0, 2.0, size=(max_points, 2)).astype(np.float32)
    mask = np.zeros(max_points, bool)
    mask[:n_points] = True
    pts[n_points:] = 0
    center = np.array([spec.width / 2, spec.height / 2, 0.3], np.float32)
    return spec, probs, pts, mask, n_points, center


def test_scores_match_serial_reference():
    spec, probs, pts, mask, n, center = _random_world()
    p = _params()
    scores, angles, xs, ys = jax.jit(
        lambda pr, po: score_candidates(spec, p, pr, jnp.zeros(2), po,
                                        jnp.asarray(mask), n, jnp.asarray(center)),
        static_argnums=(),
    )(jnp.asarray(probs), jnp.asarray(pts))

    ref_scores, ref_angles, ref_xs, ref_ys = score_candidates_serial(
        probs, spec.default_prob, spec.inv_res, pts, n, center,
        p.search_space_size, p.search_space_resolution,
        p.search_angle_offset, p.search_angle_resolution, p.use_point_size)

    np.testing.assert_allclose(np.asarray(angles), ref_angles, atol=1e-5)
    np.testing.assert_allclose(np.asarray(xs), ref_xs, atol=1e-4)
    np.testing.assert_allclose(np.asarray(scores), ref_scores, atol=2e-3)


def test_penalty_matches_serial_reference():
    spec, probs, pts, mask, n, center = _random_world(1)
    p = _params()
    scores, angles, xs, ys = score_candidates(
        spec, p, jnp.asarray(probs), jnp.zeros(2), jnp.asarray(pts),
        jnp.asarray(mask), n, jnp.asarray(center))
    pen = penalize_scores(p, spec, scores, angles, xs, ys, jnp.asarray(center))
    ref = penalize_serial(np.asarray(scores), np.asarray(angles), np.asarray(xs),
                          np.asarray(ys), center, spec.resolution,
                          p.search_space_size, 0.4)
    np.testing.assert_allclose(np.asarray(pen), ref, atol=1e-4)


def test_find_best_matches_serial_reference():
    spec, probs, pts, mask, n, center = _random_world(2)
    p = _params()
    scores, angles, xs, ys = score_candidates(
        spec, p, jnp.asarray(probs), jnp.zeros(2), jnp.asarray(pts),
        jnp.asarray(mask), n, jnp.asarray(center))
    pose, best = find_best_candidate(scores, angles, xs, ys)
    ref_pose, ref_best = find_best_serial(np.asarray(scores), np.asarray(angles),
                                          np.asarray(xs), np.asarray(ys))
    assert abs(float(best) - ref_best) < 1e-5
    np.testing.assert_allclose(np.asarray(pose), ref_pose, atol=1e-3)


def test_match_recovers_known_offset():
    """End-to-end: build a map from a scan, perturb the pose, expect the
    matcher to recover the true pose within a cell."""
    from roborts_slam.ops.raster import stamp_scan
    from roborts_slam.models.grid_map import ProbMap

    rng = np.random.default_rng(3)
    spec = ProbMapSpec(resolution=0.05, height=256, width=256, deviation=0.1,
                       blur_offset=0.72, default_prob=0.3)
    # a room-like point set: box walls sampled
    t = np.linspace(0, 2 * np.pi, 120, endpoint=False)
    pts = np.stack([3.0 * np.sign(np.cos(t)) * np.abs(np.cos(t)) ** 0.2,
                    2.0 * np.sign(np.sin(t)) * np.abs(np.sin(t)) ** 0.2], -1)
    max_points = 128
    points = np.zeros((max_points, 2), np.float32)
    points[:120] = pts
    mask = np.zeros(max_points, bool)
    mask[:120] = True

    true_pose = jnp.array([0.0, 0.0, 0.0], jnp.float32)
    offset = jnp.array([6.4, 6.4], jnp.float32)  # center the 12.8m map
    pmap = ProbMap(probs=jnp.full((256, 256), 0.3, jnp.float32), offset=offset)
    pmap = stamp_scan(spec, pmap, jnp.asarray(points), jnp.asarray(mask),
                      true_pose, use_blur=True)

    init = jnp.array([0.12, -0.08, 0.05], jnp.float32)  # perturbed guess
    p = CorrelativeParams(
        search_space_size=0.4, search_space_resolution=0.05,
        search_angle_offset=0.0349 * 5, search_angle_resolution=0.00349 * 2,
        response_threshold=0.3, use_point_size=60,
        use_center_penalty=False, tier=COARSE)
    res = correlative_scan_match(spec, p, pmap.probs, pmap.offset,
                                 jnp.asarray(points), jnp.asarray(mask),
                                 120, init, jnp.eye(3))
    assert float(res.response) > 0.5
    err = np.asarray(res.pose) - np.asarray(true_pose)
    assert abs(err[0]) < 0.06 and abs(err[1]) < 0.06, err
    assert abs(err[2]) < 0.02, err
    # covariance present and positive
    cov = np.asarray(res.cov)
    assert cov[0, 0] > 0 and cov[1, 1] > 0 and cov[2, 2] > 0


@pytest.mark.parametrize("ulps", [-2, 2, 8])
def test_angular_covariance_ignores_rounding_of_the_best_pose(ulps):
    """A best pose on the candidate grid has its neighbours exactly one
    search step away; float32 rounding of its map coordinates (here a few
    ulps at ~2000 cells) must not drop them from the angular covariance."""
    from roborts_slam.ops.correlative import angular_covariance

    spec = ProbMapSpec(resolution=0.01, height=4096, width=4096,
                       deviation=0.03, blur_offset=0.88, default_prob=0.5)
    params = CorrelativeParams(
        search_space_size=0.04, search_space_resolution=0.01,
        search_angle_offset=0.0349, search_angle_resolution=0.00349,
        response_threshold=0.5, use_point_size=100,
        use_center_penalty=True, tier=SUPER)
    A, N = params.n_angles, params.n_space
    angles = jnp.arange(A, dtype=jnp.float32) * 0.00349
    xs = 2000.0 + jnp.arange(N, dtype=jnp.float32)
    ys = 1500.0 + jnp.arange(N, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    scores = jnp.asarray(rng.uniform(0.8, 0.9, (A, N, N)), jnp.float32)
    best = jnp.array([xs[2], ys[2], angles[A // 2]], jnp.float32)

    def var_aa(pose):
        cov = angular_covariance(params, spec, scores, angles, xs, ys, pose,
                                 jnp.float32(0.9), jnp.eye(3))
        return float(cov[2, 2])

    moved = best.at[:2].set(np.float32(best[:2]) + ulps * np.spacing(
        np.float32(best[:2])))
    assert var_aa(moved) == pytest.approx(var_aa(best), rel=1e-6)
