"""The device paths of the front end's hot ops against their serial NumPy
references (roborts_slam/bench/cpu_reference.py): correlative scoring,
the pub-map mark image and the map-consistency bad-ray count. The same
checks run at full width on the GPU in chip_smoke.py (phase 1)."""

import jax.numpy as jnp
import numpy as np
import pytest

from roborts_slam.bench import cpu_reference as R
from roborts_slam.models.grid_map import CountMap, CountMapSpec, ProbMapSpec
from roborts_slam.ops import raycast
from roborts_slam.ops.correlative import (
    COARSE, FINE, SUPER, CorrelativeParams, score_candidates,
)
from roborts_slam.ops.raster import scan_mark_image


def _score_setup(seed, n_points, center_xy, reach_m=3.0, size=1024,
                 res=0.02, max_points=256):
    rng = np.random.default_rng(seed)
    spec = ProbMapSpec(resolution=res, height=size, width=size,
                       deviation=0.05, blur_offset=0.88, default_prob=0.3)
    probs = rng.uniform(0, 1, (size, size)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, max_points)
    r = rng.uniform(0.3, reach_m, max_points)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    mask = np.zeros(max_points, bool)
    mask[:n_points] = True
    pts[n_points:] = 0
    center = np.array([*center_xy, 0.4], np.float32)
    return spec, probs, pts, mask, center


@pytest.mark.parametrize("params,setup", [
    (CorrelativeParams(0.6, 0.1, 0.175, 0.0349, 0.6, 40, True, COARSE),
     dict(seed=0, n_points=90, center_xy=(512.0, 512.0))),
    (CorrelativeParams(0.2, 0.04, 0.0698, 0.0349, 0.6, 40, True, FINE),
     dict(seed=1, n_points=90, center_xy=(512.0, 512.0))),
    (CorrelativeParams(0.04, 0.02, 0.0349, 0.00349, 0.6, 60, True, SUPER),
     dict(seed=2, n_points=150, center_xy=(512.0, 512.0))),
    # fewer points than 2x use_point_size: every point sampled, divisor P
    (CorrelativeParams(0.4, 0.04, 0.0698, 0.0349, 0.6, 40, True, COARSE),
     dict(seed=3, n_points=30, center_xy=(512.0, 512.0))),
    # sensor at the map corner with 25 m beams: most samples fall off the
    # map and must score exactly default_prob
    (CorrelativeParams(0.2, 0.02, 0.05, 0.025, 0.6, 25, True, FINE),
     dict(seed=10, n_points=50, center_xy=(1000.0, 30.0), reach_m=25.0)),
], ids=["coarse", "fine", "super", "small_scan", "out_of_map"])
def test_scores_match_serial_reference(params, setup):
    spec, probs, pts, mask, center = _score_setup(**setup)
    n = int(mask.sum())
    s, a, xs, ys = score_candidates(
        spec, params, jnp.asarray(probs), jnp.zeros(2), jnp.asarray(pts),
        jnp.asarray(mask), n, jnp.asarray(center))
    rs, ra, rxs, rys = R.score_candidates_serial(
        probs, spec.default_prob, spec.inv_res, pts, n, center,
        params.search_space_size, params.search_space_resolution,
        params.search_angle_offset, params.search_angle_resolution,
        params.use_point_size)
    np.testing.assert_allclose(np.asarray(a), ra, atol=1e-6)
    np.testing.assert_allclose(np.asarray(xs), rxs, atol=1e-4)
    np.testing.assert_allclose(np.asarray(ys), rys, atol=1e-4)
    np.testing.assert_allclose(np.asarray(s), rs, atol=1e-4)


def _scan(rng, n, rmax):
    ang = rng.uniform(-2.4, 2.4, n)
    r = rng.uniform(0.2, rmax, n)
    pts = np.stack([r * np.cos(ang), r * np.sin(ang)], -1).astype(np.float32)
    return pts, rng.random(n) > 0.1


def _mark_case(size, offset_m, pose, seed, n, rmax):
    spec = CountMapSpec(resolution=0.05, height=size, width=size,
                        max_ray_cells=52)
    pts, mask = _scan(np.random.default_rng(seed), n, rmax)
    return spec, np.array([offset_m, offset_m], np.float32), \
        np.asarray(pose, np.float32), pts, mask


@pytest.mark.parametrize("case", [
    dict(size=256, offset_m=6.4, pose=[0.0, 0.0, 0.0], seed=0, n=64,
         rmax=2.4),
    dict(size=256, offset_m=6.4, pose=[1.3, -0.7, 0.9], seed=1, n=64,
         rmax=2.4),
    dict(size=256, offset_m=6.4, pose=[-5.0, 5.5, -2.2], seed=2, n=64,
         rmax=2.4),                          # near the map corner
    dict(size=256, offset_m=0.0, pose=[0.2, 0.1, 0.0], seed=3, n=64,
         rmax=2.4),                          # sensor at the map origin edge
    # rays leaving a small map: only the in-map prefix is marked
    dict(size=128, offset_m=3.2, pose=[2.8, -2.9, 0.7], seed=7, n=48,
         rmax=2.5),
    # empty scan: nothing marked
    dict(size=128, offset_m=3.2, pose=[0.0, 0.0, 0.0], seed=4, n=0,
         rmax=1.0),
], ids=["origin", "rotated", "corner", "map_edge", "long_rays", "empty"])
def test_mark_image_matches_serial_dda(case):
    spec, offset, pose, pts, mask = _mark_case(**case)
    got = np.asarray(scan_mark_image(spec, jnp.asarray(offset),
                                     jnp.asarray(pts.reshape(-1, 2)),
                                     jnp.asarray(mask), jnp.asarray(pose)))
    ref = R.mark_image_serial(spec.height, spec.width, spec.inv_res, offset,
                              pose, pts.reshape(-1, 2), mask)
    assert int((got != ref).sum()) == 0, (
        f"free ref={int((ref == 1).sum())} got={int((got == 1).sum())}, "
        f"occ ref={int((ref == 2).sum())} got={int((got == 2).sum())}")
    if case["n"]:
        assert (ref == 2).sum() > 0       # endpoints actually stamped
    else:
        assert (got == 0).all()


def test_bad_ray_count_matches_serial():
    """The consistency check counts the same bad rays as a serial walk,
    across map states and poses."""
    rng = np.random.default_rng(11)
    spec = CountMapSpec(resolution=0.05, height=256, width=256,
                        max_ray_cells=52)
    passes = np.floor(rng.random((256, 256)) * 8).astype(np.float32)
    hits = passes * (rng.random((256, 256)) > 0.95)
    cmap = CountMap(jnp.asarray(hits), jnp.asarray(passes),
                    jnp.asarray([6.4, 6.4], jnp.float32))
    counts, rays = [], []
    for seed, pose in [(0, [0.0, 0.0, 0.0]), (1, [1.1, -0.8, 0.5]),
                       (2, [-4.9, 5.2, 2.0])]:
        pts, mask = _scan(np.random.default_rng(seed), 80, 2.4)
        start, end, ok, _ = raycast.penalty_rays(
            spec, cmap, jnp.asarray(pts), jnp.asarray(mask), jnp.int32(80),
            jnp.asarray(pose, jnp.float32), 40)
        rstart, rend, rok = R.penalty_rays_serial(
            256, 256, spec.inv_res, np.asarray(cmap.offset), pose, pts, mask,
            80, 40)
        assert tuple(np.asarray(start)) == tuple(rstart)
        np.testing.assert_array_equal(np.asarray(end), rend)
        np.testing.assert_array_equal(np.asarray(ok), rok)
        got = int(raycast.bad_ray_count(spec, cmap, start, end, ok,
                                        jnp.float32(3.0), jnp.float32(0.5),
                                        26))
        ref = R.bad_rays_serial(hits, passes, rstart, rend, rok, 3.0, 0.5,
                                5.0)
        assert got == ref, (seed, got, ref)
        counts.append(ref)
        rays.append(int(rok.sum()))
    # the map discriminates: some rays are bad, not all
    assert 0 < sum(counts) < sum(rays), (counts, rays)
