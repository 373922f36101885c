"""Scan de-distortion vs analytically distorted sweeps
(LaserDataProcessor parity, src/laser_data_processor.cpp:154-314)."""

import numpy as np

from roborts_slam.io.dedistort import dedistort_scan, interpolate_poses
from roborts_slam.models.scan import LaserModel


def _wall_range(angle: float, half: float = 3.0) -> float:
    """Distance from origin to an axis-aligned square wall at +-half."""
    c, s = np.cos(angle), np.sin(angle)
    best = np.inf
    for d, comp in ((c, 0), (s, 1)):
        if abs(d) > 1e-9:
            for sign in (+1.0, -1.0):
                t = sign * half / d
                if t > 0:
                    p = np.array([c * t, s * t])
                    if np.all(np.abs(p) <= half + 1e-9):
                        best = min(best, t)
    return best


def test_interpolate_poses_linear():
    ot = np.array([0.0, 1.0])
    op = np.array([[0.0, 0.0, 0.0], [2.0, -1.0, 1.0]])
    p = interpolate_poses(np.array([0.25, 0.5]), ot, op)
    np.testing.assert_allclose(p[0], [0.5, -0.25, 0.25])
    np.testing.assert_allclose(p[1], [1.0, -0.5, 0.5])


def test_dedistort_rotating_sweep():
    """A robot spinning while sweeping sees warped walls; after correction
    the points must match the static scan from the sweep-start pose."""
    laser = LaserModel(angle_min=-np.pi / 2, angle_max=np.pi / 2,
                       range_min=0.05, range_max=10.0, num_beams=181)
    sweep = 0.1                      # s
    omega = 1.0                      # rad/s spin -> 0.1 rad over the sweep
    # odometry samples during the sweep
    ot = np.linspace(-0.01, sweep + 0.01, 25)
    op = np.stack([np.zeros_like(ot), np.zeros_like(ot), omega * ot], -1)

    # distorted ranges: each beam b fires at time t_b with robot yaw w*t_b,
    # so it measures the wall along (beam_angle + yaw)
    beam_t = np.linspace(0.0, sweep, laser.num_beams)
    angles = laser.angles
    ranges = np.array([_wall_range(a + omega * t)
                       for a, t in zip(angles, beam_t)], np.float32)

    pts = dedistort_scan(ranges, laser, 0.0, sweep, ot, op)
    valid = ~np.isnan(pts[:, 0])
    assert valid.sum() > 150

    # correction re-expresses each measured endpoint in the sweep-start
    # frame; corrected points must lie ON the square wall (|coord|_inf = 3)
    def wall_dist(p):
        return np.abs(np.max(np.abs(p), axis=1) - 3.0)

    assert np.max(wall_dist(pts[valid])) < 0.02, np.max(wall_dist(pts[valid]))

    # WITHOUT correction the warped sweep misses the wall badly
    raw = np.stack([ranges * np.cos(angles), ranges * np.sin(angles)], -1)
    assert np.max(wall_dist(raw[valid])) > 0.2, np.max(wall_dist(raw[valid]))


def test_dedistort_invalid_beams_nan():
    laser = LaserModel(angle_min=-1.0, angle_max=1.0, range_min=0.05,
                       range_max=5.0, num_beams=11)
    ranges = np.full(11, 2.0, np.float32)
    ranges[3] = 0.0        # below range_min
    ranges[7] = 9.0        # above range_max
    ot = np.array([0.0, 0.1])
    op = np.zeros((2, 3))
    pts = dedistort_scan(ranges, laser, 0.0, 0.1, ot, op)
    assert np.isnan(pts[3]).all() and np.isnan(pts[7]).all()
    assert not np.isnan(pts[0]).any()
