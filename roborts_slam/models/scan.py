"""Scan and sensor models.

Replacement for the reference's ``RangeDataContainer2d`` /
``LaserRangeFinder`` (src/slam/sensor_data_manager.h:32-346). Differences by
design:

- Fixed-shape, masked point arrays (``max_points`` padding) instead of
  std::vector — required for XLA static shapes, and what lets us vmap over
  scans and shard batches of scans across a device mesh.
- No per-resolution scaled copies: the reference stores one scaled copy of
  every scan per map (sensor_data_manager.h:99-115, 579); we scale points by
  ``1/resolution`` on the fly inside kernels (one fused multiply).
- No frame-state machine: points are always stored in the sensor-local frame;
  world/map coordinates are produced functionally where needed.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class LaserModel:
    """Sensor intrinsics (reference ``LaserRangeFinder``,
    sensor_data_manager.h:32-78)."""

    angle_min: float
    angle_max: float
    range_min: float
    range_max: float
    num_beams: int
    range_threshold_scale: float = 0.95
    scan_time: float = 0.0     # sweep duration (s); 0 = instantaneous

    @property
    def range_threshold(self) -> float:
        """``range_min + scale * (range_max - range_min)``
        (sensor_data_manager.h:43-49); beams beyond it are dropped
        (roborts_slam_node.cpp:295-307)."""
        return self.range_min + self.range_threshold_scale * (
            self.range_max - self.range_min
        )

    @property
    def angles(self) -> np.ndarray:
        return np.linspace(self.angle_min, self.angle_max, self.num_beams)

    def to_array(self) -> np.ndarray:
        """Flat serialization used by .npz logs and checkpoints."""
        return np.array([self.angle_min, self.angle_max, self.range_min,
                         self.range_max, self.num_beams,
                         self.range_threshold_scale, self.scan_time])

    @staticmethod
    def from_array(a: np.ndarray) -> "LaserModel":
        return LaserModel(
            angle_min=float(a[0]), angle_max=float(a[1]),
            range_min=float(a[2]), range_max=float(a[3]),
            num_beams=int(a[4]), range_threshold_scale=float(a[5]),
            # older serializations predate the scan_time field
            scan_time=float(a[6]) if len(a) > 6 else 0.0,
        )


class Scan(NamedTuple):
    """One laser scan with a fixed-shape masked point set.

    points: (P, 2) float32 — cartesian points in the sensor-local frame (m).
    mask:   (P,) bool — valid-point mask (padding is False).
    pose:   (3,) float32 — sensor pose in world (estimated by SLAM).
    odom:   (3,) float32 — odometry pose at capture time.
    time:   () float32 — timestamp (s).
    """

    points: jnp.ndarray
    mask: jnp.ndarray
    pose: jnp.ndarray
    odom: jnp.ndarray
    time: jnp.ndarray

    @property
    def num_valid(self):
        return jnp.sum(self.mask.astype(jnp.int32))


def pack_points(pts: np.ndarray, max_points: int):
    """Front-pack a (N, 2) valid-point array into fixed-shape
    (points (max_points, 2), mask (max_points,), n)."""
    n = pts.shape[0]
    if n > max_points:
        raise ValueError(f"scan has {n} valid points > max_points={max_points}")
    points = np.zeros((max_points, 2), dtype=np.float32)
    points[:n] = pts
    mask = np.zeros((max_points,), dtype=bool)
    mask[:n] = True
    return points, mask, n


def ranges_to_packed(ranges: np.ndarray, laser: LaserModel,
                     max_points: int):
    """Host-only polar → cartesian + range gating + front-packing
    (BuildRangeDataContainer, roborts_slam_node.cpp:290-311). Returns pure
    NumPy ``(points (max_points, 2) f32, mask (max_points,) bool, n_valid)``
    — the engine ingest path uses this directly: round-tripping the packed
    scan through the device (scan_from_ranges builds jnp arrays) would cost
    three fetch round-trips per scan."""
    ranges = np.asarray(ranges, dtype=np.float32)
    angles = laser.angles.astype(np.float32)
    valid = (ranges > laser.range_min) & (ranges < laser.range_threshold)
    r = ranges[valid]
    a = angles[valid]
    pts = np.stack([r * np.cos(a), r * np.sin(a)], axis=-1)
    return pack_points(pts, max_points)


def scan_from_ranges(
    ranges: np.ndarray,
    laser: LaserModel,
    odom_pose: np.ndarray,
    timestamp: float,
    max_points: int,
    pose: np.ndarray | None = None,
) -> Scan:
    """Polar → cartesian with range gating, reference
    ``SlamNode::BuildRangeDataContainer`` (roborts_slam_node.cpp:290-311):
    keep beams with ``range_min < r < range_threshold``. Padded to
    ``max_points`` with mask; valid points are front-packed so the
    subsampled-scoring index rule (point_step striding) sees the same point
    ordering as the reference."""
    ranges = np.asarray(ranges, dtype=np.float32)
    angles = laser.angles.astype(np.float32)
    valid = (ranges > laser.range_min) & (ranges < laser.range_threshold)
    r = ranges[valid]
    a = angles[valid]
    pts = np.stack([r * np.cos(a), r * np.sin(a)], axis=-1)
    points, mask, n = pack_points(pts, max_points)
    if pose is None:
        pose = odom_pose
    return Scan(
        points=jnp.asarray(points),
        mask=jnp.asarray(mask),
        pose=jnp.asarray(pose, dtype=jnp.float32),
        odom=jnp.asarray(odom_pose, dtype=jnp.float32),
        time=jnp.asarray(timestamp, dtype=jnp.float32),
    )


def barycenter_pose(points, mask, pose):
    """Barycenter pose: centroid of the world-frame points with the sensor
    yaw (reference ``UpdateBarycenterPose``, sensor_data_manager.h:214-238).
    Used for every back-end distance test."""
    from ..utils.geometry import transform_points

    w = mask.astype(points.dtype)
    world = transform_points(pose, points)
    denom = jnp.maximum(jnp.sum(w), 1.0)
    centroid = jnp.sum(world * w[..., None], axis=-2) / denom
    return jnp.stack([centroid[..., 0], centroid[..., 1], pose[..., 2]], axis=-1)
