"""Vectorized SE(2) pose algebra.

Replacement for the reference's ``src/util/slam_util.h`` /
``src/util/transform.h`` free functions and ``Transform2d`` /
``TransformByMidFrame`` classes. Everything here is a pure jnp function on
``(..., 3)`` pose arrays ``[x, y, theta]`` — batched, differentiable, and
usable both inside jit and from the host (via numpy broadcasting rules).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax


def normalize_angle(angle):
    """Normalize to [-pi, pi] (reference ``util::NormalizeAngle``,
    slam_util.h:103-111)."""
    two_pi = 2.0 * jnp.pi
    a = jnp.mod(jnp.mod(angle, two_pi) + two_pi, two_pi)
    return jnp.where(a > jnp.pi, a - two_pi, a)


def rot2(theta):
    """(...,) -> (..., 2, 2) rotation matrices."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack(
        [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
    )


def pose_compose(a, b):
    """SE(2) composition a ⊕ b: apply b in a's frame. (...,3)x(...,3)->(...,3)."""
    ca, sa = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    th = normalize_angle(a[..., 2] + b[..., 2])
    return jnp.stack([x, y, th], axis=-1)


def pose_inverse(a):
    """SE(2) inverse: pose_compose(pose_inverse(a), a) == identity."""
    ca, sa = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    return jnp.stack([x, y, -a[..., 2]], axis=-1)


def pose_relative(a, b):
    """Relative pose of b expressed in a's frame: a⁻¹ ⊕ b.

    Matches the reference's mid-frame construction
    ``TransformByMidFrame(pose_1, pose_2).Transform(0)`` used for
    ``EdgeLinkInfo`` (pose_graph.h:88-107): the result is pose_2 relative to
    pose_1 in pose_1's frame.
    """
    return pose_compose(pose_inverse(a), b)


def transform_points(pose, points):
    """Apply SE(2) pose to local points. pose (...,3), points (...,N,2)."""
    r = rot2(pose[..., 2])
    # full float32: in TF32 a 30 m beam would move by ~1.5 cm, more than a
    # fine-map cell
    rotated = jnp.einsum("...ij,...nj->...ni", r, points,
                         precision=lax.Precision.HIGHEST)
    return rotated + pose[..., None, :2]


def points_bound_box(points, mask):
    """Masked axis-aligned bound box of a point set (reference
    ``BoundBox2d`` + ``RangeDataContainer::UpdateBoundBox``, boundbox.h:34-147,
    sensor_data_manager.h:241-247). Returns ((2,) min, (2,) max); empty
    masks yield an inverted box (min=+inf, max=-inf) like the reference's
    initial state."""
    big = jnp.float32(3.4e38)
    w = mask[..., None]
    mn = jnp.min(jnp.where(w, points, big), axis=-2)
    mx = jnp.max(jnp.where(w, points, -big), axis=-2)
    return mn, mx


def bound_box_contains(mn, mx, xy):
    """Point-in-box test (BoundBox::Contain, boundbox.h:96-104)."""
    return jnp.all((xy >= mn) & (xy <= mx), axis=-1)


def bound_box_union(mn1, mx1, mn2, mx2):
    """Box union (BoundBox::AddBoundBox, boundbox.h:77-94)."""
    return jnp.minimum(mn1, mn2), jnp.maximum(mx1, mx2)


def pose_change_enough(p1, p2, dist_thresh, angle_thresh):
    """Reference ``util::PoseChangeEnough`` (slam_util.h:113-126)."""
    dist = jnp.linalg.norm(p1[..., :2] - p2[..., :2], axis=-1)
    dth = jnp.abs(normalize_angle(p1[..., 2] - p2[..., 2]))
    return (dist >= dist_thresh) | (dth >= angle_thresh)


def squared_distance(p1, p2):
    """xy squared distance between poses (slam_util.h:128-130)."""
    d = p1[..., :2] - p2[..., :2]
    return jnp.sum(d * d, axis=-1)


def predict_pose_by_odom(last_pose, last_odom, cur_odom):
    """Odometry-based pose prediction, exactly the reference formula
    (slam_processor.cpp:618-634): rebase the odom delta into the map frame
    via the yaw offset between the last corrected pose and last odom pose."""
    dth = last_pose[..., 2] - last_odom[..., 2]
    c, s = jnp.cos(dth), jnp.sin(dth)
    # odom_to_map translation
    tx = last_pose[..., 0] - (c * last_odom[..., 0] - s * last_odom[..., 1])
    ty = last_pose[..., 1] - (s * last_odom[..., 0] + c * last_odom[..., 1])
    x = c * cur_odom[..., 0] - s * cur_odom[..., 1] + tx
    y = s * cur_odom[..., 0] + c * cur_odom[..., 1] + ty
    th = dth + cur_odom[..., 2]
    return jnp.stack([x, y, th], axis=-1)
