"""Gauss-Newton scan-to-map refinement (optimize matcher).

Replacement for ``BasedOptimizeScanMatch``
(src/scan_match/optimize_scan_matcher.h:60-237). The per-point bilinear
interpolation + analytic Jacobian accumulation (:154-221) is vectorized over
all points; the early-stopping iteration (:86-124) is a ``lax.while_loop``
so the whole refinement stays on device inside the front-end step jit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ..models.grid_map import ProbMapSpec, map_to_world_pose, world_to_map_pose
from ..utils.geometry import normalize_angle

K_COST_POINT_SIZE = 1000.0   # optimize_scan_matcher.h:234
K_MAX_COST = 1000.0          # optimize_scan_matcher.h:235


@dataclasses.dataclass(frozen=True)
class OptimizeParams:
    """OptimizeScanMatchParam (optimize_scan_matcher.h:33-58)."""

    iterate_max_times: int
    cost_decrease_threshold: float
    cost_min_threshold: float
    max_update_distance: float
    max_update_angle: float


class OptimizeResult(NamedTuple):
    pose: jnp.ndarray   # (3,) world
    cost: jnp.ndarray   # () normalized cost


def _cost_h_b(spec: ProbMapSpec, probs, pose_map, points, mask):
    """One UpdateCost pass (optimize_scan_matcher.h:154-221): bilinear map
    interpolation, residual 1-p, analytic Jacobian, accumulate H, b."""
    inv_res = spec.inv_res
    c, s = jnp.cos(pose_map[2]), jnp.sin(pose_map[2])
    local = points * inv_res                            # (P,2) map units
    mx = c * local[:, 0] - s * local[:, 1] + pose_map[0]
    my = s * local[:, 0] + c * local[:, 1] + pose_map[1]

    in_map = (mx > 0) & (mx < spec.width) & (my > 0) & (my < spec.height) & mask

    x0 = jnp.floor(mx)
    y0 = jnp.floor(my)
    x1 = x0 + 1.0
    y1 = y0 + 1.0

    def at(xi, yi):
        xi_i = jnp.clip(xi.astype(jnp.int32), 0, spec.width - 1)
        yi_i = jnp.clip(yi.astype(jnp.int32), 0, spec.height - 1)
        return probs[yi_i, xi_i]

    p00, p01 = at(x0, y0), at(x0, y1)
    p10, p11 = at(x1, y0), at(x1, y1)

    resp = ((my - y0) * (p11 * (mx - x0) + p01 * (x1 - mx))
            + (y1 - my) * (p10 * (mx - x0) + p00 * (x1 - mx)))
    resp = jnp.clip(resp, 0.0, 1.0)
    err = jnp.where(in_map, 1.0 - resp, 0.0)

    # d(residual)/d(pose): J = -de_m * de_s (:196-210)
    dmx = (my - y0) * (p11 - p01) + (y1 - my) * (p10 - p00)
    dmy = (mx - x0) * (p11 - p10) + (x1 - mx) * (p01 - p00)
    dsx_th = -s * local[:, 0] - c * local[:, 1]
    dsy_th = c * local[:, 0] - s * local[:, 1]
    j0 = -dmx
    j1 = -dmy
    j2 = -(dmx * dsx_th + dmy * dsy_th)
    J = jnp.stack([j0, j1, j2], axis=-1)                # (P,3)
    J = jnp.where(in_map[:, None], J, 0.0)

    # full float32 (no TF32): the normal equations feed a solve
    H = jnp.matmul(J.T, J, precision=lax.Precision.HIGHEST)
    b = -jnp.matmul(J.T, err, precision=lax.Precision.HIGHEST)
    cost = jnp.sum(err * err)
    valid = 1 + jnp.sum(in_map.astype(jnp.int32))       # starts at 1 (:160)
    cost = cost * (K_COST_POINT_SIZE / valid.astype(jnp.float32))
    return cost, H, b


def optimize_scan_match(spec: ProbMapSpec, params: OptimizeParams,
                        probs, offset, points, mask, pose_world) -> OptimizeResult:
    """Iterated GN with step clamping and plateau early-stop
    (optimize_scan_matcher.h:86-132)."""
    pose0 = world_to_map_pose(offset, spec.inv_res, pose_world)
    max_d = params.max_update_distance * spec.inv_res

    def cond(state):
        it, pose, cost, last_cost, done = state
        return (~done) & (it < params.iterate_max_times)

    def body(state):
        it, pose, cost, last_cost, _ = state
        new_last = cost
        new_cost, H, b = _cost_h_b(spec, probs, pose, points, mask)
        det = jnp.linalg.solve(H + 1e-9 * jnp.eye(3), b)
        nan = jnp.any(jnp.isnan(det))
        converged = (it > 0) & (
            (new_last - new_cost < params.cost_decrease_threshold)
            | (new_cost < params.cost_min_threshold)
        )
        step = jnp.stack([
            jnp.clip(det[0], -max_d, max_d),
            jnp.clip(det[1], -max_d, max_d),
            jnp.clip(det[2], -params.max_update_angle, params.max_update_angle),
        ])
        new_pose = jnp.where(converged | nan, pose, pose + step)
        out_cost = jnp.where(nan, K_MAX_COST, new_cost)
        return (it + 1, new_pose, out_cost, new_last, converged | nan)

    init = (jnp.int32(0), pose0, jnp.float32(0.0), jnp.float32(0.0), jnp.bool_(False))
    _, pose, cost, _, _ = lax.while_loop(cond, body, init)
    # empty-scan guard (optimize_scan_matcher.h:73-76): max cost, keep pose
    empty = ~jnp.any(mask)
    cost = jnp.where(empty, K_MAX_COST, cost)
    pose = jnp.where(empty, pose0, pose)
    pose = pose.at[2].set(normalize_angle(pose[2]))
    return OptimizeResult(pose=map_to_world_pose(offset, spec.inv_res, pose),
                          cost=cost)
