"""Map-consistency raycast check.

Replacement for ``OccuGridMap::MapFeedbackResponsePenalty``
(src/map/occu_grid_map.h:331-392 + CheckOccuLineVisitorCallback :447-471):
ray-trace a pose hypothesis against the pub map and penalize rays that cross
an occupied cell well before their endpoint. The rays are a masked
exact-integer DDA sample grid over (rays, steps) read with one gather; the
cell rule is the one the map carve uses (ops/raster.py:_ray_cells).
"""

from __future__ import annotations

import math

import jax.numpy as jnp

from ..models.grid_map import CountMap, CountMapSpec, world_to_map_pose
from ..utils.geometry import transform_points
from .raster import _cell_round


def _sample_beams(points, mask, n_valid, check_point_num: int):
    """Beam subsampling with the scan matcher's striding rule
    (occu_grid_map.h:362-369)."""
    use = check_point_num
    small = n_valid < 2 * use
    step = jnp.where(small, 1, n_valid // jnp.maximum(use - 1, 1))
    max_samples = 2 * use
    sidx = jnp.arange(max_samples, dtype=jnp.int32) * step
    svalid = sidx < n_valid
    sidx = jnp.clip(sidx, 0, points.shape[0] - 1)
    svalid &= mask[sidx]
    return sidx, svalid


def penalty_rays(spec: CountMapSpec, cmap: CountMap, points, mask, n_valid,
                 pose_world, check_point_num: int):
    """The rays the consistency check walks: sensor cell ``start`` (2,),
    subsampled endpoint cells ``end`` (S,2), their mask ``ray_ok`` (S,) and
    whether the sensor lies inside the map."""
    inv_res = spec.inv_res
    pose_map = world_to_map_pose(cmap.offset, inv_res, pose_world)
    in_map = ((pose_map[0] > 0) & (pose_map[0] < spec.width)
              & (pose_map[1] > 0) & (pose_map[1] < spec.height))

    sidx, svalid = _sample_beams(points, mask, n_valid, check_point_num)
    pts_map = transform_points(pose_map, points[sidx] * inv_res)  # (S,2)
    end = _cell_round(pts_map)
    start = _cell_round(pose_map[:2])
    same = (end[:, 0] == start[0]) & (end[:, 1] == start[1])
    end_in = ((end[:, 0] > 0) & (end[:, 0] < spec.width)
              & (end[:, 1] > 0) & (end[:, 1] < spec.height))
    return start, end, svalid & ~same & end_in, in_map


def map_feedback_penalty(spec: CountMapSpec, cmap: CountMap,
                         points, mask, n_valid, pose_world,
                         check_point_num: int, bound_tolerance: float,
                         penalty_gain: float,
                         min_passthrough, occu_threshold):
    """Returns the response coefficient in [0.1, 1+2*gain].

    Reference semantics: subsample ``check_point_num`` beams; a ray is "bad"
    (adds 1) if any visited cell is Occupied (pass >= min_passthrough and
    prob >= occu_threshold, grid_map_cell.h:125-136) at distance
    > bound_tolerance cells from the beam endpoint; coefficient =
    max(1 + 2*gain − gain·Σbad, 0.1) (occu_grid_map.h:388-389).
    """
    start, end, ray_ok, in_map = penalty_rays(
        spec, cmap, points, mask, n_valid, pose_world, check_point_num)
    # d > tol  <=>  d^2 >= floor(tol^2) + 1  (d^2 integer)
    thr_d2 = int(math.floor(bound_tolerance * bound_tolerance)) + 1
    bad_total = bad_ray_count(spec, cmap, start, end, ray_ok,
                              min_passthrough, occu_threshold, thr_d2)

    penalty = bad_total.astype(jnp.float32) * penalty_gain
    coeff = jnp.maximum(1.0 + 2.0 * penalty_gain - penalty, 0.1)
    return jnp.where(in_map, coeff, 0.0)


def bad_ray_count(spec, cmap, start, end, ray_ok,
                  min_passthrough, occu_threshold, thr_d2: int):
    """Rays (start cell -> ``end`` cells, masked by ``ray_ok``) that cross
    an Occupied pub-map cell whose squared distance to the ray's endpoint
    is at least ``thr_d2`` cells²."""
    S = spec.max_ray_cells
    delta = end - start[None, :]                                  # (P,2) int
    nsteps = jnp.maximum(jnp.max(jnp.abs(delta), axis=-1), 1)
    t = jnp.arange(S, dtype=jnp.int32)[None, :]
    n2 = (2 * nsteps)[:, None, None]
    num = (n2 * start[None, None, :]
           + 2 * delta[:, None, :] * t[:, :, None] + nsteps[:, None, None])
    cells = num // n2                                             # (P,S,2)
    on_line = t <= nsteps[:, None]

    cx = jnp.clip(cells[..., 0], 0, spec.width - 1)
    cy = jnp.clip(cells[..., 1], 0, spec.height - 1)
    passes = cmap.passes[cy, cx]
    hits = cmap.hits[cy, cx]
    prob = jnp.where(passes > 0, hits / jnp.maximum(passes, 1e-9), 0.5)
    occupied = (passes >= min_passthrough) & (prob >= occu_threshold)

    d2 = jnp.sum((cells - end[:, None, :]) ** 2, axis=-1)
    bad_cell = occupied & (d2 >= thr_d2) & on_line & ray_ok[:, None]
    return jnp.sum(jnp.any(bad_cell, axis=-1).astype(jnp.int32))
