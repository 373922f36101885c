"""Branch-and-bound correlative matcher — a fixed-shape beam search over
max-pooled score bounds.

Replaces ``BranchAndBoundCorrelateScanMatcher``
(src/scan_match/correlate_scan_matcher.h:271-502): the reference seeds a
depth-``max_depth`` recursion with sparse "lowest resolution" candidates
(stride ``2^D`` cells, :333-393) and refines each into its 2x2 children
({0, half_width} offsets) depth-first with score pruning (:434-476). Its
coarse levels score on the *raw* map, so a coarse candidate's score says
nothing about its children and the pruning can drop the true peak — one
reason the call site is disabled (scan_matchers.h:266-273).

This build keeps the search structure but fixes both problems:

- **Admissible bounds** (Cartographer-style precomputed grids): level ``d``
  scores against a max-pooled map ``M_d[y,x] = max_{k,l<2^d} M[y+k,x+l]``,
  so a parent's score upper-bounds every descendant and coarse ranking is
  sound. The pyramid is built on device by shift-max doubling.
- **Beam search instead of DFS**: data-dependent recursion cannot live
  under ``jit``; at every depth the top ``beam_width`` candidates survive
  (lax.top_k) and ALL of their 2x2 children are scored in one batched
  gather. With admissible bounds the optimum's ancestors rank above any
  candidate whose bound is below the true best; the search is therefore
  EXACT whenever fewer than ``beam_width`` candidates bound above the true
  best at every depth (tests assert equality with exhaustive dense scoring
  on such cases). In highly repetitive environments (long corridors) more
  ties can exist than the beam holds — raise ``beam_width`` (cost is one
  larger batched gather per level) or fall back to the dense tiers.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..models.grid_map import ProbMapSpec, map_to_world_pose, world_to_map_pose
from .correlative import _sample_indices


@dataclasses.dataclass(frozen=True)
class BnBParams:
    """FAST_CORRELATION_SCAN_MATCH parameter block; defaults are the
    reference's hard-coded test values (scan_matchers.h:337-344)."""

    search_space_size: float = 0.8
    search_space_resolution: float = 0.01
    search_angle_offset: float = 0.523
    search_angle_resolution: float = 0.00349
    response_threshold: float = 0.5
    use_point_size: int = 100
    max_depth: int = 4
    beam_width: int = 256            # fixed beam replaces DFS pruning

    @property
    def n_angles(self) -> int:
        import math
        return int(math.floor(self.search_angle_offset * 2
                              / self.search_angle_resolution) + 1)

    @property
    def max_samples(self) -> int:
        return 2 * self.use_point_size


class BnBResult(NamedTuple):
    pose: jnp.ndarray      # (3,) world pose (updated iff score > threshold)
    response: jnp.ndarray  # () best score
    best_map_pose: jnp.ndarray  # (3,) best candidate in map coords


def max_pool_pyramid(probs, max_depth: int, step_cells: int,
                     default_prob: float):
    """levels[d][y, x] = max over {k·st, l·st : k,l < 2^d} of probs shifted —
    the admissible score bound for a candidate block of side ``2^d`` lattice
    steps anchored at (y, x). Built by shift-max doubling; shifted-out
    regions read the out-of-map default (GetGridProbValue semantics)."""
    def shift(m, dy, dx):
        h, w = m.shape
        out = jnp.full_like(m, default_prob)
        return out.at[: h - dy, : w - dx].set(m[dy:, dx:])

    levels = [probs]
    m = probs
    for d in range(max_depth):
        s = step_cells * (1 << d)
        m = jnp.maximum(m, shift(m, 0, s))
        m = jnp.maximum(m, shift(m, s, 0))
        levels.append(m)
    return levels


def _score_at(spec: ProbMapSpec, level_probs, rx, ry, svalid, divisor,
              cand_x, cand_y, cand_ai):
    """Score candidates at arbitrary map positions (ScoreCandidates,
    correlate_scan_matcher.h:398-431) against one pyramid level."""
    crx = rx[cand_ai]                           # (C,S)
    cry = ry[cand_ai]
    gx = jnp.floor(crx + cand_x[:, None] + 0.5).astype(jnp.int32)
    gy = jnp.floor(cry + cand_y[:, None] + 0.5).astype(jnp.int32)
    ok = ((gx >= 0) & (gx < spec.width) & (gy >= 0) & (gy < spec.height)
          & svalid[None, :])
    flat = jnp.where(ok, gy * spec.width + gx, -1)
    vals = jnp.take(level_probs.reshape(-1), flat, mode="fill",
                    fill_value=float(spec.default_prob))
    vals = jnp.where(ok, vals,
                     jnp.where(svalid[None, :], spec.default_prob, 0.0))
    return jnp.sum(vals, axis=1) / divisor       # (C,)


def bnb_scan_match(spec: ProbMapSpec, params: BnBParams, probs, offset,
                   points, mask, n_valid, pose_world) -> BnBResult:
    """One branch-and-bound match (ScanMatch,
    correlate_scan_matcher.h:274-332). Requires an integer candidate step in
    map cells (true for the reference's parameter block)."""
    del mask  # points are front-packed; n_valid drives sampling
    inv_res = spec.inv_res
    st = params.search_space_resolution * inv_res
    st_i = int(round(st))
    assert abs(st - st_i) < 1e-6 and st_i >= 1, (
        f"branch-and-bound requires integer candidate step, got {st}")
    center = world_to_map_pose(offset, inv_res, pose_world)

    A = params.n_angles
    D = params.max_depth
    n0 = int(round(params.search_space_size
                   / ((1 << D) * params.search_space_resolution)) + 1)

    base_angle = center[2]
    angles = (base_angle - params.search_angle_offset
              + jnp.arange(A, dtype=jnp.float32)
              * params.search_angle_resolution)
    sidx, svalid, divisor = _sample_indices(n_valid, params.use_point_size,
                                            params.max_samples)
    pts = points[sidx] * inv_res
    c, s = jnp.cos(angles), jnp.sin(angles)
    rx = c[:, None] * pts[None, :, 0] - s[:, None] * pts[None, :, 1]  # (A,S)
    ry = s[:, None] * pts[None, :, 0] + c[:, None] * pts[None, :, 1]

    start_x = center[0] - (params.search_space_size * inv_res) * 0.5
    start_y = center[1] - (params.search_space_size * inv_res) * 0.5

    levels = max_pool_pyramid(probs, D, st_i, spec.default_prob)

    # ---- level D: dense over (A, n0, n0) against the pooled bound ----
    stride0 = (1 << D) * st
    xs0 = start_x + jnp.arange(n0, dtype=jnp.float32) * stride0
    ys0 = start_y + jnp.arange(n0, dtype=jnp.float32) * stride0
    ai0 = jnp.repeat(jnp.arange(A, dtype=jnp.int32), n0 * n0)
    cx0 = jnp.tile(jnp.repeat(xs0, n0), A)
    cy0 = jnp.tile(jnp.tile(ys0, n0), A)
    sc0 = _score_at(spec, levels[D], rx, ry, svalid, divisor, cx0, cy0, ai0)

    K = min(params.beam_width, sc0.shape[0])
    beam_sc, idx = jax.lax.top_k(sc0, K)
    beam_x, beam_y, beam_ai = cx0[idx], cy0[idx], ai0[idx]

    # ---- refine: depth d -> d-1, children at {0, half_width} offsets
    # (BranchAndBound :452-465), scored against level d-1 bounds ----
    for d in range(D, 0, -1):
        half = (1 << (d - 1)) * st
        offs = jnp.array([[0.0, 0.0], [half, 0.0], [0.0, half], [half, half]],
                         jnp.float32)
        cx = (beam_x[:, None] + offs[None, :, 0]).reshape(-1)   # (4K,)
        cy = (beam_y[:, None] + offs[None, :, 1]).reshape(-1)
        cai = jnp.repeat(beam_ai, 4)
        sc = _score_at(spec, levels[d - 1], rx, ry, svalid, divisor,
                       cx, cy, cai)
        kk = min(K, sc.shape[0])
        beam_sc, idx = jax.lax.top_k(sc, kk)
        beam_x, beam_y, beam_ai = cx[idx], cy[idx], cai[idx]

    best_score = beam_sc[0]
    best_map = jnp.stack([beam_x[0], beam_y[0], angles[beam_ai[0]]])

    # accept iff score > threshold (:322-326); else keep the input pose
    accept = best_score > params.response_threshold
    best_world = map_to_world_pose(offset, inv_res, best_map)
    pose = jnp.where(accept, best_world, pose_world)
    return BnBResult(pose=pose, response=best_score, best_map_pose=best_map)
