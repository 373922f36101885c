"""Batched correlative scan matching — the engine's hot kernel.

Batched replacement for the reference's serial Olson-style triple loop
(``MultiResolutionCorrelateScanMatcher::ScanMatch``,
correlate_scan_matcher.h:505-614, inner ``GetResponse`` :637-662) and the
wrapping ``BasedCorrelationScanMatch`` (:766-1036). All (angle, x, y)
candidates are scored in one fused, jitted computation:

  1. rotate the scan's points for every search angle at once — a small
     (A,2,2)x(P,2) einsum (the reference's AngleSearchLookUpTable,
     correlate_scan_matcher.h:150-186);
  2. one big gather of map probabilities at every (angle, sample, x, y)
     candidate cell;
  3. masked mean-reduce over sampled points → (A, Nx, Ny) scores;
  4. center penalty, tie-averaged best pose, and positional/angular
     covariance as vectorized postprocessing.

The scoring semantics replicate the reference exactly (point subsampling
rule, divide-by-use_point_size, truncating cell rounding, penalty gains and
clamps, tie tolerance, top-20 covariance windows) so trajectories track the
reference within its ATE bound while the execution is batched/vmappable —
vmap over scans or chains gives back-end fan-out and the throughput
benchmark for free.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import jax.numpy as jnp
from jax import lax

from ..models.grid_map import ProbMapSpec, map_to_world_pose, world_to_map_pose

# constants from correlate_scan_matcher.h:759-763, 1033 and slam_util.h:57-59
K_ANGULAR_PENALTY_GAIN = 0.25
K_DISTANCE_PENALTY_GAIN_COARSE = 0.4
K_DISTANCE_PENALTY_GAIN_FINE = 0.2
K_RESPONSE_FILTER_TOLERANCE = 1e-2
K_MAX_VARIANCE = 500.0
K_DOUBLE_TOLERANCE = 1e-6
K_MAX_VARIANCE_USE_POINT_SIZE = 20

COARSE, FINE, SUPER = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class CorrelativeParams:
    """Static search-grid configuration for one tier
    (CorrelationScanMatchParam, correlate_scan_matcher.h:41-86)."""

    search_space_size: float
    search_space_resolution: float
    search_angle_offset: float
    search_angle_resolution: float
    response_threshold: float
    use_point_size: int
    use_center_penalty: bool
    tier: int  # COARSE / FINE / SUPER

    @property
    def n_angles(self) -> int:
        # correlate_scan_matcher.h:154
        return int(math.floor(self.search_angle_offset * 2 / self.search_angle_resolution) + 1)

    @property
    def n_space(self) -> int:
        # correlate_scan_matcher.h:538 (util::Round = round-half-away)
        return int(round(self.search_space_size / self.search_space_resolution) + 1)

    @property
    def max_samples(self) -> int:
        # static bound on subsampled point count (see _sample_indices)
        return 2 * self.use_point_size


class MatchResult(NamedTuple):
    pose: jnp.ndarray        # (3,) world pose (updated iff response > threshold)
    response: jnp.ndarray    # () clamped to <= 1
    cov: jnp.ndarray         # (3,3) this tier's covariance writes applied to input cov
    best_map_pose: jnp.ndarray  # (3,) best candidate in map coords (debug)


def _sample_indices(n_valid, use_point_size: int, max_samples: int):
    """Reference point-subsampling rule (correlate_scan_matcher.h:560-566):
    step = P // (use-1) when P >= 2*use else 1; iterate i*step < P; the score
    divisor is use (or P when P < 2*use) even if the sample count differs."""
    use = use_point_size
    small = n_valid < 2 * use
    step = jnp.where(small, 1, n_valid // jnp.maximum(use - 1, 1))
    idx = jnp.arange(max_samples, dtype=jnp.int32) * step
    valid = idx < n_valid
    divisor = jnp.maximum(jnp.where(small, n_valid, use), 1).astype(jnp.float32)
    return jnp.clip(idx, 0, None), valid, divisor


def score_candidates(spec: ProbMapSpec, params: CorrelativeParams,
                     probs, offset, points, mask, n_valid, center_pose_map):
    """Score every (angle, x, y) candidate.

    Returns (scores (A,Nx,Ny), angles (A,), xs (Nx,), ys (Ny,)) where xs/ys
    are candidate sensor positions in map cells and scores are mean map
    probability over sampled beam endpoints (GetResponse,
    correlate_scan_matcher.h:637-662).
    """
    A, N = params.n_angles, params.n_space
    inv_res = spec.inv_res

    # search angles (correlate_scan_matcher.h:159-164)
    base_angle = center_pose_map[2]
    start_angle = base_angle - params.search_angle_offset
    angles = start_angle + jnp.arange(A, dtype=jnp.float32) * params.search_angle_resolution

    # subsample points (front-packed valid points)
    sidx, svalid, divisor = _sample_indices(n_valid, params.use_point_size, params.max_samples)
    pts = points[sidx] * inv_res                    # (S,2) map units, local frame
    c, s = jnp.cos(angles), jnp.sin(angles)
    # rotate: (A,S,2) — the angle lookup table, one shot
    rx = c[:, None] * pts[None, :, 0] - s[:, None] * pts[None, :, 1]
    ry = s[:, None] * pts[None, :, 0] + c[:, None] * pts[None, :, 1]

    # candidate offsets in map cells (correlate_scan_matcher.h:546-548)
    space_step = params.search_space_resolution * inv_res
    start_x = center_pose_map[0] - (params.search_space_size * inv_res) * 0.5
    start_y = center_pose_map[1] - (params.search_space_size * inv_res) * 0.5
    xs = start_x + jnp.arange(N, dtype=jnp.float32) * space_step
    ys = start_y + jnp.arange(N, dtype=jnp.float32) * space_step

    # integer cells: truncation of (coord + candidate + 0.5) (:647-648)
    gx = jnp.floor(rx[:, :, None] + xs[None, None, :] + 0.5).astype(jnp.int32)  # (A,S,Nx)
    gy = jnp.floor(ry[:, :, None] + ys[None, None, :] + 0.5).astype(jnp.int32)  # (A,S,Ny)

    okx = (gx >= 0) & (gx < spec.width)
    oky = (gy >= 0) & (gy < spec.height)
    flat = gy[:, :, None, :] * spec.width + gx[:, :, :, None]                   # (A,S,Nx,Ny)
    ok = okx[:, :, :, None] & oky[:, :, None, :] & svalid[None, :, None, None]
    flat = jnp.where(ok, flat, -1)

    vals = jnp.take(probs.reshape(-1), flat, mode="fill",
                    fill_value=float(spec.default_prob))
    vals = jnp.where(ok, vals, jnp.where(svalid[None, :, None, None],
                                         spec.default_prob, 0.0))
    scores = jnp.sum(vals, axis=1) / divisor                                     # (A,Nx,Ny)
    return scores, angles, xs, ys


def penalize_scores(params: CorrelativeParams, spec: ProbMapSpec,
                    scores, angles, xs, ys, center_pose_map):
    """Center-distance/angle penalty (PenalizeResponse,
    correlate_scan_matcher.h:718-745). Zero scores are left unpenalized."""
    if not params.use_center_penalty:
        return scores
    dist_gain = (K_DISTANCE_PENALTY_GAIN_COARSE if params.tier == COARSE
                 else K_DISTANCE_PENALTY_GAIN_FINE)
    res = spec.resolution
    dx = (xs - center_pose_map[0]) * res
    dy = (ys - center_pose_map[1]) * res
    dist_sq = dx[:, None] ** 2 + dy[None, :] ** 2                   # (Nx,Ny) m^2
    dist_pen = jnp.maximum(
        1.0 - dist_gain * dist_sq / (params.search_space_size / 2.0), 0.5
    )
    dth = (angles - center_pose_map[2]) ** 2
    ang_pen = jnp.maximum(1.0 - K_ANGULAR_PENALTY_GAIN * dth / 0.349, 0.9)
    pen = ang_pen[:, None, None] * dist_pen[None, :, :]
    return jnp.where(jnp.abs(scores) > K_DOUBLE_TOLERANCE, scores * pen, scores)


def find_best_candidate(scores, angles, xs, ys):
    """Score-weighted average of near-tied top candidates (FindBestCandidate,
    correlate_scan_matcher.h:670-710). Equivalent mask form of the
    sorted-break loop: all candidates with score >= best - tol participate."""
    best = jnp.max(scores)
    m = (scores >= best - K_RESPONSE_FILTER_TOLERANCE).astype(scores.dtype)
    w = m * scores
    wsum = jnp.maximum(jnp.sum(w), K_DOUBLE_TOLERANCE)
    x = jnp.sum(w * xs[None, :, None]) / wsum
    y = jnp.sum(w * ys[None, None, :]) / wsum
    tc = jnp.sum(w * jnp.cos(angles)[:, None, None]) / wsum
    ts = jnp.sum(w * jnp.sin(angles)[:, None, None]) / wsum
    theta = jnp.arctan2(ts, tc)
    return jnp.stack([x, y, theta]), best


def _top_candidates(scores, angles, xs, ys, select_mask, k: int):
    """Top-k candidates by score among those passing ``select_mask`` —
    the vectorized form of the reference's sorted-scan-first-20 loops."""
    A, Nx, Ny = scores.shape
    flat_scores = jnp.where(select_mask, scores, -jnp.inf).reshape(-1)
    top_s, top_i = lax.top_k(flat_scores, k)
    ai = top_i // (Nx * Ny)
    xi = (top_i // Ny) % Nx
    yi = top_i % Ny
    valid = jnp.isfinite(top_s)
    return top_s, angles[ai], xs[xi], ys[yi], valid


def positional_covariance(params: CorrelativeParams, spec: ProbMapSpec,
                          scores, angles, xs, ys, best_pose_map, best_score,
                          cov_in):
    """ComputePositionalCovariance (correlate_scan_matcher.h:887-956)."""
    max_ang_var = 4.0 * params.search_angle_resolution ** 2
    res = spec.resolution

    cov = jnp.eye(3, dtype=scores.dtype)

    # degenerate: best score ~ 0
    degen = best_score < K_DOUBLE_TOLERANCE

    score_bound = jnp.minimum(best_score - 0.1, 0.5)
    top_s, _, top_x, top_y, _ = _top_candidates(
        scores, angles, xs, ys, scores > score_bound, K_MAX_VARIANCE_USE_POINT_SIZE
    )
    w = jnp.where(jnp.isfinite(top_s), top_s, 0.0)
    norm = jnp.sum(w)
    dx = jnp.where(jnp.isfinite(top_s), top_x - best_pose_map[0], 0.0)
    dy = jnp.where(jnp.isfinite(top_s), top_y - best_pose_map[1], 0.0)
    acc_xx = jnp.sum(dx * dx * w)
    acc_xy = jnp.sum(dx * dy * w)
    acc_yy = jnp.sum(dy * dy * w)

    min_var = 0.1 * (params.search_space_resolution / res) ** 2
    var_xx = jnp.maximum(acc_xx / jnp.maximum(norm, K_DOUBLE_TOLERANCE), min_var)
    var_xy = acc_xy / jnp.maximum(norm, K_DOUBLE_TOLERANCE)
    var_yy = jnp.maximum(acc_yy / jnp.maximum(norm, K_DOUBLE_TOLERANCE), min_var)

    bs = jnp.maximum(best_score, K_DOUBLE_TOLERANCE)
    has_norm = norm > K_DOUBLE_TOLERANCE
    r2 = res * res
    cov = cov.at[0, 0].set(jnp.where(has_norm, var_xx * r2 / bs, 1.0))
    cov = cov.at[0, 1].set(jnp.where(has_norm, var_xy * r2 / bs, 0.0))
    cov = cov.at[1, 0].set(jnp.where(has_norm, var_xy * r2 / bs, 0.0))
    cov = cov.at[1, 1].set(jnp.where(has_norm, var_yy * r2 / bs, 1.0))
    cov = cov.at[2, 2].set(jnp.where(has_norm, max_ang_var, 1.0))

    # zero-variance fallback (:948-955)
    cov = cov.at[0, 0].set(jnp.where(jnp.abs(cov[0, 0]) < K_DOUBLE_TOLERANCE,
                                     K_MAX_VARIANCE, cov[0, 0]))
    cov = cov.at[1, 1].set(jnp.where(jnp.abs(cov[1, 1]) < K_DOUBLE_TOLERANCE,
                                     K_MAX_VARIANCE, cov[1, 1]))

    degen_cov = (jnp.eye(3, dtype=scores.dtype)
                 .at[0, 0].set(K_MAX_VARIANCE)
                 .at[1, 1].set(K_MAX_VARIANCE)
                 .at[2, 2].set(max_ang_var))
    return jnp.where(degen, degen_cov, cov)


def angular_covariance(params: CorrelativeParams, spec: ProbMapSpec,
                       scores, angles, xs, ys, best_pose_map, best_score,
                       cov_in):
    """ComputeAngularCovariance (correlate_scan_matcher.h:965-1019) — writes
    only cov[2,2] of the incoming covariance."""
    max_ang_var = 4.0 * params.search_angle_resolution ** 2
    # candidates within one search step of the best pose, in cells. The
    # neighbours of a best pose on the candidate grid sit exactly one step
    # away, where float32 map coordinates (~1e-4 cells apart at a few
    # thousand cells) would let rounding decide; the hundredth of a cell
    # keeps them in, as exact arithmetic would
    linear_tol = params.search_space_resolution / spec.resolution + 0.01

    score_bound = jnp.minimum(best_score - 0.1, 0.5)
    xm = jnp.abs(xs - best_pose_map[0]) <= linear_tol
    ym = jnp.abs(ys - best_pose_map[1]) <= linear_tol
    select = (scores >= score_bound) & xm[None, :, None] & ym[None, None, :]
    top_s, top_a, _, _, _ = _top_candidates(
        scores, angles, xs, ys, select, K_MAX_VARIANCE_USE_POINT_SIZE
    )
    w = jnp.where(jnp.isfinite(top_s), top_s, 0.0)
    norm = jnp.sum(w)
    da = jnp.where(jnp.isfinite(top_s), top_a - best_pose_map[2], 0.0)
    acc = jnp.sum(da * da * w)

    var_aa = jnp.where(norm > K_DOUBLE_TOLERANCE,
                       acc / jnp.maximum(norm, K_DOUBLE_TOLERANCE),
                       200.0 * max_ang_var)
    var_aa = jnp.where(best_score < K_DOUBLE_TOLERANCE, max_ang_var, var_aa)
    return cov_in.at[2, 2].set(var_aa)


def correlative_scan_match(spec: ProbMapSpec, params: CorrelativeParams,
                           probs, offset, points, mask, n_valid,
                           pose_world, cov_in) -> MatchResult:
    """One full tier match (BasedCorrelationScanMatch::ScanMatch,
    correlate_scan_matcher.h:784-875): score grid → penalty → tie-averaged
    best pose → tier-specific covariance → threshold-gated pose update."""
    center = world_to_map_pose(offset, spec.inv_res, pose_world)
    scores, angles, xs, ys = score_candidates(
        spec, params, probs, offset, points, mask, n_valid, center)
    scores = penalize_scores(params, spec, scores, angles, xs, ys, center)
    best_pose_map, best_score = find_best_candidate(scores, angles, xs, ys)

    if params.tier == COARSE:
        cov = positional_covariance(params, spec, scores, angles, xs, ys,
                                    best_pose_map, best_score, cov_in)
        cov = angular_covariance(params, spec, scores, angles, xs, ys,
                                 best_pose_map, best_score, cov)
    elif params.tier == FINE:
        cov = positional_covariance(params, spec, scores, angles, xs, ys,
                                    best_pose_map, best_score, cov_in)
    else:  # SUPER
        cov = angular_covariance(params, spec, scores, angles, xs, ys,
                                 best_pose_map, best_score, cov_in)

    # empty-scan guard (correlate_scan_matcher.h:792-795): response 0, keep pose
    response = jnp.where(n_valid > 0, jnp.minimum(best_score, 1.0), 0.0)
    accept = response > params.response_threshold
    new_world = map_to_world_pose(offset, spec.inv_res, best_pose_map)
    pose_out = jnp.where(accept, new_world, pose_world)
    return MatchResult(pose=pose_out, response=response, cov=cov,
                       best_map_pose=best_pose_map)
