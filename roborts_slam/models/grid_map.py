"""Occupancy grid map state.

Replacement for the reference's ``GridMapBase`` /
``OccuGridMap<Cell, Fn>`` hierarchy (src/map/grid_map_base.h,
src/map/occu_grid_map.h, src/map/grid_map_cell.h). Design changes:

- Maps are immutable fixed-shape arrays inside pytrees; updates are pure
  functions (ops/raster.py). No dynamic auto-resize (grid_map_base.h:188-274):
  the world extent is preallocated from the scene/laser range, and shapes are
  rounded up to multiples of 128 cells (the extents the golden trajectories
  in tests/data were recorded with).
- Cell "classes" become channels + update rules:
  * ``ProbMap``  ≈ ProbabilityCell map (ScanMatchMap, slam_map.h:34) — a
    single f32 prob plane; scan-match maps are maintained with
    ``just_update_occu`` max-merge blur stamping only (slam_processor.cpp:495,
    510 set just_update_occu=true), which makes updates order-independent and
    rebuilds batchable.
  * ``CountMap`` ≈ CountCell map (PubMap, slam_map.h:35) — hit/pass planes.
- The world↔map affine (grid_map_base.h:68-93) keeps the reference convention:
  ``map_xy = (world_xy + offset) / resolution``. ``offset`` is a traced array
  so back-end maps can be recentered per chain (slam_processor.cpp:448-462)
  without recompilation.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from ..config import gaussian_kernel_half_size

TILE = 128  # pad map dims to lane multiples


def _round_up(x: int, m: int = TILE) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ProbMapSpec:
    """Static geometry + update rules of a probability (scan-match) map."""

    resolution: float
    height: int
    width: int
    deviation: float              # gaussian blur sigma (m)
    blur_offset: float            # cell_occu_prob_offset (gaussian_blur_offset)
    default_prob: float = 0.3     # kMapUnknownCellProb (slam_processor.h:264)

    @property
    def inv_res(self) -> float:
        return 1.0 / self.resolution

    @property
    def kernel_half(self) -> int:
        return gaussian_kernel_half_size(self.deviation, self.resolution)

    def blur_kernel(self) -> np.ndarray:
        """Stamp kernel. Center value is 1.0 (SetCellOccuBlur sets the center
        cell prob to 1.0 when just_update_occu, occu_grid_map.h:544);
        neighbors get ``exp(-0.5 (d/sigma)^2) * blur_offset`` max-merged
        (occu_grid_map.h:560-573, kernel values occu_grid_map.h:88-94)."""
        h = self.kernel_half
        k = np.zeros((2 * h + 1, 2 * h + 1), dtype=np.float32)
        for j in range(-h, h + 1):
            for i in range(-h, h + 1):
                d = np.hypot(i * self.resolution, j * self.resolution)
                k[j + h, i + h] = np.exp(-0.5 * (d / max(self.deviation, 1e-9)) ** 2)
        k = k * self.blur_offset
        k[h, h] = 1.0
        return k


@dataclasses.dataclass(frozen=True)
class CountMapSpec:
    """Static geometry of a hit/pass count (publish) map."""

    resolution: float
    height: int
    width: int
    max_ray_cells: int            # static bound on cells per carved ray
    default_prob: float = 0.5     # kDefaultCellProb (grid_map_cell.h:30)

    @property
    def inv_res(self) -> float:
        return 1.0 / self.resolution


class ProbMap(NamedTuple):
    probs: jnp.ndarray      # (H, W) f32, indexed [y, x]
    offset: jnp.ndarray     # (2,) f32 world offset (m)


class CountMap(NamedTuple):
    hits: jnp.ndarray       # (H, W) f32
    passes: jnp.ndarray     # (H, W) f32
    offset: jnp.ndarray     # (2,) f32


def make_prob_map(spec: ProbMapSpec, offset) -> ProbMap:
    return ProbMap(
        probs=jnp.full((spec.height, spec.width), spec.default_prob, jnp.float32),
        offset=jnp.asarray(offset, jnp.float32),
    )


def make_count_map(spec: CountMapSpec, offset) -> CountMap:
    return CountMap(
        hits=jnp.zeros((spec.height, spec.width), jnp.float32),
        passes=jnp.zeros((spec.height, spec.width), jnp.float32),
        offset=jnp.asarray(offset, jnp.float32),
    )


def world_to_map(offset, inv_res: float, xy):
    """world (m) -> map (cells, float). grid_map_base.h:78-81."""
    return (xy + offset) * inv_res


def map_to_world(offset, inv_res: float, xy):
    return xy / inv_res - offset


def world_to_map_pose(offset, inv_res: float, pose):
    """Pose variant keeping theta unchanged (grid_map_base.h:89-93)."""
    xy = (pose[..., :2] + offset) * inv_res
    return jnp.concatenate([xy, pose[..., 2:3]], axis=-1)


def map_to_world_pose(offset, inv_res: float, pose):
    xy = pose[..., :2] / inv_res - offset
    return jnp.concatenate([xy, pose[..., 2:3]], axis=-1)


class LogOddsMap(NamedTuple):
    """Log-odds occupancy plane (LogOddsCell, grid_map_cell.h:166-296 —
    defined by the reference but unused by its map aliases; provided here
    for parity and as the standard alternative pub-map cell model)."""

    log_odds: jnp.ndarray   # (H, W) f32
    offset: jnp.ndarray     # (2,) f32


def make_log_odds_map(spec: CountMapSpec, offset) -> LogOddsMap:
    return LogOddsMap(
        log_odds=jnp.zeros((spec.height, spec.width), jnp.float32),
        offset=jnp.asarray(offset, jnp.float32),
    )


def prob_to_log_odds(p):
    """ProbToLogOdds (grid_map_cell.h:286-292)."""
    return jnp.log(p / (1.0 - p))


def log_odds_to_prob(lo):
    """GetGridProbability (grid_map_cell.h:84-89): odds/(1+odds)."""
    odds = jnp.exp(lo)
    return odds / (1.0 + odds)


def log_odds_map_states(lmap: LogOddsMap, occu_threshold: float = 0.5):
    """GridStates (grid_map_cell.h:100-108): -1 unknown (untouched),
    0 free, 100 occupied."""
    p = log_odds_to_prob(lmap.log_odds)
    unknown = lmap.log_odds == 0.0
    return jnp.where(unknown, -1,
                     jnp.where(p >= occu_threshold, 100, 0)).astype(jnp.int32)


def count_map_probs(cmap: CountMap, default_prob: float = 0.5):
    """Derived cell probability hit/pass (grid_map_cell.h:94-111)."""
    return jnp.where(cmap.passes > 0, cmap.hits / jnp.maximum(cmap.passes, 1e-9), default_prob)


def count_map_states(cmap: CountMap, min_passthrough: float, occu_threshold: float):
    """GridStates for the pub map (grid_map_cell.h:125-136):
    -1 unknown, 0 free, 100 occupied."""
    probs = count_map_probs(cmap)
    known = cmap.passes >= min_passthrough
    occ = probs >= occu_threshold
    return jnp.where(known, jnp.where(occ, 100, 0), -1).astype(jnp.int32)


def pub_map_spec(config, laser_range_max: float, world_size: float) -> CountMapSpec:
    n = _round_up(int(np.ceil(world_size / config.map_resolution)))
    # rays are at most range_threshold long; Chebyshev cell count bound
    max_cells = int(np.ceil(laser_range_max / config.map_resolution)) + 4
    return CountMapSpec(
        resolution=config.map_resolution, height=n, width=n,
        max_ray_cells=max_cells,
    )


def shift_prob_map(spec: ProbMapSpec, pmap: ProbMap,
                   shift_cells: tuple[int, int]) -> ProbMap:
    """Recenter: move the map window by (sy, sx) cells. Content shifts so
    probs_new[y, x] = probs_old[y + sy, x + sx]; exposed cells take the
    default prob; the world↔map offset moves with the window. Host-side
    numpy (recentering is a rare, host-decided event — traced dynamic
    slices are pathologically slow on some backends)."""
    sy, sx = shift_cells
    old = np.asarray(pmap.probs)
    new = np.full_like(old, spec.default_prob)
    H, W = old.shape
    ys = slice(max(sy, 0), min(H + sy, H))
    xs = slice(max(sx, 0), min(W + sx, W))
    yd = slice(max(-sy, 0), max(-sy, 0) + (ys.stop - ys.start))
    xd = slice(max(-sx, 0), max(-sx, 0) + (xs.stop - xs.start))
    if ys.stop > ys.start and xs.stop > xs.start:
        new[yd, xd] = old[ys, xs]
    off = np.asarray(pmap.offset) - np.array([sx, sy]) * spec.resolution
    return ProbMap(probs=jnp.asarray(new),
                   offset=jnp.asarray(off, jnp.float32))


def scan_match_map_specs(config, world_size: float):
    """Front-end coarse + fine scan-match map specs (CreateAllMap,
    slam_processor.cpp:482-510). With ``match_map_window > 0`` the specs
    cover only the rolling window (the engine recenters them; pub map keeps
    the world extent)."""
    if config.match_map_window > 0:
        world_size = min(world_size, config.match_map_window)
    nc = _round_up(int(np.ceil(world_size / config.coarse_map_resolution)))
    nf = _round_up(int(np.ceil(world_size / config.fine_map_resolution)))
    coarse = ProbMapSpec(
        resolution=config.coarse_map_resolution,
        height=nc, width=nc,
        deviation=config.coarse_map_deviation,
        blur_offset=config.gaussian_blur_offset,
    )
    fine = ProbMapSpec(
        resolution=config.fine_map_resolution,
        height=nf, width=nf,
        deviation=config.fine_map_deviation,
        blur_offset=config.gaussian_blur_offset,
    )
    return coarse, fine


def backend_map_specs(config, laser_range_max: float):
    """Back-end chain-match map specs; sized ``(range_max + 2m) * 2`` per
    CreateScanMatchMapWithRangeVec (slam_processor.cpp:433-439,
    kMinScanMatchMapBound=2.0 slam_processor.h:263)."""
    size = (laser_range_max + 2.0) * 2.0
    nc = _round_up(int(np.ceil(size / config.coarse_map_resolution)))
    nf = _round_up(int(np.ceil(size / config.fine_map_resolution)))
    coarse = ProbMapSpec(
        resolution=config.coarse_map_resolution,
        height=nc, width=nc,
        deviation=config.coarse_map_deviation,
        blur_offset=config.gaussian_blur_offset,
    )
    fine = ProbMapSpec(
        resolution=config.fine_map_resolution,
        height=nf, width=nf,
        deviation=config.fine_map_deviation,
        blur_offset=config.gaussian_blur_offset,
    )
    return coarse, fine
