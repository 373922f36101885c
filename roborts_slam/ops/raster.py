"""Map rasterization ops: blur stamping, ray carving, batch rebuilds.

Replacement for the reference's per-beam serial Bresenham +
per-cell blur stamping (``OccuGridMap::UpdateMapByRange`` occu_grid_map.h:258-329,
``LineVisitor::ErgodLineBresenhami`` occu_grid_map.h:125-188,
``SetCellOccuBlur`` occu_grid_map.h:531-576). Design:

- Scan-match (prob) maps use only endpoint blur stamping (just_update_occu,
  slam_processor.cpp:495,510): the update is a *max-merge* of a Gaussian
  stamp at each beam endpoint. We compute it as: scatter-max endpoints into
  an indicator image, then take a shifted-multiply max ("max-convolution" /
  grayscale dilation) with the static kernel, then max with the map. This is
  exactly equivalent to the reference's per-endpoint SetGridProbability
  max-merge, and — being a commutative max — makes chain-map rebuilds a
  single batched op instead of a serial loop.
- The pub (count) map carves free space along rays. Bresenham becomes a
  fixed-step DDA: each beam emits ``max_ray_cells`` candidate cells (masked),
  scatter-max'ed into a per-scan mark image (free=1, occupied=2), after which
  hit/pass counts update image-wise. The mark image reproduces the
  reference's per-scan idempotence rules (update_index_ marks,
  occu_grid_map.h:499-529): occupied beats free, one update per cell per scan.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..models.grid_map import (
    CountMap, CountMapSpec, ProbMap, ProbMapSpec, world_to_map_pose,
)
from ..utils.geometry import transform_points


def _cell_round(x):
    """float map coords -> int cell, reference convention
    ``static_cast<int>(v + 0.5)`` for positive in-map coords
    (occu_grid_map.h:301-310)."""
    return jnp.floor(x + 0.5).astype(jnp.int32)


def endpoint_image(spec: ProbMapSpec, offset, points, mask, pose_world):
    """Scatter beam endpoints (world-frame scan at ``pose_world``) into a
    binary (H, W) indicator image. Beams whose endpoint cell equals the
    sensor cell are skipped (occu_grid_map.h:312)."""
    pose_map = world_to_map_pose(offset, spec.inv_res, pose_world)
    pts_map = transform_points(pose_map, points * spec.inv_res)
    end = _cell_round(pts_map)                       # (P, 2) int
    start = _cell_round(pose_map[:2])                # (2,)
    same = (end[:, 0] == start[0]) & (end[:, 1] == start[1])
    valid = mask & ~same
    valid &= (end[:, 0] >= 0) & (end[:, 0] < spec.width)
    valid &= (end[:, 1] >= 0) & (end[:, 1] < spec.height)
    flat = jnp.where(valid, end[:, 1] * spec.width + end[:, 0], -1)
    img = jnp.zeros((spec.height * spec.width,), jnp.float32)
    img = img.at[flat].max(jnp.where(valid, 1.0, 0.0), mode="drop")
    return img.reshape(spec.height, spec.width)


def dilate_with_kernel(img, kernel: np.ndarray):
    """Grayscale dilation: out[y,x] = max_{dy,dx} img[y-dy, x-dx] * k[dy,dx].

    Implemented as K*K shifted multiplies (K is small: 5 for the reference's
    sigma/resolution ratios), which XLA fuses into a few elementwise
    passes."""
    h = kernel.shape[0] // 2
    out = jnp.zeros_like(img)
    for dy in range(-h, h + 1):
        for dx in range(-h, h + 1):
            k = float(kernel[dy + h, dx + h])
            if k <= 0.0:
                continue
            shifted = jnp.roll(img, (dy, dx), axis=(0, 1))
            # zero the wrapped-around borders
            if dy > 0:
                shifted = shifted.at[:dy, :].set(0.0)
            elif dy < 0:
                shifted = shifted.at[dy:, :].set(0.0)
            if dx > 0:
                shifted = shifted.at[:, :dx].set(0.0)
            elif dx < 0:
                shifted = shifted.at[:, dx:].set(0.0)
            out = jnp.maximum(out, shifted * k)
    return out


def stamp_scan(spec: ProbMapSpec, pmap: ProbMap, points, mask, pose_world,
               use_blur: bool = True) -> ProbMap:
    """Update a scan-match map with one scan (UpdateMapByRange with
    just_update_occu=true): max-merge the (blurred) endpoint stamp.

    Implemented as a sparse scatter-max of the kernel footprint around every
    endpoint (P x K x K values) directly into the map — equivalent to
    stamping + dilating, but touches only the endpoint neighborhoods instead
    of streaming the full map through a shifted-max pass."""
    pose_map = world_to_map_pose(pmap.offset, spec.inv_res, pose_world)
    pts_map = transform_points(pose_map, points * spec.inv_res)
    end = _cell_round(pts_map)                       # (P, 2)
    start = _cell_round(pose_map[:2])
    same = (end[:, 0] == start[0]) & (end[:, 1] == start[1])
    valid = mask & ~same

    if use_blur and spec.kernel_half > 0:
        kernel = spec.blur_kernel()                  # (K, K), center 1.0
        h = spec.kernel_half
        offs = np.stack(np.meshgrid(np.arange(-h, h + 1),
                                    np.arange(-h, h + 1),
                                    indexing="ij"), -1).reshape(-1, 2)  # (K²,2) [dy,dx]
        kvals = jnp.asarray(kernel.reshape(-1), jnp.float32)            # (K²,)
        cy = end[:, None, 1] + jnp.asarray(offs[:, 0])                  # (P, K²)
        cx = end[:, None, 0] + jnp.asarray(offs[:, 1])
        vals = jnp.broadcast_to(kvals[None, :], cy.shape)
    else:
        cy = end[:, 1:2]
        cx = end[:, 0:1]
        vals = jnp.ones_like(cy, jnp.float32)

    inb = (cx >= 0) & (cx < spec.width) & (cy >= 0) & (cy < spec.height)
    ok = inb & valid[:, None]
    flat = jnp.where(ok, cy * spec.width + cx, -1)
    vals = jnp.where(ok, vals, 0.0)
    probs = pmap.probs.reshape(-1).at[flat.reshape(-1)].max(
        vals.reshape(-1), mode="drop")
    return pmap._replace(probs=probs.reshape(spec.height, spec.width))


def stamp_scan_batch(spec: ProbMapSpec, pmap: ProbMap, points_b, mask_b,
                     poses_b, scan_valid, use_blur: bool = True) -> ProbMap:
    """Rebuild/extend a scan-match map from a batch of scans in one op.

    Because the update is a commutative max-merge, all scans' endpoints are
    scattered into a single indicator image and dilated once — replacing the
    reference's serial InitMapWithRangeVec loop (occu_grid_map.h:222-255)
    with one fused batched kernel. ``scan_valid`` masks padded chain slots.
    """
    inv_res = spec.inv_res
    poses_map = jax.vmap(
        lambda p: world_to_map_pose(pmap.offset, inv_res, p))(poses_b)
    pts_map = jax.vmap(transform_points)(poses_map, points_b * inv_res)  # (K,P,2)
    end = _cell_round(pts_map)
    start = _cell_round(poses_map[:, None, :2])
    same = jnp.all(end == start, axis=-1)
    valid = mask_b & scan_valid[:, None] & ~same
    valid &= (end[..., 0] >= 0) & (end[..., 0] < spec.width)
    valid &= (end[..., 1] >= 0) & (end[..., 1] < spec.height)
    flat = jnp.where(valid, end[..., 1] * spec.width + end[..., 0], -1)
    img = jnp.zeros((spec.height * spec.width,), jnp.float32)
    img = img.at[flat.reshape(-1)].max(
        jnp.where(valid, 1.0, 0.0).reshape(-1), mode="drop")
    img = img.reshape(spec.height, spec.width)
    if use_blur and spec.kernel_half > 0:
        img = dilate_with_kernel(img, spec.blur_kernel())
    return pmap._replace(probs=jnp.maximum(pmap.probs, img))


def rebuild_count_map(spec: CountMapSpec, cmap_offset, points_b, mask_b,
                      poses_b, scan_valid, free_factor, occu_factor,
                      first_scan_extra: int = 0,
                      first_free_factor=None, first_occu_factor=None) -> CountMap:
    """Rebuild the pub map from scratch over a batch of scans.

    Count updates are additive and commute, so the rebuild is a lax.scan of
    per-scan mark images folded into fresh hit/pass planes — the equivalent
    of CorrectPoseAndMap's InitMapWithRangeVec rebuild
    (slam_processor.cpp:350-356), including the quirk of re-applying scan 0
    ``min_passthrough`` extra times (:351-353).
    """
    fresh = CountMap(
        hits=jnp.zeros((spec.height, spec.width), jnp.float32),
        passes=jnp.zeros((spec.height, spec.width), jnp.float32),
        offset=jnp.asarray(cmap_offset, jnp.float32),
    )

    def step(carry, inp):
        pts, m, pose, v = inp
        new = update_count_map(spec, carry, pts, m & v, pose,
                               free_factor, occu_factor)
        return new, None

    out, _ = jax.lax.scan(
        step, fresh,
        (points_b, mask_b, poses_b, jnp.broadcast_to(scan_valid[:, None],
                                                     mask_b.shape)),
    )
    for _ in range(first_scan_extra):
        out = update_count_map(spec, out, points_b[0], mask_b[0], poses_b[0],
                               free_factor, occu_factor)
    return out


def _ray_cells(spec: CountMapSpec, start_cell, end_cells, beam_mask):
    """Cells along each beam via DDA line sampling.

    Returns (P, S) flat cell indices (−1 = invalid) and an (P, S) int mark
    value (1=free along ray, 2=occupied at endpoint). The cell sequence
    approximates Bresenham (occu_grid_map.h:125-188): identical start/end and
    4/8-connected midpoints that differ at most on diagonal tie-break cells.
    """
    S = spec.max_ray_cells
    delta = end_cells - start_cell[None, :]                       # (P,2) int
    nsteps = jnp.maximum(jnp.max(jnp.abs(delta), axis=-1), 1)     # (P,) chebyshev
    t = jnp.arange(S, dtype=jnp.int32)[None, :]                   # (1,S)
    # exact integer DDA: cell(t) = floor(start + delta*t/n + 1/2)
    #                            = (2n*start + 2*delta*t + n) // (2n)
    n2 = (2 * nsteps)[:, None, None]                              # (P,1,1)
    num = (n2 * start_cell[None, None, :]
           + 2 * delta[:, None, :] * t[:, :, None] + nsteps[:, None, None])
    cells = num // n2                                             # (P,S,2)
    on_ray = t < nsteps[:, None]                                  # strictly before endpoint
    is_end = t == nsteps[:, None]
    valid = (on_ray | is_end) & beam_mask[:, None]
    inb = (
        (cells[..., 0] >= 0) & (cells[..., 0] < spec.width)
        & (cells[..., 1] >= 0) & (cells[..., 1] < spec.height)
    )
    valid &= inb
    flat = jnp.where(valid, cells[..., 1] * spec.width + cells[..., 0], -1)
    markv = jnp.where(is_end, 2, 1) * valid.astype(jnp.int32)
    return flat, markv


def scan_mark_image(spec: CountMapSpec, offset, points, mask, pose_world):
    """Per-scan mark image: 0 untouched, 1 free (ray pass-through),
    2 occupied (beam endpoint). Occupied wins over free, matching the
    update_index_ rules (occu_grid_map.h:499-529): one scatter-max of the
    DDA ray cells."""
    inv_res = spec.inv_res
    pose_map = world_to_map_pose(offset, inv_res, pose_world)
    pts_map = transform_points(pose_map, points * inv_res)
    end = _cell_round(pts_map)
    start = _cell_round(pose_map[:2])
    same = (end[:, 0] == start[0]) & (end[:, 1] == start[1])
    beam_mask = mask & ~same
    flat, markv = _ray_cells(spec, start, end, beam_mask)
    img = jnp.zeros((spec.height * spec.width,), jnp.int32)
    img = img.at[flat.reshape(-1)].max(markv.reshape(-1), mode="drop")
    return img.reshape(spec.height, spec.width)


def update_log_odds_map(spec: CountMapSpec, lmap, points, mask, pose_world,
                        free_prob: float = 0.3, occu_prob: float = 0.9):
    """Log-odds pub-map update for one scan (LogOddsCellFunctions,
    grid_map_cell.h:205-235): pass-through cells add log-odds(free_prob),
    endpoint cells add log-odds(occu_prob); per-scan idempotence comes from
    the mark image (occupied wins over free on the same cell)."""
    mark = scan_mark_image(spec, lmap.offset, points, mask, pose_world)
    lo_free = float(np.log(free_prob / (1.0 - free_prob)))
    lo_occu = float(np.log(occu_prob / (1.0 - occu_prob)))
    delta = jnp.where(mark == 2, lo_occu, jnp.where(mark == 1, lo_free, 0.0))
    return lmap._replace(log_odds=lmap.log_odds + delta)


def update_count_map(spec: CountMapSpec, cmap: CountMap, points, mask,
                     pose_world, free_factor, occu_factor) -> CountMap:
    """Pub-map update for one scan (CountCellFunctions, grid_map_cell.h:94-111):
    per touched cell: pass += 1+free_factor; endpoint cells additionally
    hit += 1+occu_factor."""
    mark = scan_mark_image(spec, cmap.offset, points, mask, pose_world)
    touched = (mark > 0).astype(jnp.float32)
    occu = (mark == 2).astype(jnp.float32)
    return cmap._replace(
        hits=cmap.hits + occu * (1.0 + occu_factor),
        passes=cmap.passes + touched * (1.0 + free_factor),
    )
