"""Serial NumPy references of the device hot paths.

Plain loop re-implementations, written from the algorithm spec, that the
batched device ops are checked against (tests and chip_smoke.py):

- ``score_candidates_serial``: the reference's serial candidate scoring
  (``MultiResolutionCorrelateScanMatcher::ScanMatch``,
  correlate_scan_matcher.h:505-614), in float32 like the engine;
- ``penalize_serial`` / ``find_best_serial``: its penalty and tie average;
- ``mark_image_serial``: the per-scan pub-map mark image, beam by beam
  (a DDA walk instead of the reference's Bresenham, occu_grid_map.h:125-188);
- ``penalty_rays_serial`` / ``bad_rays_serial``: the map-consistency
  check's sampled rays and bad-ray count (occu_grid_map.h:331-392,
  447-471);
- ``optimize_scan_match_serial``: the Gauss-Newton matcher, in float64;
- ``solve_pose_graph_serial``: SPA as dense float64 Levenberg-Marquardt.
"""

from __future__ import annotations

import math

import numpy as np


def score_candidates_serial(probs: np.ndarray, default_prob: float,
                            inv_res: float,
                            points: np.ndarray, n_valid: int,
                            center_pose_map: np.ndarray,
                            search_space_size: float,
                            search_space_resolution: float,
                            search_angle_offset: float,
                            search_angle_resolution: float,
                            use_point_size: int):
    """Triple-loop candidate scoring; returns (scores[A,Nx,Ny], angles, xs, ys).

    Coordinates are float32, as on the device, and cells are floored
    (``floor(coord + 0.5)``; for in-map cells the same as the reference's
    truncation). Sums run in float64."""
    f32 = np.float32
    H, W = probs.shape
    n_angles = int(math.floor(search_angle_offset * 2 / search_angle_resolution) + 1)
    n_space = int(round(search_space_size / search_space_resolution) + 1)

    center_pose_map = np.asarray(center_pose_map, f32)
    start_angle = center_pose_map[2] - f32(search_angle_offset)

    P = n_valid
    use = use_point_size
    if P < 2 * use:
        use = P
        step = 1
    else:
        step = P // (use - 1)

    half = f32(search_space_size * inv_res) * f32(0.5)
    start_x = center_pose_map[0] - half
    start_y = center_pose_map[1] - half
    space_step = f32(search_space_resolution * inv_res)

    angles = np.zeros(n_angles, f32)
    xs = start_x + np.arange(n_space, dtype=f32) * space_step
    ys = start_y + np.arange(n_space, dtype=f32) * space_step
    scores = np.zeros((n_angles, n_space, n_space))

    sample = np.arange(0, P, step)
    px = points[sample, 0].astype(f32) * f32(inv_res)
    py = points[sample, 1].astype(f32) * f32(inv_res)
    for ai in range(n_angles):
        angle = start_angle + f32(ai) * f32(search_angle_resolution)
        angles[ai] = angle
        c, s = np.cos(angle), np.sin(angle)
        rx = c * px - s * py
        ry = s * px + c * py
        for xi in range(n_space):
            gx = np.floor(rx + xs[xi] + f32(0.5)).astype(np.int64)
            for yi in range(n_space):
                gy = np.floor(ry + ys[yi] + f32(0.5)).astype(np.int64)
                total = 0.0
                for x, y in zip(gx, gy):
                    if 0 <= x < W and 0 <= y < H:
                        total += float(probs[y, x])
                    else:
                        total += default_prob
                scores[ai, xi, yi] = total / use
    return scores, angles, xs, ys


def penalize_serial(scores, angles, xs, ys, center_pose_map, map_resolution,
                    search_space_size, distance_gain, angle_gain=0.25):
    """PenalizeResponse (correlate_scan_matcher.h:718-745)."""
    out = scores.copy()
    for ai in range(scores.shape[0]):
        dth2 = (angles[ai] - center_pose_map[2]) ** 2
        apen = max(1.0 - angle_gain * dth2 / 0.349, 0.9)
        for xi in range(scores.shape[1]):
            for yi in range(scores.shape[2]):
                if abs(scores[ai, xi, yi]) <= 1e-6:
                    continue
                d2 = ((xs[xi] - center_pose_map[0]) ** 2
                      + (ys[yi] - center_pose_map[1]) ** 2)
                d2 *= map_resolution ** 2
                dpen = max(1.0 - distance_gain * d2 / (search_space_size / 2), 0.5)
                out[ai, xi, yi] *= dpen * apen
    return out


def find_best_serial(scores, angles, xs, ys, tol=1e-2):
    """FindBestCandidate tie averaging (correlate_scan_matcher.h:670-710)."""
    order = np.argsort(scores.reshape(-1))[::-1]
    A, Nx, Ny = scores.shape
    flat = scores.reshape(-1)
    best = flat[order[0]]
    pos = np.zeros(2)
    tx = ty = wsum = 0.0
    count = 0
    for idx in order:
        sc = flat[idx]
        if sc - best < -abs(tol):
            break
        ai, xi, yi = idx // (Nx * Ny), (idx // Ny) % Nx, idx % Ny
        pos += np.array([xs[xi], ys[yi]]) * sc
        tx += math.cos(angles[ai]) * sc
        ty += math.sin(angles[ai]) * sc
        wsum += sc
        count += 1
    first = order[0]
    ai, xi, yi = first // (Nx * Ny), (first // Ny) % Nx, first % Ny
    if count > 1 and wsum > 0:
        return np.array([pos[0] / wsum, pos[1] / wsum,
                         math.atan2(ty / wsum, tx / wsum)]), best
    return np.array([xs[xi], ys[yi], angles[ai]]), best


def _ray_cells_serial(start, end):
    """Cells of one ray by an integer DDA: n = Chebyshev length, cell t =
    round-half-up(start + (end - start) * t / n) for t = 0..n (exact
    integer arithmetic)."""
    dx, dy = end[0] - start[0], end[1] - start[1]
    n = max(abs(dx), abs(dy), 1)
    return [((2 * n * start[0] + 2 * dx * t + n) // (2 * n),
             (2 * n * start[1] + 2 * dy * t + n) // (2 * n))
            for t in range(n + 1)]


def _map_cells(offset, inv_res, pose_world, points):
    """Sensor cell and beam-endpoint cells, float32 like the device."""
    f32 = np.float32
    inv = f32(inv_res)
    pose = np.asarray(pose_world, f32)
    off = np.asarray(offset, f32)
    px, py = (pose[0] + off[0]) * inv, (pose[1] + off[1]) * inv
    c, s = np.cos(pose[2]), np.sin(pose[2])
    lx = np.asarray(points, f32)[:, 0] * inv
    ly = np.asarray(points, f32)[:, 1] * inv
    ex = np.floor(c * lx - s * ly + px + f32(0.5)).astype(np.int64)
    ey = np.floor(s * lx + c * ly + py + f32(0.5)).astype(np.int64)
    start = (int(np.floor(px + f32(0.5))), int(np.floor(py + f32(0.5))))
    return start, list(zip(ex.tolist(), ey.tolist()))


def mark_image_serial(height: int, width: int, inv_res: float, offset,
                      pose_world, points, mask) -> np.ndarray:
    """Per-scan mark image, beam by beam: 1 on the cells a ray passes
    (endpoint excluded), 2 on the endpoint cell; occupied wins over free,
    cells outside the map are dropped, and a beam ending in the sensor's
    own cell marks nothing."""
    img = np.zeros((height, width), np.int32)
    start, ends = _map_cells(offset, inv_res, pose_world, points)
    for end, ok in zip(ends, np.asarray(mask)):
        if not ok or end == start:
            continue
        cells = _ray_cells_serial(start, end)
        for k, (x, y) in enumerate(cells):
            if 0 <= x < width and 0 <= y < height:
                img[y, x] = max(img[y, x], 2 if k == len(cells) - 1 else 1)
    return img


def penalty_rays_serial(height: int, width: int, inv_res: float, offset,
                        pose_world, points, mask, n_valid: int,
                        check_point_num: int):
    """The rays the consistency check walks (occu_grid_map.h:362-369):
    every ``step``-th of the ``n_valid`` front-packed beams, where ``step``
    is ``n_valid // (check_point_num - 1)`` once there are at least twice
    ``check_point_num`` beams and 1 below that. Returns the sensor cell,
    the endpoint cells and which rays count: a sampled, valid beam that
    ends strictly inside the map and outside the sensor's cell."""
    use = check_point_num
    step = 1 if n_valid < 2 * use else n_valid // (use - 1)
    sidx = np.arange(2 * use) * step
    take = np.clip(sidx, 0, len(points) - 1)
    start, ends = _map_cells(offset, inv_res, pose_world,
                             np.asarray(points)[take])
    ends = np.asarray(ends)
    ok = ((sidx < n_valid) & np.asarray(mask)[take]
          & ~((ends[:, 0] == start[0]) & (ends[:, 1] == start[1]))
          & (ends[:, 0] > 0) & (ends[:, 0] < width)
          & (ends[:, 1] > 0) & (ends[:, 1] < height))
    return start, ends, ok


def bad_rays_serial(hits: np.ndarray, passes: np.ndarray, start, ends,
                    ray_ok, min_passthrough: float, occu_threshold: float,
                    bound_tolerance: float) -> int:
    """Rays that cross an Occupied cell (pass count >= min_passthrough and
    hit/pass >= occu_threshold; cells off the map clamp to its edge) more
    than ``bound_tolerance`` cells from their endpoint."""
    H, W = passes.shape
    bad = 0
    for end, ok in zip(ends, ray_ok):
        if not ok:
            continue
        for x, y in _ray_cells_serial(tuple(start), tuple(end)):
            cx, cy = min(max(x, 0), W - 1), min(max(y, 0), H - 1)
            p = passes[cy, cx]
            prob = hits[cy, cx] / p if p > 0 else 0.5
            far = math.hypot(x - end[0], y - end[1]) > bound_tolerance
            if p >= min_passthrough and prob >= occu_threshold and far:
                bad += 1
                break
    return bad


def optimize_scan_match_serial(probs: np.ndarray, inv_res: float, offset,
                               points, mask, pose_world,
                               iterate_max_times: int,
                               cost_decrease_threshold: float,
                               cost_min_threshold: float,
                               max_update_distance: float,
                               max_update_angle: float):
    """The Gauss-Newton optimize matcher (optimize_scan_matcher.h:86-221) in
    float64: bilinear map response, analytic Jacobian, a 3x3 solve per
    iteration, clamped steps and the cost-plateau stop. Returns the world
    pose and the normalized cost."""
    H, W = probs.shape
    p = np.asarray(probs, np.float64)
    off = np.asarray(offset, np.float64)
    pose = np.array([(pose_world[0] + off[0]) * inv_res,
                     (pose_world[1] + off[1]) * inv_res, pose_world[2]],
                    np.float64)
    pts = np.asarray(points, np.float64)[np.asarray(mask)] * inv_res

    def at(x, y):
        return p[np.clip(y.astype(np.int64), 0, H - 1),
                 np.clip(x.astype(np.int64), 0, W - 1)]

    def cost_h_b(pose):
        c, s = math.cos(pose[2]), math.sin(pose[2])
        mx = c * pts[:, 0] - s * pts[:, 1] + pose[0]
        my = s * pts[:, 0] + c * pts[:, 1] + pose[1]
        inside = (mx > 0) & (mx < W) & (my > 0) & (my < H)
        x0, y0 = np.floor(mx), np.floor(my)
        x1, y1 = x0 + 1.0, y0 + 1.0
        p00, p01, p10, p11 = at(x0, y0), at(x0, y1), at(x1, y0), at(x1, y1)
        resp = ((my - y0) * (p11 * (mx - x0) + p01 * (x1 - mx))
                + (y1 - my) * (p10 * (mx - x0) + p00 * (x1 - mx)))
        err = np.where(inside, 1.0 - np.clip(resp, 0.0, 1.0), 0.0)
        dmx = (my - y0) * (p11 - p01) + (y1 - my) * (p10 - p00)
        dmy = (mx - x0) * (p11 - p10) + (x1 - mx) * (p01 - p00)
        dth = (dmx * (-s * pts[:, 0] - c * pts[:, 1])
               + dmy * (c * pts[:, 0] - s * pts[:, 1]))
        J = np.where(inside[:, None], -np.stack([dmx, dmy, dth], -1), 0.0)
        cost = float(err @ err) * 1000.0 / (1 + int(inside.sum()))
        return cost, J.T @ J, -(J.T @ err)

    max_d = max_update_distance * inv_res
    limit = np.array([max_d, max_d, max_update_angle])
    cost = 0.0
    for it in range(iterate_max_times):
        last = cost
        cost, Hm, b = cost_h_b(pose)
        if not pts.size:
            break
        step = np.linalg.solve(Hm + 1e-9 * np.eye(3), b)
        if np.isnan(step).any():
            cost = 1000.0
            break
        if it > 0 and (last - cost < cost_decrease_threshold
                       or cost < cost_min_threshold):
            break
        pose = pose + np.clip(step, -limit, limit)
    if not pts.size:
        cost = 1000.0
    theta = math.atan2(math.sin(pose[2]), math.cos(pose[2]))
    return np.array([pose[0] / inv_res - off[0], pose[1] / inv_res - off[1],
                     theta]), cost


def _spa_residuals(poses, eij, erel):
    pa, pb = poses[eij[:, 0]], poses[eij[:, 1]]
    c, s = np.cos(pa[:, 2]), np.sin(pa[:, 2])
    dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
    dt = pb[:, 2] - pa[:, 2] - erel[:, 2]
    return np.stack([c * dx + s * dy - erel[:, 0],
                     -s * dx + c * dy - erel[:, 1],
                     np.arctan2(np.sin(dt), np.cos(dt))], -1)


def spa_cost_serial(poses, edge_ij, edge_rel, edge_info) -> float:
    """0.5 Σ rᵀ I r over all edges, in float64."""
    r = _spa_residuals(np.asarray(poses, np.float64),
                       np.asarray(edge_ij), np.asarray(edge_rel, np.float64))
    return 0.5 * float(np.einsum("ei,eij,ej->", r,
                                 np.asarray(edge_info, np.float64), r))


def solve_pose_graph_serial(poses, edge_ij, edge_rel, edge_info,
                            max_iters: int = 50):
    """Sparse pose adjustment as dense Levenberg-Marquardt in float64:
    the residual R(θa)ᵀ(pb−pa)−p_ab with the normalized angle, weighted by
    the edge information, node 0 held fixed (ceres_types.h:87-134,
    ceres_pose_graph_solver.cpp:212-216). Returns (poses, cost)."""
    import scipy.linalg

    x = np.asarray(poses, np.float64).copy()
    eij = np.asarray(edge_ij)
    erel = np.asarray(edge_rel, np.float64)
    info = np.asarray(edge_info, np.float64)
    n = x.shape[0]
    ia, ib = eij[:, 0], eij[:, 1]
    cost = spa_cost_serial(x, eij, erel, info)
    lam = 1e-4
    for _ in range(max_iters):
        r = _spa_residuals(x, eij, erel)
        pa, pb = x[ia], x[ib]
        c, s = np.cos(pa[:, 2]), np.sin(pa[:, 2])
        dx, dy = pb[:, 0] - pa[:, 0], pb[:, 1] - pa[:, 1]
        z, o = np.zeros_like(c), np.ones_like(c)
        ja = np.stack([np.stack([-c, -s, -s * dx + c * dy], -1),
                       np.stack([s, -c, -c * dx - s * dy], -1),
                       np.stack([z, z, -o], -1)], -2)
        jb = np.stack([np.stack([c, s, z], -1), np.stack([-s, c, z], -1),
                       np.stack([z, z, o], -1)], -2)
        Hm = np.zeros((n, 3, n, 3))
        g = np.zeros((n, 3))
        for (i, ji), (j, jj) in (((ia, ja), (ia, ja)), ((ia, ja), (ib, jb)),
                                 ((ib, jb), (ia, ja)), ((ib, jb), (ib, jb))):
            np.add.at(Hm, (i, slice(None), j, slice(None)),
                      np.einsum("eki,ekl,elj->eij", ji, info, jj))
        np.add.at(g, ia, np.einsum("eji,ejk,ek->ei", ja, info, r))
        np.add.at(g, ib, np.einsum("eji,ejk,ek->ei", jb, info, r))
        Hf = Hm.reshape(3 * n, 3 * n)[3:, 3:]          # node 0 fixed
        Hf = Hf + lam * np.eye(3 * n - 3)
        step = scipy.linalg.solve(Hf, -g.reshape(-1)[3:], assume_a="pos")
        new = x.copy()
        new[1:] += step.reshape(-1, 3)
        new[:, 2] = np.arctan2(np.sin(new[:, 2]), np.cos(new[:, 2]))
        new_cost = spa_cost_serial(new, eij, erel, info)
        if new_cost < cost:
            done = cost - new_cost < 1e-12 * (cost + 1e-12)
            x, cost, lam = new, new_cost, max(lam * 0.33, 1e-8)
            if done:
                break
        else:
            lam *= 10.0
    return x, cost
