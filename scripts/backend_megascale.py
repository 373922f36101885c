"""Mega-sequence back-end scaling: flat per-scan cost at >=10k scans.

Demonstrates a >=10k-scan run with
flat per-scan back-end cost. The round-1 back end was O(N^2) over a run
(full barycenter-array rebuilds per scan + serial loop verification);
round 2 made barycenters an O(1)-append incremental cache, vectorized the
distance gates, and batched chain verification into bucketed dispatches.
This script proves the result at mega-sequence scale.

Workload shape: a long trajectory that is locally loopy and globally
extended — T tiles, each a translated copy of the icra arena, the robot
driving ``laps`` loops per tile (scans raycast against the arena map in
tile-local frame, poses offset by the tile origin). That is the stitched
mega-sequence structure (bounded revisits per place, unbounded places):
near-chain counts stay bounded per scan while the store grows without
bound, which is exactly the regime where the round-1 host logic went
quadratic.

The back end is driven directly (store.add -> update_graph ->
try_close_loop per scan, the same call sequence SlamEngine.process_backend
makes) with poses near GT, so every chain match runs on real map content
and link/loop decisions take their real code paths. The front-end matcher
is not in the loop — its per-scan cost is constant by construction
(measured separately, BASELINE_MEASURED.md).

Run: python scripts/backend_megascale.py [--target 10000] [--laps 2]
Prints a per-scan back-end cost table binned by store size N.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", type=int, default=10_000,
                    help="kept scans to reach")
    ap.add_argument("--laps", type=int, default=2, help="laps per tile")
    ap.add_argument("--stride-m", type=float, default=0.12,
                    help="kept-scan spacing along the path")
    ap.add_argument("--bin", type=int, default=1000,
                    help="report bin width in scans")
    args = ap.parse_args()

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np

    from roborts_slam.backend.processor import Backend, BackendSpec
    from roborts_slam.config import SlamConfig
    from roborts_slam.engine import ScanStore
    from roborts_slam.io.scenes import SCENES, load_scene_map
    from roborts_slam.io.simulate import (
        auto_loop_waypoints, path_to_trajectory, plan_loop_path, raycast,
    )
    from roborts_slam.models.grid_map import CountMapSpec
    from roborts_slam.models.scan import scan_from_ranges

    # cheap-but-real back-end config: coarse resolutions keep the CPU
    # dispatches small; thresholds/tiers are the test-suite profile
    cfg = SlamConfig(
        use_odometry=True, use_optimize_scan_match=False,
        map_resolution=0.1, map_min_passthrough=2.0,
        coarse_map_resolution=0.16, coarse_map_deviation=0.4,
        fine_map_resolution=0.08, fine_map_deviation=0.1,
        gaussian_blur_offset=0.88,
        coarse_search_space_size=0.6, coarse_search_space_resolution=0.08,
        coarse_search_angle_offset=0.349, coarse_search_angle_resolution=0.0349,
        coarse_response_threshold=0.6, coarse_use_point_size=100,
        fine_search_space_size=0.16, fine_search_space_resolution=0.08,
        fine_search_angle_offset=0.175, fine_search_angle_resolution=0.0349,
        fine_response_threshold=0.6, fine_use_point_size=100,
        super_fine_search_space_size=0.16,
        super_fine_search_space_resolution=0.08,
        super_fine_search_angle_offset=0.0698,
        super_fine_search_angle_resolution=0.0349,
        super_fine_response_threshold=0.6, super_fine_use_point_size=100,
        use_map_check_feedback=False,   # fixed-size per-dispatch cost;
                                        # measured in the e2e runs
        loop_match_min_chain_size=8, link_match_min_response=0.65,
        link_scan_max_distance=3.0, loop_match_min_response_coarse=0.65,
        loop_match_max_variance_coarse=0.4, loop_match_min_response_fine=0.65,
        max_points=384, world_size=20.0,
    )

    sc = SCENES["icra"]
    gt = load_scene_map(sc)
    rng = np.random.default_rng(0)

    # one lap of the arena, strided to kept-scan spacing
    wps = auto_loop_waypoints(gt, n=6, clearance_m=0.3)
    path = plan_loop_path(gt, wps, clearance_m=0.3)
    traj = path_to_trajectory(path, speed=0.5, scan_rate=10.0)
    poses_lap = traj[:, :3]
    keep = [0]
    for i in range(1, len(poses_lap)):
        if np.hypot(*(poses_lap[i, :2] - poses_lap[keep[-1], :2])) >= args.stride_m:
            keep.append(i)
    lap = poses_lap[keep]
    per_tile = len(lap) * args.laps
    n_tiles = (args.target + per_tile - 1) // per_tile
    print(f"lap: {len(lap)} kept scans; {args.laps} laps x {n_tiles} tiles "
          f"-> {per_tile * n_tiles} scans", flush=True)

    store = ScanStore(cfg.max_points)
    bspec = BackendSpec.from_config(cfg, sc.laser.range_max,
                                    CountMapSpec(resolution=cfg.map_resolution,
                                                 height=64, width=64,
                                                 max_ray_cells=128))
    backend = Backend(bspec, store)

    def on_corr(corrected):
        for i in range(corrected.shape[0]):
            store.set_pose(i, corrected[i])
    backend.on_corrections = on_corr
    # map-check feedback is off; the pub-map slot still feeds the dispatch
    zero_pub = (jnp.zeros((64, 64), jnp.float32),
                jnp.zeros((64, 64), jnp.float32),
                jnp.zeros((2,), jnp.float32))
    store._pub_arrays = zero_pub

    cov = np.diag([2e-4, 2e-4, 4e-4])
    tile_pitch = 12.0                  # m between tile origins (> 8m lidar)
    grid_w = max(1, int(np.ceil(np.sqrt(n_tiles))))

    bins_upd, bins_loop = {}, {}
    t_start = time.perf_counter()
    sid = -1
    for tile in range(n_tiles):
        origin = np.array([(tile % grid_w) * tile_pitch,
                           (tile // grid_w) * tile_pitch, 0.0])
        for lap_i in range(args.laps):
            for local in lap:
                ranges = raycast(gt, local, sc.laser, rng, 0.005)
                s = scan_from_ranges(ranges, sc.laser, local, 0.0,
                                     cfg.max_points)
                pose = local + origin
                pose = pose + rng.normal(0, [0.004, 0.004, 0.002])
                sid = store.add(np.asarray(s.points), np.asarray(s.mask),
                                int(np.asarray(s.mask).sum()), pose, pose,
                                float(sid + 1) * 0.1)
                t0 = time.perf_counter()
                backend.update_graph(sid, cov)
                t1 = time.perf_counter()
                backend.try_close_loop(sid)
                t2 = time.perf_counter()
                b = sid // args.bin
                bins_upd.setdefault(b, []).append(t1 - t0)
                bins_loop.setdefault(b, []).append(t2 - t1)
                if sid + 1 >= args.target and sid + 1 >= per_tile:
                    break
            if sid + 1 >= args.target:
                break
        done = sid + 1
        el = time.perf_counter() - t_start
        print(f"tile {tile + 1}/{n_tiles}: N={done} links={backend.num_links} "
              f"closures={backend.num_loop_closures} "
              f"({done / el:.1f} scans/s)", flush=True)
        if done >= args.target:
            break

    n = len(store)
    print(f"\nfinal: N={n} scans, {len(backend.graph.edges)} edges, "
          f"{backend.num_links} links, {backend.num_loop_closures} closures")
    print(f"store memory: "
          f"{n * cfg.max_points * (8 + 1) / 1e6:.0f} MB points+masks\n")
    print("| N range | update_graph ms/scan (mean/p90) | "
          "try_close_loop ms/scan (mean/p90) |")
    print("|---|---|---|")
    for b in sorted(bins_upd):
        u = np.array(bins_upd[b]) * 1e3
        l = np.array(bins_loop[b]) * 1e3
        print(f"| {b * args.bin}-{(b + 1) * args.bin} "
              f"| {u.mean():.1f} / {np.percentile(u, 90):.1f} "
              f"| {l.mean():.1f} / {np.percentile(l, 90):.1f} |")

    # flatness check: last-bin mean within 2x of the 2nd bin (the 1st bin
    # carries compile time)
    bs = sorted(bins_upd)
    if len(bs) >= 3:
        ref_b = np.array(bins_upd[bs[1]]).mean() + np.array(
            bins_loop[bs[1]]).mean()
        last = np.array(bins_upd[bs[-1]]).mean() + np.array(
            bins_loop[bs[-1]]).mean()
        ratio = last / ref_b
        print(f"\nper-scan back-end cost, last bin vs bin 2: {ratio:.2f}x")
        assert ratio < 2.0, "back-end per-scan cost is not flat"
        print("FLAT — O(1) per-scan back-end cost confirmed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
