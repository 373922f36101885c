"""Full-scene willow regression gate, on the GPU.

Replays the generated willow scene's whole waypoint loop (io/scenes.py,
~3,400 scans of a 1081-beam lidar) through the blocking engine with the
reference simulation profile. The loop spans more than the 50 m world the
profile derives, so the pub map covers every beam the run can see and the
scan-match maps follow the robot as a 40 m window. The gate fails unless
the engine keeps scans to the end of the run, at least one loop closes
and the ATE against ground truth stays under the reference's own willow
ATE.

Usage:
    python scripts/willow_gate.py [--pipelined [--depth 3]]

Writes out/willow_gate.json every run.
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# the reference's measured willow ATE (BASELINE_MEASURED.md)
ATE_BOUND_M = 0.067


def world_extent(log) -> float:
    """Side (m) of a world centred on the start that holds every beam
    endpoint of the run, plus 3 m."""
    import numpy as np

    la = log.laser
    start = log.gt_poses[0, :2]
    reach = np.abs(log.gt_poses[:, :2] - start).max() + la.range_max
    return 2.0 * (float(reach) + 3.0)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pipelined", action="store_true",
                    help="use the double-buffered fetch pipeline")
    ap.add_argument("--depth", type=int, default=3,
                    help="pipeline depth (quality/throughput dial)")
    args = ap.parse_args()

    import jax

    from roborts_slam.config import (SIMULATION_REFERENCE_PROFILE,
                                     load_config)
    from roborts_slam.engine import SlamEngine
    from roborts_slam.io.scenes import SCENES, load_scene_map
    from roborts_slam.io.simulate import simulate_log
    from roborts_slam.utils.compile_cache import enable_compile_cache
    from roborts_slam.utils.evaluation import ate_rmse, match_by_time

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"the gate runs on a GPU; JAX found {dev.platform}")
    enable_compile_cache()

    sc = SCENES["willow"]
    log = simulate_log(load_scene_map(sc), sc.laser,
                       odom_error=sc.odom_error, range_noise=0.005, seed=0,
                       n_waypoints=sc.n_waypoints,
                       clearance_m=sc.clearance_m)
    window = 4.0 * log.laser.range_threshold + 2.0
    cfg = load_config(SIMULATION_REFERENCE_PROFILE).replace(
        match_map_window=window)
    engine = SlamEngine(cfg, log.laser, world_size=world_extent(log),
                        synchronous_backend=True)
    if args.pipelined:
        engine.pipelined_fetch = True
        engine.pipeline_depth = args.depth
    n = len(log)
    t0 = time.time()
    for i in range(n):
        engine.process(log.ranges[i], log.odom[i], float(log.times[i]))
        if i % 500 == 0:
            print(f"  scan {i}/{n} kept={len(engine.store)} "
                  f"loops={engine.backend.num_loop_closures} "
                  f"t={time.time() - t0:.0f}s", flush=True)
    engine.finish()
    wall = time.time() - t0

    traj = engine.trajectory_array()
    est, gt = match_by_time(traj, log.gt_poses, log.times)
    rec = {
        "device": dev.device_kind, "scene": "willow", "scans_fed": n,
        "scans_kept": len(engine.store), "wall_s": wall,
        "ate_m": float(ate_rmse(est, gt)),
        "last_kept_s": float(traj[-1, 0]), "log_s": float(log.times[-1]),
        "loop_closures": engine.backend.num_loop_closures,
        "links": engine.backend.num_links,
        "pipelined": bool(args.pipelined),
        "pipeline_depth": args.depth if args.pipelined else 0,
    }
    os.makedirs(os.path.join(REPO, "out"), exist_ok=True)
    with open(os.path.join(REPO, "out", "willow_gate.json"), "w") as fh:
        json.dump(rec, fh, indent=1)
    print(json.dumps(rec, indent=1))

    fails = []
    if rec["ate_m"] > ATE_BOUND_M:
        fails.append(f"ATE {rec['ate_m']} exceeds the reference's "
                     f"{ATE_BOUND_M}")
    if rec["loop_closures"] == 0:
        fails.append("no loop closures")
    if rec["last_kept_s"] < rec["log_s"] - 5.0:
        fails.append(f"no scan kept after t={rec['last_kept_s']:.1f} s of "
                     f"{rec['log_s']:.1f} s")
    if fails:
        print("WILLOW GATE: FAIL")
        for f in fails:
            print("  -", f)
        sys.exit(1)
    print(f"WILLOW GATE: PASS (ATE {rec['ate_m']} m)")


if __name__ == "__main__":
    main()
