"""End-to-end SLAM on a simulated benchmark scene.

Usage:
  python examples/run_slam.py [icra|rm|willow] [--async] [--save-map out.pgm]

Simulates a loop trajectory through one of the generated benchmark scenes
(io/scenes.py), runs the full online pipeline (front-end matching,
pose-graph back-end with loop closure), and reports ATE + stage timings.
Runs on whatever JAX backend is active; pass --cpu to force the CPU backend.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene", nargs="?", default="icra",
                    choices=["icra", "rm", "willow"])
    ap.add_argument("--async", dest="async_backend", action="store_true",
                    help="run the back end on a worker thread")
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-map", default=None)
    ap.add_argument("--render", default=None,
                    help="render map+trajectory+graph to a PNG")
    ap.add_argument("--checkpoint", default=None,
                    help="write an engine checkpoint at the end")
    args = ap.parse_args()

    if args.cpu:
        import os

        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device_count=8").strip()
        import jax

        jax.config.update("jax_platforms", "cpu")

    from roborts_slam.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from roborts_slam.config import (SIMULATION_REFERENCE_PROFILE,
                                     load_config)
    from roborts_slam.engine import SlamEngine
    from roborts_slam.io.scenes import SCENES, load_scene_map
    from roborts_slam.io.simulate import simulate_log
    from roborts_slam.utils.evaluation import ate_rmse, match_by_time

    scene = SCENES[args.scene]
    print(f"simulating {args.scene} ...")
    gt_map = load_scene_map(scene)
    log = simulate_log(gt_map, scene.laser, odom_error=scene.odom_error,
                       range_noise=0.005, seed=args.seed)
    print(f"  {len(log)} scans, {scene.laser.num_beams} beams")

    cfg = load_config(SIMULATION_REFERENCE_PROFILE)
    # CPU-friendly fine map for the example; on a GPU keep the profile's
    cfg = cfg.replace(fine_map_resolution=0.02, max_points=1152)
    engine = SlamEngine(cfg, log.laser,
                        synchronous_backend=not args.async_backend)
    traj = engine.run_log(log, progress=True)

    est, gt = match_by_time(traj, log.gt_poses, log.times)
    print(f"\nATE RMSE: {ate_rmse(est, gt):.3f} m over {len(traj)} kept scans")
    print(f"loop closures: {engine.diag.loop_closures}, "
          f"graph links: {engine.backend.num_links}")
    print("\n" + engine.timers.report())

    if args.save_map:
        from roborts_slam.utils.viz import save_map

        save_map(engine, args.save_map)
        print(f"map written to {args.save_map} (+ map_server YAML)")

    if args.render:
        from roborts_slam.utils.viz import render_run

        render_run(engine, args.render, gt_poses=log.gt_poses)
        print(f"render written to {args.render}")

    if args.checkpoint:
        from roborts_slam.io.checkpoint import save_checkpoint

        save_checkpoint(engine, args.checkpoint)
        print(f"checkpoint written to {args.checkpoint}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
