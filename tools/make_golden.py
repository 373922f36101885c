"""Generate golden-trajectory regression fixtures.

Writes tests/data/golden_<scene>.npz: a small fixed scan-log slice plus
the engine's expected output trajectory on the CPU backend with the
reference simulation config. tests/test_golden.py replays the log and
asserts the trajectory byte-for-semantics: any scoring/gating/map-update
semantics drift fails loudly even when it stays under the scene ATE bound.

Scenes: icra (270 beams, the default inner-loop pin) and willow (1081
beams — pins the high-beam-count packing/subsampling semantics).

Regenerate ONLY after an intentional semantics change, and say why in the
commit message:

    python tools/make_golden.py [icra willow]
"""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SEED = 5
# willow: fewer scans (1081-beam steps are ~10x the icra cost on CPU) and
# a 0.02 m fine map so the fixture replays in test-suite time
SCENES_GOLD = {
    "icra": dict(n_scans=120, world_size=24.0, overrides={}),
    "willow": dict(n_scans=70, world_size=30.0,
                   overrides={"fine_map_resolution": 0.02,
                              "max_points": 1152}),
}


def build_engine(laser, scene: str = "icra"):
    from roborts_slam.config import SIMULATION_REFERENCE_PROFILE, load_config
    from roborts_slam.engine import SlamEngine

    g = SCENES_GOLD[scene]
    cfg = load_config(SIMULATION_REFERENCE_PROFILE)
    if g["overrides"]:
        cfg = cfg.replace(**g["overrides"])
    return SlamEngine(cfg, laser, world_size=g["world_size"],
                      synchronous_backend=True)


def make(scene: str):
    from roborts_slam.io.scenes import SCENES, load_scene_map
    from roborts_slam.io.simulate import simulate_log

    out = os.path.join(REPO, "tests", "data", f"golden_{scene}.npz")
    sc = SCENES[scene]
    gt_map = load_scene_map(sc)
    log = simulate_log(gt_map, sc.laser, odom_error=sc.odom_error,
                       range_noise=0.005, seed=SEED)
    n = min(SCENES_GOLD[scene]["n_scans"], len(log))

    engine = build_engine(log.laser, scene)
    kept_ids = []
    for i in range(n):
        if engine.process(log.ranges[i], log.odom[i], float(log.times[i])):
            kept_ids.append(i)
    traj = engine.trajectory_array()

    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(
        out,
        ranges=log.ranges[:n].astype(np.float32),
        odom=log.odom[:n].astype(np.float64),
        times=log.times[:n].astype(np.float64),
        laser=log.laser.to_array(),
        kept_ids=np.asarray(kept_ids, np.int64),
        trajectory=traj.astype(np.float64),
        loops=np.int64(engine.backend.num_loop_closures),
        links=np.int64(engine.backend.num_links),
    )
    print(f"golden[{scene}]: {n} scans, kept {len(kept_ids)}, "
          f"links {engine.backend.num_links}, "
          f"loops {engine.backend.num_loop_closures} -> {out} "
          f"({os.path.getsize(out)//1024} KiB)")


def main():
    # goldens are recorded on the CPU backend
    import jax

    jax.config.update("jax_platforms", "cpu")
    scenes = sys.argv[1:] or list(SCENES_GOLD)
    for scene in scenes:
        make(scene)


if __name__ == "__main__":
    main()
