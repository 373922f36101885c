"""Mega-sequence distributed solve: willow + icra + rm pose graphs, sharded.

The BASELINE.md multi-host scenario: run SLAM over the three benchmark
scenes, concatenate the resulting *real* pose graphs into one problem, and
solve it with edges sharded across the device mesh (psum-reduced
Gauss-Newton), verifying the sharded result against the single-device
solve. By default the mesh is virtualized on the CPU (pass --devices);
--real uses the GPUs of this host.

Usage: python examples/mega_sequence.py [--devices 8] [--scans-per-scene 80]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--scans-per-scene", type=int, default=80)
    ap.add_argument("--real", action="store_true",
                    help="use the attached GPUs instead of a virtual "
                         "CPU mesh (needs --devices GPUs)")
    args = ap.parse_args()

    if not args.real:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}").strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    from roborts_slam.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp
    import numpy as np

    from roborts_slam.backend.spa import PoseGraphData, solve_pose_graph
    from roborts_slam.engine import SlamEngine
    from roborts_slam.io.scenes import SCENES, load_scene_map
    from roborts_slam.io.simulate import simulate_log
    from roborts_slam.parallel.dist_spa import solve_pose_graph_sharded
    from roborts_slam.parallel.mesh import make_mesh
    from tests.test_e2e_small import _small_config

    graphs = []
    for name in ("icra", "rm", "willow"):
        sc = SCENES[name]
        log = simulate_log(load_scene_map(sc), sc.laser,
                           odom_error=sc.odom_error, range_noise=0.005,
                           seed=1, speed=1.0)
        cfg = _small_config().replace(
            world_size=40.0 if name != "icra" else 20.0,
            max_points=1152 if name == "willow" else 384)
        eng = SlamEngine(cfg, log.laser)
        n = min(args.scans_per_scene * 2, len(log))
        kept = 0
        for i in range(n):
            eng.process(log.ranges[i], log.odom[i], float(log.times[i]))
            kept = eng.diag.scans_processed
            if kept >= args.scans_per_scene:
                break
        eng.finish()
        data = eng.backend.graph.as_solver_data(eng.store.poses_array())
        graphs.append((name, data))
        print(f"{name}: {eng.backend.graph.num_vertices} nodes, "
              f"{len(eng.backend.graph.edges)} edges, "
              f"{eng.diag.loop_closures} loop closures", flush=True)

    # ---- concatenate into one problem (node ids offset per scene) ----
    poses, nmask, eij, erel, einfo, emask = [], [], [], [], [], []
    base = 0
    for name, d in graphs:
        n = int(np.sum(np.asarray(d.node_mask)))
        e = int(np.sum(np.asarray(d.edge_mask)))
        poses.append(np.asarray(d.poses)[:n])
        nmask.append(np.ones(n, bool))
        eij.append(np.asarray(d.edge_ij)[:e] + base)
        erel.append(np.asarray(d.edge_rel)[:e])
        einfo.append(np.asarray(d.edge_info)[:e])
        emask.append(np.ones(e, bool))
        base += n
    mega = PoseGraphData(
        poses=jnp.asarray(np.concatenate(poses), jnp.float32),
        node_mask=jnp.asarray(np.concatenate(nmask)),
        edge_ij=jnp.asarray(np.concatenate(eij), jnp.int32),
        edge_rel=jnp.asarray(np.concatenate(erel), jnp.float32),
        edge_info=jnp.asarray(np.concatenate(einfo), jnp.float32),
        edge_mask=jnp.asarray(np.concatenate(emask)),
    )
    print(f"mega graph: {mega.poses.shape[0]} nodes, "
          f"{mega.edge_ij.shape[0]} edges", flush=True)

    t0 = time.perf_counter()
    p1, c1, i1 = solve_pose_graph(mega)
    jax.block_until_ready(p1)
    t1 = time.perf_counter() - t0
    print(f"single-device solve: cost {float(c1):.5f}, {int(i1)} iters, "
          f"{t1*1e3:.0f} ms", flush=True)

    mesh = make_mesh(min(args.devices, len(jax.devices())), axis_name="graph")
    t0 = time.perf_counter()
    p2, c2, i2 = solve_pose_graph_sharded(mega, mesh, axis="graph")
    jax.block_until_ready(p2)
    t2 = time.perf_counter() - t0
    n_nodes = mega.poses.shape[0]
    err = float(np.abs(np.asarray(p1)[:n_nodes] - np.asarray(p2)[:n_nodes]).max())
    print(f"{mesh.shape['graph']}-way sharded solve: cost {float(c2):.5f}, "
          f"{int(i2)} iters, {t2*1e3:.0f} ms, max disagreement {err:.2e}",
          flush=True)
    assert err < 1e-2
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
