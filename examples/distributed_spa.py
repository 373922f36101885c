"""Distributed pose-graph solve over a device mesh.

Usage:
  python examples/distributed_spa.py [--devices 4] [--nodes 1024] [--cpu]

Builds a noisy loop pose graph, solves it single-device, then re-solves
with edges sharded across the mesh (psum-reduced Gauss-Newton) and checks
both agree. Runs on the active backend (the GPUs of this host); ``--cpu``
runs it on ``--devices`` virtual CPU devices instead.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--nodes", type=int, default=1024)
    ap.add_argument("--cpu", action="store_true",
                    help="run on --devices virtual CPU devices")
    args = ap.parse_args()

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.devices}").strip()
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from roborts_slam.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import time

    import numpy as np

    from roborts_slam.backend.spa import solve_pose_graph
    from roborts_slam.parallel.dist_spa import solve_pose_graph_sharded
    from roborts_slam.parallel.mesh import make_mesh
    from roborts_slam.parallel.multihost import make_synthetic_loop_graph

    n_dev = min(args.devices, len(jax.devices()))
    print(f"devices: {len(jax.devices())} ({jax.default_backend()}), using {n_dev}")

    n = args.nodes
    data = make_synthetic_loop_graph(n)

    t0 = time.perf_counter()
    p1, c1, i1 = solve_pose_graph(data)
    jax.block_until_ready(p1)
    t1 = time.perf_counter() - t0
    print(f"single-device: cost {float(c1):.4f} in {int(i1)} iters, {t1*1e3:.0f} ms")

    mesh = make_mesh(n_dev, axis_name="graph")
    t0 = time.perf_counter()
    p2, c2, i2 = solve_pose_graph_sharded(data, mesh, axis="graph")
    jax.block_until_ready(p2)
    t2 = time.perf_counter() - t0
    print(f"{n_dev}-device sharded: cost {float(c2):.4f} in {int(i2)} iters, {t2*1e3:.0f} ms")

    err = float(np.abs(np.asarray(p1)[:n] - np.asarray(p2)[:n]).max())
    print(f"max pose disagreement: {err:.2e}")
    assert err < 1e-2
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
