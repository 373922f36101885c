"""Structure of the distributed SPA solve and the sharded chain matcher.

Checks, on ``--devices`` virtual CPU devices, what does not need the cards:

1. **Collective count from compiled HLO**: the edge-sharded solve is
   lowered for an N-device mesh and its all-reduces are counted. The count
   must be independent of the edge count (it scales with solver/CG
   iterations only); each psum moves O(poses) data, independent of the
   edge shard size.
2. **The sharded programs run**: the edge-sharded SPA solve on 1 and 2
   devices and the chain-match fan-out on 1..N devices, with their host
   wall times. Virtual devices share the host's cores, so these times say
   nothing about scaling on GPUs; measure that with ``python chip_smoke.py
   --four-cards`` and a trace on the cards.

Run: python scripts/scaling_evidence.py [--devices 8]
"""

from __future__ import annotations

import argparse
import os
import re
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--cg-iters", type=int, default=25)
    ap.add_argument("--max-iters", type=int, default=10)
    args = ap.parse_args()

    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + f" --xla_force_host_platform_device_count={args.devices}").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp  # noqa: F401
    import numpy as np

    from roborts_slam.parallel.dist_spa import (
        pad_edges_to, solve_pose_graph_sharded,
    )
    from roborts_slam.parallel.mesh import make_mesh
    from roborts_slam.parallel.multihost import make_synthetic_loop_graph

    mesh = make_mesh(args.devices)
    axis = mesh.axis_names[0]

    print(f"## Distributed SPA scaling evidence ({args.devices}-device mesh, "
          f"{args.max_iters} LM iters x {args.cg_iters} CG iters)\n")

    # --- 1. collective sites in the compiled loop body (must be
    # edge-count independent: they execute once per solver iteration) ---
    print("| nodes | edges | all-reduce sites in HLO |")
    print("|---|---|---|")
    counts = []
    for n_nodes in (128, 512, 2048):
        data = make_synthetic_loop_graph(n_nodes, seed=0)
        data = pad_edges_to(data, args.devices)

        def run(d=data):
            return solve_pose_graph_sharded(
                d, mesh, axis=axis, max_iters=args.max_iters,
                cg_iters=args.cg_iters)

        txt = jax.jit(run).lower().compile().as_text()
        n_ar = len(re.findall(r"all-reduce(?:-start)?\(", txt))
        counts.append(n_ar)
        print(f"| {n_nodes} | {data.edge_ij.shape[0]} | {n_ar} |")
    assert len(set(counts)) == 1, (
        f"all-reduce site count varies with edge count: {counts} — "
        "collectives are no longer edge-independent")
    print(f"\nall-reduce sites: {counts[0]} per compiled program, inside the "
          "solver loops (LM setup: gradient + diagonal; CG: one HVP vector "
          "psum + scalar reductions). Per-iteration collective VOLUME is "
          "O(nodes), independent of the edge count.\n")

    # --- 2a. the edge-sharded solve executed on a 2-virtual-device mesh:
    # the collectives actually run ---
    import time as _time

    from roborts_slam.parallel.mesh import make_mesh as _mk

    data_m = make_synthetic_loop_graph(4096, seed=1)
    meas = {}
    for nd in (1, 2):
        m = _mk(nd)
        d = pad_edges_to(data_m, nd)

        def run_m(d=d, m=m):
            return solve_pose_graph_sharded(
                d, m, axis=m.axis_names[0], max_iters=args.max_iters,
                cg_iters=args.cg_iters)

        rj = jax.jit(run_m)
        jax.block_until_ready(rj())            # compile + warm
        ts = []
        for _ in range(3):
            t0 = _time.perf_counter()
            jax.block_until_ready(rj())
            ts.append(_time.perf_counter() - t0)
        meas[nd] = min(ts)
    print("### Edge-sharded SPA run (4096-node loop graph, virtual CPU "
          "devices)\n")
    print("| devices | best-of-3 s (host) |")
    print("|---|---|")
    for nd, t in meas.items():
        print(f"| {nd} | {t:.3f} |")
    print()

    # --- 2b. sharded chain-match fan-out over real map content: a batch
    # of back-end chain-match problems built from a simulated icra run is
    # matched on 1..N-device meshes ---
    from roborts_slam.config import (SIMULATION_REFERENCE_PROFILE,
                                     load_config)
    from roborts_slam.io.scenes import SCENES, load_scene_map
    from roborts_slam.io.simulate import simulate_log
    from roborts_slam.models.grid_map import backend_map_specs
    from roborts_slam.models.scan import scan_from_ranges
    from roborts_slam.frontend.matchers import MatcherParams
    from roborts_slam.parallel.sharded_match import (
        make_batched_chain_matcher,
    )
    import numpy as _np

    cfg = load_config(SIMULATION_REFERENCE_PROFILE)
    cfg = cfg.replace(fine_map_resolution=0.02, max_points=384)
    sc = SCENES["icra"]
    log = simulate_log(load_scene_map(sc), sc.laser,
                       odom_error=sc.odom_error, range_noise=0.005, seed=2)
    cspec, fspec = backend_map_specs(cfg, sc.laser.range_max)
    matcher = MatcherParams.from_config(cfg)
    B, K, Pn = 8, 8, cfg.max_points
    cpts = _np.zeros((B, K, Pn, 2), _np.float32)
    cmsk = _np.zeros((B, K, Pn), bool)
    cposes = _np.zeros((B, K, 3), _np.float32)
    qpts = _np.zeros((B, Pn, 2), _np.float32)
    qmsk = _np.zeros((B, Pn), bool)
    qnv = _np.zeros((B,), _np.int32)
    inits = _np.zeros((B, 3), _np.float32)
    for b in range(B):
        ids = list(range(2 * b, 2 * b + K))
        for k, i in enumerate(ids):
            s = scan_from_ranges(log.ranges[i], sc.laser, log.gt_poses[i],
                                 0.0, Pn)
            cpts[b, k], cmsk[b, k] = _np.asarray(s.points), _np.asarray(s.mask)
            cposes[b, k] = log.gt_poses[i]
        q = scan_from_ranges(log.ranges[2 * b + K], sc.laser,
                             log.gt_poses[2 * b + K], 0.0, Pn)
        qpts[b], qmsk[b] = _np.asarray(q.points), _np.asarray(q.mask)
        qnv[b] = int(_np.asarray(q.mask).sum())
        inits[b] = log.gt_poses[2 * b + K]
    cvalid = _np.ones((B, K), bool)
    batch_args = (cpts, cmsk, cposes, cvalid, qpts, qmsk, qnv, inits, inits)

    print("### Sharded chain-match fan-out, icra content "
          f"(B={B} chains x {K} scans, virtual CPU devices)\n")
    print("| devices | best-of-3 s (host) |")
    print("|---|---|")
    for nd in [n for n in (1, 2, 4, 8) if n <= args.devices]:
        m = _mk(nd)
        f = make_batched_chain_matcher(cspec, fspec, matcher,
                                       cfg.coarse_map_use_blur,
                                       cfg.fine_map_use_blur, mesh=m,
                                       axis=m.axis_names[0])
        jax.block_until_ready(f(*batch_args))
        ts = []
        for _ in range(3):
            t0 = _time.perf_counter()
            jax.block_until_ready(f(*batch_args))
            ts.append(_time.perf_counter() - t0)
        print(f"| {nd} | {min(ts):.3f} |")
    print("\nThe fan-out has no cross-device communication until the (B,3) "
          "result gather.\n")

    return 0


if __name__ == "__main__":
    sys.exit(main())
