"""Scaling benchmark: sharded workloads at 1..N devices.

Measures the two distributed programs (BASELINE.md multi-host targets):
- batch scan matching fanned out over the ``data`` axis (DP);
- the edge-sharded pose-graph solve over the ``graph`` axis (psum-reduced
  Gauss-Newton).

On the GPUs of a host this reports their scaling; without them it still
runs via virtual devices (pass --virtual N; efficiency there only reflects
how well the programs shard, not hardware speedup). Prints one JSON line
per point.

Usage: python bench_scaling.py [--virtual 8] [--sizes 1,2,4,8]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--virtual", type=int, default=0,
                    help="force N virtual CPU devices")
    ap.add_argument("--sizes", default=None,
                    help="comma-separated device counts")
    ap.add_argument("--nodes", type=int, default=1024)
    args = ap.parse_args()

    if args.virtual:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual}").strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    from roborts_slam.parallel.multihost import (
        initialize_distributed, scaling_run, spa_scaling_workload)

    initialize_distributed()
    n_dev = len(jax.devices())
    if args.sizes:
        sizes = [int(s) for s in args.sizes.split(",")]
    else:
        sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]

    wf = spa_scaling_workload(n_nodes=args.nodes, max_iters=10, cg_iters=25)
    for p in scaling_run(wf, sizes):
        print(json.dumps({
            "metric": "dist_spa_edge_iters_per_sec",
            "n_devices": p.n_devices,
            "value": round(p.throughput, 1),
            "unit": "edge-iterations/sec",
            "seconds": round(p.seconds, 4),
            "efficiency": round(p.efficiency, 3),
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
