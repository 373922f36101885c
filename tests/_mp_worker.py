"""Worker process for tests/test_multiprocess.py (spawned, not collected).

Joins a 2-process jax.distributed cluster on the CPU backend (4 virtual
devices per process -> 8 global), builds the global (data, graph) mesh, and
runs the two sharded programs:

- edge-sharded SPA over the intra-process ``graph`` axis AND over the
  cross-process ``data`` axis (the cross-process psums);
- the sharded batch chain matcher over ``data`` (cross-process batch
  fan-out).

Results are saved per process for the pytest parent to compare across
processes and against the single-process solves.
"""

import json
import os
import sys

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
out_dir = sys.argv[4]

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.pop("JAX_PLATFORMS", None)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from roborts_slam.parallel.multihost import (  # noqa: E402
    global_mesh, initialize_distributed, make_synthetic_loop_graph,
)


def main():
    initialize_distributed(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    assert len(jax.devices()) == 4 * nproc

    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from roborts_slam.parallel.dist_spa import solve_pose_graph_sharded

    mesh = global_mesh()          # (data=nproc, graph=4)
    assert dict(zip(mesh.axis_names, mesh.devices.shape)) == {
        "data": nproc, "graph": 4}

    data = make_synthetic_loop_graph(96, seed=3)
    results = {}
    # intra-process psums
    p_g, c_g, it_g = solve_pose_graph_sharded(data, mesh, axis="graph",
                                              max_iters=6, cg_iters=15)
    # cross-process psums — the path only this test exercises
    p_d, c_d, it_d = solve_pose_graph_sharded(data, mesh, axis="data",
                                              max_iters=6, cg_iters=15)
    np.save(os.path.join(out_dir, f"spa_graph_{pid}.npy"), np.asarray(p_g))
    np.save(os.path.join(out_dir, f"spa_data_{pid}.npy"), np.asarray(p_d))
    results["spa_cost_graph"] = float(c_g)
    results["spa_cost_data"] = float(c_d)

    # sharded batch chain matcher over the cross-process data axis
    from tests._mp_matcher_fixture import build_matcher_problem

    matcher_fn_args, arrays = build_matcher_problem()
    from roborts_slam.parallel.sharded_match import (
        make_batched_chain_matcher,
    )

    fn = make_batched_chain_matcher(*matcher_fn_args, mesh=mesh, axis="data")
    shard = NamedSharding(mesh, P("data"))
    glob = [jax.make_array_from_callback(a.shape, shard,
                                         lambda idx, a=a: a[idx])
            for a in arrays]
    poses, scores, covs = fn(*glob)
    poses = multihost_utils.process_allgather(poses, tiled=True)
    scores = multihost_utils.process_allgather(scores, tiled=True)
    np.save(os.path.join(out_dir, f"match_poses_{pid}.npy"),
            np.asarray(poses))
    np.save(os.path.join(out_dir, f"match_scores_{pid}.npy"),
            np.asarray(scores))

    with open(os.path.join(out_dir, f"done_{pid}.json"), "w") as f:
        json.dump(results, f)
    print(f"worker {pid}: done")


if __name__ == "__main__":
    main()
