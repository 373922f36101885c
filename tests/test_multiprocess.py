"""Real multi-process jax.distributed coverage.

Spawns 2 local processes × 4 virtual CPU devices (8 global) through
``initialize_distributed`` and runs the edge-sharded SPA (psums over both
the intra-process ``graph`` axis and the cross-process ``data`` axis)
plus the sharded batch chain matcher, asserting both processes
agree and match the single-process results. SURVEY §4 prescribes exactly
this: "multi-host tests runnable on CPU via jax.distributed with multiple
local processes".
"""

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_mp_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_distributed(tmp_path):
    port = _free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port), str(tmp_path)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for pid in range(2)
    ]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert os.path.exists(tmp_path / f"done_{pid}.json"), out[-2000:]

    # --- SPA: both processes identical; both axes identical; matches the
    # single-process solve ---
    from roborts_slam.backend.spa import solve_pose_graph
    from roborts_slam.parallel.multihost import make_synthetic_loop_graph

    pg = [np.load(tmp_path / f"spa_graph_{pid}.npy") for pid in range(2)]
    pd = [np.load(tmp_path / f"spa_data_{pid}.npy") for pid in range(2)]
    np.testing.assert_array_equal(pg[0], pg[1])
    np.testing.assert_array_equal(pd[0], pd[1])
    np.testing.assert_allclose(pg[0], pd[0], atol=1e-4)

    data = make_synthetic_loop_graph(96, seed=3)
    ref, _, _ = solve_pose_graph(data, max_iters=6, cg_iters=15)
    np.testing.assert_allclose(pg[0], np.asarray(ref), atol=1e-3)

    # --- sharded batch matcher: processes agree and match single-process ---
    from tests._mp_matcher_fixture import build_matcher_problem
    from roborts_slam.parallel.sharded_match import (
        make_batched_chain_matcher,
    )

    mp = [np.load(tmp_path / f"match_poses_{pid}.npy") for pid in range(2)]
    ms = [np.load(tmp_path / f"match_scores_{pid}.npy") for pid in range(2)]
    np.testing.assert_array_equal(mp[0], mp[1])
    np.testing.assert_array_equal(ms[0], ms[1])

    fn_args, arrays = build_matcher_problem()
    import jax.numpy as jnp

    fn = make_batched_chain_matcher(*fn_args)
    poses_ref, scores_ref, _ = fn(*[jnp.asarray(a) for a in arrays])
    np.testing.assert_allclose(mp[0], np.asarray(poses_ref), atol=1e-4)
    np.testing.assert_allclose(ms[0], np.asarray(scores_ref), atol=1e-4)
