"""Multi-device tests on the 8-way virtual CPU mesh."""

import numpy as np
import jax
import jax.numpy as jnp

from roborts_slam.backend.spa import solve_pose_graph
from roborts_slam.parallel.dist_spa import solve_pose_graph_sharded
from roborts_slam.parallel.mesh import make_mesh
from tests.test_spa import _make_loop_graph


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_spa_matches_single_device():
    data, gt, n = _make_loop_graph(n=48, noise=0.06, seed=11)
    p1, c1, i1 = solve_pose_graph(data)
    mesh = make_mesh(axis_name="graph")
    p2, c2, i2 = solve_pose_graph_sharded(data, mesh, axis="graph")
    assert abs(float(c1) - float(c2)) < 1e-3 * (abs(float(c1)) + 1e-6), (c1, c2)
    np.testing.assert_allclose(np.asarray(p1)[:n], np.asarray(p2)[:n],
                               atol=1e-3)


def test_sharded_batch_scan_match():
    from roborts_slam.frontend.matchers import MatcherParams
    from roborts_slam.config import SlamConfig
    from roborts_slam.models.grid_map import ProbMapSpec, make_prob_map
    from roborts_slam.ops.raster import stamp_scan
    from roborts_slam.parallel.sharded_match import make_batched_scan_matcher

    cfg = SlamConfig(use_optimize_scan_match=False,
                     coarse_search_space_size=0.4,
                     coarse_search_space_resolution=0.05,
                     coarse_search_angle_offset=0.175,
                     coarse_search_angle_resolution=0.0349,
                     fine_search_space_size=0.1,
                     fine_search_space_resolution=0.02,
                     fine_search_angle_offset=0.0698,
                     fine_search_angle_resolution=0.0349,
                     super_fine_search_space_size=0.02,
                     super_fine_search_space_resolution=0.01,
                     super_fine_search_angle_offset=0.0349,
                     super_fine_search_angle_resolution=0.00349)
    matcher = MatcherParams.from_config(cfg)
    fine_spec = ProbMapSpec(0.02, 512, 512, 0.05, 0.88)
    coarse_spec = ProbMapSpec(0.08, 128, 128, 0.24, 0.88)

    t = np.linspace(0, 2 * np.pi, 100, endpoint=False)
    pts = np.stack([2.5 * np.cos(t), 1.5 * np.sin(t)], -1).astype(np.float32)
    P = 128
    points = np.zeros((P, 2), np.float32)
    points[:100] = pts
    mask = np.zeros(P, bool)
    mask[:100] = True

    fine = stamp_scan(fine_spec, make_prob_map(fine_spec, [5.12, 5.12]),
                      jnp.asarray(points), jnp.asarray(mask), jnp.zeros(3))
    coarse = stamp_scan(coarse_spec, make_prob_map(coarse_spec, [5.12, 5.12]),
                        jnp.asarray(points), jnp.asarray(mask), jnp.zeros(3))

    B = 8
    rng = np.random.default_rng(0)
    inits = rng.uniform(-0.08, 0.08, size=(B, 3)).astype(np.float32)
    batch_pts = np.tile(points[None], (B, 1, 1))
    batch_msk = np.tile(mask[None], (B, 1))
    nvals = np.full(B, 100, np.int32)

    mesh = make_mesh(axis_name="data")
    matchfn = make_batched_scan_matcher(fine_spec, coarse_spec, matcher, mesh)
    poses, scores, covs = matchfn(fine.probs, fine.offset, coarse.probs,
                                  coarse.offset, jnp.asarray(batch_pts),
                                  jnp.asarray(batch_msk), jnp.asarray(nvals),
                                  jnp.asarray(inits))
    poses = np.asarray(poses)
    assert np.all(np.asarray(scores) > 0.5)
    assert np.abs(poses[:, :2]).max() < 0.03, poses


def test_multihost_harness_cpu():
    """Mechanics only: the mesh/scaling harness runs on the virtual mesh
    (efficiency is meaningless on shared CPU cores; real numbers come from
    the GPUs)."""
    from roborts_slam.parallel.multihost import (
        global_mesh, scaling_run, spa_scaling_workload)

    m = global_mesh()
    assert m.shape["data"] * m.shape["graph"] == len(jax.devices())
    wf = spa_scaling_workload(n_nodes=64, max_iters=3, cg_iters=5)
    pts = scaling_run(wf, [1, 2], reps=1)
    assert len(pts) == 2
    assert pts[0].throughput > 0 and pts[1].throughput > 0
    assert pts[0].efficiency == 1.0


def test_sharded_chain_matcher_gather_equality():
    """The sharded store-gather chain matcher (the sharded-map capacity
    path) must reproduce the single-device chain_match_batch_gather
    bit-for-bit on an 8-chain batch over the 8-device mesh — per-device
    memory is then B/8 chains' map temps."""
    from roborts_slam.backend.processor import (
        BackendSpec, chain_match_batch_gather,
    )
    from roborts_slam.config import (SIMULATION_REFERENCE_PROFILE,
                                     load_config)
    from roborts_slam.models.grid_map import pub_map_spec
    from roborts_slam.parallel.sharded_match import (
        make_sharded_chain_matcher_gather,
    )

    cfg = load_config(SIMULATION_REFERENCE_PROFILE)
    cfg = cfg.replace(max_points=64, max_chain_scans=4,
                      coarse_map_resolution=0.08, fine_map_resolution=0.04)
    laser_range = 3.0
    pub = pub_map_spec(cfg, laser_range, 10.0)
    bspec = BackendSpec.from_config(cfg, laser_range, pub)

    rng = np.random.default_rng(7)
    cap, P, B, K = 32, cfg.max_points, 8, cfg.max_chain_scans
    all_pts = jnp.asarray(rng.uniform(-2, 2, (cap, P, 2)).astype(np.float32))
    all_msk = jnp.asarray(np.ones((cap, P), bool))
    all_nv = jnp.asarray(np.full((cap,), P, np.int32))
    all_poses = jnp.asarray(
        rng.uniform(-1, 1, (cap, 3)).astype(np.float32))
    ids = rng.integers(0, cap - 1, (B, K)).astype(np.int32)
    ids[2, 2:] = -1                      # padded chain
    inits = rng.uniform(-0.5, 0.5, (B, 3)).astype(np.float32)
    center = jnp.asarray(np.array([0.1, -0.2, 0.3], np.float32))
    pub_hits = jnp.zeros((pub.height, pub.width), jnp.float32)
    pub_passes = jnp.zeros((pub.height, pub.width), jnp.float32)
    pub_off = jnp.asarray(np.array([5.0, 5.0], np.float32))

    single = chain_match_batch_gather(
        bspec, all_pts, all_msk, all_nv, all_poses, jnp.asarray(ids),
        jnp.int32(1), jnp.asarray(inits), center, pub_hits, pub_passes,
        pub_off)

    mesh = make_mesh(axis_name="data")
    sharded_fn = make_sharded_chain_matcher_gather(bspec, mesh)
    sharded = sharded_fn(all_pts, all_msk, all_nv, all_poses,
                         jnp.asarray(ids), jnp.int32(1), jnp.asarray(inits),
                         center, pub_hits, pub_passes, pub_off)

    for a, b in zip(single, sharded):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-6, rtol=1e-6)
