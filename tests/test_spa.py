"""SPA solver tests: convergence to ground truth, PCG vs dense agreement."""

import numpy as np
import jax.numpy as jnp

from roborts_slam.backend.spa import (
    PoseGraphData, edge_residuals, graph_cost, solve_pose_graph,
    solve_pose_graph_dense,
)
from roborts_slam.utils.geometry import normalize_angle, pose_relative


def _make_loop_graph(n=40, noise=0.05, seed=0, pad_n=64, pad_e=128):
    """Ground-truth circular trajectory; odometry edges + one loop edge."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    gt = np.stack([3 * np.cos(t), 3 * np.sin(t), normalize_angle(t + np.pi / 2)], -1)

    edges, rels, infos = [], [], []

    def add_edge(i, j, sigma):
        rel = np.asarray(pose_relative(jnp.asarray(gt[i]), jnp.asarray(gt[j])))
        rel = rel + rng.normal(0, sigma, 3) * [1, 1, 0.3]
        edges.append((i, j))
        rels.append(rel)
        infos.append(np.eye(3) / max(sigma, 1e-3) ** 2)

    for i in range(n - 1):
        add_edge(i, i + 1, noise)
    add_edge(n - 1, 0, noise * 0.1)       # strong loop closure
    add_edge(0, n // 2, noise * 0.2)      # extra cross edge

    # initial guess: integrate noisy odometry edges
    init = np.zeros((n, 3))
    init[0] = gt[0]
    for k in range(n - 1):
        i, j = edges[k]
        rel = rels[k]
        c, s = np.cos(init[i, 2]), np.sin(init[i, 2])
        init[j] = [init[i, 0] + c * rel[0] - s * rel[1],
                   init[i, 1] + s * rel[0] + c * rel[1],
                   init[i, 2] + rel[2]]

    E = len(edges)
    poses = np.zeros((pad_n, 3), np.float32)
    poses[:n] = init
    node_mask = np.zeros(pad_n, bool)
    node_mask[:n] = True
    edge_ij = np.zeros((pad_e, 2), np.int32)
    edge_ij[:E] = edges
    edge_rel = np.zeros((pad_e, 3), np.float32)
    edge_rel[:E] = rels
    edge_info = np.tile(np.eye(3, dtype=np.float32), (pad_e, 1, 1))
    edge_info[:E] = infos
    edge_mask = np.zeros(pad_e, bool)
    edge_mask[:E] = True

    data = PoseGraphData(
        poses=jnp.asarray(poses), node_mask=jnp.asarray(node_mask),
        edge_ij=jnp.asarray(edge_ij), edge_rel=jnp.asarray(edge_rel),
        edge_info=jnp.asarray(edge_info), edge_mask=jnp.asarray(edge_mask),
    )
    return data, gt, n


def test_residual_zero_at_consistent_poses():
    data, gt, n = _make_loop_graph(noise=0.0)
    r = np.asarray(edge_residuals(jnp.asarray(np.pad(gt.astype(np.float32),
                                                     ((0, 64 - n), (0, 0)))), data))
    m = np.asarray(data.edge_mask)
    assert np.abs(r[m]).max() < 1e-4


def test_pcg_solver_converges_to_gt():
    data, gt, n = _make_loop_graph(noise=0.05)
    init_cost = float(graph_cost(data.poses, data))
    poses, cost, iters = solve_pose_graph(data)
    poses = np.asarray(poses)[:n]
    assert float(cost) < init_cost * 0.1, (float(cost), init_cost)
    # trajectory should be near GT (gauge anchored at node 0 = gt[0])
    err = np.linalg.norm(poses[:, :2] - gt[:, :2], axis=1)
    assert err.mean() < 0.15, err.mean()


def test_dense_and_pcg_agree():
    data, gt, n = _make_loop_graph(noise=0.05, seed=3)
    p1, c1, _ = solve_pose_graph(data)
    p2, c2 = solve_pose_graph_dense(data)
    assert abs(float(c1) - float(c2)) / (float(c2) + 1e-9) < 0.05
    d = np.linalg.norm(np.asarray(p1)[:n, :2] - np.asarray(p2)[:n, :2], axis=1)
    assert d.max() < 0.05, d.max()


def test_solver_improves_loop_error():
    data, gt, n = _make_loop_graph(noise=0.08, seed=7)
    # initial loop-closure gap
    init = np.asarray(data.poses)[:n]
    gap0 = np.linalg.norm(init[-1, :2] - gt[-1, :2])
    poses, _, _ = solve_pose_graph(data)
    gap1 = np.linalg.norm(np.asarray(poses)[n - 1, :2] - gt[-1, :2])
    assert gap1 < gap0 * 0.5, (gap0, gap1)
