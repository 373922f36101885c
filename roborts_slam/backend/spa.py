"""Sparse Pose Adjustment (SPA) solver in JAX.

Replacement for the reference's Ceres back-end
(src/pose_graph/ceres_pose_graph_solver.{h,cpp} + ceres_types.h): the
``PoseGraph2dErrorTerm`` residual (ceres_types.h:87-134)

    r_xy = R(yaw_a)^T (p_b − p_a) − p_ab,   r_th = wrap(yaw_b − yaw_a − yaw_ab)

weighted by the edge information matrix (inverse covariance,
ceres_pose_graph_solver.cpp:144-176), minimized by Gauss-Newton/LM with the
first pose held constant for gauge (cp. :212-216; iteration budget 50 :40-45).

Instead of a general sparse Cholesky (SPARSE_NORMAL_CHOLESKY), the normal
equations are solved **matrix-free**: H·x is evaluated edge-wise with
segment-sums and never materialized, preconditioned by the block-Jacobi
3x3 diagonal. This is the accelerator-friendly formulation — all edge work is a
fixed-shape batch (vectorizable, shardable across a device mesh with psum
reductions; see parallel/dist_spa.py) and the per-iteration cost is a few
batched 3x3 matmuls over edges.

All arrays are padded: ``edge_mask`` disables padding edges, so a jitted
solve is reusable across growing graphs within a shape bucket.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.geometry import normalize_angle

# float32 contractions in full precision: a GPU may otherwise run them in
# TF32 (10-bit mantissa), and these feed a linear solve
HIGHEST = lax.Precision.HIGHEST


class PoseGraphData(NamedTuple):
    """Padded pose-graph arrays (the solver's entire input)."""

    poses: jnp.ndarray       # (N, 3) initial node poses
    node_mask: jnp.ndarray   # (N,) bool
    edge_ij: jnp.ndarray     # (E, 2) int32 [source, target]
    edge_rel: jnp.ndarray    # (E, 3) measured relative pose (source frame)
    edge_info: jnp.ndarray   # (E, 3, 3) information matrices
    edge_mask: jnp.ndarray   # (E,) bool


def edge_residuals(poses, data: PoseGraphData):
    """(E, 3) residuals of every edge at the given poses."""
    pa = poses[data.edge_ij[:, 0]]
    pb = poses[data.edge_ij[:, 1]]
    c, s = jnp.cos(pa[:, 2]), jnp.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    rx = c * dx + s * dy - data.edge_rel[:, 0]
    ry = -s * dx + c * dy - data.edge_rel[:, 1]
    rt = normalize_angle(pb[:, 2] - pa[:, 2] - data.edge_rel[:, 2])
    return jnp.stack([rx, ry, rt], -1)


def edge_jacobians(poses, data: PoseGraphData):
    """Analytic Jacobians: (E,3,3) wrt node a and node b."""
    pa = poses[data.edge_ij[:, 0]]
    pb = poses[data.edge_ij[:, 1]]
    c, s = jnp.cos(pa[:, 2]), jnp.sin(pa[:, 2])
    dx = pb[:, 0] - pa[:, 0]
    dy = pb[:, 1] - pa[:, 1]
    zeros = jnp.zeros_like(c)
    ones = jnp.ones_like(c)
    # d r / d pose_a
    ja = jnp.stack([
        jnp.stack([-c, -s, -s * dx + c * dy], -1),
        jnp.stack([s, -c, -c * dx - s * dy], -1),
        jnp.stack([zeros, zeros, -ones], -1),
    ], -2)
    # d r / d pose_b
    jb = jnp.stack([
        jnp.stack([c, s, zeros], -1),
        jnp.stack([-s, c, zeros], -1),
        jnp.stack([zeros, zeros, ones], -1),
    ], -2)
    return ja, jb


def graph_cost(poses, data: PoseGraphData):
    r = edge_residuals(poses, data)
    w = data.edge_mask.astype(poses.dtype)
    return 0.5 * jnp.sum(w * jnp.einsum("ei,eij,ej->e", r, data.edge_info, r,
                                        precision=HIGHEST))


def _gauge_project(x, node_mask):
    """Zero the update of node 0 (gauge fix) and of padding nodes."""
    m = node_mask.astype(x.dtype)[:, None]
    m = m.at[0].set(0.0)
    return x * m


def _hvp(poses, data: PoseGraphData, x, reduce_fn=None):
    """Gauss-Newton Hessian-vector product, matrix-free:
    H x = Σ_e J_e^T I_e J_e x, accumulated by segment-sum over edges."""
    ja, jb = edge_jacobians(poses, data)
    w = data.edge_mask.astype(poses.dtype)[:, None, None]
    ia = data.edge_ij[:, 0]
    ib = data.edge_ij[:, 1]
    xa = x[ia]
    xb = x[ib]
    jx = (jnp.einsum("eij,ej->ei", ja, xa, precision=HIGHEST)
          + jnp.einsum("eij,ej->ei", jb, xb, precision=HIGHEST))
    ijx = jnp.einsum("eij,ej->ei", data.edge_info * w, jx, precision=HIGHEST)
    ga = jnp.einsum("eji,ej->ei", ja, ijx, precision=HIGHEST)
    gb = jnp.einsum("eji,ej->ei", jb, ijx, precision=HIGHEST)
    out = jnp.zeros_like(x)
    out = out.at[ia].add(ga)
    out = out.at[ib].add(gb)
    if reduce_fn is not None:
        out = reduce_fn(out)
    return _gauge_project(out, data.node_mask)


def _gradient(poses, data: PoseGraphData, reduce_fn=None):
    r = edge_residuals(poses, data)
    ja, jb = edge_jacobians(poses, data)
    w = data.edge_mask.astype(poses.dtype)[:, None]
    ir = jnp.einsum("eij,ej->ei", data.edge_info, r, precision=HIGHEST) * w
    ga = jnp.einsum("eji,ej->ei", ja, ir, precision=HIGHEST)
    gb = jnp.einsum("eji,ej->ei", jb, ir, precision=HIGHEST)
    g = jnp.zeros_like(poses)
    g = g.at[data.edge_ij[:, 0]].add(ga)
    g = g.at[data.edge_ij[:, 1]].add(gb)
    if reduce_fn is not None:
        g = reduce_fn(g)
    return _gauge_project(g, data.node_mask)


def _block_diag(poses, data: PoseGraphData, damping, reduce_fn=None):
    """(N,3,3) block-diagonal of H (+ LM damping) for preconditioning."""
    ja, jb = edge_jacobians(poses, data)
    w = data.edge_mask.astype(poses.dtype)[:, None, None]
    info = data.edge_info * w
    ba = jnp.einsum("eki,ekl,elj->eij", ja, info, ja, precision=HIGHEST)
    bb = jnp.einsum("eki,ekl,elj->eij", jb, info, jb, precision=HIGHEST)
    blocks = jnp.zeros((poses.shape[0], 3, 3), poses.dtype)
    blocks = blocks.at[data.edge_ij[:, 0]].add(ba)
    blocks = blocks.at[data.edge_ij[:, 1]].add(bb)
    if reduce_fn is not None:
        blocks = reduce_fn(blocks)
    eye = jnp.eye(3, dtype=poses.dtype)
    return blocks + (damping + 1e-6) * eye[None]


def _pcg(poses, data: PoseGraphData, b, damping, iters: int, tol: float,
         reduce_fn=None):
    """Preconditioned CG on (H + λI) x = b with block-Jacobi preconditioner."""
    blocks = _block_diag(poses, data, damping, reduce_fn)
    pinv = jnp.linalg.inv(blocks)

    def precond(v):
        return _gauge_project(
            jnp.einsum("nij,nj->ni", pinv, v, precision=HIGHEST),
            data.node_mask)

    def matvec(v):
        return (_hvp(poses, data, v, reduce_fn)
                + damping * _gauge_project(v, data.node_mask))

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)
    bnorm = jnp.maximum(jnp.sqrt(jnp.sum(b * b)), 1e-12)

    def body(state):
        i, x, r, p, rz = state
        hp = matvec(p)
        alpha = rz / jnp.maximum(jnp.sum(p * hp), 1e-20)
        x = x + alpha * p
        r = r - alpha * hp
        z = precond(r)
        rz_new = jnp.sum(r * z)
        beta = rz_new / jnp.maximum(rz, 1e-20)
        p = z + beta * p
        return i + 1, x, r, p, rz_new

    def cond(state):
        i, x, r, p, rz = state
        return (i < iters) & (jnp.sqrt(jnp.sum(r * r)) > tol * bnorm)

    _, x, _, _, _ = jax.lax.while_loop(cond, body, (0, x0, r0, p0, rz0))
    return x


def lm_solve(data: PoseGraphData, max_iters: int = 50, cg_iters: int = 100,
             reduce_fn=None, scalar_reduce_fn=None):
    """Levenberg-Marquardt loop; ``reduce_fn``/``scalar_reduce_fn`` hook in
    cross-device psums when edges are sharded (parallel/dist_spa.py). Returns
    (poses, final_cost, iterations), fully on-device (lax.while_loop),
    Ceres-style accept/reject with adaptive damping."""
    poses0 = data.poses

    def cost_fn(poses):
        c = graph_cost(poses, data)
        return scalar_reduce_fn(c) if scalar_reduce_fn is not None else c

    def body(state):
        it, poses, lam, cost, done = state
        g = _gradient(poses, data, reduce_fn)
        step = _pcg(poses, data, -g, lam, cg_iters, 1e-6, reduce_fn)
        new_poses = poses + step
        new_poses = new_poses.at[:, 2].set(normalize_angle(new_poses[:, 2]))
        new_cost = cost_fn(new_poses)
        improved = new_cost < cost
        poses = jnp.where(improved, new_poses, poses)
        lam = jnp.where(improved, jnp.maximum(lam * 0.33, 1e-8), lam * 10.0)
        gnorm = jnp.sqrt(jnp.sum(g * g))
        converged = improved & ((cost - new_cost) < 1e-7 * (cost + 1e-12))
        converged |= gnorm < 1e-10
        cost = jnp.where(improved, new_cost, cost)
        return it + 1, poses, lam, cost, converged

    def cond(state):
        it, poses, lam, cost, done = state
        return (it < max_iters) & (~done)

    cost0 = cost_fn(poses0)
    it, poses, lam, cost, _ = jax.lax.while_loop(
        cond, body, (0, poses0, jnp.asarray(1e-4, poses0.dtype), cost0,
                     jnp.bool_(False)))
    return poses, cost, it


@partial(jax.jit, static_argnames=("max_iters", "cg_iters"))
def solve_pose_graph(data: PoseGraphData, max_iters: int = 50,
                     cg_iters: int = 100):
    """Single-device jitted SPA solve (see lm_solve)."""
    return lm_solve(data, max_iters=max_iters, cg_iters=cg_iters)


def solve_pose_graph_dense(data: PoseGraphData, max_iters: int = 50):
    """Dense-normal-equations LM (dense linear solve) — validation path and the
    fastest option for small graphs (3N x 3N fits comfortably to ~2k nodes)."""
    n = data.poses.shape[0]

    def build_h_g(poses, lam):
        r = edge_residuals(poses, data)
        ja, jb = edge_jacobians(poses, data)
        w = data.edge_mask.astype(poses.dtype)
        info = data.edge_info * w[:, None, None]
        H = jnp.zeros((n, 3, n, 3), poses.dtype)
        ia, ib = data.edge_ij[:, 0], data.edge_ij[:, 1]
        haa = jnp.einsum("eki,ekl,elj->eij", ja, info, ja, precision=HIGHEST)
        hab = jnp.einsum("eki,ekl,elj->eij", ja, info, jb, precision=HIGHEST)
        hbb = jnp.einsum("eki,ekl,elj->eij", jb, info, jb, precision=HIGHEST)
        H = H.at[ia, :, ia, :].add(haa)
        H = H.at[ia, :, ib, :].add(hab)
        H = H.at[ib, :, ia, :].add(jnp.swapaxes(hab, -1, -2))
        H = H.at[ib, :, ib, :].add(hbb)
        ir = jnp.einsum("eij,ej->ei", info, r, precision=HIGHEST)
        g = jnp.zeros_like(poses)
        g = g.at[ia].add(jnp.einsum("eji,ej->ei", ja, ir,
                                    precision=HIGHEST))
        g = g.at[ib].add(jnp.einsum("eji,ej->ei", jb, ir,
                                    precision=HIGHEST))
        Hf = H.reshape(3 * n, 3 * n)
        # gauge + padding: pin node 0 and masked nodes via unit rows/cols
        pin = ~data.node_mask
        pin = pin.at[0].set(True)
        pin3 = jnp.repeat(pin, 3)
        Hf = jnp.where(pin3[:, None] | pin3[None, :], 0.0, Hf)
        Hf = Hf + jnp.diag(jnp.where(pin3, 1.0, lam + 1e-8))
        gf = jnp.where(pin3, 0.0, g.reshape(-1))
        return Hf, gf

    poses = data.poses
    lam = 1e-4
    cost = graph_cost(poses, data)
    for _ in range(max_iters):
        Hf, gf = build_h_g(poses, lam)
        step = jnp.linalg.solve(Hf, -gf).reshape(-1, 3)
        new_poses = poses + step
        new_poses = new_poses.at[:, 2].set(normalize_angle(new_poses[:, 2]))
        new_cost = graph_cost(new_poses, data)
        if float(new_cost) < float(cost):
            poses, prev, cost = new_poses, cost, new_cost
            lam = max(lam * 0.33, 1e-8)
            if (float(prev) - float(cost)) < 1e-9 * (float(prev) + 1e-12):
                break
        else:
            lam *= 10.0
            if lam > 1e8:
                break
    return poses, cost
