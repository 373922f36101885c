"""Distributed SPA: pose-graph Gauss-Newton over a sharded edge set.

The BASELINE.json north star component: edges (residual blocks) are
partitioned across the ``graph`` mesh axis; every device runs the identical
LM/PCG iteration on its edge shard, and the normal-equation pieces —
gradient, block-Jacobi diagonal, and each CG Hessian-vector product — are
``psum``-reduced across the axis. Node state (poses, CG vectors) is
replicated, so after every psum all devices advance in lockstep. The four
cards of a host are joined all-to-all by NVLink, so the edge shards need no
placement: the mesh follows the algorithm.

The math is identical to backend/spa.py (same lm_solve), which is the
correctness anchor: tests assert sharded == single-device bitwise-close.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
try:
    from jax import shard_map as _shard_map
    _NOCHECK = {"check_vma": False}
except ImportError:  # older jax
    from jax.experimental.shard_map import shard_map as _shard_map
    _NOCHECK = {"check_rep": False}

from ..backend.spa import PoseGraphData, lm_solve


def pad_edges_to(data: PoseGraphData, multiple: int) -> PoseGraphData:
    e = data.edge_ij.shape[0]
    target = ((e + multiple - 1) // multiple) * multiple
    if target == e:
        return data
    pad = target - e
    return data._replace(
        edge_ij=jnp.pad(data.edge_ij, ((0, pad), (0, 0))),
        edge_rel=jnp.pad(data.edge_rel, ((0, pad), (0, 0))),
        edge_info=jnp.pad(data.edge_info, ((0, pad), (0, 0), (0, 0))),
        edge_mask=jnp.pad(data.edge_mask, (0, pad)),
    )


def solve_pose_graph_sharded(data: PoseGraphData, mesh: Mesh,
                             axis: str = "graph", max_iters: int = 50,
                             cg_iters: int = 100):
    """Run the LM solve with edges sharded across ``axis``.

    Returns (poses, cost, iters) — identical (up to float reduction order)
    to the single-device ``solve_pose_graph``.
    """
    n_shards = mesh.shape[axis]
    data = pad_edges_to(data, n_shards)

    @partial(
        _shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P(), P()),
        **_NOCHECK,
    )
    def _solve(poses, node_mask, eij, erel, einfo, emask):
        local = PoseGraphData(poses=poses, node_mask=node_mask,
                              edge_ij=eij, edge_rel=erel,
                              edge_info=einfo, edge_mask=emask)
        reduce_fn = lambda x: jax.lax.psum(x, axis)
        return lm_solve(local, max_iters=max_iters, cg_iters=cg_iters,
                        reduce_fn=reduce_fn, scalar_reduce_fn=reduce_fn)

    return jax.jit(_solve)(data.poses, data.node_mask, data.edge_ij,
                           data.edge_rel, data.edge_info, data.edge_mask)
