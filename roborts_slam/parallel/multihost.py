"""Multi-host runtime setup + scaling harness.

The reference has no multi-process story at all (one process, four threads,
SURVEY §1); this layer is the net-new scale-out path: ``jax.distributed``
across processes, one global ``Mesh`` whose ``data`` (batch fan-out) and
``graph`` (pose-graph edge sharding) axes span every device. The four cards
of one host are joined all-to-all by NVLink, so no device pair is closer
than another: the mesh follows the algorithm, with the ``graph`` axis
carrying the per-CG-iteration psums of the distributed SPA solve.

Testable without GPUs: ``local_mesh(n)`` fakes N devices on CPU via
``--xla_force_host_platform_device_count`` (tests/conftest.py), and
``scaling_run`` measures the same sharded programs at 1..N devices for the
BASELINE.md scaling-efficiency bound.
"""

from __future__ import annotations

import dataclasses
import time

import jax
import numpy as np
from jax.sharding import Mesh

from .dist_spa import solve_pose_graph_sharded
from .mesh import make_mesh


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None) -> None:
    """Bring up the multi-host runtime (jax.distributed.initialize). Pass
    the coordinator address, process count and id explicitly (nothing on a
    plain GPU host announces a cluster); no-ops when single-process
    args are absent and env autodetection finds nothing. On the CPU backend
    cross-process collectives need the gloo transport (the multi-process
    test path, SURVEY §4: multi-host tests on CPU)."""
    # must not touch the backend before jax.distributed.initialize (even
    # jax.default_backend() would initialise XLA), so set unconditionally;
    # the option only affects the CPU backend
    try:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    except Exception:
        pass  # older jax without the option
    if coordinator_address is None and num_processes is None:
        try:
            jax.distributed.initialize()
        except Exception:
            return  # single-process run
    else:
        jax.distributed.initialize(coordinator_address=coordinator_address,
                                   num_processes=num_processes,
                                   process_id=process_id)


def global_mesh(data_axis: int | None = None,
                graph_axis: int | None = None) -> Mesh:
    """2D (data, graph) mesh over all global devices. ``graph`` (the
    latency-sensitive psum axis) takes the devices of one process; ``data``
    spans the processes."""
    devs = np.array(jax.devices())
    n = len(devs)
    if graph_axis is None:
        graph_axis = min(n, max(1, n // max(jax.process_count(), 1)))
    if data_axis is None:
        data_axis = n // graph_axis
    assert data_axis * graph_axis == n, (data_axis, graph_axis, n)
    return Mesh(devs.reshape(data_axis, graph_axis), ("data", "graph"))


@dataclasses.dataclass
class ScalingPoint:
    n_devices: int
    seconds: float
    throughput: float
    efficiency: float   # vs 1-device throughput x n


def scaling_run(work_fn, sizes: list[int], reps: int = 3) -> list[ScalingPoint]:
    """Measure ``work_fn(mesh) -> items_done`` at growing device counts.
    ``work_fn`` must submit the same total work regardless of mesh size
    (strong scaling) and block until complete."""
    points = []
    base = None
    for n in sizes:
        mesh = make_mesh(n)
        work_fn(mesh)                      # compile + warm
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            items = work_fn(mesh)
            times.append(time.perf_counter() - t0)
        sec = float(np.median(times))
        thr = items / sec
        if base is None:
            base = thr
        points.append(ScalingPoint(
            n_devices=n, seconds=sec, throughput=thr,
            efficiency=thr / (base * n)))
    return points


def make_synthetic_loop_graph(n_nodes: int, noise: float = 0.05,
                              loop_frac: float = 0.25, radius: float = 10.0,
                              seed: int = 0):
    """Noisy circular pose graph (odometry chain + random loop edges) with
    exact relative-pose constraints — the standard distributed-SPA
    benchmark/demo workload. Returns a PoseGraphData."""
    import jax.numpy as jnp

    from ..backend.spa import PoseGraphData

    rng = np.random.default_rng(seed)
    theta = np.linspace(0, 2 * np.pi, n_nodes, endpoint=False)
    gt = np.stack([radius * np.cos(theta), radius * np.sin(theta),
                   theta + np.pi / 2], -1)
    noisy = gt + rng.normal(0, noise, gt.shape)
    noisy[0] = gt[0]
    eij = [(i, (i + 1) % n_nodes) for i in range(n_nodes)]
    for _ in range(int(n_nodes * loop_frac)):
        i, j = sorted(rng.integers(0, n_nodes, 2))
        if j - i > 2:
            eij.append((i, j))
    eij = np.array(eij, np.int64)

    def rel(a, b):
        d = b - a
        c, s = np.cos(a[2]), np.sin(a[2])
        return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                         np.arctan2(np.sin(d[2]), np.cos(d[2]))])

    erel = np.stack([rel(gt[i], gt[j]) for i, j in eij])
    return PoseGraphData(
        poses=jnp.asarray(noisy, jnp.float32),
        node_mask=jnp.ones(n_nodes, bool),
        edge_ij=jnp.asarray(eij, jnp.int32),
        edge_rel=jnp.asarray(erel, jnp.float32),
        edge_info=jnp.broadcast_to(
            jnp.eye(3, dtype=jnp.float32) * 20.0, (eij.shape[0], 3, 3)),
        edge_mask=jnp.ones(eij.shape[0], bool),
    )


def spa_scaling_workload(n_nodes: int = 512, seed: int = 0,
                         max_iters: int = 10, cg_iters: int = 25):
    """Returns work_fn for scaling_run: a fixed loop pose graph solved with
    edges sharded over the mesh axis (the distributed-SPA benchmark)."""
    data = make_synthetic_loop_graph(n_nodes, seed=seed)

    def work_fn(mesh):
        p, c, it = solve_pose_graph_sharded(data, mesh, axis=mesh.axis_names[0],
                                            max_iters=max_iters,
                                            cg_iters=cg_iters)
        jax.block_until_ready((p, c, it))
        return data.edge_ij.shape[0] * max_iters   # edge-iterations done
    return work_fn
