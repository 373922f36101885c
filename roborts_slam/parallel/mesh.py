"""Device mesh helpers.

The reference has no distributed runtime (4 mutex-guarded threads in one
process, SURVEY §2); this layer is the net-new scaling story:
a ``jax.sharding.Mesh`` whose axes carry

- ``data``  — batch fan-out: chain matches, loop-closure candidate scoring,
  throughput batching of scans (DP analog);
- ``graph`` — pose-graph edge sharding for the distributed SPA solve with
  psum-reduced normal equations (the SP/CP analog per SURVEY §5: the
  trajectory is the "sequence" being partitioned).

On the four GPUs of one host (joined all-to-all by NVLink) the mesh follows
the algorithm; for multi-host, ``jax.distributed.initialize`` + the same
mesh spans hosts.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis_name,))


def make_mesh_2d(n_data: int, n_graph: int) -> Mesh:
    devs = np.array(jax.devices()[: n_data * n_graph]).reshape(n_data, n_graph)
    return Mesh(devs, ("data", "graph"))


def shard_batch(mesh: Mesh, tree, axis_name: str = "data"):
    """Place a pytree with leading-dim batch sharding over ``axis_name``."""
    sharding = NamedSharding(mesh, P(axis_name))
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def replicate(mesh: Mesh, tree):
    sharding = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, sharding), tree)


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0,
                    fill=0):
    n = arr.shape[axis]
    target = ((n + multiple - 1) // multiple) * multiple
    if target == n:
        return arr
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - n)
    return np.pad(arr, pad, constant_values=fill)
