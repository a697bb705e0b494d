"""Device mesh helpers for stream-parallel serving.

The fleet design (SURVEY §2c): independent dashcam streams are the primary
data-parallel axis, sharded across devices with jax.sharding; an optional second
axis shards image rows *within* a frame for the stencil-heavy front half
(XLA SPMD inserts the halo exchanges for the window ops automatically).
There is no gradient/weight traffic — steady-state cross-chip communication
is only the occasional metrics psum.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def stream_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the 'stream' axis (data parallelism over streams)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("stream",))


def stream_row_mesh(n_stream: int, n_rows: int, devices=None) -> Mesh:
    """2-D mesh: streams x image-rows (spatial sharding of the stencils)."""
    if devices is None:
        devices = jax.devices()
    devices = np.asarray(devices[: n_stream * n_rows]).reshape(n_stream, n_rows)
    return Mesh(devices, axis_names=("stream", "rows"))


def shard_streams(tree, mesh: Mesh, axis: str = "stream"):
    """Place a pytree with a leading stream axis onto the mesh."""
    sharding = NamedSharding(mesh, P(axis))

    def put(x):
        spec = P(axis, *([None] * (x.ndim - 1))) if hasattr(x, "ndim") else P()
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, tree)


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (params, config constants) across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, sharding), tree)
