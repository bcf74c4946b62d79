"""Device mesh and sharding helpers.

The framework's parallelism model (SURVEY.md §2.4): the unit of parallelism
is *audio streams*.  All device tensors carry a leading [batch] axis sharded
over the mesh's 'data' axis (pure DP — the only parallelism this domain
rewards); the 'model' axis is available for channel/filterbank sharding of
very wide configurations.  The cards of one host are joined all to all, so
the mesh's shape follows the algorithm alone.

Collectives are whatever XLA inserts for the chosen shardings (psum for
metric reductions in BatchDecoder.stats) — no hand-rolled transport layer.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              model: int = 1, devices: Optional[Sequence] = None) -> Mesh:
    """Create a ('data', 'model') mesh over the first n_devices devices of
    ``devices`` (default: the default platform's).  Raises when there are
    too few; it never substitutes devices of another platform (a mesh of
    virtual CPU devices is built by passing ``jax.devices("cpu")``)."""
    devs = list(devices) if devices is not None else jax.devices()
    n = n_devices or len(devs)
    data = data or (n // model)
    if data * model > len(devs) or n > len(devs):
        raise ValueError(
            f"make_mesh needs {max(n, data * model)} devices, "
            f"{len(devs)} {devs[0].platform if devs else ''} devices exist")
    arr = np.array(devs[: data * model]).reshape(data, model)
    return Mesh(arr, ("data", "model"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading stream-batch axis over 'data'."""
    return NamedSharding(mesh, P("data"))


def batch_channel_sharding(mesh: Mesh, ndim: int, channel_axis: int = 2
                           ) -> NamedSharding:
    """Batch on 'data', channel axis on 'model', rest replicated."""
    spec = [None] * ndim
    spec[0] = "data"
    if channel_axis < ndim:
        spec[channel_axis] = "model"
    return NamedSharding(mesh, P(*spec))


def shard_batch(tree, mesh: Mesh):
    """Place every leaf's leading axis across 'data'."""
    sh = batch_sharding(mesh)

    def place(x):
        spec = P(*(["data"] + [None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(place, tree)
