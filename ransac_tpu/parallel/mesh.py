"""Device-mesh helpers.

The reference is single-process/single-thread (SURVEY.md §2.5: no NCCL/MPI/
threads anywhere); all parallelism in this framework is expressed through a
named ``jax.sharding.Mesh``:

- ``data``  axis: candidate cameras / keyframes / observations (DP analog)
- ``model`` axis: hypothesis blocks / map blocks / camera blocks (TP/EP
  analog)

Nothing here names a transport: XLA inserts the transfers from shardings
(NCCL between GPUs).  The GPUs of one host are joined all to all, so the
mesh shape follows the algorithm alone.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, data: int | None = None,
              model: int | None = None, devices=None) -> Mesh:
    """Build a (data, model) mesh.  Defaults: squarest factorization of the
    device count with data >= model."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if data is None or model is None:
        model = 1
        for m in range(int(np.sqrt(n)), 0, -1):
            if n % m == 0:
                model = m
                break
        data = n // model
    assert data * model == len(devices), (data, model, len(devices))
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, axis_names=("data", "model"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def sharded(mesh: Mesh, *spec) -> NamedSharding:
    return NamedSharding(mesh, P(*spec))
