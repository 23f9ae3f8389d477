"""Multi-host initialization and cluster mesh construction.

The reference has no distributed backend at all (SURVEY.md §2.5 — no
NCCL/MPI/Gloo/UCX anywhere); this module is the framework's multi-host
entry: ``jax.distributed.initialize`` + a mesh whose ``data`` axis spans
hosts (keyframes/observations partitioned per host, SURVEY.md §5
"keyframe-window partitioning") and whose ``model`` axis stays within a
host so hypothesis/map-block collectives stay on the host's links, with
only the ``data``-axis reductions (the Schur-reduced camera system psum
in parallel.dist_ba) crossing hosts.

Single-host processes degrade gracefully: ``initialize_cluster`` is a
no-op when no coordinator is configured, so every pipeline runs unchanged
from a laptop to a multi-host cluster.
"""

from __future__ import annotations

import os

import numpy as np
import jax
from jax.sharding import Mesh

from ransac_tpu.utils.logging import get_logger

log = get_logger("multihost")


def initialize_cluster(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize jax.distributed when a cluster is configured.

    Reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID when
    args are None.  Returns True if distributed mode is active.
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS")
    if coordinator_address:
        if num_processes is None:
            num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
        if process_id is None:  # 0 is a legitimate process id
            process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        log.info("distributed init: %d processes, this is %d",
                 jax.process_count(), jax.process_index())
        return True
    return False


def pod_mesh(model_axis: int | None = None) -> Mesh:
    """Global (data, model) mesh over every attached device.

    ``model`` spans devices *within* a host (host-local collectives for
    hypothesis blocks / map blocks); ``data`` spans the rest, crossing
    hosts only for the small reduced systems.
    """
    devices = jax.devices()
    n = len(devices)
    local = max(jax.local_device_count(), 1)
    if model_axis is None:
        model_axis = local
        while n % model_axis != 0 and model_axis > 1:
            model_axis //= 2
    data_axis = n // model_axis
    arr = np.array(devices).reshape(data_axis, model_axis)
    return Mesh(arr, axis_names=("data", "model"))


def is_primary() -> bool:
    return jax.process_index() == 0
