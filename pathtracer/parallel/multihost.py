"""Multi-host initialization and global mesh construction.

The reference has no inter-device story at all (SURVEY.md §2.3: its whole
"communication backend" is single-device OpenCL queue traffic). Here:
`jax.distributed.initialize` across processes, one global Mesh over every
GPU, scene arrays replicated, pixels sharded, psum for sample partials and
gradients (render_dist.py, diff/grad.py), which XLA hands to NCCL over
NVLink within a host. The network between hosts only carries the initial
rendezvous and the final host gather.
"""
from __future__ import annotations

import logging
from typing import Optional, Tuple

import jax

from .mesh import make_mesh

log = logging.getLogger("pathtracer")


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the jax.distributed cluster. Pass the coordinator address
    (host:port of process 0), the process count and this process's id:
    nothing in a plain GPU host announces a cluster, so they do not
    auto-detect. Call once per process, before any backend use."""
    kw = {}
    if coordinator_address is not None:
        kw["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kw["num_processes"] = num_processes
    if process_id is not None:
        kw["process_id"] = process_id
    jax.distributed.initialize(**kw)
    log.info(
        "distributed: process %d/%d, %d local / %d global devices",
        jax.process_index(), jax.process_count(),
        jax.local_device_count(), jax.device_count(),
    )


def global_render_mesh(shape: Optional[Tuple[int, int]] = None):
    """Mesh over every device of the cluster (call initialize_multihost
    first on multi-host). Axes ('pixels', 'spp'); the spp psum is a NCCL
    all-reduce."""
    return make_mesh(jax.devices(), shape=shape)
