"""Multi-host runtime bring-up — the roslaunch/rosmaster replacement.

The reference relied on rosmaster for discovery and roslaunch for process
supervision (SURVEY.md §5.8). On a cluster the equivalent is
`jax.distributed.initialize`: every host runs the SAME program, the runtime
wires the collectives, and the factor-sharded solver (parallel/dist) works
unchanged over a mesh spanning all hosts' devices.

Typical cluster usage:

    from graphslam.parallel import multihost
    multihost.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = multihost.global_mesh()              # all devices, all hosts
    sharded = shard_graph(graph, mesh)
    poses = dist_lm_solve(poses0, sharded, mesh)

Single-host (or CPU-mesh test) runs skip initialize() and everything still
works — the mesh just spans local devices.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the multi-host runtime. With no arguments, relies on a
    cluster environment that JAX detects (e.g. SLURM); otherwise pass the
    coordinator address, process count and this process's id. Safe to skip
    for single-host runs."""
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(axis: str = "dev") -> Mesh:
    """One flat mesh axis over every device of every host — the layout
    BASELINE.json's north star prescribes. The psum separator combines run
    over this axis."""
    return Mesh(np.array(jax.devices()), (axis,))


def is_coordinator() -> bool:
    return jax.process_index() == 0
