"""Worker for the multi-process distributed test (tests/test_multihost.py).

Run as:  python tests/_multihost_worker.py <process_id> <num_procs> <port> <out.npy>

Each process exposes 2 virtual CPU devices; jax.distributed wires them into
one 2*num_procs-device runtime — the same bring-up a multi-host cluster uses
(parallel/multihost.py, replacing the reference's rosmaster/roslaunch,
src/common/launch/fingers-crossed-go-baby-go.launch:3-8).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2"
).strip()
os.environ.setdefault("JAX_ENABLE_X64", "0")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402


def main():
    pid, nproc, port, out_path = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    )
    from graphslam.parallel import multihost

    multihost.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    assert jax.process_count() == nproc
    assert len(jax.devices()) == 2 * nproc, jax.devices()

    from graphslam.config import SolverConfig
    from graphslam.factors import from_dataset
    from graphslam.io import datasets
    from graphslam.parallel import dist_lm_solve, shard_graph

    mesh = multihost.global_mesh()
    data = datasets.manhattan(n_poses=200, loop_prob=0.2, seed=7)
    graph = from_dataset(data)
    poses0 = jnp.asarray(data["poses"])
    cfg = SolverConfig(cg_max_iterations=25)

    sharded = shard_graph(graph, mesh)
    out = dist_lm_solve(poses0, sharded, mesh, cfg, iterations=5)
    # out_specs=P() -> fully replicated: every process holds the whole array.
    local = np.asarray(out.addressable_shards[0].data)
    if pid == 0:
        np.save(out_path, local)
    jax.distributed.shutdown()


if __name__ == "__main__":
    main()
