"""Multi-chip / multi-host scaling of the pose-graph optimizer.

The reference's 'distributed backend' was three single-threaded ROS processes
on one machine (SURVEY.md §2.4). The replacement: a `jax.sharding.Mesh`
over all devices, factors sharded across devices, poses replicated (a
100k-pose SE(3) state is <6 MB — factor work dominates), and the separator
systems of SURVEY.md §2.4 combined with `psum` inside `shard_map`. Two
solver families share that layout: `dist` (factor-sharded GN/LM with a
distributed PCG) and `dist_schur` (pose-partitioned Schur reduction).
"""

from graphslam.parallel.dist import (  # noqa: F401
    make_mesh,
    shard_graph,
    dist_gn_solve,
    dist_lm_solve,
)
