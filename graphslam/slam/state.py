"""SLAMState: the entire map/graph as preallocated device arrays.

Replaces the graph node's process globals (std::vector<Keyframe>,
gtsam::NonlinearFactorGraph, Values — graph.cpp:5-10) with fixed-capacity
arrays + counts, donated across steps. Growth = bumping a count and flipping
a mask bit; the step function never recompiles. int32 ids (the reference's
int8 overflowed at 127 keyframes — SURVEY.md §2.3).

Factors are stored structurally: odometry factors live in CHAIN slots —
slot k always couples keyframes (k, k+1), so the solver's scatter-free
chain fast path (FactorGraph.chain_prefix, solver/normal_eq.py) and the
chain preconditioner (solver/tridiag.py) apply to the online graph exactly
as they do to offline g2o datasets. Loop closures
keep explicit endpoint indices.
"""

from __future__ import annotations

import jax.numpy as jnp

from graphslam.config import SLAMConfig
from graphslam.pytree import pytree_dataclass


@pytree_dataclass
class SLAMState:
    # Keyframe store (the Keyframe.msg contract: id is the array index,
    # pose_opti is kf_poses; raw scans are kept as projected point buffers).
    kf_poses: jnp.ndarray   # (K, 3) optimized SE(2) poses
    kf_points: jnp.ndarray  # (K, P, 2) projected scan points (sensor frame)
    kf_masks: jnp.ndarray   # (K, P) point validity
    # Marginal covariance of each optimized pose — the Keyframe.msg
    # pose_opti covariance field (Pose2DWithCovariance.msg:2), refreshed by
    # the pipeline after solves that commit a loop closure (SLAMConfig).
    kf_covs: jnp.ndarray    # (K, 3, 3)
    num_kf: jnp.ndarray     # () int32

    # Odometry (chain) factors: slot k couples keyframes (k, k+1); slot K-1
    # is never used. The edge list is implicit.
    chain_meas: jnp.ndarray       # (K, 3)
    chain_sqrt_info: jnp.ndarray  # (K, 3, 3)
    chain_mask: jnp.ndarray       # (K,)

    # Loop-closure factors (the Factor.msg contract, struct-of-arrays).
    loop_edges: jnp.ndarray      # (F, 2) int32
    loop_meas: jnp.ndarray       # (F, 3)
    loop_sqrt_info: jnp.ndarray  # (F, 3, 3)
    loop_mask: jnp.ndarray       # (F,)
    num_loops: jnp.ndarray       # () int32

    # Anchor (prior) for keyframe 0 — graph.cpp:38-42 semantics.
    anchor: jnp.ndarray     # (3,)

    # Accumulated odometry since the last committed keyframe (the in-state
    # replacement for the odometry node's time-interval buffer queries,
    # odometry.cpp:84-116), plus its adjoint-transported covariance: the
    # same recursion as slam/odometry.py::integrate_twist, so the factor
    # noise at keyframe commit equals query_interval's transported Q between
    # the keyframe stamps exactly (the adjoint is a homomorphism).
    odom_accum: jnp.ndarray      # (3,)
    odom_cov_accum: jnp.ndarray  # (3, 3)

    @property
    def num_factors(self) -> jnp.ndarray:
        """Total committed factors (chain + loops) — every keyframe after
        the first commits exactly one odometry factor."""
        return jnp.maximum(self.num_kf - 1, 0) + self.num_loops


def init_state(cfg: SLAMConfig, dtype=jnp.float32) -> SLAMState:
    K = cfg.max_keyframes
    F = cfg.max_factors
    P = cfg.frontend.max_points
    return SLAMState(
        kf_poses=jnp.zeros((K, 3), dtype),
        kf_points=jnp.zeros((K, P, 2), dtype),
        kf_masks=jnp.zeros((K, P), bool),
        kf_covs=jnp.zeros((K, 3, 3), dtype),
        num_kf=jnp.int32(0),
        chain_meas=jnp.zeros((K, 3), dtype),
        chain_sqrt_info=jnp.zeros((K, 3, 3), dtype),
        chain_mask=jnp.zeros((K,), bool),
        loop_edges=jnp.zeros((F, 2), jnp.int32),
        loop_meas=jnp.zeros((F, 3), dtype),
        loop_sqrt_info=jnp.zeros((F, 3, 3), dtype),
        loop_mask=jnp.zeros((F,), bool),
        num_loops=jnp.int32(0),
        anchor=jnp.zeros((3,), dtype),
        odom_accum=jnp.zeros((3,), dtype),
        odom_cov_accum=jnp.zeros((3, 3), dtype),
    )
