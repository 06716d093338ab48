"""Chordal initialization for SE(2) and SE(3) pose graphs.

Odometry-integrated initial guesses accumulate unbounded heading drift; when
it exceeds ~90 deg, Gauss-Newton basins stop containing the global optimum.
The standard cure (Carlone et al.) is a two-stage LINEAR bootstrap:

  1. Rotation averaging in chordal coordinates: each node's heading is a
     unit vector x_i = (cos t_i, sin t_i); an edge with measured rotation
     t_z gives the linear residual  G(t_z) x_i - x_j  (G = 2x2 rotation).
     One anchored linear least-squares over all headings.
  2. Translation recovery: with headings fixed, t_j ~ t_i + R(t_i) t_z is
     linear in positions — a second anchored least-squares.

Both systems reuse the solver's block machinery (BlockSystem + PCG with the
chain preconditioner) at T=2 — the pipeline stays matrix-free and jitted.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from graphslam.factors.graph import FactorGraph
from graphslam.geometry import se3, so2, so3
from graphslam.solver.normal_eq import BlockSystem, pcg_solve


def _linear_system(
    edges, G_blocks, rhs_e, num_poses, anchor_val, anchor_w, chain_prefix, w
):
    """Normal equations for  sum_e ||G_e x_i - x_j - rhs_e||^2  with an
    anchor on node 0, phrased as a BlockSystem (T=2) for pcg_solve.

    For edge e: Ji = G_e, Jj = -I, r0_e = -rhs_e (residual at x=0); solving
    the normal equations from x=0 gives the global optimum of the linear
    problem directly. Works for any block size T."""
    E = edges.shape[0]
    T = G_blocks.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(T, dtype=G_blocks.dtype), (E, T, T))
    Ji = G_blocks * w[:, None, None]
    Jj = -eye * w[:, None, None]
    # Hessian blocks.
    Aii = jnp.einsum("eki,ekj->eij", Ji, Ji)
    Aij = jnp.einsum("eki,ekj->eij", Ji, Jj)
    Ajj = jnp.einsum("eki,ekj->eij", Jj, Jj)
    # Gradient at x=0: J^T r0 with r0 = -rhs.
    gi = jnp.einsum("eki,ek->ei", Ji, -rhs_e)
    gj = jnp.einsum("eki,ek->ei", Jj, -rhs_e)

    i_idx, j_idx = edges[:, 0], edges[:, 1]
    g = jnp.zeros((num_poses, T), G_blocks.dtype)
    g = g.at[i_idx].add(gi).at[j_idx].add(gj)
    diag = jnp.zeros((num_poses, T, T), G_blocks.dtype)
    diag = diag.at[i_idx].add(Aii).at[j_idx].add(Ajj)

    # Anchor node 0 at anchor_val with weight anchor_w.
    diag = diag.at[0].add(anchor_w * jnp.eye(T, dtype=G_blocks.dtype))
    g = g.at[0].add(-anchor_w * anchor_val)

    sys = BlockSystem(Aii=Aii, Aij=Aij, Ajj=Ajj, diag=diag, g=g, edges=edges)
    return sys


def chordal_init_se2(graph: FactorGraph, num_poses: int, cg_iters: int = 150):
    """Initial SE(2) poses (N, 3) from the two-stage linear bootstrap."""
    z = graph.measurements
    w = jnp.where(graph.edge_mask, 1.0, 0.0)
    edges = graph.edges

    # --- stage 1: headings -------------------------------------------------
    G = so2.rotmat(z[:, 2])
    rhs = jnp.zeros((edges.shape[0], 2), z.dtype)
    sys = _linear_system(
        edges, G, rhs, num_poses,
        anchor_val=jnp.array([1.0, 0.0], z.dtype), anchor_w=100.0,
        chain_prefix=graph.chain_prefix, w=w,
    )
    x = pcg_solve(
        sys, jnp.asarray(0.0, z.dtype),
        max_iters=cg_iters, tol=1e-8,
        lm_diag_scaling=False, preconditioner="tridiag",
        chain_prefix=graph.chain_prefix,
    )
    theta = jnp.arctan2(x[:, 1], x[:, 0])

    # --- stage 2: positions ------------------------------------------------
    # t_j = t_i + R(theta_i) t_z  ->  residual I t_i - t_j - (-R(theta_i) t_z).
    eye2 = jnp.broadcast_to(jnp.eye(2, dtype=z.dtype), (edges.shape[0], 2, 2))
    rhs_t = -so2.rotate(theta[edges[:, 0]], z[:, :2]) * w[:, None]
    sys_t = _linear_system(
        edges, eye2, rhs_t, num_poses,
        anchor_val=jnp.zeros(2, z.dtype), anchor_w=100.0,
        chain_prefix=graph.chain_prefix, w=w,
    )
    t = pcg_solve(
        sys_t, jnp.asarray(0.0, z.dtype),
        max_iters=cg_iters, tol=1e-8,
        lm_diag_scaling=False, preconditioner="tridiag",
        chain_prefix=graph.chain_prefix,
    )
    return jnp.concatenate([t, theta[:, None]], axis=-1)


def chordal_init_se3(graph: FactorGraph, num_poses: int, cg_iters: int = 150):
    """Initial SE(3) poses (N, 12) from the chordal bootstrap.

    Rotations: R_j ~ R_i Rz means each ROW of R satisfies row_j = Rz^T row_i
    — three INDEPENDENT T=3 linear problems (solved as one vmap) followed by
    a polar projection back onto SO(3). Translations: t_j ~ t_i + R_i t_z is
    linear given rotations."""
    z = graph.measurements
    w = jnp.where(graph.edge_mask, 1.0, 0.0)
    edges = graph.edges
    Rz = se3.rot(z)
    tz = se3.trans(z)
    dt = z.dtype

    # --- rotations: one T=3 system per row of R, vmapped over rows --------
    G = jnp.swapaxes(Rz, -1, -2)  # row_j = Rz^T row_i
    rhs0 = jnp.zeros((edges.shape[0], 3), dt)
    anchors = jnp.eye(3, dtype=dt)  # rows of R_0 = I

    def solve_row(anchor_val):
        sys = _linear_system(
            edges, G, rhs0, num_poses,
            anchor_val=anchor_val, anchor_w=100.0,
            chain_prefix=graph.chain_prefix, w=w,
        )
        return pcg_solve(
            sys, jnp.asarray(0.0, dt),
            max_iters=cg_iters, tol=1e-8,
            lm_diag_scaling=False, preconditioner="tridiag",
            chain_prefix=graph.chain_prefix,
        )

    rows = jax.vmap(solve_row)(anchors)          # (3, N, 3)
    R_raw = jnp.transpose(rows, (1, 0, 2))       # (N, 3, 3) rows stacked
    R = so3.project(R_raw)                       # SVD projection onto SO(3)

    # --- translations ------------------------------------------------------
    eye3 = jnp.broadcast_to(jnp.eye(3, dtype=dt), (edges.shape[0], 3, 3))
    Ri = R[edges[:, 0]]
    rhs_t = -(Ri @ tz[..., None])[..., 0] * w[:, None]
    sys_t = _linear_system(
        edges, eye3, rhs_t, num_poses,
        anchor_val=jnp.zeros(3, dt), anchor_w=100.0,
        chain_prefix=graph.chain_prefix, w=w,
    )
    t = pcg_solve(
        sys_t, jnp.asarray(0.0, dt),
        max_iters=cg_iters, tol=1e-8,
        lm_diag_scaling=False, preconditioner="tridiag",
        chain_prefix=graph.chain_prefix,
    )
    return se3.make(R, t)
