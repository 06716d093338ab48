"""Normal-equation assembly and solves for the pose-graph optimizer.

From a `Linearization` (whitened per-factor blocks) we form the damped
Gauss-Newton system  (H + lambda*D) dx = -g  where

  H = sum_e [Ji Jj]^T [Ji Jj]  +  sum_p Jp^T Jp        (block-sparse, TxT blocks)
  g = sum_e [Ji Jj]^T r        +  sum_p Jp^T rp

Two backends (SURVEY.md §7.2):

  * dense_solve — scatter the blocks into the full (N*T, N*T) matrix and
    Cholesky it. Right for small graphs, and the reference for tests.

  * pcg_solve — never materialize H. The operator H@v is three einsums over
    the per-edge blocks plus two segment-sums (gather/scatter along edges) —
    entirely dense, static-shape ops. Preconditioned with the inverted
    block diagonal (block-Jacobi). This is the path that scales to
    city10000+ and shards over the device mesh (parallel/).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from graphslam.factors.graph import FactorGraph
from graphslam.factors.linearize import Linearization


class BlockSystem(NamedTuple):
    """Gauss-Newton system in edge-block form.

    Aii, Aij, Ajj (E, T, T): per-edge Hessian contributions
      Aii = Ji^T Ji, Aij = Ji^T Jj, Ajj = Jj^T Jj
    diag (N, T, T): assembled block diagonal of H (including priors)
    g    (N, T):    gradient J^T r
    edges (E, 2)
    """

    Aii: jnp.ndarray
    Aij: jnp.ndarray
    Ajj: jnp.ndarray
    diag: jnp.ndarray
    g: jnp.ndarray
    edges: jnp.ndarray


def build_blocks(lin: Linearization, graph: FactorGraph, num_poses: int) -> BlockSystem:
    """Edge-block Hessian + gradient from a linearization. One shot of
    einsums and segment-sums — the vmapped replacement for GTSAM's
    per-factor HessianFactor assembly. Chain-prefix edges (k, k+1) assemble
    with static slice-adds; only the loop edges pay for a scatter."""
    Ji, Jj, r = lin.Ji, lin.Jj, lin.r
    Aii = jnp.einsum("eki,ekj->eij", Ji, Ji)
    Aij = jnp.einsum("eki,ekj->eij", Ji, Jj)
    Ajj = jnp.einsum("eki,ekj->eij", Jj, Jj)
    gi = jnp.einsum("eki,ek->ei", Ji, r)
    gj = jnp.einsum("eki,ek->ei", Jj, r)

    T = r.shape[-1]
    c = min(graph.chain_prefix, num_poses - 1)

    g = jnp.zeros((num_poses, T), r.dtype)
    diag = jnp.zeros((num_poses, T, T), r.dtype)
    if c > 0:
        g = g.at[:c].add(gi[:c]).at[1 : c + 1].add(gj[:c])
        diag = diag.at[:c].add(Aii[:c]).at[1 : c + 1].add(Ajj[:c])
    i_idx = graph.edges[c:, 0]
    j_idx = graph.edges[c:, 1]
    if i_idx.shape[0] > 0:
        g = g.at[i_idx].add(gi[c:]).at[j_idx].add(gj[c:])
        diag = diag.at[i_idx].add(Aii[c:]).at[j_idx].add(Ajj[c:])

    # Priors contribute only to the diagonal and gradient.
    Ap = jnp.einsum("pki,pkj->pij", lin.Jp, lin.Jp)
    gp = jnp.einsum("pki,pk->pi", lin.Jp, lin.rp)
    diag = diag.at[graph.prior_idx].add(Ap)
    g = g.at[graph.prior_idx].add(gp)

    return BlockSystem(Aii=Aii, Aij=Aij, Ajj=Ajj, diag=diag, g=g, edges=graph.edges)


def _damped_diag(sys: BlockSystem, lam: jnp.ndarray, lm_diag_scaling: bool):
    """LM damping: lambda * diag(H) (Marquardt) or lambda * I."""
    T = sys.diag.shape[-1]
    eye = jnp.eye(T, dtype=sys.diag.dtype)
    if lm_diag_scaling:
        d = jnp.einsum("nii->ni", sys.diag)
        return sys.diag + lam * d[..., None] * eye
    return sys.diag + lam * eye


# ---------------------------------------------------------------------------
# Dense backend
# ---------------------------------------------------------------------------


def assemble_dense(
    sys: BlockSystem,
    lam: jnp.ndarray,
    lm_diag_scaling: bool = True,
) -> jnp.ndarray:
    """Scatter the edge blocks into the full (N*T, N*T) damped Hessian."""
    N, T = sys.g.shape
    H = jnp.zeros((N, T, N, T), sys.g.dtype)
    i_idx, j_idx = sys.edges[:, 0], sys.edges[:, 1]
    H = H.at[i_idx, :, i_idx, :].add(sys.Aii)
    H = H.at[j_idx, :, j_idx, :].add(sys.Ajj)
    H = H.at[i_idx, :, j_idx, :].add(sys.Aij)
    H = H.at[j_idx, :, i_idx, :].add(jnp.swapaxes(sys.Aij, -1, -2))
    # Replace the block diagonal with the (prior-inclusive, damped) one.
    idx = jnp.arange(N)
    H = H.at[idx, :, idx, :].set(_damped_diag(sys, lam, lm_diag_scaling))
    Hf = H.reshape(N * T, N * T)
    return Hf + 1e-10 * jnp.eye(N * T, dtype=Hf.dtype)


def dense_solve(
    sys: BlockSystem,
    lam: jnp.ndarray,
    lm_diag_scaling: bool = True,
) -> jnp.ndarray:
    """Assemble the full damped Hessian and Cholesky-solve.

    Returns dx (N, T) minimizing the damped quadratic model.
    """
    N, T = sys.g.shape
    Hf = assemble_dense(sys, lam, lm_diag_scaling)
    L = jnp.linalg.cholesky(Hf)
    rhs = -sys.g.reshape(N * T)
    y = jax.scipy.linalg.solve_triangular(L, rhs, lower=True)
    dx = jax.scipy.linalg.solve_triangular(L.T, y, lower=False)
    return dx.reshape(N, T)


# ---------------------------------------------------------------------------
# Matrix-free PCG backend
# ---------------------------------------------------------------------------


def hvp(
    sys: BlockSystem,
    damped_diag: jnp.ndarray,
    v: jnp.ndarray,
    chain_prefix: int = 0,
) -> jnp.ndarray:
    """(H + damping) @ v without materializing H.

    Chain-prefix edges contribute through shifted slices (scatter-free);
    remaining (loop) edges gather endpoint tangents, multiply the TxT edge
    blocks, and scatter-add back.
    """
    out = jnp.einsum("nij,nj->ni", damped_diag, v)
    c = min(chain_prefix, v.shape[0] - 1)
    if c > 0:
        A = sys.Aij[:c]
        out = out.at[:c].add(jnp.einsum("eij,ej->ei", A, v[1 : c + 1]))
        out = out.at[1 : c + 1].add(jnp.einsum("eji,ej->ei", A, v[:c]))
    i_idx, j_idx = sys.edges[c:, 0], sys.edges[c:, 1]
    if i_idx.shape[0] > 0:
        Al = sys.Aij[c:]
        out = out.at[i_idx].add(jnp.einsum("eij,ej->ei", Al, v[j_idx]))
        out = out.at[j_idx].add(jnp.einsum("eji,ej->ei", Al, v[i_idx]))
    return out


def _inv3x3(A: jnp.ndarray) -> jnp.ndarray:
    """Closed-form cofactor inverse of batched 3x3 SPD blocks — pure
    elementwise work instead of a batched Cholesky."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    row0 = jnp.stack([co00, co01, co02], axis=-1)
    row1 = jnp.stack([co01, co11, co12], axis=-1)
    row2 = jnp.stack([co02, co12, co22], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) * inv_det[..., None, None]


def _block_inv(blocks: jnp.ndarray) -> jnp.ndarray:
    """Batched SPD TxT inverse: closed forms for T=2/3; for T=6, blockwise
    Schur complement built on the 3x3 closed form."""
    T = blocks.shape[-1]
    eye = jnp.broadcast_to(jnp.eye(T, dtype=blocks.dtype), blocks.shape)
    A = blocks + 1e-8 * eye
    if T == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        det = a * d - b * c
        inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
        row0 = jnp.stack([d, -b], axis=-1)
        row1 = jnp.stack([-c, a], axis=-1)
        return jnp.stack([row0, row1], axis=-2) * inv_det[..., None, None]
    if T == 3:
        return _inv3x3(A)
    if T == 6:
        # [[P, Q], [Q^T, S]]^-1 via Schur complement of S.
        P = A[..., :3, :3]
        Q = A[..., :3, 3:]
        S = A[..., 3:, 3:]
        S_inv = _inv3x3(S)
        QSi = Q @ S_inv
        schur = P - QSi @ jnp.swapaxes(Q, -1, -2)
        TL = _inv3x3(schur)
        TR = -TL @ QSi
        BR = S_inv - jnp.swapaxes(QSi, -1, -2) @ TR
        top = jnp.concatenate([TL, TR], axis=-1)
        bottom = jnp.concatenate([jnp.swapaxes(TR, -1, -2), BR], axis=-1)
        return jnp.concatenate([top, bottom], axis=-2)
    L = jnp.linalg.cholesky(A)
    Linv = jax.scipy.linalg.solve_triangular(
        L, jnp.broadcast_to(jnp.eye(T, dtype=A.dtype), A.shape), lower=True
    )
    return jnp.einsum("nki,nkj->nij", Linv, Linv)


@partial(
    jax.jit,
    static_argnames=("max_iters", "lm_diag_scaling", "preconditioner", "chain_prefix"),
)
def pcg_solve(
    sys: BlockSystem,
    lam: jnp.ndarray,
    max_iters: int = 250,
    tol: float = 1e-8,
    lm_diag_scaling: bool = True,
    preconditioner: str = "tridiag",
    chain_prefix: int = 0,
) -> jnp.ndarray:
    """Preconditioned CG on (H + damping) dx = -g.

    preconditioner:
      * "tridiag" — solve the full block-tridiagonal (odometry-chain) part of
        H each iteration via cyclic reduction (solver/tridiag.py). Captures
        the chain's long-range modes; typically cuts CG iterations several-
        fold on chain-dominated SLAM graphs.
      * "jacobi"  — inverted block diagonal only.
    """
    from graphslam.solver.tridiag import cr_factor, cr_solve, chain_offdiag

    damped = _damped_diag(sys, lam, lm_diag_scaling)
    b = -sys.g

    if preconditioner == "tridiag" and sys.g.shape[0] > 1:
        U = chain_offdiag(sys.edges, sys.Aij, sys.g.shape[0])
        factor = cr_factor(damped, U)

        def precond(r):
            return cr_solve(factor, r)

    else:
        Minv = _block_inv(damped)

        def precond(r):
            return jnp.einsum("nij,nj->ni", Minv, r)

    x = jnp.zeros_like(b)
    r = b
    z = precond(r)
    p = z
    rz = jnp.vdot(r, z)
    b_norm2 = jnp.vdot(b, b)
    thresh = tol * tol * b_norm2

    def cond(state):
        _, r, _, _, k = state
        return (k < max_iters) & (jnp.vdot(r, r) > thresh)

    def body(state):
        x, r, p, rz, k = state
        Ap = hvp(sys, damped, p, chain_prefix)
        alpha = rz / jnp.maximum(jnp.vdot(p, Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.maximum(rz, 1e-30)
        p = z + beta * p
        return x, r, p, rz_new, k + 1

    x, _, _, _, _ = jax.lax.while_loop(cond, body, (x, r, p, rz, jnp.int32(0)))
    return x
