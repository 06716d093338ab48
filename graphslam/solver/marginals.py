"""Marginal covariance recovery — gtsam::Marginals::marginalCovariance.

The reference computed (well, commented out — graph.cpp:120,126-127) the
per-keyframe marginal covariance after each solve. Three paths:

  * dense  — invert the full Hessian via Cholesky and read the diagonal
    blocks; one dense factorization, right for graphs that fit dense.
  * cg     — for selected poses on large graphs: solve H x = e_k for the T
    canonical columns of each requested pose with the same preconditioned CG
    machinery the optimizer uses; the T solves run as one batched CG with a
    (N*T, T) block rhs.
  * all    — ALL-pose marginals at city10000 scale
    (marginal_covariances_all): Takahashi-style selected inverse of the
    block-tridiagonal (odometry-chain + prior) part via forward/backward
    Schur recursions, corrected for loop closures with one Woodbury
    identity — the only dense object is the (T*L, T*L) loop capacitance,
    factored once. Exact (up to f32), no sampling.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from graphslam.config import SolverConfig
from graphslam.factors.graph import FactorGraph
from graphslam.factors.linearize import linearize
from graphslam.solver.normal_eq import (
    BlockSystem,
    _block_inv,
    _damped_diag,
    assemble_dense,
    build_blocks,
    hvp,
)


def marginal_covariances_dense(poses: jnp.ndarray, graph: FactorGraph) -> jnp.ndarray:
    """(N, T, T) marginal covariance of every pose, dense path."""
    lin = linearize(poses, graph)
    sys = build_blocks(lin, graph, poses.shape[0])
    N, T = sys.g.shape
    Hf = assemble_dense(sys, jnp.asarray(0.0, poses.dtype), lm_diag_scaling=False)
    cov = jnp.linalg.inv(Hf)
    return cov.reshape(N, T, N, T)[jnp.arange(N), :, jnp.arange(N), :]


def _chain_prior_system(poses, graph: FactorGraph):
    """(D0, U, loop data) — the block-tridiagonal chain+prior part of H and
    the whitened loop-edge Jacobian blocks for the Woodbury correction.

    H = T0 + A^T A with T0 the (SPD) anchored chain system and A the
    (T*L, T*N) stacked loop rows: row block e holds Jiw_e at column block
    i_e and Jjw_e at j_e.
    """
    lin = linearize(poses, graph)
    N, T = poses.shape[0], graph.tangent_dim
    c = min(graph.chain_prefix, N - 1)
    Ji, Jj, r = lin.Ji, lin.Jj, lin.r

    Aii = jnp.einsum("eki,ekj->eij", Ji[:c], Ji[:c])
    Aij = jnp.einsum("eki,ekj->eij", Ji[:c], Jj[:c])
    Ajj = jnp.einsum("eki,ekj->eij", Jj[:c], Jj[:c])
    D0 = jnp.zeros((N, T, T), r.dtype)
    D0 = D0.at[:c].add(Aii).at[1 : c + 1].add(Ajj)
    U = jnp.zeros((N, T, T), r.dtype).at[:c].set(Aij)  # U[k]: rows k,k+1

    Ap = jnp.einsum("pki,pkj->pij", lin.Jp, lin.Jp)
    D0 = D0.at[graph.prior_idx].add(Ap)

    loop_i = graph.edges[c:, 0]
    loop_j = graph.edges[c:, 1]
    return D0, U, (loop_i, loop_j, Ji[c:], Jj[c:])


def _tridiag_selected_inverse(D, U):
    """Diagonal blocks of T0^{-1} for the block-tridiagonal (D, U).

    Classic two-sided Schur recursion: with forward complements
    F_i = D_i - U_{i-1}^T F_{i-1}^{-1} U_{i-1} and backward
    B_i = D_i - U_i B_{i+1}^{-1} U_i^T, the marginal is
    (T^{-1})_{ii} = (F_i + B_i - D_i)^{-1}. Two lax.scans of tiny TxT ops.
    """
    N = D.shape[0]

    eye = jnp.eye(D.shape[-1], dtype=D.dtype)

    def fwd(F_prev, inp):
        D_i, U_prev = inp  # U_prev = U[i-1]
        F = D_i - jnp.swapaxes(U_prev, -1, -2) @ _block_inv(F_prev[None])[0] @ U_prev
        return F, F

    # U_shift[0] = 0, so F[0] = D[0] exactly regardless of the seed.
    U_shift = jnp.concatenate([jnp.zeros_like(U[:1]), U[:-1]], axis=0)
    _, F = jax.lax.scan(fwd, eye * 1e12, (D, U_shift))

    def bwd(B_next, inp):
        D_i, U_i = inp  # U_i couples i, i+1
        B = D_i - U_i @ _block_inv(B_next[None])[0] @ jnp.swapaxes(U_i, -1, -2)
        return B, B

    # U[N-1] is structurally zero (it has no row N), so B[N-1] = D[N-1].
    _, B_rev = jax.lax.scan(bwd, eye * 1e12, (D[::-1], U[::-1]))
    B = B_rev[::-1]
    return _block_inv(F + B - D)


def marginal_covariances_all(
    poses: jnp.ndarray,
    graph: FactorGraph,
) -> jnp.ndarray:
    """(N, T, T) marginal covariances of EVERY pose at large-graph scale.

    Selected inverse over the chain structure + one Woodbury correction for
    the loop closures (graph.cpp:120,126-127's Marginals, for all poses):

      H^{-1} = T0^{-1} - X M^{-1} X^T,  X = T0^{-1} A^T,
      M = I + A T0^{-1} A^T

    diag_n(H^{-1}) = diag_n(T0^{-1}) - Z_n^T Z_n with Z = L_M^{-1} X^T.
    T0 solves use the sequential block-Thomas recursion batched over ALL
    T*L right-hand sides at once (each scan step is a (T*L, T) matmul, not
    scalar work); M is the only dense object, (T*L, T*L).
    """
    N, T = poses.shape[0], graph.tangent_dim
    dtype = poses.dtype
    D0, U, (li, lj, Jiw, Jjw) = _chain_prior_system(poses, graph)
    diag0 = _tridiag_selected_inverse(D0, U)
    L = li.shape[0]
    if L == 0:
        return diag0

    # A^T as dense rhs: (N, T, T*L); column block e has Jiw_e^T at row i_e,
    # Jjw_e^T at row j_e.
    AT = jnp.zeros((N, T, L, T), dtype)
    AT = AT.at[li, :, jnp.arange(L), :].add(jnp.swapaxes(Jiw, -1, -2))
    AT = AT.at[lj, :, jnp.arange(L), :].add(jnp.swapaxes(Jjw, -1, -2))
    rhs = AT.reshape(N, T, L * T)

    # block-Thomas solve T0 X = rhs, batched over all L*T columns
    def fwd(carry, inp):
        Fprev_inv, yprev = carry
        D_i, U_prev, b_i = inp
        LT = jnp.swapaxes(U_prev, -1, -2) @ Fprev_inv  # L_i F_{i-1}^{-1}
        F = D_i - LT @ U_prev
        y = b_i - LT @ yprev
        F_inv = _block_inv(F[None])[0]
        return (F_inv, y), (F_inv, y)

    U_shift = jnp.concatenate([jnp.zeros_like(U[:1]), U[:-1]], axis=0)
    eye = jnp.eye(T, dtype=dtype)
    init = (eye * 1e-12, jnp.zeros((T, L * T), dtype))
    _, (F_inv, Y) = jax.lax.scan(fwd, init, (D0, U_shift, rhs))

    def bwd(x_next, inp):
        F_inv_i, y_i, U_i = inp
        x = F_inv_i @ (y_i - U_i @ x_next)
        return x, x

    # U[N-1] is structurally zero, so i=N-1 needs no look-ahead term.
    _, X_rev = jax.lax.scan(
        bwd, jnp.zeros((T, L * T), dtype), (F_inv[::-1], Y[::-1], U[::-1])
    )
    X = X_rev[::-1]  # (N, T, L*T) = T0^{-1} A^T

    # M = I + A X: gather X at the loop endpoints and apply the J blocks.
    Xi = X[li]  # (L, T, L*T)
    Xj = X[lj]
    AX = (
        jnp.einsum("eab,ebc->eac", Jiw, Xi) + jnp.einsum("eab,ebc->eac", Jjw, Xj)
    ).reshape(L * T, L * T)
    M = jnp.eye(L * T, dtype=dtype) + AX
    M = 0.5 * (M + M.T) + 1e-7 * jnp.eye(L * T, dtype=dtype)
    Lm = jnp.linalg.cholesky(M)

    # Z = Lm^{-1} X^T: one triangular solve with N*T right-hand sides.
    Z = jax.scipy.linalg.solve_triangular(
        Lm, X.reshape(N * T, L * T).T, lower=True
    )  # (L*T, N*T)
    Zb = Z.reshape(L * T, N, T)
    corr = jnp.einsum("kna,knb->nab", Zb, Zb)
    return diag0 - corr


def marginal_covariance_cg(
    poses: jnp.ndarray,
    graph: FactorGraph,
    pose_index: jnp.ndarray,
    cfg: SolverConfig = SolverConfig(),
) -> jnp.ndarray:
    """(T, T) marginal covariance of one pose on a large graph: T CG solves
    H x = e_col, vmapped into one batched run."""
    lin = linearize(poses, graph)
    sys = build_blocks(lin, graph, poses.shape[0])
    N, T = sys.g.shape
    damped = _damped_diag(sys, jnp.asarray(0.0, poses.dtype), False)
    Minv = _block_inv(damped)

    def solve_one(col):
        b = jnp.zeros((N, T), poses.dtype).at[pose_index, col].set(1.0)

        def precond(r):
            return jnp.einsum("nij,nj->ni", Minv, r)

        x = jnp.zeros_like(b)
        r = b - hvp(sys, damped, x)
        z = precond(r)
        p = z
        rz = jnp.vdot(r, z)
        thresh = cfg.cg_tol**2 * jnp.vdot(b, b)

        def cond(s):
            x, r, p, rz, k = s
            return (k < cfg.cg_max_iterations) & (jnp.vdot(r, r) > thresh)

        def body(s):
            x, r, p, rz, k = s
            Ap = hvp(sys, damped, p)
            alpha = rz / jnp.maximum(jnp.vdot(p, Ap), 1e-30)
            x = x + alpha * p
            r = r - alpha * Ap
            z = precond(r)
            rz_new = jnp.vdot(r, z)
            p = z + rz_new / jnp.maximum(rz, 1e-30) * p
            return x, r, p, rz_new, k + 1

        x, *_ = jax.lax.while_loop(cond, body, (x, r, p, rz, jnp.int32(0)))
        return x[pose_index]

    return jax.vmap(solve_one)(jnp.arange(T)).T
