"""Block-tridiagonal solver via cyclic reduction — the chain preconditioner.

A SLAM Hessian is an odometry chain (block-tridiagonal) plus sparse loop
closures. Block-Jacobi preconditioning ignores the chain coupling and lets
CG crawl through the graph's long 'bending' modes; solving the full
tridiagonal part T per CG iteration captures them. A sequential Thomas solve
is O(N) serial — hostile to an accelerator; block CYCLIC REDUCTION does the
same in log2(N) rounds of batched 3x3/6x6 einsums over halving block counts:
every round is dense strided-slice work, no scatters.

cr_factor(D, U) precomputes the per-level elimination factors (once per
Gauss-Newton iteration); cr_solve applies the solve to each CG residual.

  T = blocktridiag(D_k, U_k):  T[k,k] = D_k,  T[k,k+1] = U_k = T[k+1,k]^T

Reference: classic block cyclic reduction (Buzbee-Golub-Nielson), laid out
batch-first for SPMD hardware.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from graphslam.solver.normal_eq import _block_inv


class CRLevel(NamedTuple):
    Dinv_odd: jnp.ndarray  # (no, T, T) inverses of odd diagonal blocks
    UL: jnp.ndarray        # (ne, T, T) U[2i-1] (left link of even i), 0-padded
    UR: jnp.ndarray        # (ne, T, T) U[2i]   (right link of even i), 0-padded
    DL: jnp.ndarray        # (ne, T, T) Dinv_odd[i-1], I-padded at i=0
    DR: jnp.ndarray        # (ne, T, T) Dinv_odd[i], I-padded past the end
    Uo: jnp.ndarray        # (ne, T, T) U[2i+1], 0-padded (for U' and backsub)


class CRFactor(NamedTuple):
    levels: Tuple[CRLevel, ...]
    root_inv: jnp.ndarray   # (m*T, m*T) explicit inverse of the reduced
                            # system — applied as one matmul (triangular
                            # solves are serial and latency-bound)
    root_n: int             # m = remaining block count at the root


def _pad_blocks(x: jnp.ndarray, n: int, eye: bool = False) -> jnp.ndarray:
    """Pad a (m, T, T) block array to (n, T, T) with zeros or identities."""
    m = x.shape[0]
    if m >= n:
        return x[:n]
    T = x.shape[-1]
    pad = jnp.broadcast_to(
        jnp.eye(T, dtype=x.dtype) if eye else jnp.zeros((T, T), x.dtype),
        (n - m, T, T),
    )
    return jnp.concatenate([x, pad], axis=0)


def _regularize(D: jnp.ndarray, eps: float) -> jnp.ndarray:
    """Add eps * (trace/T) * I per block. The level-k Schur complements of a
    barely-pinned chain approach singularity; float32 reduction order on an
    accelerator can tip them indefinite and blow up the closed-form inverses. A relative
    ridge keeps every level SPD at negligible cost to preconditioner quality
    (this is a preconditioner — CG corrects any inexactness)."""
    Tb = D.shape[-1]
    tr = jnp.einsum("nii->n", D) / Tb
    return D + (eps * jnp.abs(tr))[:, None, None] * jnp.eye(Tb, dtype=D.dtype)


def cr_factor(
    D: jnp.ndarray, U: jnp.ndarray, eps: float = 3e-4, min_blocks: int = 64
) -> CRFactor:
    """Factor the block-tridiagonal (D (n,T,T), U (n-1,T,T)). Static-shape:
    the level structure is fixed by n at trace time.

    Reduction stops at `min_blocks` and the remaining small banded system is
    Cholesky-factored densely — each CR level is a sequential dependency, so
    trading the last ~6 levels for one tiny dense solve cuts the solve's
    critical path roughly in half."""
    levels: List[CRLevel] = []
    n = D.shape[0]
    Tb = D.shape[-1]
    D = _regularize(D, eps)
    while n > min_blocks:
        ne = (n + 1) // 2
        no = n // 2
        D_even = D[0::2]                       # (ne, T, T)
        D_odd = D[1::2]                        # (no, T, T)
        Dinv_odd = _block_inv(D_odd)
        U_even = U[0::2]                       # U[2i]
        U_odd = U[1::2]                        # U[2i+1]

        UL = _pad_blocks(jnp.concatenate([jnp.zeros((1, Tb, Tb), D.dtype), U_odd]), ne)
        UR = _pad_blocks(U_even, ne)
        DL = _pad_blocks(
            jnp.concatenate([jnp.eye(Tb, dtype=D.dtype)[None], Dinv_odd]), ne, eye=True
        )
        DR = _pad_blocks(Dinv_odd, ne, eye=True)
        Uo = _pad_blocks(U_odd, ne)

        levels.append(CRLevel(Dinv_odd=Dinv_odd, UL=UL, UR=UR, DL=DL, DR=DR, Uo=Uo))

        # Reduced system on the even blocks (re-regularized each level).
        leftC = jnp.einsum("nba,nbc,ncd->nad", UL, DL, UL)
        rightC = jnp.einsum("nab,nbc,ndc->nad", UR, DR, UR)
        D = _regularize(D_even - leftC - rightC, eps)
        U = -jnp.einsum("nab,nbc,ncd->nad", UR, DR, Uo)[: ne - 1]
        n = ne

    # Dense root: assemble the (n*T, n*T) banded system and Cholesky it.
    m = n
    A = jnp.zeros((m, Tb, m, Tb), D.dtype)
    idx = jnp.arange(m)
    A = A.at[idx, :, idx, :].set(D)
    if m > 1:
        i0 = jnp.arange(m - 1)
        A = A.at[i0, :, i0 + 1, :].set(U)
        A = A.at[i0 + 1, :, i0, :].set(jnp.swapaxes(U, -1, -2))
    Af = A.reshape(m * Tb, m * Tb)
    root_inv = jnp.linalg.inv(Af + 1e-8 * jnp.eye(m * Tb, dtype=D.dtype))
    return CRFactor(levels=tuple(levels), root_inv=root_inv, root_n=m)


def cr_solve(factor: CRFactor, b: jnp.ndarray) -> jnp.ndarray:
    """Solve T x = b using a precomputed CRFactor. b: (n, T)."""
    # Forward: reduce rhs level by level, remembering the odd parts.
    odds: List[jnp.ndarray] = []
    for lv in factor.levels:
        b_even = b[0::2]
        b_odd = b[1::2]
        odds.append(b_odd)
        ne = b_even.shape[0]
        zero = jnp.zeros((1, b.shape[-1]), b.dtype)
        bL = jnp.concatenate([zero, b_odd])[:ne]          # b_odd[i-1]
        bR = jnp.concatenate([b_odd, zero])[:ne]          # b_odd[i]
        b = (
            b_even
            - jnp.einsum("nba,nbc,nc->na", lv.UL, lv.DL, bL)
            - jnp.einsum("nab,nbc,nc->na", lv.UR, lv.DR, bR)
        )

    x = (factor.root_inv @ b.reshape(-1)).reshape(factor.root_n, b.shape[-1])

    # Backward: recover odd blocks, interleave.
    for lv, b_odd in zip(reversed(factor.levels), reversed(odds)):
        no = b_odd.shape[0]
        ne = x.shape[0]
        zero = jnp.zeros((1, x.shape[-1]), x.dtype)
        x_right = jnp.concatenate([x[1:], zero])[:no]      # x_even[i+1]
        rhs = (
            b_odd
            - jnp.einsum("nba,nb->na", lv.UR[:no], x[:no])
            - jnp.einsum("nab,nb->na", lv.Uo[:no], x_right)
        )
        x_odd = jnp.einsum("nab,nb->na", lv.Dinv_odd, rhs)
        n = ne + no
        out = jnp.zeros((n, x.shape[-1]), x.dtype)
        out = out.at[0::2].set(x[:ne]).at[1::2].set(x_odd)
        x = out
    return x


def chain_offdiag(
    edges: jnp.ndarray, Aij: jnp.ndarray, num_poses: int
) -> jnp.ndarray:
    """Extract the chain (j == i+1) off-diagonal blocks U (N-1, T, T) from the
    per-edge Hessian blocks. Loop edges are excluded — they stay with CG."""
    Tb = Aij.shape[-1]
    i_idx = edges[:, 0]
    is_chain = edges[:, 1] == i_idx + 1
    contrib = jnp.where(is_chain[:, None, None], Aij, 0.0)
    U = jnp.zeros((num_poses - 1, Tb, Tb), Aij.dtype)
    return U.at[jnp.clip(i_idx, 0, num_poses - 2)].add(contrib)
