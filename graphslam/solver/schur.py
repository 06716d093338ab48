"""Partitioned Schur-complement direct solver (domain decomposition).

The pose graph is split into contiguous index blocks; poses touched by
cross-block edges become SEPARATORS. Interior poses are eliminated
block-locally (batched dense Cholesky over blocks — a vmapped
factorization), the separator normal equations are formed as

    S = H_SS - sum_b  H_SI(b) H_II(b)^{-1} H_IS(b)

and solved densely; interiors back-substitute block-locally. Under
shard_map with blocks sharded over the mesh, the sum over b is one psum —
the 'multi-host partitioned Schur reduction over collectives' of
BASELINE.json config 5 (see parallel/dist_schur.py).

The plan (partition, separator set, per-edge scatter coordinates) is
computed host-side ONCE per graph topology in numpy; the solve itself is a
fixed-shape jitted function. Best suited to graphs whose cross-block edges
are few (sphere2500 banded rings, chain-dominated city graphs at moderate
block counts); the separator grows with cross-block loop density.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from graphslam.solver.normal_eq import BlockSystem


class SchurPlan(NamedTuple):
    """Host-computed static plan. B blocks, S interior slots per block
    (padded), Q separator poses (padded to q_pad)."""

    num_poses: int
    B: int
    S: int
    Q: int  # true separator count (<= q_pad)
    q_pad: int

    # Pose classification / placement.
    interior_ids: np.ndarray   # (B, S) global pose index, -1 pad
    interior_mask: np.ndarray  # (B, S)
    sep_ids: np.ndarray        # (q_pad,) global pose index, -1 pad
    sep_mask: np.ndarray       # (q_pad,)

    # Per-pose placement: block/slot for interiors, slot for separators.
    pose_block: np.ndarray     # (N,) block of interior pose, -1 if separator
    pose_slot: np.ndarray      # (N,) interior slot or separator slot

    # Per-edge scatter coordinates (E,) each; case masks select which
    # structure an edge's off-diagonal block lands in.
    e_case: np.ndarray         # (E,) 0=II, 1=IS (i int, j sep), 2=SI, 3=SS
    e_block: np.ndarray        # (E,) owning block for II/IS/SI, else 0
    e_li: np.ndarray           # (E,) interior slot of endpoint i (or 0)
    e_lj: np.ndarray           # (E,)
    e_si: np.ndarray           # (E,) separator slot of endpoint i (or 0)
    e_sj: np.ndarray           # (E,)


def schur_plan(edges: np.ndarray, num_poses: int, num_blocks: int) -> SchurPlan:
    """Partition [0, N) into `num_blocks` contiguous ranges and classify."""
    edges = np.asarray(edges)
    N = num_poses
    B = num_blocks
    size = -(-N // B)
    block_of = np.minimum(edges // size, B - 1)  # per endpoint
    pose_block_raw = np.minimum(np.arange(N) // size, B - 1)

    is_sep = np.zeros(N, bool)
    cross = block_of[:, 0] != block_of[:, 1]
    is_sep[edges[cross, 0]] = True
    is_sep[edges[cross, 1]] = True

    sep_ids_true = np.flatnonzero(is_sep)
    Q = len(sep_ids_true)
    q_pad = max(int(Q), 1)

    pose_block = np.where(is_sep, -1, pose_block_raw)
    pose_slot = np.full(N, 0, np.int64)
    interior_lists = []
    S = 0
    for b in range(B):
        ids = np.flatnonzero((pose_block == b))
        interior_lists.append(ids)
        S = max(S, len(ids))
    S = max(S, 1)
    interior_ids = np.full((B, S), -1, np.int64)
    interior_mask = np.zeros((B, S), bool)
    for b, ids in enumerate(interior_lists):
        interior_ids[b, : len(ids)] = ids
        interior_mask[b, : len(ids)] = True
        pose_slot[ids] = np.arange(len(ids))
    sep_ids = np.full(q_pad, -1, np.int64)
    sep_mask = np.zeros(q_pad, bool)
    sep_ids[:Q] = sep_ids_true
    sep_mask[:Q] = True
    pose_slot[sep_ids_true] = np.arange(Q)

    i, j = edges[:, 0], edges[:, 1]
    i_sep = is_sep[i]
    j_sep = is_sep[j]
    e_case = np.where(
        ~i_sep & ~j_sep, 0, np.where(~i_sep & j_sep, 1, np.where(i_sep & ~j_sep, 2, 3))
    )
    # Owning block: the interior endpoint's block (II edges have both in the
    # same block by construction — a cross-block edge forces separators).
    e_block = np.where(~i_sep, pose_block[i], np.where(~j_sep, pose_block[j], 0))
    e_block = np.maximum(e_block, 0)
    e_li = np.where(~i_sep, pose_slot[i], 0)
    e_lj = np.where(~j_sep, pose_slot[j], 0)
    e_si = np.where(i_sep, pose_slot[i], 0)
    e_sj = np.where(j_sep, pose_slot[j], 0)

    return SchurPlan(
        num_poses=N, B=B, S=S, Q=int(Q), q_pad=q_pad,
        interior_ids=interior_ids, interior_mask=interior_mask,
        sep_ids=sep_ids, sep_mask=sep_mask,
        pose_block=pose_block, pose_slot=pose_slot,
        e_case=e_case.astype(np.int32), e_block=e_block.astype(np.int32),
        e_li=e_li.astype(np.int32), e_lj=e_lj.astype(np.int32),
        e_si=e_si.astype(np.int32), e_sj=e_sj.astype(np.int32),
    )


def _assemble(plan: SchurPlan, sys: BlockSystem, lam, lm_diag_scaling=True):
    """Scatter edge blocks into (HII, HIS, HSS, gI, gS)."""
    T = sys.g.shape[-1]
    B, S, q = plan.B, plan.S, plan.q_pad
    dt = sys.g.dtype

    case = jnp.asarray(plan.e_case)
    eb = jnp.asarray(plan.e_block)
    li, lj = jnp.asarray(plan.e_li), jnp.asarray(plan.e_lj)
    si, sj = jnp.asarray(plan.e_si), jnp.asarray(plan.e_sj)

    # Damped diagonal blocks placed by pose classification.
    from graphslam.solver.normal_eq import _damped_diag

    damped = _damped_diag(sys, lam, lm_diag_scaling)   # (N, T, T)
    g = sys.g

    int_ids = jnp.asarray(plan.interior_ids)
    imask = jnp.asarray(plan.interior_mask)
    sep_ids = jnp.asarray(plan.sep_ids)
    smask = jnp.asarray(plan.sep_mask)

    safe_int = jnp.maximum(int_ids, 0)
    safe_sep = jnp.maximum(sep_ids, 0)

    eyeT = jnp.eye(T, dtype=dt)
    HII = jnp.zeros((B, S, S, T, T), dt)
    bidx = jnp.arange(B)[:, None]
    sidx = jnp.arange(S)[None, :]
    diag_blocks = jnp.where(
        imask[..., None, None], damped[safe_int], eyeT
    )  # pad slots get identity -> well-conditioned
    HII = HII.at[bidx, sidx, sidx].set(diag_blocks)
    gI = jnp.where(imask[..., None], g[safe_int], 0.0)      # (B, S, T)

    HSS = jnp.zeros((q, q, T, T), dt)
    qidx = jnp.arange(q)
    HSS = HSS.at[qidx, qidx].set(
        jnp.where(smask[:, None, None], damped[safe_sep], eyeT)
    )
    gS = jnp.where(smask[:, None], g[safe_sep], 0.0)        # (q, T)

    HIS = jnp.zeros((B, S, q, T, T), dt)

    AijT = jnp.swapaxes(sys.Aij, -1, -2)
    m0 = (case == 0)[:, None, None]
    m1 = (case == 1)[:, None, None]
    m2 = (case == 2)[:, None, None]
    m3 = (case == 3)[:, None, None]

    HII = HII.at[eb, li, lj].add(jnp.where(m0, sys.Aij, 0.0))
    HII = HII.at[eb, lj, li].add(jnp.where(m0, AijT, 0.0))
    HIS = HIS.at[eb, li, sj].add(jnp.where(m1, sys.Aij, 0.0))
    HIS = HIS.at[eb, lj, si].add(jnp.where(m2, AijT, 0.0))
    HSS = HSS.at[si, sj].add(jnp.where(m3, sys.Aij, 0.0))
    HSS = HSS.at[sj, si].add(jnp.where(m3, AijT, 0.0))

    return HII, HIS, HSS, gI, gS


def schur_solve(
    plan: SchurPlan,
    sys: BlockSystem,
    lam,
    lm_diag_scaling: bool = True,
) -> jnp.ndarray:
    """Direct solve of (H + damping) dx = -g via block elimination.

    Returns dx (N, T)."""
    T = sys.g.shape[-1]
    B, S, q = plan.B, plan.S, plan.q_pad
    HII, HIS, HSS, gI, gS = _assemble(plan, sys, lam, lm_diag_scaling)

    # Flatten blocks to matrices.
    A = HII.transpose(0, 1, 3, 2, 4).reshape(B, S * T, S * T)
    Bm = HIS.transpose(0, 1, 3, 2, 4).reshape(B, S * T, q * T)
    C = HSS.transpose(0, 2, 1, 3).reshape(q * T, q * T)
    bI = -gI.reshape(B, S * T)
    bS = -gS.reshape(q * T)

    # Per-block Cholesky (batched over blocks — one vmapped potrf).
    L = jnp.linalg.cholesky(A + 1e-8 * jnp.eye(S * T, dtype=A.dtype))

    def block_solve(Lb, rhs):
        y = jax.scipy.linalg.solve_triangular(Lb, rhs, lower=True)
        return jax.scipy.linalg.solve_triangular(Lb.T, y, lower=False)

    W = jax.vmap(block_solve)(L, Bm)                       # H_II^{-1} H_IS
    u = jax.vmap(block_solve)(L, bI[..., None])[..., 0]    # H_II^{-1} bI

    # Separator system: S_hat = C - sum_b B^T W ; rhs_hat = bS - sum_b B^T u
    # precision=HIGHEST: the Schur complement subtracts two large
    # near-equal matrices; a reduced-precision dot (bf16 or TF32) makes
    # S_hat indefinite and NaNs the Cholesky (seen on m3500/sphere2500).
    S_hat = C - jnp.einsum("bip,biq->pq", Bm, W, precision=jax.lax.Precision.HIGHEST)
    rhs_hat = bS - jnp.einsum("bip,bi->p", Bm, u, precision=jax.lax.Precision.HIGHEST)
    Ls = jnp.linalg.cholesky(S_hat + 1e-8 * jnp.eye(q * T, dtype=A.dtype))
    ys = jax.scipy.linalg.solve_triangular(Ls, rhs_hat, lower=True)
    xS = jax.scipy.linalg.solve_triangular(Ls.T, ys, lower=False)

    # Back-substitute interiors: xI = u - W xS.
    xI = u - jnp.einsum("bip,p->bi", W, xS, precision=jax.lax.Precision.HIGHEST)

    # Scatter back to (N, T).
    dx = jnp.zeros((plan.num_poses, T), sys.g.dtype)
    int_ids = jnp.asarray(plan.interior_ids)
    imask = jnp.asarray(plan.interior_mask)
    xI_b = xI.reshape(B, S, T)
    dx = dx.at[jnp.maximum(int_ids, 0)].add(
        jnp.where(imask[..., None], xI_b, 0.0)
    )
    sep_ids = jnp.asarray(plan.sep_ids)
    smask = jnp.asarray(plan.sep_mask)
    dx = dx.at[jnp.maximum(sep_ids, 0)].add(
        jnp.where(smask[:, None], xS.reshape(q, T), 0.0)
    )
    return dx
