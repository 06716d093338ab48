"""Mesh-sharded partitioned Schur reduction — BASELINE config 5.

The SchurPlan's blocks are sharded over the mesh axis: every device
assembles and factorizes only ITS blocks' interior systems (batched dense
Cholesky), the separator normal equations are combined with ONE psum over
the mesh axis, each device solves the
(replicated) separator system redundantly, and interiors back-substitute
locally. The only cross-device traffic all solve long is the (Q*T)^2
separator matrix + rhs — the textbook 'combine separator systems via
all-reduce' layout of the north star.

Compile hygiene: the shard_map body and both public entry points are
module-level jitted functions (static on (mesh, axis) only), so a given
graph topology compiles ONCE; the GN driver scans its iterations on-device
like parallel/dist.py — no per-iteration host dispatch.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from graphslam.solver.normal_eq import BlockSystem
from graphslam.solver.schur import SchurPlan, _assemble


def pad_plan(plan: SchurPlan, n_dev: int) -> SchurPlan:
    """Pad the block axis to a multiple of the mesh size (padded blocks have
    no interiors: mask all-false, identity diagonals)."""
    B = plan.B
    pad = (-B) % n_dev
    if pad == 0:
        return plan
    return plan._replace(
        B=B + pad,
        interior_ids=np.concatenate(
            [plan.interior_ids, np.full((pad, plan.S), -1, plan.interior_ids.dtype)]
        ),
        interior_mask=np.concatenate(
            [plan.interior_mask, np.zeros((pad, plan.S), bool)]
        ),
    )


def _plan_tree(plan: SchurPlan) -> dict:
    """The plan's array fields as a jit-traceable pytree. Block/slot counts
    are recovered from shapes inside the trace (so the jit cache keys on
    topology SHAPE, not plan object identity)."""
    return {
        "interior_ids": jnp.asarray(plan.interior_ids),
        "interior_mask": jnp.asarray(plan.interior_mask),
        "sep_ids": jnp.asarray(plan.sep_ids),
        "sep_mask": jnp.asarray(plan.sep_mask),
        "e_case": jnp.asarray(plan.e_case),
        "e_block": jnp.asarray(plan.e_block),
        "e_li": jnp.asarray(plan.e_li),
        "e_lj": jnp.asarray(plan.e_lj),
        "e_si": jnp.asarray(plan.e_si),
        "e_sj": jnp.asarray(plan.e_sj),
    }


def _rebuild_plan(tree: dict, num_poses: int) -> SchurPlan:
    B, S = tree["interior_ids"].shape
    q = tree["sep_ids"].shape[0]
    return SchurPlan(
        num_poses=num_poses, B=B, S=S, Q=q, q_pad=q,
        pose_block=None, pose_slot=None, **tree,
    )


def _body(A_loc, B_loc, bI_loc, C_rep, bS_rep, *, axis: str):
    """Per-shard interior elimination + separator combine (runs under
    shard_map; blocks sharded over `axis`, separator replicated)."""
    ST = A_loc.shape[-1]
    qT = C_rep.shape[-1]
    eye = jnp.eye(ST, dtype=A_loc.dtype)
    L = jnp.linalg.cholesky(A_loc + 1e-8 * eye)

    def block_solve(Lb, rhs):
        y = jax.scipy.linalg.solve_triangular(Lb, rhs, lower=True)
        return jax.scipy.linalg.solve_triangular(Lb.T, y, lower=False)

    W = jax.vmap(block_solve)(L, B_loc)
    u = jax.vmap(block_solve)(L, bI_loc[..., None])[..., 0]

    # Separator combine: the one all-reduce of the whole solve.
    # precision=HIGHEST: see solver/schur.py — reduced-precision partial
    # products make the psum'd Schur complement indefinite (NaN Cholesky).
    S_part = jnp.einsum("bip,biq->pq", B_loc, W, precision=jax.lax.Precision.HIGHEST)
    r_part = jnp.einsum("bip,bi->p", B_loc, u, precision=jax.lax.Precision.HIGHEST)
    S_hat = C_rep - jax.lax.psum(S_part, axis)
    rhs_hat = bS_rep - jax.lax.psum(r_part, axis)

    Ls = jnp.linalg.cholesky(S_hat + 1e-8 * jnp.eye(qT, dtype=A_loc.dtype))
    ys = jax.scipy.linalg.solve_triangular(Ls, rhs_hat, lower=True)
    xS = jax.scipy.linalg.solve_triangular(Ls.T, ys, lower=False)

    xI = u - jnp.einsum("bip,p->bi", W, xS, precision=jax.lax.Precision.HIGHEST)
    return xI, xS


def _schur_dx(plan_tree, sys: BlockSystem, lam, mesh, axis, lm_diag_scaling):
    """Assemble + sharded eliminate + scatter: dx (N, T). Traced body shared
    by the one-shot solve and the GN scan."""
    T = sys.g.shape[-1]
    N = sys.g.shape[0]
    plan = _rebuild_plan(plan_tree, N)
    B, S, q = plan.B, plan.S, plan.q_pad

    HII, HIS, HSS, gI, gS = _assemble(plan, sys, lam, lm_diag_scaling)
    A = HII.transpose(0, 1, 3, 2, 4).reshape(B, S * T, S * T)
    Bm = HIS.transpose(0, 1, 3, 2, 4).reshape(B, S * T, q * T)
    C = HSS.transpose(0, 2, 1, 3).reshape(q * T, q * T)
    bI = -gI.reshape(B, S * T)
    bS = -gS.reshape(q * T)

    fn = shard_map(
        partial(_body, axis=axis),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(), P()),
        out_specs=(P(axis), P()),
    )
    xI, xS = fn(A, Bm, bI, C, bS)

    dx = jnp.zeros((N, T), sys.g.dtype)
    imask = plan_tree["interior_mask"]
    dx = dx.at[jnp.maximum(plan_tree["interior_ids"], 0)].add(
        jnp.where(imask[..., None], xI.reshape(B, S, T), 0.0)
    )
    smask = plan_tree["sep_mask"]
    dx = dx.at[jnp.maximum(plan_tree["sep_ids"], 0)].add(
        jnp.where(smask[:, None], xS.reshape(q, T), 0.0)
    )
    return dx


@partial(jax.jit, static_argnames=("mesh", "axis", "lm_diag_scaling"))
def _solve_jit(plan_tree, sys, lam, mesh, axis, lm_diag_scaling):
    return _schur_dx(plan_tree, sys, lam, mesh, axis, lm_diag_scaling)


def dist_schur_solve(
    plan: SchurPlan,
    sys: BlockSystem,
    lam,
    mesh: Mesh,
    axis: str = "dev",
    lm_diag_scaling: bool = True,
) -> jnp.ndarray:
    """Distributed version of solver.schur.schur_solve. The assembly runs
    replicated (cheap scatter work over edges); the expensive per-block
    factorizations and Schur products run block-sharded. One compile per
    graph topology (plan arrays are traced, not baked)."""
    plan = pad_plan(plan, mesh.shape[axis])
    return _solve_jit(
        _plan_tree(plan), sys, jnp.asarray(lam, sys.g.dtype), mesh, axis,
        lm_diag_scaling,
    )


def shard_schur_edges(graph, plan: SchurPlan, n_dev: int):
    """Host-side edge partition for the fully-sharded GN scan: every edge is
    assigned to the device owning its interior block (cross-separator SS
    edges round-robin), per-device lists padded to equal length with masked
    dummies. Returns (padded_plan, dict of (n_dev*Epd, ...) arrays laid out
    device-contiguously for `P(axis)` sharding)."""
    plan = pad_plan(plan, n_dev)
    Bpd = plan.B // n_dev
    e_case = np.asarray(plan.e_case)
    e_block = np.asarray(plan.e_block)
    E = e_block.shape[0]
    dev_e = np.where(e_case == 3, np.arange(E) % n_dev, e_block // Bpd)
    counts = np.bincount(dev_e, minlength=n_dev)
    Epd = max(int(counts.max()), 1)
    idx = np.full((n_dev, Epd), -1, np.int64)
    for d in range(n_dev):
        ids = np.flatnonzero(dev_e == d)
        idx[d, : len(ids)] = ids
    flat = idx.reshape(-1)
    pad = flat < 0
    safe = np.maximum(flat, 0)

    def take(x, zero_pad=True):
        arr = np.array(np.asarray(x)[safe])
        if zero_pad:
            arr[pad] = 0
        return arr

    emask = take(graph.edge_mask)
    emask[pad] = False
    eb_loc = np.clip(
        take(plan.e_block) - np.repeat(np.arange(n_dev), Epd) * Bpd,
        0, Bpd - 1,
    )
    shard = {
        "edges": np.clip(take(graph.edges), 0, plan.num_poses - 1),
        "meas": take(graph.measurements),
        "sq": take(graph.sqrt_info),
        "emask": emask,
        "iloop": take(graph.is_loop),
        "ecase": take(plan.e_case),
        "ebl": eb_loc.astype(np.int32),
        "eli": take(plan.e_li),
        "elj": take(plan.e_lj),
        "esi": take(plan.e_si),
        "esj": take(plan.e_sj),
    }
    return plan, {k: jnp.asarray(v) for k, v in shard.items()}


def _make_gn_body(*, axis, iterations, huber_delta, use_huber):
    from graphslam.factors.linearize import (
        linearize_edges, linearize_priors,
    )
    from graphslam.solver.lm import _retract_all

    def full(poses0, edges, meas, sq, emask, iloop, ecase, ebl, eli, elj,
             esi, esj, int_ids, imask, sep_ids, smask,
             pidx, pmeas, psq, pmask, lam):
        N = poses0.shape[0]
        B_loc, S = int_ids.shape
        q = sep_ids.shape[0]
        dt = poses0.dtype
        safe_int = jnp.maximum(int_ids, 0)
        safe_sep = jnp.maximum(sep_ids, 0)

        def gn_body(poses, _):
            r, Ji, Jj = linearize_edges(
                poses, edges, meas, sq, emask, iloop,
                huber_delta=huber_delta, use_huber=use_huber,
            )
            T = r.shape[-1]
            eyeT = jnp.eye(T, dtype=dt)
            Aii = jnp.einsum("eki,ekj->eij", Ji, Ji)
            Aij = jnp.einsum("eki,ekj->eij", Ji, Jj)
            Ajj = jnp.einsum("eki,ekj->eij", Jj, Jj)
            gi = jnp.einsum("eki,ek->ei", Ji, r)
            gj = jnp.einsum("eki,ek->ei", Jj, r)
            AijT = jnp.swapaxes(Aij, -1, -2)

            i_int = ((ecase == 0) | (ecase == 1))[:, None]
            j_int = ((ecase == 0) | (ecase == 2))[:, None]
            m0 = (ecase == 0)[:, None, None]
            m1 = (ecase == 1)[:, None, None]
            m2 = (ecase == 2)[:, None, None]
            m3 = (ecase == 3)[:, None, None]

            # interior diag/gradient: fully local (an edge with an interior
            # endpoint is owned by that endpoint's block's device)
            diagI = (
                jnp.zeros((B_loc, S, T, T), dt)
                .at[ebl, eli].add(jnp.where(i_int[..., None], Aii, 0.0))
                .at[ebl, elj].add(jnp.where(j_int[..., None], Ajj, 0.0))
            )
            gI = (
                jnp.zeros((B_loc, S, T), dt)
                .at[ebl, eli].add(jnp.where(i_int, gi, 0.0))
                .at[ebl, elj].add(jnp.where(j_int, gj, 0.0))
            )
            # separator partials: combined across devices with psums
            diagS = (
                jnp.zeros((q, T, T), dt)
                .at[esi].add(jnp.where(~i_int[..., None], Aii, 0.0))
                .at[esj].add(jnp.where(~j_int[..., None], Ajj, 0.0))
            )
            gS = (
                jnp.zeros((q, T), dt)
                .at[esi].add(jnp.where(~i_int, gi, 0.0))
                .at[esj].add(jnp.where(~j_int, gj, 0.0))
            )
            HSSo = (
                jnp.zeros((q, q, T, T), dt)
                .at[esi, esj].add(jnp.where(m3, Aij, 0.0))
                .at[esj, esi].add(jnp.where(m3, AijT, 0.0))
            )
            diagS, gS, HSSo = jax.lax.psum((diagS, gS, HSSo), axis)

            # priors: replicated compute; interiors take theirs locally
            rp, Jp = linearize_priors(poses, pidx, pmeas, psq, pmask)
            Ap = jnp.einsum("pki,pkj->pij", Jp, Jp)
            gp = jnp.einsum("pki,pk->pi", Jp, rp)
            Dpri = jnp.zeros((N, T, T), dt).at[pidx].add(Ap)
            gpri = jnp.zeros((N, T), dt).at[pidx].add(gp)
            diagI = diagI + jnp.where(
                imask[..., None, None], Dpri[safe_int], 0.0
            )
            gI = gI + jnp.where(imask[..., None], gpri[safe_int], 0.0)
            diagS = diagS + jnp.where(
                smask[:, None, None], Dpri[safe_sep], 0.0
            )
            gS = gS + jnp.where(smask[:, None], gpri[safe_sep], 0.0)

            # Marquardt damping on the TOTAL diagonals; pad slots identity
            dI = jnp.einsum("bsii->bsi", diagI)
            diagI = diagI + lam * dI[..., None] * eyeT
            diagI = jnp.where(imask[..., None, None], diagI, eyeT)
            dS = jnp.einsum("qii->qi", diagS)
            diagS = diagS + lam * dS[..., None] * eyeT
            diagS = jnp.where(smask[:, None, None], diagS, eyeT)

            # local block matrices
            bidx = jnp.arange(B_loc)[:, None]
            sidx = jnp.arange(S)[None, :]
            HII = (
                jnp.zeros((B_loc, S, S, T, T), dt)
                .at[bidx, sidx, sidx].set(diagI)
                .at[ebl, eli, elj].add(jnp.where(m0, Aij, 0.0))
                .at[ebl, elj, eli].add(jnp.where(m0, AijT, 0.0))
            )
            HIS = (
                jnp.zeros((B_loc, S, q, T, T), dt)
                .at[ebl, eli, esj].add(jnp.where(m1, Aij, 0.0))
                .at[ebl, elj, esi].add(jnp.where(m2, AijT, 0.0))
            )
            qidx = jnp.arange(q)
            HSS = HSSo.at[qidx, qidx].add(diagS)

            A = HII.transpose(0, 1, 3, 2, 4).reshape(B_loc, S * T, S * T)
            Bm = HIS.transpose(0, 1, 3, 2, 4).reshape(B_loc, S * T, q * T)
            C = HSS.transpose(0, 2, 1, 3).reshape(q * T, q * T)
            bI = -gI.reshape(B_loc, S * T)
            bS = -gS.reshape(q * T)

            xI, xS = _body(A, Bm, bI, C, bS, axis=axis)

            dx_part = jnp.zeros((N, T), dt).at[safe_int].add(
                jnp.where(imask[..., None], xI.reshape(B_loc, S, T), 0.0)
            )
            dx = jax.lax.psum(dx_part, axis)
            dx = dx.at[safe_sep].add(
                jnp.where(smask[:, None], xS.reshape(q, T), 0.0)
            )
            return _retract_all(poses, dx), None

        poses, _ = jax.lax.scan(gn_body, poses0, None, length=iterations)
        return poses

    return full


@partial(
    jax.jit,
    static_argnames=("mesh", "axis", "iterations", "huber_delta", "use_huber"),
)
def _gn_scan(poses0, shard, int_ids, imask, sep_ids, smask, priors, lam,
             mesh, axis, iterations, huber_delta, use_huber):
    body = _make_gn_body(
        axis=axis, iterations=iterations, huber_delta=huber_delta,
        use_huber=use_huber,
    )
    espec = [P(axis)] * 11  # edge + per-edge plan arrays, device-contiguous
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=tuple(
            [P()] + espec
            + [P(axis), P(axis), P(), P()]   # int_ids/imask sharded by block
            + [P(), P(), P(), P(), P()]      # priors + lam replicated
        ),
        out_specs=P(),
        check_vma=False,
    )
    return fn(
        poses0, shard["edges"], shard["meas"], shard["sq"], shard["emask"],
        shard["iloop"], shard["ecase"], shard["ebl"], shard["eli"],
        shard["elj"], shard["esi"], shard["esj"],
        int_ids, imask, sep_ids, smask, *priors, lam,
    )


def dist_schur_gn_solve(
    poses,
    graph,
    plan: SchurPlan,
    mesh: Mesh,
    iterations: int = 10,
    lam: float = 1e-6,
    axis: str = "dev",
    huber_delta: float = 1.0,
    use_huber: bool = False,
):
    """Gauss-Newton with the mesh-sharded partitioned-Schur DIRECT solve as
    the inner linear solver — BASELINE config 5 end-to-end across hosts.

    FULLY sharded per iteration (round-4, VERDICT r3 #4): each device
    linearizes ONLY the edges owned by its blocks (cross-separator edges
    round-robin), assembles its interior systems and separator partials,
    factorizes its blocks, and the separator system + interior dx scatter
    combine with psums — no full-graph replicated linearize anywhere. The
    whole GN loop is ONE on-device lax.scan inside shard_map."""
    n_dev = mesh.shape[axis]
    plan_p, shard = shard_schur_edges(graph, plan, n_dev)
    priors = (
        graph.prior_idx, graph.prior_meas, graph.prior_sqrt_info,
        graph.prior_mask,
    )
    return _gn_scan(
        poses, shard,
        jnp.asarray(plan_p.interior_ids), jnp.asarray(plan_p.interior_mask),
        jnp.asarray(plan_p.sep_ids), jnp.asarray(plan_p.sep_mask),
        priors, jnp.asarray(lam, poses.dtype), mesh, axis, iterations,
        huber_delta, use_huber,
    )
