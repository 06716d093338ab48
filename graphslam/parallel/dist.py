"""Factor-sharded distributed Gauss-Newton / Levenberg-Marquardt.

Parallel decomposition (SURVEY.md §2.4 / §7.5):

  * Factors (edges) are sharded over the mesh axis 'dev' — linearization,
    Hessian-block products and gradient scatter run on each device's shard.
  * Poses are REPLICATED: the state is tiny (N*T floats) while per-factor
    work dominates, so replicate-state + shard-work is the
    bandwidth-optimal layout; the only collectives are psums of (N,T)/(N,T,T)
    reductions — the 'separator systems combined via all-reduce' of the
    north star, over NVLink within a host and the network across hosts.
  * The PCG inner loop runs entirely inside shard_map: each device computes
    the off-diagonal part of H@v from its own edges, one psum makes it
    global, and the CG scalars are computed redundantly (deterministic,
    replicated) on every device — zero host involvement per iteration.

Multi-host: the same code runs under `jax.distributed.initialize` with a
mesh spanning hosts; no code changes (the roslaunch/rosmaster replacement,
SURVEY.md §5.8).
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from graphslam.config import SolverConfig
from graphslam.factors.graph import FactorGraph
from graphslam.factors.linearize import (
    linearize_edges,
    linearize_priors,
    group_for,
)
from graphslam.geometry import se3
from graphslam.solver.normal_eq import _block_inv


def make_mesh(num_devices: Optional[int] = None, axis: str = "dev") -> Mesh:
    devs = jax.devices()
    if num_devices is not None:
        devs = devs[:num_devices]
    return Mesh(np.array(devs), (axis,))


def shard_graph(graph: FactorGraph, mesh: Mesh, axis: str = "dev") -> FactorGraph:
    """Pad the edge arrays to a multiple of the mesh size and place them
    sharded over `axis`; prior arrays and everything else replicate."""
    n = mesh.shape[axis]
    E = graph.edges.shape[0]
    pad = (-E) % n

    def pad0(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths)

    g = graph.replace(
        edges=pad0(graph.edges),
        measurements=pad0(graph.measurements),
        sqrt_info=pad0(graph.sqrt_info),
        edge_mask=pad0(graph.edge_mask),  # padded entries get mask=False
        is_loop=pad0(graph.is_loop),
    )
    esh = NamedSharding(mesh, P(axis))
    rsh = NamedSharding(mesh, P())
    return FactorGraph(
        edges=jax.device_put(g.edges, esh),
        measurements=jax.device_put(g.measurements, esh),
        sqrt_info=jax.device_put(g.sqrt_info, esh),
        edge_mask=jax.device_put(g.edge_mask, esh),
        is_loop=jax.device_put(g.is_loop, esh),
        prior_idx=jax.device_put(g.prior_idx, rsh),
        prior_meas=jax.device_put(g.prior_meas, rsh),
        prior_sqrt_info=jax.device_put(g.prior_sqrt_info, rsh),
        prior_mask=jax.device_put(g.prior_mask, rsh),
    )


def _local_normal_eq(poses, edges, meas, sq, emask, iloop, cfg: SolverConfig, axis):
    """Per-device linearization + psum-assembled global (diag, g) and the
    local off-diagonal blocks kept for H@v products."""
    N = poses.shape[0]
    r, Ji, Jj = linearize_edges(
        poses, edges, meas, sq, emask, iloop,
        huber_delta=cfg.huber_delta, use_huber=cfg.use_huber_on_loops,
    )
    Aii = jnp.einsum("eki,ekj->eij", Ji, Ji)
    Aij = jnp.einsum("eki,ekj->eij", Ji, Jj)
    Ajj = jnp.einsum("eki,ekj->eij", Jj, Jj)
    gi = jnp.einsum("eki,ek->ei", Ji, r)
    gj = jnp.einsum("eki,ek->ei", Jj, r)
    i_idx, j_idx = edges[:, 0], edges[:, 1]
    T = r.shape[-1]
    g_part = jnp.zeros((N, T), r.dtype).at[i_idx].add(gi).at[j_idx].add(gj)
    diag_part = (
        jnp.zeros((N, T, T), r.dtype).at[i_idx].add(Aii).at[j_idx].add(Ajj)
    )
    # Separator combine: one all-reduce over the mesh axis.
    g_all = jax.lax.psum(g_part, axis)
    diag_all = jax.lax.psum(diag_part, axis)
    local_err = jax.lax.psum(jnp.sum(r * r), axis)
    return g_all, diag_all, Aij, local_err, r


def _priors_contrib(poses, pidx, pmeas, psq, pmask):
    rp, Jp = linearize_priors(poses, pidx, pmeas, psq, pmask)
    Ap = jnp.einsum("pki,pkj->pij", Jp, Jp)
    gp = jnp.einsum("pki,pk->pi", Jp, rp)
    return rp, gp, Ap


def _pcg(edges, Aij, damped, precond, b, axis, max_iters, tol):
    """Replicated-x PCG with sharded H@v. All devices hold identical x/r/p."""
    i_idx, j_idx = edges[:, 0], edges[:, 1]

    def hv(v):
        yi = jnp.einsum("eij,ej->ei", Aij, v[j_idx])
        yj = jnp.einsum("eji,ej->ei", Aij, v[i_idx])
        N, T = v.shape
        part = jnp.zeros((N, T), v.dtype).at[i_idx].add(yi).at[j_idx].add(yj)
        return jax.lax.psum(part, axis) + jnp.einsum("nij,nj->ni", damped, v)

    x = jnp.zeros_like(b)
    r = b - hv(x)
    z = precond(r)
    p = z
    rz = jnp.vdot(r, z)
    thresh = tol * tol * jnp.vdot(b, b)

    def cond(s):
        _, r, _, _, k = s
        return (k < max_iters) & (jnp.vdot(r, r) > thresh)

    def body(s):
        x, r, p, rz, k = s
        Ap = hv(p)
        alpha = rz / jnp.maximum(jnp.vdot(p, Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = jnp.vdot(r, z)
        p = z + rz_new / jnp.maximum(rz, 1e-30) * p
        return x, r, p, rz_new, k + 1

    x, _, _, _, _ = jax.lax.while_loop(cond, body, (x, r, p, rz, jnp.int32(0)))
    return x


def _retract_all(poses, dx):
    g = group_for(dx.shape[-1])
    out = g.retract(poses, dx)
    if poses.shape[-1] == 12:
        out = se3.renormalize(out)
    return out


def _make_body(cfg: SolverConfig, axis: str, iterations: int, lm: bool):
    """Build the shard_map body: `iterations` GN or LM steps, all on-device."""

    def body(poses, edges, meas, sq, emask, iloop, pidx, pmeas, psq, pmask):
        T = sq.shape[-1]
        eye = jnp.eye(T, dtype=poses.dtype)

        def chi2_at(x):
            r, _, _ = linearize_edges(
                x, edges, meas, sq, emask, iloop,
                huber_delta=cfg.huber_delta, use_huber=cfg.use_huber_on_loops,
            )
            rp, _ = linearize_priors(x, pidx, pmeas, psq, pmask)
            return jax.lax.psum(jnp.sum(r * r), axis) + jnp.sum(rp * rp)

        def gn_or_lm_step(carry, _):
            poses, lam, err = carry
            g_all, diag_all, Aij, _, _ = _local_normal_eq(
                poses, edges, meas, sq, emask, iloop, cfg, axis
            )
            rp, gp, Ap = _priors_contrib(poses, pidx, pmeas, psq, pmask)
            g_all = g_all.at[pidx].add(gp)
            diag_all = diag_all.at[pidx].add(Ap)
            d = jnp.einsum("nii->ni", diag_all)
            damped = diag_all + lam * d[..., None] * eye
            if cfg.preconditioner == "tridiag":
                # Chain off-diagonal blocks assembled across shards with one
                # more psum; each device then runs the identical (replicated)
                # cyclic-reduction solve per CG iteration.
                from graphslam.solver.tridiag import (
                    cr_factor, cr_solve, chain_offdiag,
                )

                U = jax.lax.psum(
                    chain_offdiag(edges, Aij, poses.shape[0]), axis
                )
                fac = cr_factor(damped, U)

                def precond(r):
                    return cr_solve(fac, r)

            else:
                Minv = _block_inv(damped)

                def precond(r):
                    return jnp.einsum("nij,nj->ni", Minv, r)

            dx = _pcg(
                edges, Aij, damped, precond, -g_all, axis,
                cfg.cg_max_iterations, cfg.cg_tol,
            )
            candidate = _retract_all(poses, dx)
            if not lm:
                return (candidate, lam, err), None
            new_err = chi2_at(candidate)
            accepted = new_err < err
            poses = jnp.where(accepted, candidate, poses)
            lam = jnp.where(
                accepted,
                jnp.maximum(lam / cfg.lambda_factor, cfg.min_lambda),
                jnp.minimum(lam * cfg.lambda_factor, cfg.max_lambda),
            )
            err = jnp.where(accepted, new_err, err)
            return (poses, lam, err), None

        lam0 = jnp.asarray(cfg.init_lambda if lm else 0.0, poses.dtype)
        err0 = chi2_at(poses) if lm else jnp.asarray(jnp.inf, poses.dtype)
        (poses, _, _), _ = jax.lax.scan(
            gn_or_lm_step, (poses, lam0, err0), None, length=iterations
        )
        return poses

    return body


@partial(
    jax.jit,
    static_argnames=("mesh", "axis", "cfg", "iterations", "lm"),
)
def _dist_solve(poses, graph: FactorGraph, mesh, axis, cfg, iterations, lm):
    body = _make_body(cfg, axis, iterations, lm)
    fn = shard_map(
        body,
        mesh=mesh,
        in_specs=(
            P(),        # poses replicated
            P(axis),    # edges
            P(axis),    # measurements
            P(axis),    # sqrt_info
            P(axis),    # edge_mask
            P(axis),    # is_loop
            P(), P(), P(), P(),  # priors replicated
        ),
        out_specs=P(),
    )
    return fn(
        poses,
        graph.edges,
        graph.measurements,
        graph.sqrt_info,
        graph.edge_mask,
        graph.is_loop,
        graph.prior_idx,
        graph.prior_meas,
        graph.prior_sqrt_info,
        graph.prior_mask,
    )


def dist_gn_solve(
    poses: jnp.ndarray,
    graph: FactorGraph,
    mesh: Mesh,
    cfg: SolverConfig = SolverConfig(),
    iterations: int = 10,
    axis: str = "dev",
):
    """Distributed Gauss-Newton (fixed iterations) over a factor-sharded
    graph. `graph` should come from `shard_graph(graph, mesh)`."""
    return _dist_solve(poses, graph, mesh, axis, cfg, iterations, False)


def dist_lm_solve(
    poses: jnp.ndarray,
    graph: FactorGraph,
    mesh: Mesh,
    cfg: SolverConfig = SolverConfig(),
    iterations: int = 30,
    axis: str = "dev",
):
    """Distributed LM with the accept/reject + lambda schedule run
    redundantly (replicated) on every device."""
    return _dist_solve(poses, graph, mesh, axis, cfg, iterations, True)
