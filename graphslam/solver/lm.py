"""Gauss-Newton / Levenberg-Marquardt drivers, fully under jit.

This is the JAX rebuild of the one call the whole reference backend exists
to make — gtsam::LevenbergMarquardtOptimizer(graph, initial).optimize()
(graph.cpp:119, SURVEY.md §3.3). The entire trust-region loop (linearize →
damped solve → retract → accept/reject, with the classic lambda
up/down schedule) runs inside a single lax.while_loop: no host round-trips,
one compilation, warm-startable (graph.cpp:130's warm start carries over by
simply passing the previous estimate in).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from graphslam.config import SolverConfig
from graphslam.factors.graph import FactorGraph
from graphslam.factors.linearize import chi2, group_for, linearize
from graphslam.geometry import se3
from graphslam.solver.normal_eq import build_blocks, dense_solve, pcg_solve


class LMState(NamedTuple):
    poses: jnp.ndarray
    lam: jnp.ndarray
    error: jnp.ndarray
    iterations: jnp.ndarray
    converged: jnp.ndarray


def _solve_mode(cfg: SolverConfig, num_poses: int) -> str:
    if cfg.mode == "auto":
        return "dense" if num_poses <= cfg.dense_threshold else "pcg"
    return cfg.mode


def _damped_solve(sys, lam, cfg: SolverConfig, graph: FactorGraph, mode: str):
    """Solve (H + lam I) dx = -g with the selected normal-equation solver."""
    if mode == "dense":
        return dense_solve(sys, lam)
    return pcg_solve(
        sys, lam,
        max_iters=cfg.cg_max_iterations,
        tol=cfg.cg_tol,
        preconditioner=cfg.preconditioner,
        chain_prefix=graph.chain_prefix,
    )


def _retract_all(poses: jnp.ndarray, dx: jnp.ndarray) -> jnp.ndarray:
    g = group_for(dx.shape[-1])
    out = g.retract(poses, dx)
    if poses.shape[-1] == 12:
        out = se3.renormalize(out)
    return out


def _linearized_system(poses, graph, cfg: SolverConfig):
    lin = linearize(
        poses, graph, huber_delta=cfg.huber_delta, use_huber=cfg.use_huber_on_loops
    )
    return build_blocks(lin, graph, poses.shape[0])


@partial(jax.jit, static_argnames=("cfg", "mode"))
def _lm_loop(poses0, graph: FactorGraph, cfg: SolverConfig, mode: str) -> LMState:
    err0 = chi2(
        poses0, graph, huber_delta=cfg.huber_delta, use_huber=cfg.use_huber_on_loops
    )
    init_state = LMState(
        poses=poses0,
        lam=jnp.asarray(cfg.init_lambda, poses0.dtype),
        error=err0,
        iterations=jnp.int32(0),
        converged=jnp.bool_(False),
    )
    sys0 = _linearized_system(poses0, graph, cfg)

    def cond(carry):
        s, _, _ = carry
        return (s.iterations < cfg.max_iterations) & (~s.converged)

    def body(carry):
        s, sys, need_relin = carry
        # After a rejected step the poses haven't moved — reuse the cached
        # linearization and only retry the (cheap) damped solve.
        sys = jax.lax.cond(
            need_relin,
            lambda _: _linearized_system(s.poses, graph, cfg),
            lambda _: sys,
            None,
        )
        dx = _damped_solve(sys, s.lam, cfg, graph, mode)
        candidate = _retract_all(s.poses, dx)
        new_err = chi2(
            candidate, graph,
            huber_delta=cfg.huber_delta, use_huber=cfg.use_huber_on_loops,
        )
        accepted = new_err < s.error

        poses = jnp.where(accepted, candidate, s.poses)
        lam = jnp.where(
            accepted,
            jnp.maximum(s.lam / cfg.lambda_factor, cfg.min_lambda),
            jnp.minimum(s.lam * cfg.lambda_factor, cfg.max_lambda),
        )
        err = jnp.where(accepted, new_err, s.error)
        decrease = s.error - new_err
        converged = accepted & (
            (decrease < cfg.abs_decrease_tol)
            | (decrease < cfg.rel_decrease_tol * s.error)
        )
        converged = converged | (s.lam >= cfg.max_lambda)
        new_s = LMState(
            poses=poses,
            lam=lam,
            error=err,
            iterations=s.iterations + 1,
            converged=converged,
        )
        return new_s, sys, accepted

    s, _, _ = jax.lax.while_loop(
        cond, body, (init_state, sys0, jnp.bool_(False))
    )
    return s


@jax.jit
def auto_init_poses(poses0: jnp.ndarray, graph: FactorGraph) -> jnp.ndarray:
    """Chordal bootstrap, applied only when needed — fully under jit.

    If the whitened chi2 at `poses0` is catastrophically above the
    statistical expectation (>100x the active residual dimension — a
    hopeless basin), run chordal initialization (solver/init.py) and keep
    whichever start has lower chi2. One `lax.cond`: the linear bootstrap
    costs nothing when the incoming guess is sane.
    """
    from graphslam.solver.init import chordal_init_se2, chordal_init_se3

    T = graph.tangent_dim
    m = T * (jnp.sum(graph.edge_mask) + jnp.sum(graph.prior_mask)).astype(
        poses0.dtype
    )
    e0 = chi2(poses0, graph)

    def boot(_):
        init_fn = chordal_init_se2 if T == 3 else chordal_init_se3
        cand = init_fn(graph, poses0.shape[0])
        return jnp.where(chi2(cand, graph) < e0, cand, poses0)

    return jax.lax.cond(e0 > 100.0 * m, boot, lambda _: poses0, None)


def lm_solve(
    poses0: jnp.ndarray,
    graph: FactorGraph,
    cfg: SolverConfig = SolverConfig(),
    auto_init: bool = False,
):
    """Full Levenberg-Marquardt optimization. Returns the final LMState.

    auto_init: if the initial whitened chi2 is catastrophically above the
    statistical expectation (>100x the residual dimension — a hopeless
    basin), bootstrap with chordal initialization first (solver/init.py).
    Jit-safe: the decision is a `lax.cond`, no host round-trips.
    """
    if auto_init:
        poses0 = auto_init_poses(poses0, graph)
    mode = _solve_mode(cfg, poses0.shape[0])
    return _lm_loop(poses0, graph, cfg, mode)


@partial(jax.jit, static_argnames=("cfg", "mode", "iterations"))
def _gn_loop(poses0, graph, cfg: SolverConfig, mode: str, iterations: int):
    def body(poses, _):
        lin = linearize(poses, graph)
        sys = build_blocks(lin, graph, poses.shape[0])
        dx = _damped_solve(sys, jnp.asarray(0.0, poses.dtype), cfg, graph, mode)
        return _retract_all(poses, dx), None

    poses, _ = jax.lax.scan(body, poses0, None, length=iterations)
    return poses


def gn_solve(
    poses0: jnp.ndarray,
    graph: FactorGraph,
    cfg: SolverConfig = SolverConfig(),
    iterations: int = 10,
):
    """Plain Gauss-Newton, fixed iteration count (BASELINE config 1)."""
    mode = _solve_mode(cfg, poses0.shape[0])
    return _gn_loop(poses0, graph, cfg, mode, iterations)
