"""Batched residuals + Jacobians for prior/between factors.

One vmapped forward-mode linearization replaces GTSAM's per-factor virtual
`linearize()` dispatch (graph.cpp:119's optimizer internals). Residuals are
proper Lie local-coordinates,  r = Log(z^-1 · x_i^-1 · x_j),  matching
gtsam::BetweenFactor semantics so the optimum transfers; Jacobians are taken
with `jax.jacfwd` w.r.t. right-tangent perturbations (exact, and for T=3/6
outputs forward mode costs only 2T tiny evals — negligible next to the
solve). Whitening and optional Huber reweighting are fused here.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from graphslam.factors.graph import FactorGraph
from graphslam.geometry import se2, se3


def group_for(tangent_dim: int):
    return se2 if tangent_dim == 3 else se3


class Linearization(NamedTuple):
    """Whitened per-factor blocks at the current estimate.

    r      (E, T)      whitened between residuals
    Ji, Jj (E, T, T)   whitened Jacobians w.r.t. endpoint tangents
    rp     (P, T)      whitened prior residuals
    Jp     (P, T, T)   whitened prior Jacobians
    """

    r: jnp.ndarray
    Ji: jnp.ndarray
    Jj: jnp.ndarray
    rp: jnp.ndarray
    Jp: jnp.ndarray


def _between_residual(g, xi, xj, z):
    return g.local(z, g.between(xi, xj))


def _prior_residual(g, x, z):
    return g.local(z, x)


def residuals(poses: jnp.ndarray, graph: FactorGraph) -> jnp.ndarray:
    """Whitened between residuals (E, T), zeroed where masked."""
    g = group_for(graph.tangent_dim)
    xi = poses[graph.edges[:, 0]]
    xj = poses[graph.edges[:, 1]]
    r = jax.vmap(lambda a, b, z: _between_residual(g, a, b, z))(
        xi, xj, graph.measurements
    )
    rw = jnp.einsum("eab,eb->ea", graph.sqrt_info, r)
    return jnp.where(graph.edge_mask[:, None], rw, 0.0)


def _huber_weights(rw: jnp.ndarray, is_loop: jnp.ndarray, delta: float, enabled: bool):
    """IRLS sqrt-weights for a Huber kernel applied to loop edges only."""
    if not enabled:
        return jnp.ones(rw.shape[0], rw.dtype)
    norm = jnp.linalg.norm(rw, axis=-1)
    w = jnp.minimum(1.0, delta / jnp.maximum(norm, 1e-12))
    return jnp.where(is_loop, jnp.sqrt(w), 1.0)


def chi2(
    poses: jnp.ndarray,
    graph: FactorGraph,
    huber_delta: float = 1.0,
    use_huber: bool = False,
) -> jnp.ndarray:
    """Total (optionally robustified) cost: sum of squared whitened residuals,
    with Huber rho on loop edges when enabled. This is GTSAM's `error()`."""
    g = group_for(graph.tangent_dim)
    rw = residuals(poses, graph)
    e = jnp.sum(rw * rw, axis=-1)
    if use_huber:
        n = jnp.sqrt(jnp.maximum(e, 1e-24))
        rho = jnp.where(n <= huber_delta, e, 2.0 * huber_delta * n - huber_delta**2)
        e = jnp.where(graph.is_loop, rho, e)
    e = jnp.where(graph.edge_mask, e, 0.0)

    xp = poses[graph.prior_idx]
    rp = jax.vmap(lambda a, z: _prior_residual(g, a, z))(xp, graph.prior_meas)
    rpw = jnp.einsum("pab,pb->pa", graph.prior_sqrt_info, rp)
    ep = jnp.where(graph.prior_mask, jnp.sum(rpw * rpw, axis=-1), 0.0)
    return jnp.sum(e) + jnp.sum(ep)


def linearize_edges(
    poses: jnp.ndarray,
    edges: jnp.ndarray,
    measurements: jnp.ndarray,
    sqrt_info: jnp.ndarray,
    edge_mask: jnp.ndarray,
    is_loop: jnp.ndarray,
    huber_delta: float = 1.0,
    use_huber: bool = False,
):
    """Whitened (r, Ji, Jj) for an arbitrary slice of between-edges.

    Array-level so the sharded solver can call it on a per-device shard
    inside shard_map (parallel/dist.py) with identical semantics.
    """
    T = sqrt_info.shape[-1]
    g = group_for(T)
    zeros = jnp.zeros((T,), poses.dtype)

    xi = poses[edges[:, 0]]
    xj = poses[edges[:, 1]]

    if T == 3:
        # Analytic SE(2) path (hot): r = Log(z^-1 h) with h = x_i^-1 x_j;
        #   dr/d(delta_j) =  Jr^{-1}(r)
        #   dr/d(delta_i) = -Jr^{-1}(r) Ad(h^-1)
        # (right-perturbation chain rule; validated against jacfwd in
        # tests/test_factors.py). Saves the 2T forward-mode passes.
        h = se2.between(xi, xj)
        r = se2.log(se2.between(measurements, h))
        Jr_inv = se2.right_jacobian_inv(r)
        Ad_hinv = se2.adjoint(se2.inverse(h))
        Jj = Jr_inv
        Ji = -jnp.einsum("eab,ebc->eac", Jr_inv, Ad_hinv)
    else:
        # Analytic SE(3): same chain rule with the Barfoot-Q Jacobian inverse.
        h = se3.between(xi, xj)
        r = se3.log(se3.between(measurements, h))
        Jr_inv = se3.right_jacobian_inv(r)
        Ad_hinv = se3.adjoint(se3.inverse(h))
        Jj = Jr_inv
        Ji = -jnp.einsum("eab,ebc->eac", Jr_inv, Ad_hinv)

    rw = jnp.einsum("eab,eb->ea", sqrt_info, r)
    Jiw = jnp.einsum("eab,ebc->eac", sqrt_info, Ji)
    Jjw = jnp.einsum("eab,ebc->eac", sqrt_info, Jj)

    # Robust reweighting (loop edges only — BASELINE config 2).
    sw = _huber_weights(rw, is_loop, huber_delta, use_huber)
    m = jnp.where(edge_mask, sw, 0.0)[:, None]
    return rw * m, Jiw * m[..., None], Jjw * m[..., None]


def linearize_priors(
    poses: jnp.ndarray,
    prior_idx: jnp.ndarray,
    prior_meas: jnp.ndarray,
    prior_sqrt_info: jnp.ndarray,
    prior_mask: jnp.ndarray,
):
    """Whitened (rp, Jp) for the prior factors."""
    T = prior_sqrt_info.shape[-1]
    g = group_for(T)
    zeros = jnp.zeros((T,), poses.dtype)
    xp = poses[prior_idx]

    if T == 3:
        rp = se2.log(se2.between(prior_meas, xp))
        Jp = se2.right_jacobian_inv(rp)
    else:
        rp = se3.log(se3.between(prior_meas, xp))
        Jp = se3.right_jacobian_inv(rp)
    rpw = jnp.einsum("pab,pb->pa", prior_sqrt_info, rp)
    Jpw = jnp.einsum("pab,pbc->pac", prior_sqrt_info, Jp)
    pm = prior_mask[:, None].astype(poses.dtype)
    return rpw * pm, Jpw * pm[..., None]


def linearize(
    poses: jnp.ndarray,
    graph: FactorGraph,
    huber_delta: float = 1.0,
    use_huber: bool = False,
) -> Linearization:
    """Whitened residuals and Jacobians at `poses` for every factor at once."""
    rw, Jiw, Jjw = linearize_edges(
        poses,
        graph.edges,
        graph.measurements,
        graph.sqrt_info,
        graph.edge_mask,
        graph.is_loop,
        huber_delta=huber_delta,
        use_huber=use_huber,
    )
    rpw, Jpw = linearize_priors(
        poses,
        graph.prior_idx,
        graph.prior_meas,
        graph.prior_sqrt_info,
        graph.prior_mask,
    )
    return Linearization(r=rw, Ji=Jiw, Jj=Jjw, rp=rpw, Jp=Jpw)
