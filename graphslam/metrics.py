"""Trajectory evaluation: ATE / RPE and graph chi-squared.

The reference's only 'metric' was eyeballing rviz arrows (SURVEY.md §4);
these are the quantitative replacements the BASELINE targets require.
"""

from __future__ import annotations

import jax.numpy as jnp

from graphslam.geometry import se2, se3


def _positions(poses: jnp.ndarray) -> jnp.ndarray:
    if poses.shape[-1] == 3:  # SE2 [x,y,theta]
        return poses[..., :2]
    return se3.trans(poses)  # SE3 flat [R|t]


def align_umeyama(est: jnp.ndarray, ref: jnp.ndarray):
    """Least-squares similarity (rotation+translation, no scale) aligning
    estimated positions to reference positions. Returns (R, t) with
    aligned = est @ R.T + t."""
    mu_e = est.mean(axis=0)
    mu_r = ref.mean(axis=0)
    E = est - mu_e
    Rf = ref - mu_r
    C = Rf.T @ E / est.shape[0]
    U, _, Vt = jnp.linalg.svd(C)
    d = jnp.sign(jnp.linalg.det(U @ Vt))
    D = jnp.diag(jnp.concatenate([jnp.ones(est.shape[-1] - 1), d[None]]))
    R = U @ D @ Vt
    t = mu_r - R @ mu_e
    return R, t


def ate(estimate: jnp.ndarray, reference: jnp.ndarray, align: bool = True):
    """Absolute trajectory error (RMSE of position residuals after optional
    rigid alignment). Accepts SE2 (N,3) or SE3 (N,12) pose arrays."""
    p_est = _positions(estimate)
    p_ref = _positions(reference)
    if align:
        R, t = align_umeyama(p_est, p_ref)
        p_est = p_est @ R.T + t
    err2 = jnp.sum((p_est - p_ref) ** 2, axis=-1)
    return jnp.sqrt(jnp.mean(err2))


def rpe(estimate: jnp.ndarray, reference: jnp.ndarray, delta: int = 1):
    """Relative pose error over index offset `delta` (translation RMSE)."""
    if estimate.shape[-1] == 3:
        rel_e = se2.between(estimate[:-delta], estimate[delta:])
        rel_r = se2.between(reference[:-delta], reference[delta:])
        dt = rel_e[..., :2] - rel_r[..., :2]
    else:
        rel_e = se3.between(estimate[:-delta], estimate[delta:])
        rel_r = se3.between(reference[:-delta], reference[delta:])
        dt = se3.trans(rel_e) - se3.trans(rel_r)
    return jnp.sqrt(jnp.mean(jnp.sum(dt * dt, axis=-1)))
