"""Keyframe gating + motion-scaled measurement covariance.

The reference conflated two decisions in one threshold (scanner.cpp:56-70,
SURVEY.md §3.6.3): it created a keyframe when GICP *fitness exceeded* 0.1 —
a motion/novelty gate (scans differ enough) — and then trusted the delta from
that same poor alignment. We keep its motion gate verbatim and add the
quality gate it lacked.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from graphslam.config import FrontendConfig
from graphslam.frontend.icp import MatchResult


class KeyframeDecision(NamedTuple):
    is_keyframe: jnp.ndarray   # bool: motion gate fired (reference semantics)
    is_reliable: jnp.ndarray   # bool: the delta is trustworthy as a factor


def decide_keyframe(match: MatchResult, cfg: FrontendConfig) -> KeyframeDecision:
    moved_enough = (
        (match.fitness > cfg.keyframe_fitness_threshold)
        | (jnp.linalg.norm(match.delta[..., :2], axis=-1) > cfg.keyframe_trans_threshold)
        | (jnp.abs(match.delta[..., 2]) > cfg.keyframe_rot_threshold)
    )
    reliable = (
        match.converged
        & (match.inlier_rms < cfg.max_match_rmse)
        & (match.matched_frac > 0.5)
    )
    return KeyframeDecision(is_keyframe=moved_enough, is_reliable=reliable)


def motion_covariance(delta: jnp.ndarray, cfg: FrontendConfig) -> jnp.ndarray:
    """Motion-magnitude-scaled diagonal covariance — the intended semantics of
    the reference's compute_covariance (scanner.hpp:64-80, which left its
    off-diagonals uninitialized; SURVEY.md §3.6.5) and of the odometry noise
    model (odometry.cpp:23):
        sigma^2_xy    = k_disp_disp * dl
        sigma^2_theta = k_rot_disp * dl + k_rot_rot * |dtheta|
    """
    dl = jnp.linalg.norm(delta[..., :2], axis=-1)
    dth = jnp.abs(delta[..., 2])
    floor = 1e-6
    var_xy = jnp.maximum(cfg.k_disp_disp * dl, floor)
    var_th = jnp.maximum(cfg.k_rot_disp * dl + cfg.k_rot_rot * dth, floor)
    zeros = jnp.zeros_like(var_xy)
    row0 = jnp.stack([var_xy, zeros, zeros], axis=-1)
    row1 = jnp.stack([zeros, var_xy, zeros], axis=-1)
    row2 = jnp.stack([zeros, zeros, var_th], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2)
