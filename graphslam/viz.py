"""Trajectory / map visualization — the markers-node + rviz replacement.

The reference re-published every keyframe pose as an rviz ARROW marker at
20 Hz (basic_shapes.cpp:13-42,92-103) and optionally per-scan-point SPHERE
markers (disabled, :44-78). The batch equivalents: matplotlib figures of the
trajectory with heading arrows, the factor-graph edges (loops highlighted),
and the reprojected map cloud.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def plot_trajectory(
    poses,
    gt=None,
    edges=None,
    is_loop=None,
    covariances=None,
    path: Optional[str] = None,
    title: str = "trajectory",
    arrow_every: int = 20,
    ellipse_every: int = 10,
    ellipse_sigma: float = 2.0,
):
    """Plot an SE(2) (N,3) or SE(3) (N,12) trajectory; optionally overlay
    ground truth, graph edges (loop closures in red), and per-pose
    uncertainty ellipses from (N, 3, 3) marginal covariances (the
    Pose2DWithCovariance contract drawn the way rviz renders covariance
    markers — `ellipse_sigma`-sigma contours of the xy block)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    poses = np.asarray(poses)
    if poses.shape[-1] == 12:
        xy = poses[:, 9:11]
        fig, ax = plt.subplots(figsize=(7, 7))
    else:
        xy = poses[:, :2]
        fig, ax = plt.subplots(figsize=(7, 7))

    if edges is not None:
        edges = np.asarray(edges)
        mask = np.ones(len(edges), bool) if is_loop is None else np.asarray(is_loop)
        for (i, j), lp in zip(edges, mask):
            ax.plot(
                [xy[i, 0], xy[j, 0]],
                [xy[i, 1], xy[j, 1]],
                color="tomato" if lp else "0.85",
                lw=0.7 if lp else 0.4,
                zorder=1,
            )
    if gt is not None:
        gt = np.asarray(gt)
        gxy = gt[:, 9:11] if gt.shape[-1] == 12 else gt[:, :2]
        ax.plot(gxy[:, 0], gxy[:, 1], "g--", lw=0.8, label="ground truth", zorder=2)
    ax.plot(xy[:, 0], xy[:, 1], "b-", lw=1.0, label="estimate", zorder=3)
    if covariances is not None:
        from matplotlib.patches import Ellipse

        covs = np.asarray(covariances)
        for k in range(0, len(covs), max(ellipse_every, 1)):
            C = covs[k][:2, :2]
            if not np.all(np.isfinite(C)):
                continue
            w, V = np.linalg.eigh(0.5 * (C + C.T))
            w = np.maximum(w, 0.0)
            ang = np.degrees(np.arctan2(V[1, 1], V[0, 1]))
            ax.add_patch(Ellipse(
                xy[k], width=2 * ellipse_sigma * np.sqrt(w[1]),
                height=2 * ellipse_sigma * np.sqrt(w[0]), angle=ang,
                facecolor="none", edgecolor="orange", lw=0.7, zorder=4,
            ))
    # Heading arrows (the rviz ARROW markers).
    if poses.shape[-1] == 3:
        sub = poses[::arrow_every]
        ax.quiver(
            sub[:, 0], sub[:, 1], np.cos(sub[:, 2]), np.sin(sub[:, 2]),
            scale=40, width=2.5e-3, color="navy", zorder=4,
        )
    ax.set_aspect("equal")
    ax.legend(loc="best", fontsize=8)
    ax.set_title(title)
    if path:
        fig.savefig(path, dpi=130, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig


def plot_map(kf_poses, kf_points, kf_masks, num_kf, path: Optional[str] = None):
    """Reproject keyframe scans through optimized poses into one map cloud
    (the disabled create_scan spheres, done right)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from graphslam.geometry import se2
    import jax.numpy as jnp

    n = int(num_kf)
    poses = jnp.asarray(np.asarray(kf_poses)[:n])
    pts = jnp.asarray(np.asarray(kf_points)[:n])
    world = np.asarray(se2.transform(poses[:, None, :].squeeze(1), pts))
    masks = np.asarray(kf_masks)[:n]

    fig, ax = plt.subplots(figsize=(7, 7))
    for k in range(n):
        w = world[k][masks[k]]
        ax.scatter(w[:, 0], w[:, 1], s=0.2, c="0.4", alpha=0.5)
    p = np.asarray(poses)
    ax.plot(p[:, 0], p[:, 1], "b.-", lw=1.0, ms=2.5)
    ax.set_aspect("equal")
    ax.set_title(f"map ({n} keyframes)")
    if path:
        fig.savefig(path, dpi=130, bbox_inches="tight")
        plt.close(fig)
        return path
    return fig
