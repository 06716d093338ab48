"""Segment-world raycasting + scripted trajectories (Stage equivalent)."""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from graphslam.config import FrontendConfig
from graphslam.frontend.projection import beam_angles
from graphslam.geometry import se2


class World(NamedTuple):
    segments: jnp.ndarray  # (S, 2, 2): [start xy, end xy] walls


def default_world() -> World:
    """An indoor-ish floorplan: outer box + interior walls/obstacles."""
    segs = []

    def box(x0, y0, x1, y1):
        segs.extend(
            [
                [[x0, y0], [x1, y0]],
                [[x1, y0], [x1, y1]],
                [[x1, y1], [x0, y1]],
                [[x0, y1], [x0, y0]],
            ]
        )

    box(-10.0, -8.0, 10.0, 8.0)          # outer walls
    box(-4.0, -3.0, -1.5, -0.5)          # room/obstacle
    box(2.0, 1.0, 5.0, 4.0)              # another obstacle
    segs.append([[-10.0, 3.0], [-5.0, 3.0]])   # wall stub
    segs.append([[5.0, -8.0], [5.0, -3.5]])    # wall stub
    segs.append([[0.0, -8.0], [0.0, -5.0]])    # wall stub
    return World(segments=jnp.asarray(segs, jnp.float32))


@partial(jax.jit, static_argnames=())
def raycast(world: World, pose: jnp.ndarray, angles: jnp.ndarray, max_range: float):
    """Cast |angles| rays from SE(2) `pose`; returns ranges (B,).

    Vectorized ray-segment intersection over the full (B, S) grid — dense,
    tiny, and fused by XLA; no spatial structure needed at this scale.
    """
    o = pose[:2]
    th = pose[2] + angles
    d = jnp.stack([jnp.cos(th), jnp.sin(th)], axis=-1)        # (B, 2)
    a = world.segments[:, 0]                                   # (S, 2)
    b = world.segments[:, 1]
    e = b - a                                                  # (S, 2)
    ao = a - o                                                 # (S, 2)

    # Solve o + t d = a + u e:  t = cross(ao, e)/cross(d, e), u = cross(ao, d)/cross(d, e)
    cross_de = d[:, None, 0] * e[None, :, 1] - d[:, None, 1] * e[None, :, 0]  # (B, S)
    cross_aoe = ao[None, :, 0] * e[None, :, 1] - ao[None, :, 1] * e[None, :, 0]
    cross_aod = ao[None, :, 0] * d[:, None, 1] - ao[None, :, 1] * d[:, None, 0]
    denom = jnp.where(jnp.abs(cross_de) < 1e-12, 1e-12, cross_de)
    t = cross_aoe / denom
    u = cross_aod / denom
    hit = (t > 1e-6) & (u >= 0.0) & (u <= 1.0)
    t = jnp.where(hit, t, jnp.inf)
    r = jnp.min(t, axis=1)
    return jnp.minimum(r, max_range + 1.0)  # beyond max_range => masked later


def figure_eight_waypoints() -> np.ndarray:
    """A loop-closing tour of the default world (revisits its start)."""
    return np.array(
        [
            [-7.0, -5.0], [-7.0, 0.0], [-7.0, 5.0], [-2.0, 5.5], [0.0, 3.0],
            [0.5, 0.0], [-0.5, -2.5], [2.0, -5.0], [6.5, -5.5], [8.0, -2.0],
            [8.0, 2.0], [6.5, 5.5], [1.5, 6.5], [-2.0, 6.0], [-7.0, 5.0],
            [-7.0, 0.0], [-7.0, -5.0],
        ],
        np.float32,
    )


def _waypoint_trajectory(waypoints: np.ndarray, step_len: float) -> np.ndarray:
    """Piecewise-linear path resampled at ~step_len with headings along the
    path; returns (T, 3) poses."""
    pts = []
    for k in range(len(waypoints) - 1):
        a, b = waypoints[k], waypoints[k + 1]
        seg = b - a
        n = max(1, int(np.ceil(np.linalg.norm(seg) / step_len)))
        for i in range(n):
            pts.append(a + seg * (i / n))
    pts.append(waypoints[-1])
    pts = np.asarray(pts, np.float32)
    headings = np.arctan2(
        np.diff(pts[:, 1], append=pts[-1, 1] + 1e-9),
        np.diff(pts[:, 0], append=pts[-1, 0] + 1e-9),
    ).astype(np.float32)
    # Smooth headings to avoid instant turns.
    return np.concatenate([pts, headings[:, None]], axis=-1)


def simulate_trajectory(
    cfg: FrontendConfig,
    world: World | None = None,
    waypoints: np.ndarray | None = None,
    step_len: float = 0.25,
    odom_trans_sigma: float = 0.01,
    odom_rot_sigma: float = 0.004,
    seed: int = 0,
):
    """Run the scripted robot through the world.

    Returns dict with:
      gt_poses    (T, 3)
      scans       (T, B) simulated ranges (reference laser model)
      odom_deltas (T-1, 3) noisy relative odometry (the /cmd_vel integration
                  the reference's odometry node intended, odometry.cpp:139-206)
    """
    world = world or default_world()
    wps = waypoints if waypoints is not None else figure_eight_waypoints()
    gt = _waypoint_trajectory(wps, step_len)
    angles = beam_angles(cfg.num_beams, cfg.fov_rad)

    scan_fn = jax.jit(
        jax.vmap(lambda p: raycast(world, p, angles, cfg.max_range))
    )
    scans = np.asarray(scan_fn(jnp.asarray(gt)))

    rng = np.random.default_rng(seed)
    deltas = np.asarray(se2.between(jnp.asarray(gt[:-1]), jnp.asarray(gt[1:])))
    noise = rng.normal(size=deltas.shape).astype(np.float32) * np.array(
        [odom_trans_sigma, odom_trans_sigma, odom_rot_sigma], np.float32
    )
    odom = deltas + noise
    return {"gt_poses": gt, "scans": scans, "odom_deltas": odom, "world": world}
