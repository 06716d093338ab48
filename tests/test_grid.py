"""Occupancy-grid raycaster vs the exact segment raycaster, and PGM IO."""

import jax.numpy as jnp
import numpy as np

from graphslam.config import FrontendConfig
from graphslam.frontend.projection import beam_angles
from graphslam.sim import default_world, raycast
from graphslam.sim.grid import load_pgm, rasterize_world, raycast_grid


def test_grid_matches_segment_raycast():
    world = default_world()
    gw = rasterize_world(world, resolution=0.04)
    cfg = FrontendConfig(num_beams=181)
    angles = beam_angles(cfg.num_beams, cfg.fov_rad)
    for pose in [jnp.array([-7.0, -5.0, 0.2]), jnp.array([0.5, 0.0, -1.0])]:
        exact = np.asarray(raycast(world, pose, angles, cfg.max_range))
        grid = np.asarray(raycast_grid(gw, pose, angles, cfg.max_range))
        valid = exact <= cfg.max_range
        # Grid marching quantizes at the cell scale; rays tangent to a wall
        # face or clipping a segment endpoint may disagree entirely between
        # the two world models, so compare robustly: the bulk must agree to
        # the cell scale and near-tangent outliers must be rare.
        err = np.abs(grid[valid] - exact[valid])
        assert np.median(err) < 0.05
        assert np.quantile(err, 0.97) < 0.3, np.quantile(err, 0.97)


def test_pgm_roundtrip(tmp_path):
    # Write a tiny P5 map: border walls.
    H = W = 40
    img = np.full((H, W), 255, np.uint8)
    img[0, :] = img[-1, :] = img[:, 0] = img[:, -1] = 0
    path = str(tmp_path / "map.pgm")
    with open(path, "wb") as f:
        f.write(b"P5\n# test map\n%d %d\n255\n" % (W, H))
        f.write(img.tobytes())
    gw = load_pgm(path, resolution=0.1)
    assert gw.occ.shape == (H, W)
    assert bool(gw.occ[0, 0]) and not bool(gw.occ[H // 2, W // 2])
    # Raycast from the middle: walls at ~2.0 m in each axis direction.
    r = np.asarray(
        raycast_grid(gw, jnp.zeros(3), jnp.array([0.0, np.pi / 2]), 30.0)
    )
    assert np.all(np.abs(r - 1.9) < 0.2), r
