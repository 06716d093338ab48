"""Smoke tests for the viz module (figures render and save)."""

import numpy as np

from graphslam import viz
from graphslam.io import datasets


def test_plot_trajectory(tmp_path):
    d = datasets.manhattan(n_poses=100, seed=2)
    p = str(tmp_path / "traj.png")
    out = viz.plot_trajectory(
        d["poses"], gt=d["gt"], edges=d["edges"], is_loop=d["is_loop"], path=p
    )
    assert out == p
    import os

    assert os.path.getsize(p) > 1000


def test_plot_trajectory_se3(tmp_path):
    d = datasets.sphere(n_rings=4, poses_per_ring=6)
    p = str(tmp_path / "traj3.png")
    viz.plot_trajectory(d["poses"], gt=d["gt"], path=p)


def test_plot_map(tmp_path):
    import jax.numpy as jnp

    kf_poses = np.zeros((3, 3), np.float32)
    kf_poses[1, 0] = 1.0
    kf_points = np.random.default_rng(0).normal(size=(3, 32, 2)).astype(np.float32)
    kf_masks = np.ones((3, 32), bool)
    p = str(tmp_path / "map.png")
    viz.plot_map(jnp.asarray(kf_poses), jnp.asarray(kf_points), kf_masks, 3, path=p)
