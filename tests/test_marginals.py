"""Marginal covariance tests: dense inverse vs CG column solves, and a
sanity law (marginals grow with distance from the anchor along a chain)."""

import jax.numpy as jnp
import numpy as np

from graphslam.factors import from_dataset
from graphslam.io import datasets
from graphslam.solver.marginals import (
    marginal_covariances_dense,
    marginal_covariance_cg,
)


def test_dense_vs_cg():
    data = datasets.manhattan(n_poses=60, seed=17)
    graph = from_dataset(data)
    poses = jnp.asarray(data["gt"])
    dense = marginal_covariances_dense(poses, graph)
    for k in [0, 7, 30, 59]:
        cg = marginal_covariance_cg(poses, graph, jnp.int32(k))
        assert np.allclose(cg, dense[k], rtol=5e-2, atol=1e-5), k


def test_uncertainty_grows_from_anchor():
    # Pure odometry chain: marginal covariance must be monotonically larger
    # (in trace) away from the anchored pose 0.
    data = datasets.manhattan(n_poses=40, seed=18, loop_prob=0.0)
    graph = from_dataset(data)
    poses = jnp.asarray(data["gt"])
    cov = marginal_covariances_dense(poses, graph)
    traces = np.asarray(jnp.einsum("nii->n", cov))
    assert traces[0] < traces[10] < traces[39]


def test_all_pose_selected_inverse_matches_dense():
    from graphslam.solver.marginals import marginal_covariances_all

    data = datasets.manhattan(n_poses=120, loop_prob=0.25, seed=19)
    graph = from_dataset(data)
    poses = jnp.asarray(data["gt"])
    dense = marginal_covariances_dense(poses, graph)
    allc = marginal_covariances_all(poses, graph)
    scale = np.abs(np.asarray(dense)).max()
    np.testing.assert_allclose(
        np.asarray(allc), np.asarray(dense), atol=5e-4 * scale, rtol=2e-2
    )


def test_all_pose_selected_inverse_chain_only():
    from graphslam.solver.marginals import marginal_covariances_all

    data = datasets.manhattan(n_poses=80, loop_prob=0.0, seed=20)
    graph = from_dataset(data)
    poses = jnp.asarray(data["gt"])
    dense = marginal_covariances_dense(poses, graph)
    allc = marginal_covariances_all(poses, graph)
    scale = np.abs(np.asarray(dense)).max()
    np.testing.assert_allclose(
        np.asarray(allc), np.asarray(dense), atol=5e-4 * scale, rtol=2e-2
    )
