"""Partitioned Schur solver vs the dense reference solve."""

import jax.numpy as jnp
import numpy as np
import pytest

from graphslam.factors import from_dataset, linearize
from graphslam.io import datasets
from graphslam.solver import build_blocks, dense_solve
from graphslam.solver.schur import schur_plan, schur_solve


@pytest.mark.parametrize("num_blocks", [2, 4, 7])
def test_schur_matches_dense_se2(num_blocks):
    data = datasets.manhattan(n_poses=120, seed=23)
    graph = from_dataset(data)
    poses = jnp.asarray(data["poses"])
    lin = linearize(poses, graph)
    sys = build_blocks(lin, graph, 120)
    lam = jnp.asarray(1e-4)

    dx_dense = dense_solve(sys, lam)
    plan = schur_plan(np.asarray(graph.edges), 120, num_blocks)
    assert plan.Q > 0
    dx_schur = schur_solve(plan, sys, lam)
    assert np.allclose(dx_schur, dx_dense, rtol=1e-2, atol=1e-3), (
        np.abs(np.asarray(dx_schur - dx_dense)).max()
    )


def test_schur_matches_dense_se3():
    data = datasets.sphere(n_rings=6, poses_per_ring=8, radius=4.0, seed=24)
    graph = from_dataset(data)
    n = data["poses"].shape[0]
    poses = jnp.asarray(data["poses"])
    lin = linearize(poses, graph)
    sys = build_blocks(lin, graph, n)
    lam = jnp.asarray(1e-3)
    dx_dense = dense_solve(sys, lam)
    plan = schur_plan(np.asarray(graph.edges), n, 3)
    dx_schur = schur_solve(plan, sys, lam)
    assert np.allclose(dx_schur, dx_dense, rtol=2e-2, atol=2e-3)


def test_dist_schur_matches_single_device():
    from graphslam.parallel import make_mesh
    from graphslam.parallel.dist_schur import dist_schur_solve

    data = datasets.manhattan(n_poses=160, seed=26)
    graph = from_dataset(data)
    poses = jnp.asarray(data["poses"])
    lin = linearize(poses, graph)
    sys = build_blocks(lin, graph, 160)
    lam = jnp.asarray(1e-4)
    plan = schur_plan(np.asarray(graph.edges), 160, 6)  # 6 blocks over 8 devices
    single = schur_solve(plan, sys, lam)
    mesh = make_mesh()
    multi = dist_schur_solve(plan, sys, lam, mesh)
    assert np.allclose(single, multi, rtol=1e-3, atol=1e-4)


def test_dist_schur_gn_converges_sphere():
    # BASELINE config 5 end-to-end: SE(3) sphere optimized with the
    # mesh-sharded partitioned-Schur direct solver.
    from graphslam.factors import chi2
    from graphslam.parallel import make_mesh
    from graphslam.parallel.dist_schur import dist_schur_gn_solve

    data = datasets.sphere(n_rings=8, poses_per_ring=10, radius=5.0, seed=27)
    n = data["poses"].shape[0]
    graph = from_dataset(data)
    plan = schur_plan(np.asarray(graph.edges), n, 4)
    mesh = make_mesh()
    poses = dist_schur_gn_solve(
        jnp.asarray(data["poses"]), graph, plan, mesh, iterations=8
    )
    e0 = float(chi2(jnp.asarray(data["poses"]), graph))
    e1 = float(chi2(poses, graph))
    assert e1 < 0.1 * e0, (e0, e1)


def test_dist_schur_gn_sharded_mesh_invariant():
    # The fully-sharded GN scan (per-device linearize of owned edges only,
    # VERDICT r3 #4) must produce the same trajectory on 1 and 8 devices.
    from graphslam.factors import chi2
    from graphslam.parallel import make_mesh
    from graphslam.parallel.dist_schur import dist_schur_gn_solve

    data = datasets.manhattan(n_poses=160, seed=26, loop_prob=0.25)
    graph = from_dataset(data)
    poses0 = jnp.asarray(data["poses"])
    plan = schur_plan(np.asarray(graph.edges), 160, 8)
    out1 = np.asarray(dist_schur_gn_solve(
        poses0, graph, plan, make_mesh(num_devices=1), iterations=5
    ))
    out8 = np.asarray(dist_schur_gn_solve(
        poses0, graph, plan, make_mesh(num_devices=8), iterations=5
    ))
    assert np.allclose(out1, out8, atol=1e-4), np.abs(out1 - out8).max()
    e0 = float(chi2(poses0, graph))
    e1 = float(chi2(jnp.asarray(out8), graph))
    assert e1 < 0.1 * e0, (e0, e1)


def test_separator_is_small_for_banded_graph():
    # sphere rings: only boundary rings become separators.
    # 2 blocks of 5 rings: only the two rings at the cut are separators.
    data = datasets.sphere(n_rings=10, poses_per_ring=10, radius=5.0, seed=25)
    n = data["poses"].shape[0]
    plan = schur_plan(np.asarray(data["edges"]), n, 2)
    assert plan.Q < 0.3 * n, plan.Q
