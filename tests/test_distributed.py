"""Distributed solver tests on the virtual 8-device CPU mesh: the sharded
solver must match the single-device solver bit-for-bit-ish and converge."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphslam import metrics
from graphslam.config import SolverConfig
from graphslam.factors import from_dataset, chi2
from graphslam.io import datasets
from graphslam.parallel import make_mesh, shard_graph, dist_gn_solve, dist_lm_solve
from graphslam.solver import gn_solve


class TestDistributed:
    def test_mesh_has_8_devices(self):
        mesh = make_mesh()
        assert mesh.shape["dev"] == 8

    def test_dist_gn_matches_single_device(self):
        data = datasets.manhattan(n_poses=200, seed=11)
        graph = from_dataset(data)
        poses0 = jnp.asarray(data["poses"])
        cfg = SolverConfig(mode="pcg", cg_max_iterations=300, cg_tol=1e-10)

        single = gn_solve(poses0, graph, cfg, iterations=5)

        mesh = make_mesh()
        sharded = shard_graph(graph, mesh)
        multi = dist_gn_solve(poses0, sharded, mesh, cfg, iterations=5)

        # Same algorithm, different reduction orders — expect float32-level
        # agreement of the final trajectories.
        assert np.allclose(single, multi, atol=5e-3)
        e_s = float(chi2(jnp.asarray(single), graph))
        e_m = float(chi2(jnp.asarray(multi), graph))
        assert abs(e_s - e_m) < 1e-2 * max(e_s, 1.0)

    def test_dist_lm_converges_se2(self):
        data = datasets.manhattan(n_poses=400, seed=12)
        graph = from_dataset(data)
        poses0 = jnp.asarray(data["poses"])
        mesh = make_mesh()
        sharded = shard_graph(graph, mesh)
        out = dist_lm_solve(poses0, sharded, mesh, SolverConfig(), iterations=20)
        e0 = float(chi2(poses0, graph))
        e1 = float(chi2(jnp.asarray(out), graph))
        assert e1 < 0.1 * e0
        # Single-device LM on this graph bottoms out at ATE ~0.70 (15 loop
        # closures over 400 poses); distributed must match that optimum.
        ate = float(metrics.ate(jnp.asarray(out), jnp.asarray(data["gt"])))
        assert ate < 0.8

    def test_dist_lm_converges_se3(self):
        data = datasets.sphere(n_rings=6, poses_per_ring=10, radius=4.0, seed=13)
        graph = from_dataset(data)
        poses0 = jnp.asarray(data["poses"])
        mesh = make_mesh()
        sharded = shard_graph(graph, mesh)
        out = dist_lm_solve(poses0, sharded, mesh, SolverConfig(), iterations=25)
        e0 = float(chi2(poses0, graph))
        e1 = float(chi2(jnp.asarray(out), graph))
        assert e1 < 0.2 * e0

    def test_deterministic_across_runs(self):
        # The reference's 'race detection' story was single-threaded spins
        # (SURVEY.md §5); ours is determinism by construction — identical
        # inputs must give bitwise-identical results across runs, collectives
        # included.
        data = datasets.manhattan(n_poses=150, seed=15)
        graph = from_dataset(data)
        poses0 = jnp.asarray(data["poses"])
        mesh = make_mesh()
        sharded = shard_graph(graph, mesh)
        cfg = SolverConfig(mode="pcg", cg_max_iterations=40)
        a = np.asarray(dist_gn_solve(poses0, sharded, mesh, cfg, iterations=4))
        b = np.asarray(dist_gn_solve(poses0, sharded, mesh, cfg, iterations=4))
        assert np.array_equal(a, b)

    def test_edge_padding_is_harmless(self):
        # 7 edges over 8 devices forces padding; masked pads must not change
        # the solution.
        data = datasets.manhattan(n_poses=8, seed=14)
        graph = from_dataset(data)
        poses0 = jnp.asarray(data["poses"])
        mesh = make_mesh()
        sharded = shard_graph(graph, mesh)
        multi = dist_gn_solve(poses0, sharded, mesh, SolverConfig(mode="pcg"), iterations=3)
        single = gn_solve(poses0, graph, SolverConfig(mode="pcg"), iterations=3)
        assert np.allclose(single, multi, atol=1e-3)


# Mesh-size invariance: the same graph on 1, 2, 4 and 8 devices must reach
# the single-device solver's answer (reduction order differs; float32).
@pytest.fixture(scope="module")
def invariance_case():
    data = datasets.manhattan(n_poses=120, seed=16)
    return from_dataset(data), jnp.asarray(data["poses"])


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_dist_lm_mesh_size_invariance(n_dev, invariance_case):
    from graphslam.solver import lm_solve

    graph, poses0 = invariance_case
    cfg = SolverConfig(mode="pcg", cg_max_iterations=200, cg_tol=1e-10,
                       max_iterations=15)
    single = lm_solve(poses0, graph, cfg)
    mesh = make_mesh(num_devices=n_dev)
    multi = dist_lm_solve(poses0, shard_graph(graph, mesh), mesh, cfg,
                          iterations=15)
    e_s = float(single.error)
    e_m = float(chi2(jnp.asarray(multi), graph))
    assert abs(e_m - e_s) <= 1e-3 * e_s, (e_s, e_m)
    assert np.allclose(single.poses, multi, atol=5e-3)


@pytest.mark.parametrize("n_dev", [1, 2, 4, 8])
def test_dist_schur_mesh_size_invariance(n_dev, invariance_case):
    from graphslam.parallel.dist_schur import dist_schur_gn_solve
    from graphslam.solver.schur import schur_plan

    graph, poses0 = invariance_case
    single = gn_solve(poses0, graph, SolverConfig(mode="dense"), iterations=4)
    plan = schur_plan(np.asarray(graph.edges), poses0.shape[0], 8)
    multi = dist_schur_gn_solve(poses0, graph, plan, make_mesh(num_devices=n_dev),
                                iterations=4)
    assert np.allclose(single, multi, atol=5e-3)
    e_s = float(chi2(single, graph))
    e_m = float(chi2(jnp.asarray(multi), graph))
    assert abs(e_m - e_s) <= 1e-3 * e_s + 1e-3, (e_s, e_m)
