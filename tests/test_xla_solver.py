"""The XLA solver path (pcg) against the dense reference, over the graph
cases the single-device solvers must handle.

Both run under "highest" matmul precision, so that the comparison is
float32 against float32 on any backend (an accelerator may otherwise run a
float32 dot at reduced precision).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from graphslam.config import SolverConfig
from graphslam.factors import chi2, from_dataset
from graphslam.factors.linearize import group_for
from graphslam.io import datasets
from graphslam.solver import gn_solve, lm_solve


def _graph(group: str, case: str):
    if group == "se2":
        data = datasets.manhattan(n_poses=60, loop_skip=10, loop_radius=1.5,
                                  seed=31)
    else:
        data = datasets.sphere(n_rings=5, poses_per_ring=8, radius=4.0, seed=32)
    if case == "chain":
        keep = ~np.asarray(data["is_loop"])
        data = dict(data, edges=data["edges"][keep],
                    measurements=data["measurements"][keep],
                    information=data["information"][keep], is_loop=data["is_loop"][keep])
    graph = from_dataset(data)
    if case == "masked":
        # Every third loop edge switched off (the online graph's empty slots).
        loops = np.flatnonzero(np.asarray(graph.is_loop))
        mask = np.ones(graph.num_edges, bool)
        mask[loops[::3]] = False
        graph = graph.replace(edge_mask=jnp.asarray(mask))
    # Start away from the optimum (a chain-only graph's dataset poses are
    # already consistent with its odometry).
    poses = jnp.asarray(data["poses"])
    T = graph.tangent_dim
    dx = 0.05 * jax.random.normal(jax.random.PRNGKey(33), (poses.shape[0], T))
    return graph, group_for(T).retract(poses, dx)


@pytest.mark.parametrize("method", ["gn", "lm"])
@pytest.mark.parametrize("case", ["loops", "chain", "masked", "huber"])
@pytest.mark.parametrize("group", ["se2", "se3"])
def test_pcg_matches_dense(group, case, method):
    graph, poses0 = _graph(group, case)
    if case != "chain":
        assert bool(jnp.any(graph.is_loop & graph.edge_mask))
    base = SolverConfig(cg_max_iterations=400, cg_tol=1e-12,
                        use_huber_on_loops=case == "huber", max_iterations=6)
    out = {}
    with jax.default_matmul_precision("highest"):
        for mode in ("dense", "pcg"):
            cfg = dataclasses.replace(base, mode=mode)
            if method == "gn":
                out[mode] = gn_solve(poses0, graph, cfg, iterations=3)
            else:
                out[mode] = lm_solve(poses0, graph, cfg).poses
    e0 = float(chi2(poses0, graph))
    ed, ep = (float(chi2(out[m], graph)) for m in ("dense", "pcg"))
    assert ed < e0
    # CG to 1e-12 relative residual vs a Cholesky solve: float32 agreement.
    assert abs(ep - ed) <= 1e-3 * ed + 1e-3, (ed, ep)
    np.testing.assert_allclose(out["pcg"], out["dense"], atol=2e-3)


def test_removed_modes_are_rejected():
    for mode in ("gn_fused", "pcg_fused"):
        with pytest.raises(ValueError, match="unknown solver mode"):
            SolverConfig(mode=mode)
