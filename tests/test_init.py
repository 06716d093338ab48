"""Chordal initialization: must land near ground truth even when the
odometry-integrated guess is hopeless, and must rescue LM from that case."""

import jax.numpy as jnp
import numpy as np

from graphslam import metrics
from graphslam.config import SolverConfig
from graphslam.factors import from_dataset, chi2
from graphslam.io import datasets
from graphslam.solver import lm_solve
from graphslam.solver.init import chordal_init_se2


def hard_dataset():
    # Heavy rotation noise: odometry integration drifts far out of the GN
    # basin over 800 steps.
    return datasets.manhattan(
        n_poses=800, rot_sigma=0.06, trans_sigma=0.05, seed=31
    )


def test_chordal_beats_odometry_init():
    data = hard_dataset()
    graph = from_dataset(data)
    gt = jnp.asarray(data["gt"])
    odo = jnp.asarray(data["poses"])
    chordal = chordal_init_se2(graph, 800)
    ate_odo = float(metrics.ate(odo, gt))
    ate_chordal = float(metrics.ate(chordal, gt))
    assert ate_chordal < 0.5 * ate_odo, (ate_chordal, ate_odo)


def test_chordal_rescues_lm():
    data = hard_dataset()
    graph = from_dataset(data)
    gt = jnp.asarray(data["gt"])
    cfg = SolverConfig(mode="pcg", max_iterations=60, cg_max_iterations=100)

    from_odo = lm_solve(jnp.asarray(data["poses"]), graph, cfg)
    chordal = chordal_init_se2(graph, 800)
    from_chordal = lm_solve(chordal, graph, cfg)

    assert float(from_chordal.error) <= float(from_odo.error) * 1.05
    ate = float(metrics.ate(from_chordal.poses, gt))
    ate0 = float(metrics.ate(jnp.asarray(data["poses"]), gt))
    # Information-limited floor for this noise level is ~0.7-0.8 m.
    assert ate < 1.0, ate
    assert ate < 0.25 * ate0, (ate, ate0)


def test_chordal_se3_beats_odometry_init():
    from graphslam.solver.init import chordal_init_se3

    data = datasets.sphere(
        n_rings=15, poses_per_ring=15, radius=8.0, rot_sigma=0.05, seed=35
    )
    n = data["poses"].shape[0]
    graph = from_dataset(data)
    gt = jnp.asarray(data["gt"])
    odo = jnp.asarray(data["poses"])
    chordal = chordal_init_se3(graph, n)
    ate_odo = float(metrics.ate(odo, gt))
    ate_ch = float(metrics.ate(chordal, gt))
    assert ate_ch < 0.7 * ate_odo, (ate_ch, ate_odo)
    # Rotations are valid after projection.
    R = chordal[:, :9].reshape(n, 3, 3)
    RtR = np.einsum("nji,njk->nik", np.asarray(R), np.asarray(R))
    assert np.allclose(RtR, np.eye(3)[None], atol=1e-3)


def test_lm_auto_init():
    data = hard_dataset()
    graph = from_dataset(data)
    gt = jnp.asarray(data["gt"])
    cfg = SolverConfig(mode="pcg", max_iterations=60, cg_max_iterations=100)
    out = lm_solve(jnp.asarray(data["poses"]), graph, cfg, auto_init=True)
    ate = float(metrics.ate(out.poses, gt))
    assert ate < 1.0, ate


def test_chordal_exact_on_noiseless_chain():
    # With exact measurements the linear bootstrap is exact (up to float32).
    data = datasets.manhattan(n_poses=120, rot_sigma=1e-9, trans_sigma=1e-9, seed=33)
    graph = from_dataset(data)
    out = chordal_init_se2(graph, 120)
    gt = jnp.asarray(data["gt"])
    ate = float(metrics.ate(out, gt))
    assert ate < 1e-2, ate
