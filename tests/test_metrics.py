"""ATE/RPE metric tests."""

import jax.numpy as jnp
import numpy as np

from graphslam import metrics
from graphslam.geometry import se2


def test_ate_zero_for_identical():
    traj = jnp.asarray(np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32))
    assert float(metrics.ate(traj, traj)) < 1e-5


def test_ate_invariant_to_rigid_transform():
    rng = np.random.default_rng(1)
    traj = jnp.asarray(rng.normal(size=(60, 3)).astype(np.float32))
    offset = jnp.array([3.0, -2.0, 0.8])
    moved = se2.compose(jnp.broadcast_to(offset, traj.shape), traj)
    assert float(metrics.ate(moved, traj, align=True)) < 1e-3
    assert float(metrics.ate(moved, traj, align=False)) > 1.0


def test_rpe_detects_local_error():
    rng = np.random.default_rng(2)
    traj = jnp.asarray(
        np.cumsum(rng.normal(size=(40, 3)).astype(np.float32) * 0.1, axis=0)
    )
    noisy = traj + 0.05 * jnp.asarray(rng.normal(size=(40, 3)).astype(np.float32))
    assert float(metrics.rpe(traj, traj)) < 1e-6
    assert float(metrics.rpe(noisy, traj)) > 0.01


def test_rpe_se3():
    from graphslam.io import datasets

    d = datasets.sphere(n_rings=4, poses_per_ring=8)
    est = jnp.asarray(d["poses"])
    ref = jnp.asarray(d["gt"])
    r = float(metrics.rpe(est, ref, delta=1))
    assert np.isfinite(r) and r < 1.0
