"""Frontend tests: projection, normals, and GICP matching accuracy on
simulated scans with known ground-truth deltas."""

import jax
import jax.numpy as jnp
import numpy as np

from graphslam.config import FrontendConfig
from graphslam.frontend import gicp_match, scan_to_points
from graphslam.frontend.icp import estimate_normals
from graphslam.frontend.keyframes import motion_covariance
from graphslam.frontend.projection import beam_angles
from graphslam.geometry import se2
from graphslam.sim import default_world, raycast

CFG = FrontendConfig(num_beams=361, fov_rad=4.71716, max_points=384)
ANGLES = beam_angles(CFG.num_beams, CFG.fov_rad)


def scan_at(pose):
    world = default_world()
    r = raycast(world, jnp.asarray(pose, jnp.float32), ANGLES, CFG.max_range)
    return scan_to_points(r, ANGLES, CFG.min_range, CFG.max_range, CFG.max_points)


class TestProjection:
    def test_shapes_and_mask(self):
        r = jnp.full((CFG.num_beams,), 5.0)
        pts, mask = scan_to_points(r, ANGLES, 0.02, 30.0, CFG.max_points)
        assert pts.shape == (CFG.max_points, 2)
        assert mask.shape == (CFG.max_points,)
        assert int(mask.sum()) == CFG.num_beams
        assert np.allclose(np.linalg.norm(pts[: CFG.num_beams], axis=1), 5.0, atol=1e-4)

    def test_out_of_range_masked(self):
        r = jnp.array([0.01, 5.0, jnp.inf, jnp.nan, 40.0])
        ang = jnp.zeros(5)
        pts, mask = scan_to_points(r, ang, 0.02, 30.0, 8)
        assert list(np.asarray(mask[:5])) == [False, True, False, False, False]


class TestNormals:
    def test_straight_wall(self):
        # Points along the x-axis: normal must be +-y.
        xs = jnp.linspace(0.0, 1.0, 32)
        pts = jnp.stack([xs, jnp.zeros_like(xs)], axis=-1)
        mask = jnp.ones(32, bool)
        normals, _ = estimate_normals(pts, mask, 4)
        assert np.allclose(np.abs(normals[:, 1]), 1.0, atol=1e-3)
        assert np.allclose(normals[:, 0], 0.0, atol=1e-3)


class TestGICP:
    def test_identity(self):
        pose = jnp.array([-7.0, -5.0, 0.3])
        pts, mask = scan_at(pose)
        res = gicp_match(pts, mask, pts, mask, iterations=8)
        assert np.allclose(res.delta, 0.0, atol=1e-4)
        assert float(res.fitness) < 1e-6
        assert bool(res.converged)

    def test_known_delta(self):
        # Two scans from poses with a known relative transform; the match must
        # recover between(tgt_pose, src_pose).
        tgt_pose = jnp.array([-7.0, -5.0, 0.2])
        src_pose = jnp.array([-6.85, -4.9, 0.28])
        tgt_pts, tgt_mask = scan_at(tgt_pose)
        src_pts, src_mask = scan_at(src_pose)
        res = gicp_match(src_pts, src_mask, tgt_pts, tgt_mask, iterations=32)
        expected = se2.between(tgt_pose, src_pose)
        assert np.allclose(res.delta, expected, atol=0.02), (res.delta, expected)

    def test_larger_delta_with_init(self):
        tgt_pose = jnp.array([0.5, 0.0, -1.2])
        src_pose = jnp.array([0.9, -0.5, -0.8])
        tgt_pts, tgt_mask = scan_at(tgt_pose)
        src_pts, src_mask = scan_at(src_pose)
        expected = se2.between(tgt_pose, src_pose)
        init = expected + jnp.array([0.1, -0.1, 0.05])
        res = gicp_match(
            src_pts, src_mask, tgt_pts, tgt_mask, init_delta=init, iterations=32
        )
        assert np.allclose(res.delta, expected, atol=0.03), (res.delta, expected)

    def test_batched_vmap(self):
        tgt_pose = jnp.array([-7.0, -5.0, 0.2])
        src_pose = jnp.array([-6.9, -4.95, 0.25])
        tgt_pts, tgt_mask = scan_at(tgt_pose)
        src_pts, src_mask = scan_at(src_pose)
        batched = jax.vmap(
            lambda s, sm, t, tm: gicp_match(s, sm, t, tm, iterations=16)
        )
        res = batched(
            jnp.stack([src_pts, tgt_pts]),
            jnp.stack([src_mask, tgt_mask]),
            jnp.stack([tgt_pts, tgt_pts]),
            jnp.stack([tgt_mask, tgt_mask]),
        )
        assert res.delta.shape == (2, 3)
        assert np.allclose(res.delta[1], 0.0, atol=1e-4)


class TestDegeneracy:
    def test_corridor_is_degenerate(self):
        # Two infinite parallel walls: translation along the corridor is
        # unobservable — the matcher must flag it.
        xs = jnp.linspace(-10.0, 10.0, 180)
        top = jnp.stack([xs, jnp.full_like(xs, 1.5)], -1)
        bot = jnp.stack([xs, jnp.full_like(xs, -1.5)], -1)
        pts = jnp.concatenate([top, bot])
        mask = jnp.ones(360, bool)
        res = gicp_match(pts, mask, pts, mask, iterations=8)
        assert bool(res.degenerate)

    def test_room_is_not_degenerate(self):
        pose = jnp.array([-7.0, -5.0, 0.3])
        pts, mask = scan_at(pose)
        res = gicp_match(pts, mask, pts, mask, iterations=8)
        assert not bool(res.degenerate)


class TestMotionCovariance:
    def test_scaling(self):
        cfg = FrontendConfig()
        small = motion_covariance(jnp.array([0.01, 0.0, 0.0]), cfg)
        big = motion_covariance(jnp.array([1.0, 0.0, 0.5]), cfg)
        assert big[0, 0] > small[0, 0]
        assert big[2, 2] > small[2, 2]
        # Symmetric positive diagonal, zero off-diagonals (the reference left
        # them uninitialized — SURVEY.md §3.6.5).
        assert np.allclose(small, np.diag(np.diag(small)))


class TestMatchInformedCovariance:
    def test_corridor_covariance_is_anisotropic(self):
        # The match-informed factor covariance (slam/pipeline.py::
        # _factor_covariance) must inflate the unobservable along-corridor
        # direction far above the cross-corridor one — the graded
        # replacement for the reference's binary accept/reject
        # (scanner.hpp:64-80 modeled only motion magnitude).
        from graphslam.slam.pipeline import _factor_covariance

        xs = jnp.linspace(-10.0, 10.0, 180)
        top = jnp.stack([xs, jnp.full_like(xs, 1.5)], -1)
        bot = jnp.stack([xs, jnp.full_like(xs, -1.5)], -1)
        pts = jnp.concatenate([top, bot])
        mask = jnp.ones(360, bool)
        res = gicp_match(pts, mask, pts, mask, iterations=8)

        cfg = FrontendConfig()
        delta = jnp.array([0.3, 0.0, 0.0])
        cov = _factor_covariance(res, delta, cfg, jnp.bool_(True))
        # x = along the corridor (unobservable), y = across (well observed)
        assert float(cov[0, 0]) > 10.0 * float(cov[1, 1]), np.asarray(cov)
        # fallback path: motion model only
        cov_fb = _factor_covariance(res, delta, cfg, jnp.bool_(False))
        mc = motion_covariance(delta, cfg)
        assert np.allclose(np.asarray(cov_fb), np.asarray(mc))

    def test_good_match_tightens_over_motion_model(self):
        # A well-constrained room scan: the match information should beat
        # the coarse motion-scaled model for a large step.
        from graphslam.slam.pipeline import _factor_covariance

        pose = jnp.array([-7.0, -5.0, 0.3])
        pts, mask = scan_at(pose)
        res = gicp_match(pts, mask, pts, mask, iterations=8)
        cfg = FrontendConfig()
        delta = jnp.array([1.0, 0.0, 0.2])
        cov = _factor_covariance(res, delta, cfg, jnp.bool_(True))
        mc = motion_covariance(delta, cfg)
        assert float(jnp.trace(cov)) < float(jnp.trace(mc))
        # PSD sanity
        eig = np.linalg.eigvalsh(np.asarray(cov))
        assert (eig > 0).all()
