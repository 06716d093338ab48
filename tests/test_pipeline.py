"""Closed-loop pipeline tests: simulated world -> online SLAM -> ATE."""

import jax.numpy as jnp
import numpy as np

from graphslam import metrics
from graphslam.config import FrontendConfig, SLAMConfig, SolverConfig
from graphslam.geometry import se2
from graphslam.sim import simulate_trajectory
from graphslam.slam import run_slam
from graphslam.slam.odometry import init_buffer, integrate_twist, query_interval


def small_cfg(**kw):
    fcfg = FrontendConfig(num_beams=361, max_points=384, icp_iterations=24)
    return SLAMConfig(
        max_keyframes=256,
        max_factors=1024,
        frontend=fcfg,
        solver=SolverConfig(mode="pcg", cg_max_iterations=50),
        **kw,
    )


class TestOdometryBuffer:
    def test_integration_and_query(self):
        buf = init_buffer(depth=64)
        # Drive straight 1 m/s for 10 ticks of 0.1 s, then turn in place.
        for k in range(10):
            buf = integrate_twist(
                buf, jnp.array([1.0, 0.0, 0.0]), jnp.float32(0.1), jnp.float32(k * 0.1)
            )
        assert np.allclose(buf.pose, [1.0, 0.0, 0.0], atol=1e-5)
        delta, cov = query_interval(buf, jnp.float32(0.0), jnp.float32(0.95))
        assert np.allclose(delta[0], 0.9, atol=0.06)
        assert cov[0, 0] > 0

    def test_interval_covariance_is_transported(self):
        # Q_ab from query_interval must equal the noise accumulated strictly
        # inside the interval: replaying the integrate_twist recursion from a
        # zero covariance starting at t_start reproduces it exactly.
        from graphslam.frontend.keyframes import motion_covariance
        from graphslam.config import FrontendConfig

        cfg = FrontendConfig()
        buf = init_buffer(depth=64)
        tw = jnp.array([1.0, 0.2, 0.3])
        dt = jnp.float32(0.1)
        for k in range(12):
            buf = integrate_twist(buf, tw, dt, jnp.float32(k * 0.1), cfg)

        start_k, end_k = 3, 11
        delta, Q = query_interval(
            buf, jnp.float32(start_k * 0.1), jnp.float32(end_k * 0.1), cfg
        )
        # Independent replay of steps start_k+1 .. end_k with C(start_k) = 0.
        C = jnp.zeros((3, 3))
        d = np.asarray(tw) * 0.1
        Ad_inv = np.asarray(se2.adjoint(se2.inverse(jnp.asarray(d))))
        for _ in range(start_k + 1, end_k + 1):
            C = Ad_inv @ C @ Ad_inv.T + np.asarray(
                motion_covariance(jnp.asarray(d), cfg)
            )
        assert np.allclose(Q, C, atol=1e-5), (np.asarray(Q), np.asarray(C))
        # And the delta matches the relative pose between the two stamps.
        expect = se2.between(buf.poses[start_k], buf.poses[end_k])
        assert np.allclose(delta, expect, atol=1e-6)

    def test_ring_wraps(self):
        buf = init_buffer(depth=8)
        for k in range(20):
            buf = integrate_twist(
                buf, jnp.array([0.5, 0.0, 0.1]), jnp.float32(0.1), jnp.float32(k * 0.1)
            )
        assert int(buf.head) == 20
        assert bool(buf.valid.all())


class TestClosedLoop:
    def test_slam_on_simulated_run(self):
        cfg = small_cfg()
        sim = simulate_trajectory(cfg.frontend, step_len=0.35, seed=3)
        # Use a subsampled run to keep the test fast.
        scans = sim["scans"][:120]
        odom = sim["odom_deltas"][:119]
        gt = sim["gt_poses"][:120]

        state, infos = run_slam(scans, odom, cfg)
        n_kf = int(state.num_kf)
        assert n_kf >= 10, f"expected keyframes, got {n_kf}"
        assert int(state.num_factors) >= n_kf - 1

        # Keyframe trajectory vs the ground-truth poses where keyframes fired.
        kf_steps = [t for t, i in enumerate(infos) if bool(i.is_keyframe)]
        est = np.asarray(state.kf_poses[:n_kf])
        ref = gt[kf_steps]
        ate = float(metrics.ate(jnp.asarray(est), jnp.asarray(ref)))
        # Raw odometry-only dead reckoning error for comparison.
        dead = [gt[0]]
        for d in odom:
            dead.append(np.asarray(se2.compose(jnp.asarray(dead[-1]), jnp.asarray(d))))
        dead = np.asarray(dead)
        ate_dead = float(metrics.ate(jnp.asarray(dead[kf_steps]), jnp.asarray(ref)))
        assert ate < 0.5, f"SLAM ATE too high: {ate} (dead-reckoning {ate_dead})"

    def test_scan_replay_matches_stepwise(self):
        from graphslam.slam.pipeline import run_slam_scan

        fcfg = FrontendConfig(num_beams=181, max_points=192, icp_iterations=12)
        cfg = SLAMConfig(
            max_keyframes=64, max_factors=256, frontend=fcfg,
            solver=SolverConfig(mode="pcg", cg_max_iterations=25),
        )
        sim = simulate_trajectory(cfg.frontend, step_len=0.4, seed=3)
        scans = sim["scans"][:40]
        odom = sim["odom_deltas"][:39]
        s1, _ = run_slam(scans, odom, cfg)
        s2, infos = run_slam_scan(scans, odom, cfg)
        assert int(s1.num_kf) == int(s2.num_kf)
        assert int(s1.num_factors) == int(s2.num_factors)
        n = int(s1.num_kf)
        assert np.allclose(s1.kf_poses[:n], s2.kf_poses[:n], atol=1e-4)
        # Stacked infos cover every step.
        assert infos.is_keyframe.shape[0] == 40

    def test_enabled_solve_beats_reference_disabled_solve(self):
        # The reference never ran its optimizer (solve() commented out,
        # graph.cpp:195) — pose_opti stayed at composed dead-reckoning. Our
        # enabled periodic solve must beat that behavior on a loop-closing
        # tour.
        fcfg = FrontendConfig(num_beams=361, max_points=384, icp_iterations=16)
        base = dict(max_keyframes=128, max_factors=512, frontend=fcfg,
                    solver=SolverConfig(mode="pcg", cg_max_iterations=50))
        sim = simulate_trajectory(fcfg, step_len=0.3, seed=9,
                                  odom_trans_sigma=0.02, odom_rot_sigma=0.01)
        scans, odom, gt = sim["scans"], sim["odom_deltas"], sim["gt_poses"]

        solved_cfg = SLAMConfig(**base, solve_every=1)
        disabled_cfg = SLAMConfig(**base, solve_every=10**6)  # never solves

        s1, i1 = run_slam(scans, odom, solved_cfg)
        s0, i0 = run_slam(scans, odom, disabled_cfg)

        def kf_ate(state, infos):
            steps = [t for t, i in enumerate(infos) if bool(i.is_keyframe)]
            n = int(state.num_kf)
            return float(metrics.ate(
                jnp.asarray(np.asarray(state.kf_poses[:n])),
                jnp.asarray(gt[steps]),
            ))

        ate_solved = kf_ate(s1, i1)
        ate_disabled = kf_ate(s0, i0)
        assert ate_solved <= ate_disabled + 1e-6, (ate_solved, ate_disabled)

    def test_scan_to_map_matching(self):
        # L=3 local-map targets must work at least as well as scan-to-keyframe.
        fcfg = FrontendConfig(num_beams=181, max_points=192, icp_iterations=16)
        mk = lambda L: SLAMConfig(
            max_keyframes=64, max_factors=256, frontend=fcfg,
            solver=SolverConfig(mode="pcg", cg_max_iterations=25),
            scan_to_map_keyframes=L,
        )
        sim = simulate_trajectory(fcfg, step_len=0.4, seed=3)
        scans, odom, gt = sim["scans"][:80], sim["odom_deltas"][:79], sim["gt_poses"]

        def run(L):
            state, infos = run_slam(scans, odom, mk(L))
            steps = [t for t, i in enumerate(infos) if bool(i.is_keyframe)]
            n = int(state.num_kf)
            return float(metrics.ate(
                jnp.asarray(np.asarray(state.kf_poses[:n])), jnp.asarray(gt[steps])
            ))

        a1 = run(1)
        a3 = run(3)
        assert a3 < a1 * 1.5 + 0.05, (a1, a3)
        assert a3 < 0.5

    def test_state_to_dataset_roundtrip(self, tmp_path):
        from graphslam.io import save_g2o, load_g2o
        from graphslam.slam.pipeline import state_to_dataset

        cfg = small_cfg()
        sim = simulate_trajectory(cfg.frontend, step_len=0.35, seed=3)
        state, _ = run_slam(sim["scans"][:60], sim["odom_deltas"][:59], cfg)
        data = state_to_dataset(state)
        assert data["poses"].shape[0] == int(state.num_kf)
        path = str(tmp_path / "online.g2o")
        save_g2o(path, data)
        back = load_g2o(path, use_native=False)
        assert np.allclose(back["poses"], data["poses"], atol=1e-5)

    def test_twist_driven_replay(self):
        from graphslam.geometry import se2
        from graphslam.slam.pipeline import run_slam_from_twists
        from graphslam.sim import default_world, raycast
        from graphslam.frontend.projection import beam_angles

        fcfg = FrontendConfig(num_beams=181, max_points=192, icp_iterations=12)
        cfg = SLAMConfig(
            max_keyframes=64, max_factors=256, frontend=fcfg,
            solver=SolverConfig(mode="pcg", cg_max_iterations=25),
        )
        # Drive straight then turn, generating scans from the integrated pose.
        world = default_world()
        angles = beam_angles(fcfg.num_beams, fcfg.fov_rad)
        dt = 0.1
        twists = np.array(
            [[2.0, 0.0, 0.0]] * 20 + [[1.5, 0.0, 1.0]] * 15, np.float32
        )
        pose = jnp.array([-7.0, -5.0, 0.0])
        scans = [np.asarray(raycast(world, pose, angles, fcfg.max_range))]
        for tw in twists:
            pose = se2.compose(pose, jnp.asarray(tw * dt))
            scans.append(np.asarray(raycast(world, pose, angles, fcfg.max_range)))
        state, infos = run_slam_from_twists(np.asarray(scans), twists, dt, cfg)
        assert int(state.num_kf) >= 3
        assert int(state.num_factors) >= int(state.num_kf) - 1
        # single-dispatch path returns stacked infos covering every step
        assert int(np.asarray(infos.is_keyframe).shape[0]) == len(scans)

    def test_twist_factor_covariance_comes_from_odometry_buffer(self):
        # With scans that can never match (no valid returns), the committed
        # chain factors fall back to odometry; their covariance must be the
        # TRANSPORTED interval covariance between the keyframe stamps —
        # exactly what query_interval (the OdometryBuffer.srv rebuild,
        # odometry.cpp:84-116) returns on the same buffer.
        from graphslam.slam.odometry import (
            init_buffer, integrate_twist, query_interval,
        )
        from graphslam.slam.pipeline import run_slam_from_twists

        fcfg = FrontendConfig(num_beams=181, max_points=192, icp_iterations=8)
        cfg = SLAMConfig(
            max_keyframes=64, max_factors=256, frontend=fcfg,
            solver=SolverConfig(mode="pcg", cg_max_iterations=10),
        )
        dt = 0.2
        T = 12
        # rotation in the twist makes the adjoint transport non-trivial
        twists = np.tile(np.array([1.0, 0.0, 0.5], np.float32), (T - 1, 1))
        scans = np.full((T, fcfg.num_beams), fcfg.max_range + 5.0, np.float32)
        state, infos = run_slam_from_twists(scans, twists, dt, cfg)
        kf_steps = np.flatnonzero(np.asarray(infos.is_keyframe))
        assert len(kf_steps) >= 3, kf_steps

        # independent buffer replay + interval queries between kf stamps
        # (seed the t=0 entry exactly as run_slam_from_twists does)
        buf = init_buffer(depth=T)
        buf = buf.replace(
            times=buf.times.at[0].set(0.0),
            valid=buf.valid.at[0].set(True),
            head=jnp.int32(1),
        )
        for k in range(1, T):
            buf = integrate_twist(
                buf, jnp.asarray(twists[k - 1]), jnp.float32(dt),
                jnp.float32(k * dt), fcfg,
            )
        for f, (a, b) in enumerate(zip(kf_steps[:-1], kf_steps[1:])):
            d_exp, Q_exp = query_interval(
                buf, jnp.float32(a * dt), jnp.float32(b * dt), fcfg
            )
            si = np.asarray(state.chain_sqrt_info[f])
            cov_got = np.linalg.inv(si.T @ si)
            np.testing.assert_allclose(
                np.asarray(state.chain_meas[f]), np.asarray(d_exp), atol=1e-4
            )
            np.testing.assert_allclose(
                cov_got, np.asarray(Q_exp), rtol=2e-2, atol=1e-5
            )

    def test_capacity_guard(self):
        fcfg = FrontendConfig(num_beams=181, max_points=192, icp_iterations=8)
        cfg = SLAMConfig(
            max_keyframes=4, max_factors=8, frontend=fcfg,
            solver=SolverConfig(mode="pcg", cg_max_iterations=10),
        )
        sim = simulate_trajectory(cfg.frontend, step_len=0.4, seed=3)
        state, infos = run_slam(sim["scans"][:60], sim["odom_deltas"][:59], cfg)
        assert int(state.num_kf) <= 4
        assert int(state.num_factors) <= 8
        assert any(bool(i.at_capacity) for i in infos)

    def test_online_keyframe_covariances_match_dense_marginals(self):
        # The Keyframe.msg pose_opti covariance contract, live: after each
        # periodic solve the pipeline refreshes SLAMState.kf_covs via the
        # selected-inverse + Woodbury path; the values must match the dense
        # marginal covariance of the same graph view (graph.cpp:120,126-127
        # — the Marginals calls the reference sketched but never ran).
        from graphslam.slam.pipeline import (
            _solve_buckets, graph_view, state_to_dataset,
        )
        from graphslam.solver.marginals import marginal_covariances_dense

        fcfg = FrontendConfig(num_beams=181, max_points=192, icp_iterations=12)
        cfg = SLAMConfig(
            max_keyframes=64, max_factors=256, frontend=fcfg,
            solver=SolverConfig(mode="pcg", cg_max_iterations=25),
            cov_every=1, cov_on_loop_only=False,
        )
        sim = simulate_trajectory(cfg.frontend, step_len=0.4, seed=3)
        state, infos = run_slam(sim["scans"][:60], sim["odom_deltas"][:59], cfg)
        n = int(state.num_kf)
        assert n >= 5
        # last solve + refresh ran over this bucket
        buckets = _solve_buckets(64, cfg.solve_bucket_min)
        B = next(b for b in buckets if b >= n)
        Fc = min(cfg.cov_loop_window, 256)
        dense = marginal_covariances_dense(
            state.kf_poses[:B], graph_view(state, cfg, B, loop_size=Fc)
        )
        got = np.asarray(state.kf_covs[:n])
        np.testing.assert_allclose(got, np.asarray(dense[:n]),
                                   rtol=5e-2, atol=5e-5)
        # covariances are SPD and grow along the chain before loop closures
        eig = np.linalg.eigvalsh(0.5 * (got + np.swapaxes(got, -1, -2)))
        assert (eig > -1e-7).all()
        # exported dataset carries them (the Pose2DWithCovariance field)
        data = state_to_dataset(state)
        assert data["covariances"].shape == (n, 3, 3)
        np.testing.assert_allclose(data["covariances"], got)

    def test_keyframe_covs_transported_between_refreshes(self):
        # With periodic recovery disabled, fresh keyframes still carry a
        # dead-reckoning-grade covariance: parent marginal transported
        # through the factor delta plus the factor noise.
        fcfg = FrontendConfig(num_beams=181, max_points=192, icp_iterations=8)
        cfg = SLAMConfig(
            max_keyframes=64, max_factors=256, frontend=fcfg,
            solver=SolverConfig(mode="pcg", cg_max_iterations=10),
            cov_every=0,
        )
        scans = np.full((6, fcfg.num_beams), fcfg.max_range + 5.0, np.float32)
        odom = np.tile(np.array([0.6, 0.0, 0.0], np.float32), (5, 1))
        state, _ = run_slam(scans, odom, cfg)
        n = int(state.num_kf)
        assert n == 6
        covs = np.asarray(state.kf_covs[:n])
        # keyframe 0 = prior covariance; uncertainty grows monotonically
        assert np.allclose(covs[0], np.diag([0.01, 0.01, 0.01]), atol=1e-6)
        tr = np.trace(covs, axis1=-2, axis2=-1)
        assert (np.diff(tr) > 0).all(), tr

    def test_rejected_match_still_commits_dead_reckoned_keyframes(self):
        # The keyframe gate must run on the EFFECTIVE delta: when the ICP
        # match is rejected (here: scans with zero valid returns, so the
        # matcher can never converge), motion over the distance threshold
        # must still commit keyframes from raw odometry — otherwise scan
        # overlap with the last keyframe only shrinks and the map freezes
        # (pipeline.py keyframe-decision comment). The chain factor must
        # then carry the MOTION-MODEL covariance, not the match Hessian.
        from graphslam.frontend.keyframes import motion_covariance
        from graphslam.slam.pipeline import _sqrt_info_from_cov

        fcfg = FrontendConfig(num_beams=181, max_points=192, icp_iterations=8)
        cfg = SLAMConfig(
            max_keyframes=64, max_factors=256, frontend=fcfg,
            solver=SolverConfig(mode="pcg", cg_max_iterations=10),
        )
        # Every beam beyond max_range -> scan_to_points masks out all points
        # -> matched_frac == 0 -> odo_ok is False on every step.
        scans = np.full((8, fcfg.num_beams), fcfg.max_range + 5.0, np.float32)
        # 0.6 m per step exceeds keyframe_trans_threshold (0.5 m).
        step_delta = np.array([0.6, 0.0, 0.0], np.float32)
        odom = np.tile(step_delta, (7, 1))

        state, infos = run_slam(scans, odom, cfg)
        n_kf = int(state.num_kf)
        # first frame + one dead-reckoned keyframe per subsequent step
        assert n_kf == 8, n_kf
        assert all(bool(i.is_keyframe) for i in infos)
        # the committed factor is the raw odometry delta...
        for k in range(n_kf - 1):
            assert bool(state.chain_mask[k])
            assert np.allclose(state.chain_meas[k], step_delta, atol=1e-6)
        # ...with the motion-model covariance (match covariance path is
        # gated off when the match was rejected)
        expect_si = np.asarray(_sqrt_info_from_cov(
            motion_covariance(jnp.asarray(step_delta), fcfg)
        ))
        assert np.allclose(state.chain_sqrt_info[0], expect_si, atol=1e-5)

    def test_first_frame_creates_keyframe(self):
        cfg = small_cfg()
        sim = simulate_trajectory(cfg.frontend, step_len=0.35, seed=3)
        state, infos = run_slam(sim["scans"][:1], None, cfg)
        assert int(state.num_kf) == 1
        assert bool(infos[0].is_keyframe)
        assert int(state.num_factors) == 0  # prior is implicit, not an edge


class TestWarmStartedSolves:
    # Online solves start from the poses the previous solve left in
    # SLAMState (graph.cpp:130's initial = poses_opti).

    def test_cov_refresh_on_loop_commits(self):
        # cov_on_loop_only (the default): the full selected-inverse
        # recovery fires only on steps that COMMIT a loop closure; between
        # loops the per-commit dead-reckoned transport covers growth
        # (config.py). A refresh must visibly contract uncertainty — the
        # trace sequence cannot be monotone dead-reckoning growth.
        fcfg = FrontendConfig(num_beams=361, max_points=384,
                              icp_iterations=16)
        cfg = SLAMConfig(
            max_keyframes=128, max_factors=512, frontend=fcfg,
            solver=SolverConfig(mode="pcg", cg_max_iterations=50),
        )
        sim = simulate_trajectory(fcfg, step_len=0.3, seed=9,
                                  odom_trans_sigma=0.02, odom_rot_sigma=0.01)
        state, infos = run_slam(sim["scans"], sim["odom_deltas"], cfg)
        n = int(state.num_kf)
        assert int(state.num_loops) >= 1, "tour produced no loop closures"
        covs = np.asarray(state.kf_covs[:n])
        eig = np.linalg.eigvalsh(0.5 * (covs + np.swapaxes(covs, -1, -2)))
        assert (eig > -1e-7).all()
        tr = np.trace(covs, axis1=-2, axis2=-1)
        assert (np.diff(tr) < 0).any(), tr
