"""The jitted SLAM step: scan in, updated map out.

One call covers the whole reference dataflow for a scan (SURVEY.md §3.1-3.2):
scanner_callback (projection + GICP vs last keyframe + loop probe) and
registration_callback (prior/new/loop factor creation) fused in-process, plus
the solve() the reference disabled (graph.cpp:195). Branches are masked
writes, not Python control flow — the step compiles once and never
recompiles as the map grows.

Of the reference's two GICP registrations (scanner.cpp:115,141), the
odometry match runs every step and the loop probe runs under lax.cond only
when a spatial candidate is plausible — most steps skip it entirely.

Periodic solves are OCCUPANCY-BUCKETED: the graph is solved over the
smallest power-of-two pose window covering the live keyframes (lax.switch
over a handful of statically-shaped solver instances), so solve cost tracks
the actual map size, not the preallocated capacity. Odometry factors live in
chain slots (slam/state.py), giving the online graph the same
chain_prefix structure as offline datasets, so the chain preconditioner
applies unchanged.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from graphslam.config import SLAMConfig
from graphslam.factors.graph import FactorGraph
from graphslam.frontend.icp import MatchResult, gicp_match
from graphslam.frontend.keyframes import motion_covariance
from graphslam.frontend.projection import beam_angles, scan_to_points
from graphslam.geometry import se2
from graphslam.slam.state import SLAMState, init_state
from graphslam.solver.lm import _gn_loop, _solve_mode


class StepInfo(NamedTuple):
    is_keyframe: jnp.ndarray
    added_loop: jnp.ndarray
    fitness: jnp.ndarray
    delta: jnp.ndarray
    num_kf: jnp.ndarray
    num_factors: jnp.ndarray
    # Capacity exhaustion (preallocated arrays full): keyframe/factor commits
    # stop rather than silently corrupting slots; the caller should
    # checkpoint and restart with larger capacities (SLAMConfig).
    at_capacity: jnp.ndarray


def graph_view(
    state: SLAMState,
    cfg: SLAMConfig,
    size: Optional[int] = None,
    loop_size: Optional[int] = None,
) -> FactorGraph:
    """A FactorGraph view over the first `size` pose slots (static; default =
    full capacity).

    Chain factors occupy the first `size-1` edge slots as literal (k, k+1)
    pairs — FactorGraph.chain_prefix applies, enabling the scatter-free
    assembly and the chain preconditioner. Inactive poses (index >= num_kf) get
    identity priors anchored at their current values — zero residual, but
    keeps the masked normal equations nonsingular so one solver compilation
    serves every map size within the bucket.

    loop_size restricts the view to the first `loop_size` loop slots (static)
    — used by the covariance recovery, whose Woodbury capacitance is dense
    over the loop window. Loop slots fill contiguously, so the view is exact
    while num_loops <= loop_size.
    """
    K = state.kf_poses.shape[0] if size is None else size
    dtype = state.kf_poses.dtype
    idx = jnp.arange(K)
    inactive = idx >= state.num_kf
    prior_mask = (idx == 0) | inactive
    anchor_info_sqrt = jnp.eye(3, dtype=dtype) / cfg.prior_sigma_xy
    eye = jnp.broadcast_to(jnp.eye(3, dtype=dtype), (K, 3, 3))
    prior_sqrt = jnp.where((idx == 0)[:, None, None], anchor_info_sqrt, eye)
    prior_meas = jnp.where((idx == 0)[:, None], state.anchor, state.kf_poses[:K])

    c = K - 1
    chain_edges = jnp.stack([jnp.arange(c), jnp.arange(1, K)], axis=1).astype(jnp.int32)
    F = state.loop_edges.shape[0] if loop_size is None else loop_size
    # Clip endpoints into the pose window: slots beyond num_loops are masked
    # (zero residual/Jacobian), but out-of-window indices would read/write
    # out of bounds in the gather/scatter paths.
    loop_edges = jnp.minimum(state.loop_edges[:F], K - 1)
    return FactorGraph(
        chain_prefix=c,
        edges=jnp.concatenate([chain_edges, loop_edges], axis=0),
        measurements=jnp.concatenate(
            [state.chain_meas[:c], state.loop_meas[:F]], axis=0
        ),
        sqrt_info=jnp.concatenate(
            [state.chain_sqrt_info[:c], state.loop_sqrt_info[:F]], axis=0
        ),
        edge_mask=jnp.concatenate(
            [state.chain_mask[:c], state.loop_mask[:F]], axis=0
        ),
        is_loop=jnp.concatenate(
            [jnp.zeros((c,), bool), jnp.ones((F,), bool)], axis=0
        ),
        prior_idx=idx.astype(jnp.int32),
        prior_meas=prior_meas,
        prior_sqrt_info=prior_sqrt,
        prior_mask=prior_mask,
    )


def _solve_buckets(capacity: int, min_bucket: int):
    """Static power-of-two pose-window sizes covering [min_bucket, capacity]."""
    sizes = []
    b = min(min_bucket, capacity)
    while b < capacity:
        sizes.append(b)
        b *= 2
    sizes.append(capacity)
    return sizes


def _m33(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """3x3 product at full f32 precision. A default-precision float32 dot
    may run at reduced precision on an accelerator (TF32 on the H100) —
    covariance transports need the exact product or the Cholesky downstream
    can see an indefinite matrix."""
    return jnp.einsum("ij,jk->ik", a, b, precision=jax.lax.Precision.HIGHEST)


def _sqrt_info_from_cov(cov: jnp.ndarray) -> jnp.ndarray:
    """Upper sqrt-information from a covariance: info = cov^-1 = U^T U."""
    # Symmetrize + trace-scaled ridge: the covariance arrives through
    # adjoint transports and matmul roundoff; an indefinite input would NaN
    # the Cholesky and silently poison the whole graph downstream.
    cov = 0.5 * (cov + jnp.swapaxes(cov, -1, -2))
    tr = jnp.trace(cov, axis1=-2, axis2=-1)
    eye = jnp.eye(cov.shape[-1], dtype=cov.dtype)
    cov = cov + (1e-6 * jnp.abs(tr) + 1e-9)[..., None, None] * eye
    L = jnp.linalg.cholesky(cov)
    eye = jnp.eye(cov.shape[-1], dtype=cov.dtype)
    Linv = jax.scipy.linalg.solve_triangular(L, eye, lower=True)
    # info = Linv^T Linv, so U = Linv works: U^T U = info, U lower->no; take
    # Linv itself (triangularity is irrelevant to the solver, only U^T U).
    return Linv


def _factor_covariance(res: MatchResult, delta, fcfg, use_match, mc=None):
    """Measurement covariance for a committed factor.

    When the match is trusted, use the GICP IRLS Hessian — the Fisher
    information of the registration — scaled by the residual-consistency
    factor s = max(mahal_rmse^2 / 2, 1) (never deflate below nominal), plus
    a fraction of the motion model as a floor. Anisotropy (e.g. corridor
    degeneracy) shows up as inflated variance along the weak direction
    instead of the reference's binary accept/reject (fixes scanner.hpp:64-80
    which modeled only motion magnitude). Falls back to the pure motion
    model when the match was rejected.

    `mc` overrides the motion-model covariance — the pipeline passes the
    adjoint-transported interval covariance accumulated since the last
    keyframe (the OdometryBuffer.srv contract, odometry.cpp:84-116).
    """
    if mc is None:
        mc = motion_covariance(delta, fcfg)
    if not fcfg.use_match_covariance:
        return mc
    s = jnp.maximum(res.mahal_rmse**2 / 2.0, 1.0)
    eye = jnp.eye(3, dtype=delta.dtype)
    cov_match = s * jnp.linalg.inv(res.hessian + 1e-8 * eye)
    cov_match = cov_match + fcfg.match_cov_motion_floor * mc + 1e-8 * eye
    # symmetrize (inv of near-symmetric H)
    cov_match = 0.5 * (cov_match + cov_match.T)
    return jnp.where(use_match, cov_match, mc)


def make_slam_step(cfg: SLAMConfig):
    """Build the jitted step: (state, ranges, odom_delta) -> (state, info)."""
    fcfg = cfg.frontend
    angles = beam_angles(fcfg.num_beams, fcfg.fov_rad)
    scfg = cfg.solver

    @partial(jax.jit, donate_argnums=(0,))
    def step(
        state: SLAMState,
        ranges: jnp.ndarray,
        odom_delta: jnp.ndarray,
        odom_cov: Optional[jnp.ndarray] = None,
    ):
        pts, mask = scan_to_points(
            ranges, angles, fcfg.min_range, fcfg.max_range, fcfg.max_points
        )
        first = state.num_kf == 0
        last_idx = jnp.maximum(state.num_kf - 1, 0)
        last_pose = state.kf_poses[last_idx]
        last_pts = state.kf_points[last_idx]
        last_mask = state.kf_masks[last_idx]

        # Odometry accumulated since the last keyframe — the ICP prior and
        # the fallback factor measurement — with its covariance transported
        # by the interval adjoint (the same recursion as
        # odometry.py::integrate_twist, so the committed factor noise equals
        # query_interval's Q between the keyframe stamps exactly).
        # odom_cov (optional per-step input) carries this tick's odometry
        # noise from the twist-integration path; without it the per-tick
        # motion model applies.
        odom_acc = se2.compose(state.odom_accum, odom_delta)
        q_step = motion_covariance(odom_delta, fcfg)
        if odom_cov is not None:
            q_step = jnp.where(jnp.any(odom_cov != 0), odom_cov, q_step)
        Ad_od = se2.adjoint(se2.inverse(odom_delta))
        cov_acc = _m33(_m33(Ad_od, state.odom_cov_accum), Ad_od.T) + q_step

        # --- loop candidate (graph.cpp:146-178's O(n) scan as one argmin) ---
        pose_guess = se2.compose(last_pose, odom_acc)
        kidx = jnp.arange(state.kf_poses.shape[0])
        eligible = kidx < (state.num_kf - cfg.loop_closure_skip)
        d2 = jnp.sum((state.kf_poses[:, :2] - pose_guess[:2]) ** 2, axis=-1)
        d2 = jnp.where(eligible, d2, jnp.inf)
        cand_idx = jnp.argmin(d2)
        cand_dist = jnp.sqrt(d2[cand_idx])
        cand_pose = state.kf_poses[cand_idx]
        cand_pts = state.kf_points[cand_idx]
        cand_mask = state.kf_masks[cand_idx]

        # --- GICP vs last keyframe (every step) -----------------------------
        def match(s, sm, t, tm, i):
            return gicp_match(
                s, sm, t, tm,
                init_delta=i,
                iterations=fcfg.icp_iterations,
                max_corr_dist=fcfg.max_correspondence_distance,
                half_window=fcfg.normal_half_window,
                gicp_eps=fcfg.gicp_epsilon,
                use_pallas=fcfg.gicp_kernel,
            )

        # Scan-to-map: widen the target to the last L keyframes' points
        # expressed in the last keyframe's optimized frame (L=1 reduces to
        # the reference's scan-to-keyframe).
        L = cfg.scan_to_map_keyframes
        if L > 1:
            offs = jnp.arange(L)
            src_idx = jnp.clip(state.num_kf - 1 - offs, 0, state.kf_poses.shape[0] - 1)
            kf_sel_pose = state.kf_poses[src_idx]            # (L, 3)
            rel = se2.between(
                jnp.broadcast_to(last_pose, kf_sel_pose.shape), kf_sel_pose
            )
            moved = se2.transform(rel, state.kf_points[src_idx])
            seg_valid = (offs < state.num_kf)[:, None]
            tgt_pts_all = moved.reshape(-1, 2)
            tgt_mask_all = (state.kf_masks[src_idx] & seg_valid).reshape(-1)
        else:
            tgt_pts_all = last_pts
            tgt_mask_all = last_mask

        res_odo = match(pts, mask, tgt_pts_all, tgt_mask_all, odom_acc)
        odo_delta = res_odo.delta
        odo_fitness = res_odo.fitness
        odo_ok = (
            res_odo.converged
            & (res_odo.matched_frac > 0.5)
            & (res_odo.inlier_rms < fcfg.max_match_rmse)
            & ~res_odo.degenerate
        )

        # --- loop-probe GICP, only when a candidate is plausible ------------
        # (the reference also gated its probe on the keyframe branch,
        # scanner.cpp:130-155; lax.cond skips the work at runtime on the
        # majority of steps with no nearby candidate)
        loop_init = se2.between(cand_pose, pose_guess)
        loop_plausible = jnp.isfinite(cand_dist) & (
            cand_dist < cfg.loop_closure_max_distance
        )

        def do_probe(_):
            return match(pts, mask, cand_pts, cand_mask, loop_init)

        def skip_probe(_):
            zero3 = jnp.zeros(3, pts.dtype)
            f = jnp.asarray(0.0, pts.dtype)
            return MatchResult(
                delta=zero3, fitness=f, inlier_rms=f + 1e9,
                matched_frac=f, converged=jnp.bool_(False),
                mahal_rmse=f + 1e9, degenerate=jnp.bool_(True),
                hessian=jnp.eye(3, dtype=pts.dtype),
            )

        res_loop = jax.lax.cond(loop_plausible, do_probe, skip_probe, None)
        loop_delta = res_loop.delta
        loop_ok = (
            res_loop.converged
            & (res_loop.matched_frac > 0.5)
            & (res_loop.inlier_rms < fcfg.max_match_rmse)
            & ~res_loop.degenerate
        )

        # When the match is unreliable, fall back to raw odometry for the
        # factor (the reference trusted a poor alignment — SURVEY.md §3.6.3).
        delta = jnp.where(odo_ok, odo_delta, odom_acc)

        # --- keyframe decision (reference motion gate + our quality gate) ---
        # The motion gate runs on the EFFECTIVE delta: a rejected match must
        # still commit keyframes from dead-reckoned odometry, otherwise the
        # pipeline deadlocks — scan overlap with the last keyframe only
        # shrinks once the robot outruns the ICP basin, so no later match
        # can ever succeed and the map freezes (the fitness term is gated on
        # odo_ok because a failed match reports garbage fitness).
        moved_enough = (
            (odo_ok & (odo_fitness > fcfg.keyframe_fitness_threshold))
            | (jnp.linalg.norm(delta[:2]) > fcfg.keyframe_trans_threshold)
            | (jnp.abs(delta[2]) > fcfg.keyframe_rot_threshold)
        )
        # Capacity guard: stop committing when arrays are full.
        at_capacity = (state.num_kf >= state.kf_poses.shape[0]) | (
            state.num_loops >= state.loop_edges.shape[0] - 1
        )
        is_kf = (first | moved_enough) & ~at_capacity
        new_pose = jnp.where(first, jnp.zeros(3, pts.dtype), se2.compose(last_pose, delta))

        do_loop = (
            is_kf
            & ~first
            & (cand_dist < cfg.loop_closure_max_distance)
            & loop_ok
        )

        # --- commit keyframe (masked writes) --------------------------------
        ki = jnp.minimum(state.num_kf, state.kf_poses.shape[0] - 1)
        kf_poses = state.kf_poses.at[ki].set(
            jnp.where(is_kf, new_pose, state.kf_poses[ki])
        )
        kf_points = state.kf_points.at[ki].set(
            jnp.where(is_kf, pts, state.kf_points[ki])
        )
        kf_masks = state.kf_masks.at[ki].set(
            jnp.where(is_kf, mask, state.kf_masks[ki])
        )
        num_kf = state.num_kf + jnp.where(is_kf, 1, 0).astype(jnp.int32)

        # --- odometry factor -> chain slot last_idx (couples last_idx, ki) --
        # The motion-model part is the transported interval covariance
        # accumulated since the last keyframe (cov_acc) — the online
        # equivalent of query_interval(last_kf_stamp, now).
        add_odo = is_kf & ~first
        cov = _factor_covariance(res_odo, delta, fcfg, odo_ok, mc=cov_acc)
        si = _sqrt_info_from_cov(cov)

        # Dead-reckoning-grade covariance for the fresh keyframe until the
        # next marginal refresh: transport the parent marginal through the
        # factor delta and add the factor noise (first keyframe gets the
        # prior covariance, graph.cpp:38-42).
        Ad = se2.adjoint(se2.inverse(delta))
        prop_cov = _m33(_m33(Ad, state.kf_covs[last_idx]), Ad.T) + cov
        prior_cov = jnp.diag(
            jnp.asarray(
                [cfg.prior_sigma_xy**2, cfg.prior_sigma_xy**2,
                 cfg.prior_sigma_theta**2], pts.dtype,
            )
        )
        new_cov = jnp.where(first, prior_cov, prop_cov)
        kf_covs = state.kf_covs.at[ki].set(
            jnp.where(is_kf, new_cov, state.kf_covs[ki])
        )
        chain_meas = state.chain_meas.at[last_idx].set(
            jnp.where(add_odo, delta, state.chain_meas[last_idx])
        )
        chain_sqrt_info = state.chain_sqrt_info.at[last_idx].set(
            jnp.where(add_odo, si, state.chain_sqrt_info[last_idx])
        )
        chain_mask = state.chain_mask.at[last_idx].set(
            jnp.where(add_odo, True, state.chain_mask[last_idx])
        )

        # --- loop factor -> next loop slot -----------------------------------
        F = state.loop_edges.shape[0]
        loop_cov = _factor_covariance(res_loop, loop_delta, fcfg, loop_ok)
        loop_si = _sqrt_info_from_cov(loop_cov)
        f1 = jnp.minimum(state.num_loops, F - 1)
        loop_edges = state.loop_edges.at[f1].set(
            jnp.where(
                do_loop,
                jnp.stack([cand_idx, ki]).astype(jnp.int32),
                state.loop_edges[f1],
            )
        )
        loop_meas = state.loop_meas.at[f1].set(
            jnp.where(do_loop, loop_delta, state.loop_meas[f1])
        )
        loop_sqrt_info = state.loop_sqrt_info.at[f1].set(
            jnp.where(do_loop, loop_si, state.loop_sqrt_info[f1])
        )
        loop_mask = state.loop_mask.at[f1].set(
            jnp.where(do_loop, True, state.loop_mask[f1])
        )
        num_loops = state.num_loops + jnp.where(do_loop, 1, 0).astype(jnp.int32)

        state = state.replace(
            kf_poses=kf_poses,
            kf_points=kf_points,
            kf_masks=kf_masks,
            kf_covs=kf_covs,
            num_kf=num_kf,
            chain_meas=chain_meas,
            chain_sqrt_info=chain_sqrt_info,
            chain_mask=chain_mask,
            loop_edges=loop_edges,
            loop_meas=loop_meas,
            loop_sqrt_info=loop_sqrt_info,
            loop_mask=loop_mask,
            num_loops=num_loops,
            odom_accum=jnp.where(is_kf, jnp.zeros(3, pts.dtype), odom_acc),
            odom_cov_accum=jnp.where(
                is_kf, jnp.zeros((3, 3), pts.dtype), cov_acc
            ),
        )

        # --- periodic solve (the graph.cpp:195 solve, enabled) --------------
        # Occupancy-bucketed: lax.switch over static pose-window sizes so
        # solve cost tracks the live map, not the capacity; each bucket
        # threads cfg.solver.mode through _gn_loop.
        do_solve = is_kf & (num_kf % cfg.solve_every == 0) & (num_kf > 1)
        K = state.kf_poses.shape[0]
        buckets = _solve_buckets(K, cfg.solve_bucket_min)

        Fc = min(cfg.cov_loop_window, state.loop_edges.shape[0])

        def make_branch(B: int):
            mode = _solve_mode(scfg, B)

            def branch(s: SLAMState) -> SLAMState:
                graph = graph_view(s, cfg, B)
                poses = _gn_loop(
                    s.kf_poses[:B], graph, scfg, mode, cfg.solve_iterations
                )
                s = s.replace(kf_poses=s.kf_poses.at[:B].set(poses))
                if cfg.cov_every:
                    # Per-keyframe marginal covariances — the pose_opti
                    # covariance contract (Keyframe.msg:4) the reference
                    # sketched in its commented Marginals calls
                    # (graph.cpp:120,126-127). DENSE recovery at bucket
                    # sizes up to 2048 poses: the selected-inverse +
                    # Woodbury path loses f32 precision exactly in the
                    # online regime — a long chain anchored only at pose 0
                    # has chain-only covariances ~1e4x the loop-corrected
                    # marginals, and the subtraction cancels past f32 (a
                    # -0.49 minimum eigenvalue at 124 keyframes, 31 loops).
                    # marginal_covariances_all remains the large-graph
                    # offline path. Skipped (stale values kept) once
                    # num_loops outgrows the static window.
                    from graphslam.solver.marginals import (
                        marginal_covariances_all,
                        marginal_covariances_dense,
                    )

                    def with_cov(s: SLAMState) -> SLAMState:
                        gcov = graph_view(s, cfg, B, loop_size=Fc)
                        if B <= 2048:
                            covs = marginal_covariances_dense(
                                s.kf_poses[:B], gcov
                            )
                        else:
                            covs = marginal_covariances_all(
                                s.kf_poses[:B], gcov
                            )
                        return s.replace(kf_covs=s.kf_covs.at[:B].set(covs))

                    # cov_on_loop_only: uncertainty only shrinks at loop
                    # commits — refresh there; the per-commit transported
                    # covariance covers growth between loops (config.py).
                    want_cov = (
                        do_loop if cfg.cov_on_loop_only
                        else (num_kf % cfg.cov_every == 0)
                    )
                    do_cov = want_cov & (s.num_loops <= Fc)
                    s = jax.lax.cond(do_cov, with_cov, lambda s: s, s)
                return s

            return branch

        def solve(s: SLAMState) -> SLAMState:
            if len(buckets) == 1:
                return make_branch(buckets[0])(s)
            bidx = sum(
                jnp.where(s.num_kf > b, 1, 0) for b in buckets[:-1]
            ).astype(jnp.int32)
            return jax.lax.switch(bidx, [make_branch(b) for b in buckets], s)

        state = jax.lax.cond(do_solve, solve, lambda s: s, state)

        info = StepInfo(
            is_keyframe=is_kf,
            added_loop=do_loop,
            fitness=odo_fitness,
            delta=delta,
            num_kf=num_kf,
            num_factors=jnp.maximum(num_kf - 1, 0) + num_loops,
            at_capacity=at_capacity,
        )
        return state, info

    return step


def state_to_dataset(state: SLAMState) -> dict:
    """Export the online map as the standard dataset dict (interoperable with
    io.g2o.save_g2o) — keyframe poses + committed factors only."""
    n = int(state.num_kf)
    nl = int(state.num_loops)
    c = max(n - 1, 0)
    chain_edges = np.stack([np.arange(c), np.arange(1, n)], axis=1).astype(np.int32) \
        if c else np.zeros((0, 2), np.int32)
    edges = np.concatenate([chain_edges, np.asarray(state.loop_edges[:nl])], axis=0)
    meas = np.concatenate(
        [np.asarray(state.chain_meas[:c]), np.asarray(state.loop_meas[:nl])], axis=0
    )
    sqrt_info = np.concatenate(
        [np.asarray(state.chain_sqrt_info[:c]), np.asarray(state.loop_sqrt_info[:nl])],
        axis=0,
    )
    info = np.einsum("eba,ebc->eac", sqrt_info, sqrt_info)
    return {
        "dim": 2,
        "poses": np.asarray(state.kf_poses[:n]),
        # pose_opti covariances (Pose2DWithCovariance.msg:2's float64[9],
        # here (n, 3, 3)) — live when cfg.cov_every > 0.
        "covariances": np.asarray(state.kf_covs[:n]),
        "edges": edges,
        "measurements": meas,
        "information": info,
        "is_loop": np.concatenate([np.zeros(c, bool), np.ones(nl, bool)]),
    }


def make_slam_replay(cfg: SLAMConfig, num_steps: int):
    """Whole-replay version: one jitted lax.scan over all scans.

    A single device dispatch for the full run — this is the honest frames/s
    measurement path (the per-step driver pays a host round-trip per scan).
    """
    step = make_slam_step(cfg)
    # Reuse the step's traced logic inside a scan; donate the state.

    @partial(jax.jit, donate_argnums=(0,))
    def replay(
        state: SLAMState,
        scans: jnp.ndarray,
        odom: jnp.ndarray,
        odom_covs: Optional[jnp.ndarray] = None,
    ):
        def body(s, inp):
            ranges, od, oc = inp
            s, info = step.__wrapped__(s, ranges, od, oc)
            return s, info

        if odom_covs is None:
            odom_covs = jnp.zeros((num_steps, 3, 3), scans.dtype)
        return jax.lax.scan(
            body, state, (scans, odom, odom_covs), length=num_steps
        )

    return replay


def run_slam_scan(scans: np.ndarray, odom_deltas: Optional[np.ndarray], cfg: SLAMConfig):
    """Replay the whole run in one on-device scan; returns (state, stacked infos)."""
    T = scans.shape[0]
    odom = np.zeros((T, 3), np.float32)
    if odom_deltas is not None:
        odom[1:] = odom_deltas[: T - 1]
    replay = make_slam_replay(cfg, T)
    state = init_state(cfg)
    state, infos = replay(state, jnp.asarray(scans), jnp.asarray(odom))
    return state, infos


def run_slam_from_twists(
    scans: np.ndarray,
    twists: np.ndarray,
    dt: float,
    cfg: SLAMConfig,
):
    """Replay driver fed by body twists (the /cmd_vel path) — ONE device
    dispatch for the whole run.

    Inside a single jit: a lax.scan over `integrate_twist` builds the
    odometry ring buffer (the dead odometry node's intended 100 Hz loop,
    odometry.cpp:139-206), `query_interval` (the OdometryBuffer.srv rebuild,
    odometry.cpp:84-116) is vmapped over consecutive scan stamps for the
    per-tick deltas AND transported covariances, and the SLAM replay
    consumes both — the step accumulates them with the interval adjoint, so
    the factor noise at each keyframe commit equals
    query_interval(last_kf_stamp, kf_stamp) exactly (the adjoint transport
    is a homomorphism; see tests/test_pipeline.py).

    Returns (final_state, stacked StepInfos).
    """
    from graphslam.slam.odometry import (
        init_buffer, integrate_twist, query_interval,
    )

    T = int(scans.shape[0])
    step = make_slam_step(cfg)
    fdt = float(dt)

    @partial(jax.jit, donate_argnums=(0,))
    def full(state: SLAMState, scans_d: jnp.ndarray, twists_d: jnp.ndarray):
        dtype = state.kf_poses.dtype
        # seed the buffer with the t=0 entry (origin, zero covariance)
        buf0 = init_buffer(depth=T, dtype=dtype)
        buf0 = buf0.replace(
            times=buf0.times.at[0].set(0.0),
            valid=buf0.valid.at[0].set(True),
            head=jnp.int32(1),
        )
        times = jnp.arange(1, T, dtype=dtype) * fdt

        def ibody(buf, inp):
            tw, t = inp
            return integrate_twist(buf, tw, fdt, t, cfg.frontend), None

        buf, _ = jax.lax.scan(ibody, buf0, (twists_d[: T - 1], times))

        t_prev = jnp.arange(0, T - 1, dtype=dtype) * fdt
        deltas, Qs = jax.vmap(
            lambda a, b: query_interval(buf, a, b, cfg.frontend)
        )(t_prev, t_prev + fdt)
        odom = jnp.concatenate([jnp.zeros((1, 3), dtype), deltas], axis=0)
        covs = jnp.concatenate([jnp.zeros((1, 3, 3), dtype), Qs], axis=0)

        def body(s, inp):
            ranges, od, oc = inp
            return step.__wrapped__(s, ranges, od, oc)

        return jax.lax.scan(body, state, (scans_d, odom, covs), length=T)

    return full(init_state(cfg), jnp.asarray(scans), jnp.asarray(twists))


def run_slam(
    scans: np.ndarray,
    odom_deltas: Optional[np.ndarray],
    cfg: SLAMConfig,
):
    """Replay driver: feed every scan through the jitted step.

    Returns (final_state, list[StepInfo]). The reference's equivalent is the
    whole roslaunch closed loop (SURVEY.md §4) — here it's a deterministic
    array program.
    """
    step = make_slam_step(cfg)
    state = init_state(cfg)
    infos = []
    T = scans.shape[0]
    zeros = jnp.zeros(3, state.kf_poses.dtype)
    for t in range(T):
        od = zeros if odom_deltas is None or t == 0 else jnp.asarray(odom_deltas[t - 1])
        state, info = step(state, jnp.asarray(scans[t]), od)
        infos.append(jax.tree_util.tree_map(np.asarray, info))
    return state, infos
