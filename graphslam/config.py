"""Typed configuration for the whole framework.

The reference hard-codes every tunable as a C++ global annotated "TODO
migrate to rosparams" (graph.cpp:12-16, scanner.cpp:9-11, odometry.cpp:22-23).
This module is the real config system it lacked; defaults reproduce the
reference constants exactly.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Pose-graph optimizer settings (replaces gtsam LM defaults, graph.cpp:119).

    `mode` selects the normal-equation solve:
      * "dense"  — dense Cholesky of the full (D*N, D*N) Hessian; right for
                   small graphs and tests.
      * "pcg"    — matrix-free block-sparse preconditioned conjugate gradient;
                   right for large graphs (city10000+) and the multi-device path.
      * "auto"   — dense up to `dense_threshold` poses, else pcg.
    """

    mode: str = "auto"
    # The dense/pcg crossover. The value was chosen on an earlier
    # accelerator and is not measured on the H100.
    dense_threshold: int = 512

    # Levenberg-Marquardt schedule (mirrors GTSAM's defaults closely enough to
    # hit the same optima: lambda up/down factors, initial lambda).
    max_iterations: int = 100
    init_lambda: float = 1e-5
    lambda_factor: float = 10.0
    min_lambda: float = 1e-10
    max_lambda: float = 1e7
    # Relative decrease in chi2 below which we declare convergence.
    rel_decrease_tol: float = 1e-6
    abs_decrease_tol: float = 1e-9

    # PCG settings. preconditioner: "tridiag" (cyclic-reduction solve of the
    # odometry-chain block-tridiagonal part — solver/tridiag.py) or "jacobi".
    cg_max_iterations: int = 250
    cg_tol: float = 1e-8
    preconditioner: str = "tridiag"

    # Robust kernel on loop-closure edges (BASELINE config 2). delta is the
    # Huber transition point in units of whitened residual norm.
    huber_delta: float = 1.0
    use_huber_on_loops: bool = False

    dtype: str = "float32"

    def __post_init__(self):
        if self.mode not in ("auto", "dense", "pcg"):
            raise ValueError(f"unknown solver mode {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Scan-matching frontend settings (replaces scanner.cpp:9-11 globals)."""

    # Laser model — the reference Stage world (willow.world:8-14).
    num_beams: int = 1081
    fov_rad: float = 4.71716  # 270.25 deg
    max_range: float = 30.0
    min_range: float = 0.02

    # Padded point budget: 1081 beams pad to 1152 = 9 * 128. The value was
    # chosen on an earlier accelerator and is not measured on the H100.
    max_points: int = 1152

    # GICP IRLS iteration budget (PCL GICP default is up to 200 outer
    # iterations). The loop stops early once the update norm is below tol.
    icp_iterations: int = 32
    # Correspondence gating distance (m).
    max_correspondence_distance: float = 1.0
    # GICP surfel regularization: covariance eigenvalues (1, epsilon) along
    # (tangent, normal) of the locally fitted line.
    gicp_epsilon: float = 1e-3
    # Neighborhood half-width (beams) for local line fit.
    normal_half_window: int = 4
    # Run each GICP IRLS iteration as one GPU kernel (ops/icp_kernel.py).
    # None chooses by platform: the kernel on a CUDA device, XLA elsewhere.
    gicp_kernel: Optional[bool] = None

    # Keyframe gating. The reference creates a keyframe when GICP fitness
    # EXCEEDS 0.1 (scanner.cpp:57) — a motion/novelty gate (quirk §3.6.3 in
    # SURVEY.md). We keep that motion gate and add the quality gate the
    # reference conflated with it.
    keyframe_fitness_threshold: float = 0.1
    # Standard distance/rotation keyframe gates (environment-independent
    # backstop the reference lacked — its fitness gate alone can starve in
    # feature-poor corridors or fire constantly in clutter).
    keyframe_trans_threshold: float = 0.5
    keyframe_rot_threshold: float = 0.3
    # Quality gate: RMS gated-correspondence error must be below this for the
    # delta to be trusted as a factor.
    max_match_rmse: float = 0.5

    # Motion-scaled diagonal covariance model constants (scanner.cpp:11,
    # odometry.cpp:23 — intended semantics per SURVEY.md §3.6.5).
    k_disp_disp: float = 0.1
    k_rot_disp: float = 0.1
    k_rot_rot: float = 0.1

    # Match-informed factor covariance: when a registration is trusted, the
    # factor noise is the scaled inverse of the GICP IRLS Hessian (the match
    # Fisher information) instead of the motion-magnitude model alone —
    # anisotropic, so weakly-observed directions (corridors) carry inflated
    # variance rather than the reference's binary accept/reject
    # (scanner.hpp:64-80). The motion model contributes a floor scaled by
    # match_cov_motion_floor.
    use_match_covariance: bool = True
    match_cov_motion_floor: float = 0.01

    dtype: str = "float32"


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    """Online pipeline settings (replaces graph.cpp:12-16 globals)."""

    # Preallocated capacities (the reference used unbounded std::vector and
    # int8 ids that overflow at 127 keyframes — SURVEY.md §2.3).
    max_keyframes: int = 1024
    max_factors: int = 4096

    # Prior noise sigma on x, y, theta (graph.cpp:13-14).
    prior_sigma_xy: float = 0.1
    prior_sigma_theta: float = 0.1

    # Loop closure: exclude this many most-recent keyframes from candidate
    # search (graph.cpp:15) and gate candidates by distance (the reference had
    # no gate — SURVEY.md §3.6.6; we add one).
    loop_closure_skip: int = 10
    loop_closure_max_distance: float = 3.0

    # Run the optimizer every K accepted keyframes (the reference's solve()
    # was disabled entirely, graph.cpp:195; we enable it).
    solve_every: int = 1
    solve_iterations: int = 8
    # Occupancy bucketing: periodic solves run over the smallest power-of-two
    # pose window >= num_kf (and >= this floor), so solve cost tracks the
    # live map instead of max_keyframes. Each bucket is one extra solver
    # compilation.
    solve_bucket_min: int = 128

    # Per-keyframe covariance recovery — the Keyframe.msg pose_opti
    # covariance contract (src/common/msg/Keyframe.msg:4,
    # Pose2DWithCovariance.msg:2) and the Marginals::marginalCovariance the
    # reference sketched but never ran (graph.cpp:120,126-127). After a
    # periodic solve, recover the marginal covariance of every live pose
    # into SLAMState.kf_covs (slam/pipeline.py: a dense inverse of the
    # bucket's Hessian). 0 disables. Recovery uses the first cov_loop_window
    # loop slots (a static width), so it runs only while
    # num_loops <= cov_loop_window; beyond it, covariances keep their last
    # refreshed values. cov_every is the cadence when cov_on_loop_only is off.
    cov_every: int = 8
    cov_loop_window: int = 64
    # Refresh marginals only on steps that COMMIT a loop closure (instead
    # of every cov_every-th keyframe). Loop closures are the only events
    # that shrink uncertainty; between them every fresh keyframe already
    # gets the dead-reckoning-grade transported covariance at commit time
    # (pipeline.py), which only grows — so the periodic cadence was paying
    # the full selected-inverse recovery to reproduce what the transport
    # already tracks. With solve_every == 1 (default) every loop commit is
    # followed by its solve, so no refresh is missed; at solve_every > 1 a
    # loop's refresh lands on the next periodic solve.
    cov_on_loop_only: bool = True

    # Scan-to-map matching: the odometry match's target is the union of the
    # last K keyframes' points expressed in the last keyframe's (optimized)
    # frame. 1 = plain scan-to-keyframe (the reference's behavior,
    # scanner.cpp:115); >1 = local-map matching per the north star.
    scan_to_map_keyframes: int = 1

    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for the distributed solver."""

    # Axis names; factors are sharded over 'dev'. State (poses) is replicated
    # — a 100k-pose SE(3) state is <6 MB, while factor work dominates.
    axis: str = "dev"
    num_devices: Optional[int] = None  # None → all visible devices
