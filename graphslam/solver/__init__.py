"""Pose-graph optimizer: Gauss-Newton / Levenberg-Marquardt over the
linearized factor blocks — the JAX rebuild of
gtsam::LevenbergMarquardtOptimizer (graph.cpp:115-132, SURVEY.md §3.3).

Two normal-equation backends:
  dense — full (N*T, N*T) Hessian + Cholesky; for small graphs.
  pcg   — matrix-free block-sparse preconditioned CG; gather/einsum/
          segment-sum products for large graphs and the sharded solver.
"""

from graphslam.solver.lm import lm_solve, gn_solve, LMState  # noqa: F401
from graphslam.solver.normal_eq import (  # noqa: F401
    build_blocks,
    dense_solve,
    pcg_solve,
    BlockSystem,
)
from graphslam.solver.init import chordal_init_se2, chordal_init_se3  # noqa: F401
from graphslam.solver.schur import schur_plan, schur_solve  # noqa: F401
from graphslam.solver.marginals import (  # noqa: F401
    marginal_covariances_dense,
    marginal_covariance_cg,
)
from graphslam.solver.tridiag import cr_factor, cr_solve  # noqa: F401
